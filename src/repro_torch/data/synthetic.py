"""Deterministic synthetic data (seeded numpy, the JAX package's generators).

LM batches follow a Zipf-ish unigram distribution with local bigram
structure, so the loss actually decreases in a short run; DLRM batches mirror the public DLRM data generator (uniform categorical +
normal dense) the paper evaluates with.  The arrays are numpy, drawn exactly
as the JAX package draws them, so one seed gives both packages the same
batch; the caller moves them to its device.
"""
from __future__ import annotations

import numpy as np


class LMBatches:
    """{"tokens", "labels"}: [batch, seq] int32 each, labels the tokens
    shifted by one."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.rng = np.random.default_rng(seed)
        # fixed random bigram table gives learnable structure
        self._follow = np.random.default_rng(seed + 1).integers(
            0, vocab, size=(min(vocab, 4096),), dtype=np.int64)

    def __iter__(self):
        return self

    def __next__(self):
        zipf = self.rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(zipf - 1, self.vocab - 1).astype(np.int32)
        # inject bigram structure: half the positions follow the table
        mask = self.rng.random((self.batch, self.seq)) < 0.5
        nxt = self._follow[toks[:, :-1] % len(self._follow)].astype(np.int32)
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DLRMBatches:
    def __init__(self, n_tables: int, vocab: int, pooling: int, n_dense: int,
                 batch: int, seed: int = 0):
        self.p = (n_tables, vocab, pooling, n_dense, batch)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        t, v, L, nd, b = self.p
        return {
            "dense": self.rng.standard_normal((b, nd)).astype(np.float32),
            "indices": self.rng.integers(0, v, size=(b, t, L)).astype(np.int32),
            "labels": (self.rng.random(b) < 0.3).astype(np.float32),
        }
