"""Deterministic synthetic data (seeded numpy, the JAX package's generators).

DLRM batches mirror the public DLRM data generator (uniform categorical +
normal dense) the paper evaluates with.  The arrays are numpy, drawn exactly
as the JAX package draws them, so one seed gives both packages the same
batch; the caller moves them to its device.
"""
from __future__ import annotations

import numpy as np


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
