"""Host-side paged KV cache: a block allocator + per-request block tables.

The device side is a shared pool of fixed-size KV blocks (per layer
``[NB + 1, block, Hkv, hd]``: the ``NB`` blocks the allocator hands out and
one sink block, see :func:`repro_torch.models.attention.paged_cache_update`).
This module owns the *mapping*: which pool blocks hold which request's
sequence.  Ragged sequences then cost device memory in proportion to the
tokens they actually hold instead of the dense ``B x S_max`` worst case, and
a retired request's blocks return to the free list immediately.

Allocation stripes round-robin across the tp *rank stripes* (rank d owns
global blocks ``[d*NB/n, (d+1)*NB/n)``), so KV writes and attention reads
stay balanced across ranks instead of piling onto whichever rank's stripe
the free list happened to drain first.  On one card there is one stripe.

Block tables are padded with ``FREE_BLOCK`` (-1): a sentinel no rank owns,
so the device-side scatter drops those rows and the gather masks them
instead of corrupting block 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FREE_BLOCK = -1


class OutOfBlocks(RuntimeError):
    """The pool has no free block for a required allocation."""


@dataclasses.dataclass
class PagedStats:
    num_blocks: int
    block_size: int
    used_blocks: int
    peak_blocks: int
    requests: int

    @property
    def used_tokens_capacity(self) -> int:
        return self.used_blocks * self.block_size


class PagedKVCache:
    """Block allocator + per-request block tables (host side, numpy).

    Parameters
    ----------
    num_blocks:      total pool blocks (must divide evenly by n_stripes).
    block_size:      tokens per block.
    max_blocks_per_request:
                     table width MB; a request holds at most
                     ``MB * block_size`` tokens (the serving cache bound).
    n_stripes:       tp size: allocation round-robins across the per-rank
                     block stripes to balance memory and attention load.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_request: int, n_stripes: int = 1):
        if num_blocks % n_stripes:
            raise ValueError(
                f"num_blocks={num_blocks} not divisible by n_stripes={n_stripes}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks = max_blocks_per_request
        self.n_stripes = n_stripes
        per = num_blocks // n_stripes
        # LIFO per stripe: recently freed blocks are handed out again first
        self._free: list[list[int]] = [
            list(range(s * per + per - 1, s * per - 1, -1))
            for s in range(n_stripes)]
        self._rr = 0
        self._tables: dict[int, list[int]] = {}
        self.peak_blocks = 0

    # -- introspection ----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    def stats(self) -> PagedStats:
        return PagedStats(self.num_blocks, self.block_size,
                          self.used_blocks, self.peak_blocks,
                          len(self._tables))

    def blocks_for(self, uid: int) -> list[int]:
        return list(self._tables.get(uid, ()))

    # -- allocation -------------------------------------------------------
    def _alloc_one(self) -> int:
        for _ in range(self.n_stripes):
            stripe = self._free[self._rr]
            self._rr = (self._rr + 1) % self.n_stripes
            if stripe:
                return stripe.pop()
        raise OutOfBlocks(
            f"pool exhausted: {self.num_blocks} blocks all in use")

    def register(self, uid: int) -> None:
        if uid not in self._tables:
            self._tables[uid] = []

    def ensure(self, uid: int, length: int) -> None:
        """Grow ``uid``'s table to cover ``length`` tokens.

        Raises :class:`OutOfBlocks` when the pool is exhausted (the caller
        decides: defer admission, or preempt); partial growth is rolled
        back, so a failed ensure leaves the table unchanged.  Raises
        ``ValueError`` past the table bound ``MB * block_size`` (the engine
        retires at the bound before this can trigger).
        """
        need = -(-length // self.block_size)          # ceil
        if need > self.max_blocks:
            raise ValueError(
                f"request {uid}: {length} tokens exceeds table bound "
                f"{self.max_blocks * self.block_size}")
        table = self._tables.setdefault(uid, [])
        grown: list[int] = []
        try:
            while len(table) < need:
                table.append(self._alloc_one())
                grown.append(table[-1])
        except OutOfBlocks:
            for b in grown:
                table.remove(b)
            self._release_blocks(grown)
            raise
        self.peak_blocks = max(self.peak_blocks, self.used_blocks)

    def capacity(self, uid: int) -> int:
        """Tokens the request's current blocks can hold."""
        return len(self._tables.get(uid, ())) * self.block_size

    # -- release ----------------------------------------------------------
    def _release_blocks(self, blocks: list[int]) -> None:
        per = self.num_blocks // self.n_stripes
        for b in blocks:
            self._free[b // per].append(b)

    def release(self, uid: int) -> None:
        """Free all of a retired request's blocks back to their stripes."""
        self._release_blocks(self._tables.pop(uid, []))

    def reset(self) -> None:
        for uid in list(self._tables):
            self.release(uid)

    # -- device-facing views ----------------------------------------------
    def table(self, uid: int) -> np.ndarray:
        t = np.full(self.max_blocks, FREE_BLOCK, np.int32)
        blocks = self._tables.get(uid, ())
        t[: len(blocks)] = blocks
        return t

    def tables_for(self, uids) -> np.ndarray:
        """Stack tables for a slot list ([B] of uid or None) -> [B, MB]."""
        out = np.full((len(uids), self.max_blocks), FREE_BLOCK, np.int32)
        for i, uid in enumerate(uids):
            if uid is not None:
                out[i] = self.table(uid)
        return out


def _tree_bytes(tree) -> int:
    """Total bytes of a nested dict/list of torch tensors."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def pool_hbm_bytes(pool) -> int:
    """Total device bytes of a paged pool tree (all layers, K and V, the
    sink block included)."""
    return _tree_bytes(pool)


def dense_cache_hbm_bytes(cache) -> int:
    """Total device bytes of a dense ``[L, B, S_max, ...]`` cache tree (a
    cache on the ``meta`` device counts without being allocated)."""
    return _tree_bytes(cache)
