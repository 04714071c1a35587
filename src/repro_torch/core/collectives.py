"""Collective building blocks.

The JAX package's module also holds the chunked rings and decomposed
All-to-Alls of ``fused`` mode; they come with ROADMAP Queue 1 item 1 (the
multi-card tp world).  This port runs one card.
"""
from __future__ import annotations

from repro_torch.parallel.sharding import ParallelContext

_MULTI_CARD_ITEM = "ROADMAP Queue 1 item 1 (the multi-card tp world)"


def feasible_chunks_per_rank(dim: int, n: int, q: int) -> int:
    """Largest q' <= q such that ``dim`` splits evenly into ``n * q'``
    fine chunks (sub-chunk granularity must divide the chunked dim)."""
    q = max(1, int(q))
    while q > 1 and dim % (n * q) != 0:
        q -= 1
    return q


def bulk_all_to_all(ctx: ParallelContext, x):
    """Baseline: one All-to-All over the leading dim [n, ...] -> [n, ...]
    across the tp ranks.  On a one-card world it is the identity."""
    if ctx.tp != 1:
        raise NotImplementedError(f"bulk_all_to_all over tp={ctx.tp}: {_MULTI_CARD_ITEM}")
    return x
