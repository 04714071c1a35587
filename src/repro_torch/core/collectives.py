"""Collective building blocks.

The JAX package's module also holds the chunked rings of ``fused`` mode and
the remote sends of the decomposed All-to-All; they come with ROADMAP Queue
1 item 1 (the multi-card tp world).  This port runs one card, where every
All-to-All keeps each rank's own block.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.scheduling import ring_offsets
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


def direct_all_to_all_compute(
    ctx: ParallelContext,
    produce_fn: Callable[[int], torch.Tensor],
    chunk_shape,
    *,
    schedule: str = "comm_aware",
    chunks_per_rank: int = 1,
    sub_axis: int = 0,
    skew: int = 0,
):
    """Fused compute + All-to-All by per-destination direct sends.

    ``produce_fn(f)`` computes the fine chunk ``f = dest * q + s``: the
    ``s``-th of ``q = chunks_per_rank`` slices along ``sub_axis`` of the
    chunk this rank owes rank ``dest`` (``chunk_shape`` describes the whole
    chunk).  Destinations are visited in ``ring_offsets(n, schedule,
    skew)`` order.  Returns ``[n, *chunk_shape]`` stacked by source rank.

    On one card (n = 1) the only destination is the rank itself, whose
    chunk never touches the wire, so the reference's ``wire`` (the remote
    payload's dtype) has nothing to act on and is not taken; with q = 1 the
    produced chunk is returned without a copy."""
    n = ctx.tp * ctx.dp
    if n != 1:
        raise NotImplementedError(f"direct_all_to_all_compute over {n} ranks: "
                                  f"{_MULTI_CARD_ITEM}")
    q = chunks_per_rank
    if chunk_shape[sub_axis] % q:
        raise ValueError(
            f"sub-chunk factor {q} does not divide destination-chunk axis "
            f"{sub_axis} of size {chunk_shape[sub_axis]}; clamp via "
            f"feasible_chunks_per_rank first")
    pieces = []
    for off in ring_offsets(n, schedule, skew):
        dest = off            # (my + off) % n with my = 0
        pieces += [produce_fn(dest * q + s) for s in range(q)]
    own = pieces[0] if q == 1 else torch.cat(pieces, dim=sub_axis)
    return own.unsqueeze(0)
