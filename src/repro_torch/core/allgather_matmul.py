"""AllGather x matmul and matmul x ReduceScatter (sequence parallel).

Under sequence parallelism the row-parallel AllReduce splits into a
reduce-scatter fused with the producing matmul and the next layer's
all-gather fused with the consuming matmul.  The JAX package computes both
as plain products around ring hops, outside any Pallas kernel.

This slice runs one card (tp = 1): the gather and the scatter are the
identity, so ``bulk`` and ``kernel`` mode are the one product (the
reference's ``bulk`` branch, and its ring with no hops).  ``fused`` mode
(the chunked ring) comes with the multi-card tp world, and its gradient
with dense training.
"""
from __future__ import annotations

from repro_torch.parallel.sharding import ParallelContext

_FUSED_ITEM = ("ROADMAP Queue 1 items 1 and 4 (the multi-card tp world's rings, "
               "and dense training)")


def _one_card_product(ctx: ParallelContext, op: str, family: str, x, w):
    mode = ctx.fusion.resolve(family)
    if mode not in ("bulk", "kernel"):
        raise NotImplementedError(f"{op} mode={mode!r}: {_FUSED_ITEM}")
    return x @ w


def allgather_matmul(ctx: ParallelContext, x, w):
    """y[b, s, :] = (AG_tp(x) @ w_colshard)[b, s, :]: x [B, S, K], w [K, N]
    -> [B, S, N], in the mode ``ctx.fusion.resolve("ag_matmul")``."""
    return _one_card_product(ctx, "allgather_matmul", "ag_matmul", x, w)


def matmul_reducescatter(ctx: ParallelContext, x, w):
    """y = ReduceScatter_tp(x @ w_rowshard) over the sequence dim: x [B, S, K],
    w [K, N] -> [B, S, N], in the mode ``ctx.fusion.resolve("matmul_rs")``."""
    return _one_card_product(ctx, "matmul_reducescatter", "matmul_rs", x, w)
