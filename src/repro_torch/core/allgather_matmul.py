"""AllGather x matmul and matmul x ReduceScatter (sequence parallel).

Under sequence parallelism the row-parallel AllReduce splits into a
reduce-scatter fused with the producing matmul and the next layer's
all-gather fused with the consuming matmul.  The JAX package computes both
as plain products around ring hops, outside any Pallas kernel, and so does
the port: ``fused`` and ``kernel`` mode run the ring (at tp = 1 it has no
hops), ``bulk`` mode one collective and one product.

  allgather_matmul:     x [B, S_local, K] (this rank's sequence chunk), w
                        [K, N_local] (its columns) -> y [B, S, N_local]
  matmul_reducescatter: x [B, S, K_local], w [K_local, N] (its rows)
                        -> y [B, S_local, N], summed over the ranks

The rings are not differentiable at tp > 1 (training at tp > 1, and the
prefill around these ops, are ROADMAP Queue 1 item 1's left part).

Both consult the degradation policy (``core/degrade.py``) before their
mode branch, under the reference's keys (``x.shape + w.shape`` in whole
shapes), and resolve ``"auto"`` granularity or wire through
``tune_allgather_matmul`` / ``tune_matmul_allreduce`` (``core/autotune.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import (resolve_overlap, tune_allgather_matmul,
                                       tune_matmul_allreduce)
from repro_torch.core.collectives import (_no_grad_over_ranks, all_gather, all_reduce,
                                          ring_permute_start, ring_reduce_scatter_compute,
                                          wire_cast, wire_uncast)
from repro_torch.core.degrade import degrade_mode
from repro_torch.core.scheduling import sub_chunk_service_order
from repro_torch.parallel.sharding import ParallelContext


def allgather_matmul(ctx: ParallelContext, x, w, *, mode: str | None = None,
                     chunks_per_rank: int | str | None = None,
                     skew: int | None = None, wire: str | None = None):
    """y[b, s, :] = (AG_tp(x) @ w_colshard)[b, s, :], in the mode
    ``ctx.fusion.resolve("ag_matmul")`` unless ``mode`` is given.

    The ring: the local sequence chunk is multiplied first (it is there at
    once, hiding the first hop), then each arriving chunk while the next
    is on the wire.  ``chunks_per_rank`` splits the payload into sub-chunks
    that ring (and are consumed) on their own (Fig. 13); ``skew`` rotates
    their service order (Fig. 14; results land in disjoint slices, so the
    rotation is bit-exact); ``wire`` compresses the forwarded sub-chunks
    once at their source.  The defaults are ``ctx.fusion``'s."""
    mode = mode or ctx.fusion.resolve("ag_matmul")
    n, d = ctx.tp, ctx.tp_rank
    b, s_loc, k = x.shape
    n_loc = w.shape[1]
    mode = degrade_mode("allgather_matmul", (b, s_loc * n, k, k, n_loc * n), mode)
    if mode == "bulk":
        return all_gather(ctx, x, axis=1) @ w
    skew = ctx.fusion.skew if skew is None else int(skew)
    q, wire = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_allgather_matmul(
            b, s_loc, k, n_loc, dtype_bytes=x.element_size(), n_dev=n, hw=ctx.hw,
            skew=skew, wire=wr, fixed_q=fq),
        dim=s_loc, ring=1)
    if n == 1 and mode == "kernel":
        return x @ w     # the ring with no hops and one sub-chunk: one product
    _no_grad_over_ranks(ctx, "allgather_matmul", x, w)
    order = sub_chunk_service_order(q, skew)
    sub = s_loc // q
    out = torch.empty((x.shape[0], s_loc * n, w.shape[1]), dtype=x.dtype, device=x.device)
    bufs = [wire_cast(b, wire) for b in x.split(sub, dim=1)] if n > 1 else []
    pending = {j: ring_permute_start(ctx, bufs[j]) for j in order} if n > 1 else {}
    for j, xj in enumerate(x.split(sub, dim=1)):
        out[:, d * s_loc + j * sub:d * s_loc + (j + 1) * sub] = xj @ w
    for i in range(1, n):
        src = (d - i) % n
        for j in order:
            bufs[j] = pending[j]()
            if i < n - 1:
                pending[j] = ring_permute_start(ctx, bufs[j])
            lo = src * s_loc + j * sub
            out[:, lo:lo + sub] = wire_uncast(bufs[j], x.dtype) @ w
    return out


def matmul_reducescatter(ctx: ParallelContext, x, w, *, mode: str | None = None,
                         schedule: str | None = None,
                         chunks_per_rank: int | str | None = None,
                         skew: int | None = None, wire: str | None = None):
    """y = ReduceScatter_tp(x @ w_rowshard) over the sequence dim, in the mode
    ``ctx.fusion.resolve("matmul_rs")`` unless ``mode`` is given.  The ring
    (``ring_reduce_scatter_compute`` over sequence chunks) takes
    ``schedule``, ``chunks_per_rank``, ``skew`` and ``wire``, defaulting to
    ``ctx.fusion``'s; bulk mode sums the whole product over the ranks and
    keeps this rank's sequence chunk."""
    mode = mode or ctx.fusion.resolve("matmul_rs")
    n, d = ctx.tp, ctx.tp_rank
    b, s, k_loc = x.shape
    nout = w.shape[1]
    mode = degrade_mode("matmul_reducescatter", (b, s, k_loc * n, k_loc * n, nout), mode)
    if mode == "bulk":
        y = all_reduce(ctx, x @ w)
        return y if n == 1 else y[:, d * (s // n):(d + 1) * (s // n)]
    skew = ctx.fusion.skew if skew is None else int(skew)
    q, wire = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_matmul_allreduce(
            b * s, k_loc, nout, dtype_bytes=x.element_size(), n_dev=n, chunk_dim=s,
            allgather_phase=False, hw=ctx.hw, skew=skew, wire=wr, fixed_q=fq),
        dim=s, ring=n)
    if n == 1 and mode == "kernel":
        return x @ w
    _no_grad_over_ranks(ctx, "matmul_reducescatter", x, w)
    chunk = s // (n * q)
    return ring_reduce_scatter_compute(
        ctx, lambda f: x[:, f * chunk:(f + 1) * chunk] @ w,
        schedule=schedule or ctx.fusion.schedule, chunks_per_rank=q, sub_axis=1,
        skew=skew, wire=wire)


def allgather_seq(ctx: ParallelContext, x, *, axis_pos: int = 1):
    """Plain all-gather of a sequence-sharded activation (layout boundaries)."""
    return all_gather(ctx, x, axis=axis_pos)
