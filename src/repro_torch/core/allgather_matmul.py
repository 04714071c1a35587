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

At tp > 1 each ring is one ``torch.autograd.Function`` whose backward runs
the dual ring in a fixed order on every rank (JAX's transpose of the
reference's rings): ``allgather_matmul``'s dx is a reduce-scatter ring of
``dy @ w.T`` and its dw the sum of the received chunks' ``x.T dy``;
``matmul_reducescatter``'s dx and dw come from an all-gather ring of dy.
Bulk mode trains through the differentiable bulk collectives.

Both consult the degradation policy (``core/degrade.py``) before their
mode branch, under the reference's keys (``x.shape + w.shape`` in whole
shapes), and resolve ``"auto"`` granularity or wire through
``tune_allgather_matmul`` / ``tune_matmul_allreduce`` (``core/autotune.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import (resolve_overlap, tune_allgather_matmul,
                                       tune_matmul_allreduce)
from repro_torch.core.collectives import (all_gather, reduce_scatter, ring_all_gather_compute,
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
    n = ctx.tp
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
    if n == 1:
        return _ag_ring(ctx, x, w, q, skew, wire)
    return _AllGatherMatmul.apply(ctx, x, w, q, skew, wire)


def _ag_ring(ctx: ParallelContext, x, w, q, skew, wire, keep=None):
    """The forward ring of ``allgather_matmul``; ``keep`` (a list) receives
    every consumed chunk as ``(row offset, chunk)``, the remote ones as they
    arrived off the wire."""
    n, d = ctx.tp, ctx.tp_rank
    s_loc = x.shape[1]
    order = sub_chunk_service_order(q, skew)
    sub = s_loc // q
    out = torch.empty((x.shape[0], s_loc * n, w.shape[1]), dtype=x.dtype, device=x.device)
    bufs = [wire_cast(b, wire) for b in x.split(sub, dim=1)] if n > 1 else []
    pending = {j: ring_permute_start(ctx, bufs[j]) for j in order} if n > 1 else {}
    for j, xj in enumerate(x.split(sub, dim=1)):
        lo = d * s_loc + j * sub
        out[:, lo:lo + sub] = xj @ w
        if keep is not None:
            keep.append((lo, xj))
    for i in range(1, n):
        src = (d - i) % n
        for j in order:
            bufs[j] = pending[j]()
            if i < n - 1:
                pending[j] = ring_permute_start(ctx, bufs[j])
            lo = src * s_loc + j * sub
            xj = wire_uncast(bufs[j], x.dtype)
            out[:, lo:lo + sub] = xj @ w
            if keep is not None:
                keep.append((lo, xj))
    return out


class _AllGatherMatmul(torch.autograd.Function):
    """y = AG(x) @ w over the ring, with the dual ring as its backward: dx
    is the reduce-scatter ring of ``dy[:, c] @ w.T`` (the forward's
    sub-chunks, skew and wire, under ``ctx.fusion.schedule``), dw the sum
    over the chunks the forward consumed of ``x_c.T dy_c`` (kept as they
    arrived, so a compressed wire's rounding is the one the forward saw)."""

    @staticmethod
    def forward(fctx, ctx, x, w, q, skew, wire):
        keep = []
        out = _ag_ring(ctx, x, w, q, skew, wire, keep)
        keep.sort(key=lambda c: c[0])
        xs = torch.cat([c for _, c in keep], dim=1)
        fctx.save_for_backward(xs, w)
        fctx.args = (ctx, q, skew, wire, x.shape[1])
        return out

    @staticmethod
    def backward(fctx, dy):
        xs, w = fctx.saved_tensors
        ctx, q, skew, wire, s_loc = fctx.args
        dy = dy.contiguous()
        chunk = s_loc // q
        wt = w.t()
        dx = ring_reduce_scatter_compute(
            ctx, lambda f: dy[:, f * chunk:(f + 1) * chunk] @ wt, schedule=ctx.fusion.schedule,
            chunks_per_rank=q, sub_axis=1, skew=skew, wire=wire)
        k, n_loc = w.shape
        dw = (xs.reshape(-1, k).t() @ dy.reshape(-1, n_loc)).to(w.dtype)
        return None, dx, dw, None, None, None


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
    n = ctx.tp
    b, s, k_loc = x.shape
    nout = w.shape[1]
    mode = degrade_mode("matmul_reducescatter", (b, s, k_loc * n, k_loc * n, nout), mode)
    if mode == "bulk":
        return reduce_scatter(ctx, x @ w, axis=1)
    skew = ctx.fusion.skew if skew is None else int(skew)
    q, wire = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_matmul_allreduce(
            b * s, k_loc, nout, dtype_bytes=x.element_size(), n_dev=n, chunk_dim=s,
            allgather_phase=False, hw=ctx.hw, skew=skew, wire=wr, fixed_q=fq),
        dim=s, ring=n)
    if n == 1 and mode == "kernel":
        return x @ w
    schedule = schedule or ctx.fusion.schedule
    if n == 1:
        return _rs_ring(ctx, x, w, schedule, q, skew, wire)
    return _MatmulReduceScatter.apply(ctx, x, w, schedule, q, skew, wire)


def _rs_ring(ctx: ParallelContext, x, w, schedule, q, skew, wire):
    chunk = x.shape[1] // (ctx.tp * q)
    return ring_reduce_scatter_compute(
        ctx, lambda f: x[:, f * chunk:(f + 1) * chunk] @ w, schedule=schedule,
        chunks_per_rank=q, sub_axis=1, skew=skew, wire=wire)


class _MatmulReduceScatter(torch.autograd.Function):
    """y = RS(x @ w) over the ring, with the dual ring as its backward: an
    all-gather ring of dy (``wire`` casts it once at its source), each
    arriving chunk multiplied by ``w.T`` into its rows of dx and adding
    ``x[:, c].T dy_c`` to dw (in f32)."""

    @staticmethod
    def forward(fctx, ctx, x, w, schedule, q, skew, wire):
        fctx.save_for_backward(x, w)
        fctx.args = (ctx, wire)
        return _rs_ring(ctx, x, w, schedule, q, skew, wire)

    @staticmethod
    def backward(fctx, dy):
        x, w = fctx.saved_tensors
        ctx, wire = fctx.args
        s_loc = dy.shape[1]
        dx = torch.empty_like(x)
        wt = w.t()

        def consume(src, dy_src, dw):
            rows = slice(src * s_loc, (src + 1) * s_loc)
            dx[:, rows] = dy_src @ wt
            xs = x[:, rows].reshape(-1, x.shape[-1])
            return dw.addmm_(xs.t().float(), dy_src.reshape(-1, dy_src.shape[-1]).float())

        dw = ring_all_gather_compute(ctx, dy.contiguous(), consume, wire=wire,
                                     out_init=torch.zeros(w.shape, dtype=torch.float32,
                                                          device=w.device))
        return None, dx, dw.to(w.dtype), None, None, None, None


def allgather_seq(ctx: ParallelContext, x, *, axis_pos: int = 1):
    """Plain all-gather of a sequence-sharded activation (layout boundaries)."""
    return all_gather(ctx, x, axis=axis_pos)
