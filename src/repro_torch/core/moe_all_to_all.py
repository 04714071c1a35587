"""The MoE layer's two All-to-Alls as entries of their own (paper Sec. III,
GEMM + All-to-All): the dispatch exchange and the expert FFN fused with the
combine exchange.

After the JAX package's ``repro.core.moe_all_to_all``.  Experts are sharded
over the tp ranks (expert parallelism); tokens move between the tp ranks of
one data row (``group="tp"`` of ``core/collectives.py``), so both entries
run at any dp.  Every rank calls them on its own view, the body of the
reference's ``shard_map``:

  dispatch  x [B, n_ep, E_loc, C, D], dim 1 the destination rank ->
            [B, n_ep, E_loc, C, D], dim 1 the source rank
  combine   x_dispatched [B, n_ep, E_loc, C, D] by source and this rank's
            experts' w_up / w_gate [E_loc, D, F], w_down [E_loc, F, D] ->
            [B, n_ep, E_loc, C, D], the expert outputs back by destination

Three modes:

  bulk    one bulk All-to-All (the combine's after all three einsums)
  fused   per-destination direct sends (``direct_all_to_all_compute``):
          each destination's block (cut into ``chunks_per_rank`` slices
          along the capacity axis) is put on the wire the moment it is
          sliced out (dispatch) or its FFN is computed (combine), farthest
          destination first under comm_aware, rotated by ``skew``; ``wire``
          compresses each remote send
  kernel  the hand-written CUDA kernels (``kernels/fused_dispatch_a2a``,
          ``kernels/fused_gemm_a2a``) on one rank; over several ranks they
          need real peers and raise (ROADMAP Queue 1 item 1)

``chunks_per_rank`` and ``wire`` resolve as the reference's ``_resolve``
does (``"auto"`` through ``tune_all_to_all``).  Both entries consult the
degradation policy under the reference's keys (``moe_dispatch_a2a``,
``moe_combine_a2a``) and are differentiable.  In fused mode the expert
weights' gradient sums the destinations' blocks in f32 in destination order,
whatever order the schedule and ``skew`` computed them in, so the skew keeps
the gradient's bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import resolve_overlap, tune_all_to_all
from repro_torch.core.collectives import bulk_all_to_all, direct_all_to_all_compute
from repro_torch.core.degrade import degrade_mode
from repro_torch.kernels import clamp_kernel_wire
from repro_torch.kernels.fused_dispatch_a2a.ops import REAL_PEERS_ITEM, fused_dispatch_a2a
from repro_torch.kernels.fused_gemm_a2a.ops import fused_gemm_a2a
from repro_torch.kernels.fused_gemm_a2a.ref import expert_ffn_ref
from repro_torch.parallel.sharding import ParallelContext


def _resolve(ctx: ParallelContext, chunks_per_rank, wire, *, sub_dim, chunk_elems,
             flops_per_dest, dtype_bytes, skew=0, kernel=False):
    """FusionConfig/override -> feasible (chunks_per_rank, wire).  Sub-chunks
    are cut along the capacity axis, so q must divide ``sub_dim`` (= C).
    ``kernel=True`` tunes the device-initiated path under its own op (fp8
    clamped to bf16 in the decision, and a pinned fp8 clamped after it)."""
    dec = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_all_to_all(chunk_elems, flops_per_dest, dtype_bytes=dtype_bytes,
                                       n_dev=ctx.tp, sub_dim=sub_dim, hw=ctx.hw, skew=skew,
                                       wire=wr, fixed_q=fq, kernel=kernel),
        dim=sub_dim, ring=1)
    if kernel and dec.wire == "fp8":
        dec = dec._replace(wire=clamp_kernel_wire(dec.wire, "moe_a2a_kernel"))
    return dec


class _FanOut(torch.autograd.Function):
    """``n`` aliases of ``w``, one for each block that uses it.  The backward
    sums the aliases' cotangents in f32 in the aliases' order and rounds the
    sum once, so the gradient does not depend on the order the blocks ran
    in (autograd would add them in w's dtype as they arrive)."""

    @staticmethod
    def forward(fctx, n, w):
        fctx.dtype = w.dtype
        return tuple(w.view_as(w) for _ in range(n))

    @staticmethod
    def backward(fctx, *gs):                   # undefined cotangents come as zeros
        out = torch.empty_like(gs[0], dtype=fctx.dtype)
        for i in range(out.shape[0]):          # an expert at a time: a small f32 sum
            acc = gs[0][i].to(torch.float32, copy=True)
            for g in gs[1:]:
                acc.add_(g[i])
            out[i] = acc
        return None, out


def _kernel_one_rank(ctx: ParallelContext, what: str):
    if ctx.tp > 1:
        raise NotImplementedError(f"{what} in kernel mode at tp={ctx.tp} needs real peers: "
                                  f"{REAL_PEERS_ITEM}")


def _global_key(ctx: ParallelContext, x, *extra):
    """The reference's degradation key: the data row's global layout
    [B, n_ep, E, C, D] (experts over the tp ranks), then ``extra``."""
    b, n_ep, e_loc, cap, d = x.shape
    return (b, n_ep, e_loc * ctx.tp, cap, d) + tuple(extra)


def moe_dispatch_all_to_all(ctx: ParallelContext, x, *, mode: str | None = None,
                            schedule: str | None = None, chunks_per_rank=None,
                            skew: int | None = None, wire: str | None = None):
    """All-to-All of dispatch buffers over the tp ranks of this data row.

    x: [B, n_ep, E_loc, C, D], dim 1 the destination rank -> the same shape,
    dim 1 the source rank.  ``mode`` defaults to
    ``ctx.fusion.resolve("moe_a2a")``; ``schedule``, ``skew``,
    ``chunks_per_rank`` and ``wire`` (``None``: ``ctx.fusion``'s) shape the
    fused and kernel exchanges (module docstring)."""
    mode = mode or ctx.fusion.resolve("moe_a2a")
    mode = degrade_mode("moe_dispatch_a2a", _global_key(ctx, x), mode)
    schedule = schedule or ctx.fusion.schedule
    skew = ctx.fusion.skew if skew is None else int(skew)
    b, n_ep, e_loc, cap, dmodel = x.shape
    if n_ep != ctx.tp:
        raise ValueError(f"moe_dispatch_all_to_all: {n_ep} destinations in a world of tp="
                         f"{ctx.tp}")
    if mode == "kernel":
        _kernel_one_rank(ctx, "moe_dispatch_all_to_all")
    dec = (None if mode == "bulk" else
           _resolve(ctx, chunks_per_rank, wire, sub_dim=cap, chunk_elems=b * e_loc * cap * dmodel,
                    flops_per_dest=0.0, dtype_bytes=x.element_size(), skew=skew,
                    kernel=mode == "kernel"))
    xt = x.movedim(1, 0)                                   # [n_ep, B, E_loc, C, D]
    if mode == "kernel":
        out = fused_dispatch_a2a(xt.contiguous(), comm_aware=schedule == "comm_aware",
                                 chunks_per_rank=dec.q, skew=skew, wire=dec.wire)
    elif mode == "bulk":
        out = bulk_all_to_all(ctx, xt.contiguous(), group="tp")
    else:
        q, sub = dec.q, cap // dec.q

        def produce(f):
            dest, s = divmod(f, q)
            return xt[dest].narrow(2, s * sub, sub)

        out = direct_all_to_all_compute(ctx, produce, tuple(xt.shape[1:]), schedule=schedule,
                                        chunks_per_rank=q, sub_axis=2, skew=skew,
                                        wire=dec.wire, group="tp")
    return out.movedim(0, 1)


def fused_expert_ffn_combine(ctx: ParallelContext, x_dispatched, w_up, w_gate, w_down, *,
                             act: str = "silu", mode: str | None = None,
                             schedule: str | None = None, chunks_per_rank=None,
                             skew: int | None = None, wire: str | None = None):
    """Expert FFN fused with the combine All-to-All (the paper's GEMM+A2A).

    x_dispatched: [B, n_ep, E_loc, C, D], tokens dispatched to this rank's
    experts, dim 1 the source rank (the combine's destination); w_up,
    w_gate [E_loc, D, F], w_down [E_loc, F, D]: this rank's experts.
    Returns [B, n_ep, E_loc, C, D], dim 1 the destination: each block's
    act(x w_gate) (x w_up) w_down back at the rank that sent it.

    fused: for each destination, farthest first and the local block last
    (comm_aware), the FFN over its block, cut into ``chunks_per_rank``
    slices along the capacity axis, each slice shipped the moment its
    products finish.  kernel: the FFN + combine kernel on one rank (its
    wire resolved under the kernel's own tuning key)."""
    mode = mode or ctx.fusion.resolve("moe_a2a")
    mode = degrade_mode("moe_combine_a2a", _global_key(ctx, x_dispatched, w_up.shape[-1]), mode)
    schedule = schedule or ctx.fusion.schedule
    skew = ctx.fusion.skew if skew is None else int(skew)
    b, n_ep, e_loc, cap, dmodel = x_dispatched.shape
    if n_ep != ctx.tp:
        raise ValueError(f"fused_expert_ffn_combine: {n_ep} sources in a world of tp={ctx.tp}")
    d_ff = w_up.shape[-1]
    chunk_elems = b * e_loc * cap * dmodel
    flops = 2.0 * 3 * b * e_loc * cap * dmodel * d_ff
    xt = x_dispatched.movedim(1, 0)                        # [n_ep, B, E_loc, C, D]
    if mode == "kernel":
        _kernel_one_rank(ctx, "fused_expert_ffn_combine")
        kdec = _resolve(ctx, 1, wire, sub_dim=cap, chunk_elems=chunk_elems,
                        flops_per_dest=flops, dtype_bytes=x_dispatched.element_size(),
                        skew=skew, kernel=True)
        out = fused_gemm_a2a(xt.contiguous(), w_up, w_gate, w_down, act=act,
                             comm_aware=schedule == "comm_aware", skew=skew, wire=kdec.wire)
    elif mode == "bulk":
        y = expert_ffn_ref(xt, w_up, w_gate, w_down, act)   # all GEMMs first...
        out = bulk_all_to_all(ctx, y, group="tp")            # ...then one A2A
    else:
        dec = _resolve(ctx, chunks_per_rank, wire, sub_dim=cap, chunk_elems=chunk_elems,
                       flops_per_dest=flops, dtype_bytes=x_dispatched.element_size(), skew=skew)
        q, sub = dec.q, cap // dec.q
        ws = [_FanOut.apply(n_ep * q, w_) for w_ in (w_up, w_gate, w_down)]

        def produce(f):
            dest, s = divmod(f, q)
            return expert_ffn_ref(xt[dest].narrow(2, s * sub, sub), *(w_[f] for w_ in ws), act)

        out = direct_all_to_all_compute(ctx, produce, tuple(xt.shape[1:]), schedule=schedule,
                                        chunks_per_rank=q, sub_axis=2, skew=skew,
                                        wire=dec.wire, group="tp")
    return out.movedim(0, 1)

