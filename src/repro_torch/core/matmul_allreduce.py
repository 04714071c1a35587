"""Fused GEMV/GEMM + AllReduce (paper Sec. III-B, Fig. 7).

Megatron row-parallel layer: ``x`` carries the contraction dim sharded
over tp, ``w`` is row-sharded; every rank produces a *partial* full-size
output that must be summed across the tp ranks.

  bulk   : y = all_reduce(x_local @ w_local)     (the NCCL-baseline analogue)
  fused  : the output is chunked; a matmul-interleaved ring reduce-scatter
           adds each chunk's partials while other chunks are still being
           computed, then an all-gather of the reduced chunks: the two
           phases of the paper's direct AllReduce, phase one fused into the
           product.  Comm-aware scheduling: a rank's own output chunk is
           computed last (Fig. 7b).
  kernel : the hand-written device-initiated CUDA kernel
           (``repro_torch.kernels.fused_gemv_allreduce``), at tp = 1.  With
           real peers it needs symmetric-memory pointer tables, which wait
           for a multi-card host; at tp > 1 it raises (no fallback).

Gradients: bulk mode trains through the differentiable all-reduce (its
backward passes the replicated output's cotangent through); fused mode at
tp > 1 is one ``torch.autograd.Function`` whose backward needs no
collective: y is the same on every rank, so dx = dy @ w.T and dw = x.T dy
on this rank's shards.  Kernel mode at tp = 1 (zamba2's Mamba ``w_out`` in
training) takes the same local backward around the kernel's launch.

The chunked dim is chosen as in the reference: rows (the flattened leading
dims) when they split over the ring, else the output columns.

Granularity (paper Fig. 13): ``chunks_per_rank`` splits each ring step's
payload into sub-chunks, each shipped the moment its partial product is
done; it is clamped to the largest factor dividing the chunked dim.
``"auto"`` granularity or wire resolves through ``tune_matmul_allreduce``
(``core/autotune.py``).  Before the mode branch the call consults the
degradation policy (``core/degrade.py``), which demotes a quarantined
``(op, shape)`` key to bulk mode.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import resolve_overlap, tune_matmul_allreduce
from repro_torch.core.collectives import (all_gather_wire, all_reduce,
                                          ring_reduce_scatter_compute)
from repro_torch.core.degrade import degrade_mode
from repro_torch.kernels import clamp_kernel_wire
from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
from repro_torch.parallel.sharding import ParallelContext

_KERNEL_PEERS_ITEM = ("ROADMAP Queue 1 item 1 (left: the real-peer half, kernel mode at tp > 1 "
                      "with symmetric-memory pointer tables; use fused or bulk mode)")
MODES = ("bulk", "fused", "kernel")


def matmul_allreduce(
    ctx: ParallelContext,
    x,
    w,
    *,
    mode: str | None = None,
    schedule: str | None = None,
    chunks_per_rank: int | str | None = None,
    skew: int | None = None,
    wire: str | None = None,
):
    """y = AllReduce_tp(x @ w) for row-parallel ``w``.

    x: [..., K_local], this rank's slice of the contraction dim; w:
    [K_local, N], its rows.  Returns [..., N] at x's dtype, the same on
    every rank.

    ``mode`` defaults to ``ctx.fusion.resolve("matmul_rs")``; ``schedule``,
    ``chunks_per_rank`` (the fused ring's sub-chunk granularity), ``skew``
    (the measured straggler rotation, Fig. 14) and ``wire`` (the ring
    payload's dtype) default to ``ctx.fusion``'s.  In kernel mode the
    kernel's granularity is its own tile pipeline and ``wire`` is its PUT
    payload dtype, fp8 clamped to bf16; a CUDA tensor launches the kernel
    or raises.

    The degradation key is the reference's, ``x.shape[:-1] + w.shape`` in
    whole (unsharded) shapes; the tune key holds this rank's shapes, as the
    reference's local view does."""
    mode = mode or ctx.fusion.resolve("matmul_rs")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n = ctx.tp
    lead = x.shape[:-1]
    k_loc, nout = w.shape
    mode = degrade_mode("matmul_allreduce", tuple(lead) + (k_loc * n, nout), mode)
    xf = x.reshape(-1, x.shape[-1])
    if mode == "bulk":
        return all_reduce(ctx, xf @ w).reshape(*lead, nout)
    if mode == "kernel" and n > 1:
        raise NotImplementedError(f"matmul_allreduce mode='kernel' at tp={n}: "
                                  f"{_KERNEL_PEERS_ITEM}")
    skew = ctx.fusion.skew if skew is None else int(skew)
    rows = xf.shape[0]
    use_rows = rows % n == 0 and rows >= n
    chunk_dim = rows if use_rows else nout
    dec = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_matmul_allreduce(
            rows, k_loc, nout, dtype_bytes=x.element_size(), n_dev=n, chunk_dim=chunk_dim,
            hw=ctx.hw, skew=skew, wire=wr, fixed_q=fq, allow_fp8=mode != "kernel"),
        dim=chunk_dim, ring=n)
    if mode == "kernel":
        # the kernel's granularity is its own tile pipeline
        wire = clamp_kernel_wire(dec.wire, "matmul_allreduce")
        y = _LocalBackward.apply(lambda a, b: fused_matmul_allreduce(a, b, wire=wire),
                                 xf.contiguous(), w)
        return y.reshape(*lead, nout)
    q, wire = dec
    schedule = schedule or ctx.fusion.schedule
    if n == 1:
        return _ring(ctx, xf, w, use_rows, schedule, q, skew, wire).reshape(*lead, nout)
    return _LocalBackward.apply(lambda a, b: _ring(ctx, a, b, use_rows, schedule, q, skew, wire),
                                xf, w).reshape(*lead, nout)


def _ring(ctx: ParallelContext, xf, w, use_rows, schedule, q, skew, wire):
    """The fused ring: a reduce-scatter of the chunks' partial products,
    then the all-gather of the reduced chunks."""
    n = ctx.tp
    if use_rows:
        chunk = xf.shape[0] // (n * q)
        partial = lambda f: xf[f * chunk:(f + 1) * chunk] @ w
    else:
        chunk = w.shape[1] // (n * q)
        partial = lambda f: xf @ w[:, f * chunk:(f + 1) * chunk]
    mine = ring_reduce_scatter_compute(ctx, partial, schedule=schedule, chunks_per_rank=q,
                                       sub_axis=0 if use_rows else 1, skew=skew, wire=wire)
    return all_gather_wire(ctx, mine, axis=0 if use_rows else 1, wire=wire)


class _LocalBackward(torch.autograd.Function):
    """``product(xf, w)``, the sum over the tp ranks of x_r @ w_r: the fused
    ring at tp > 1, or kernel mode's fused kernel at tp = 1 (a launch on a
    CUDA tensor, its plain version on the CPU; the kernel has no backward of
    its own).  The backward is local: y is replicated, so every rank holds
    the whole dy."""

    @staticmethod
    def forward(fctx, product, xf, w):
        fctx.save_for_backward(xf, w)
        return product(xf, w)

    @staticmethod
    def backward(fctx, dy):
        xf, w = fctx.saved_tensors
        return None, dy @ w.t(), (xf.t() @ dy).to(w.dtype)
