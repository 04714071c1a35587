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

The chunked dim is chosen as in the reference: rows (the flattened leading
dims) when they split over the ring, else the output columns.

Granularity (paper Fig. 13): ``chunks_per_rank`` splits each ring step's
payload into sub-chunks, each shipped the moment its partial product is
done; it is clamped to the largest factor dividing the chunked dim.  The
``"auto"`` granularity and wire need the autotuner (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

from repro_torch.core.collectives import (WIRE_DTYPES, _no_grad_over_ranks, all_gather_wire,
                                          all_reduce, feasible_chunks_per_rank,
                                          ring_reduce_scatter_compute)
from repro_torch.kernels import clamp_kernel_wire
from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
from repro_torch.parallel.sharding import ParallelContext

_KERNEL_PEERS_ITEM = ("ROADMAP Queue 1 item 1 (left: the real-peer half, kernel mode at tp > 1 "
                      "with symmetric-memory pointer tables; use fused or bulk mode)")
_AUTOTUNE_ITEM = "ROADMAP Queue 1 item 3 (autotune/degrade)"
MODES = ("bulk", "fused", "kernel")


def resolve_overlap(granularity, wire, dim: int, ring: int) -> tuple[int, str]:
    """The fixed branch of the reference's ``resolve_overlap``: an integer
    granularity clamped to ``feasible_chunks_per_rank(dim, ring, q)`` and a
    wire of ``WIRE_DTYPES``; ``"auto"`` (either) raises."""
    if granularity == "auto" or wire == "auto":
        raise NotImplementedError(
            f"granularity={granularity!r}, wire={wire!r}: the 'auto' choices are "
            f"{_AUTOTUNE_ITEM}")
    if wire not in WIRE_DTYPES:
        raise ValueError(f"wire must be one of {WIRE_DTYPES + ('auto',)}, got {wire!r}")
    if isinstance(granularity, bool) or int(granularity) < 1:
        raise ValueError(f"granularity must be >= 1 or 'auto', got {granularity!r}")
    return feasible_chunks_per_rank(dim, ring, int(granularity)), wire


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
    or raises."""
    mode = mode or ctx.fusion.resolve("matmul_rs")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n = ctx.tp
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    nout = w.shape[1]
    if mode == "bulk":
        return all_reduce(ctx, xf @ w).reshape(*lead, nout)
    granularity = ctx.fusion.granularity if chunks_per_rank is None else chunks_per_rank
    wire = wire or ctx.fusion.wire
    if mode == "kernel":
        if n > 1:
            raise NotImplementedError(f"matmul_allreduce mode='kernel' at tp={n}: "
                                      f"{_KERNEL_PEERS_ITEM}")
        resolve_overlap(granularity, wire, 1, 1)
        y = fused_matmul_allreduce(
            xf.contiguous(), w, wire=clamp_kernel_wire(wire, "matmul_allreduce"))
        return y.reshape(*lead, nout)
    _no_grad_over_ranks(ctx, "matmul_allreduce", x, w)
    rows = xf.shape[0]
    use_rows = rows % n == 0 and rows >= n
    q, wire = resolve_overlap(granularity, wire, rows if use_rows else nout, n)
    schedule = schedule or ctx.fusion.schedule
    skew = ctx.fusion.skew if skew is None else int(skew)
    if use_rows:
        chunk = rows // (n * q)
        partial = lambda f: xf[f * chunk:(f + 1) * chunk] @ w
    else:
        chunk = nout // (n * q)
        partial = lambda f: xf @ w[:, f * chunk:(f + 1) * chunk]
    mine = ring_reduce_scatter_compute(ctx, partial, schedule=schedule, chunks_per_rank=q,
                                       sub_axis=0 if use_rows else 1, skew=skew, wire=wire)
    y = all_gather_wire(ctx, mine, axis=0 if use_rows else 1, wire=wire)
    return y.reshape(*lead, nout)
