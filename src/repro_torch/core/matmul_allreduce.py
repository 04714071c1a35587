"""Fused GEMV/GEMM + AllReduce (paper Sec. III-B, Fig. 7).

Megatron row-parallel layer: ``x`` carries the contraction dim sharded
over TP, ``w`` is row-sharded; every rank produces a *partial* full-size
output that must be summed across TP ranks.

  bulk   : y = all_reduce(x_local @ w_local)     (NCCL-baseline analogue)
  kernel : the hand-written device-initiated CUDA kernel
           (``repro_torch.kernels.fused_gemv_allreduce``)

This slice runs one card (tp = 1), where the all-reduce is the identity.
``fused`` mode (the chunked ring) needs ``core/collectives.py`` and the
``"auto"`` granularity/wire choices need ``core/autotune.py``: both come
with the multi-card tp world and the autotuner (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.kernels import clamp_kernel_wire
from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
from repro_torch.parallel.sharding import ParallelContext

_FUSED_ITEM = ("ROADMAP Queue 1 item 1 (the multi-card tp world: "
               "core/collectives.py and fused mode)")
_AUTOTUNE_ITEM = "ROADMAP Queue 1 item 3 (autotune/degrade)"


def matmul_allreduce(
    ctx: ParallelContext,
    x,
    w,
    *,
    mode: str | None = None,
    chunks_per_rank: int | str | None = None,
    wire: str | None = None,
):
    """y = AllReduce_tp(x @ w) for row-parallel ``w``.

    x: [..., K]; w: [K, N].  Returns [..., N] at x's dtype.

    ``mode`` defaults to ``ctx.fusion.resolve("matmul_rs")``.  In kernel
    mode the kernel's granularity is its own tile pipeline (one sub-chunk
    per rank, comm-aware order) and ``wire`` (``None`` = ``ctx.fusion.wire``)
    is its PUT payload dtype; fp8 is clamped to bf16.  A CUDA tensor
    launches the kernel or raises."""
    mode = mode or ctx.fusion.resolve("matmul_rs")
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if mode == "bulk":
        # one-card all-reduce: the identity
        return (xf @ w).reshape(*lead, w.shape[1])
    if mode != "kernel":
        raise NotImplementedError(f"matmul_allreduce mode={mode!r}: {_FUSED_ITEM}")
    granularity = (ctx.fusion.granularity if chunks_per_rank is None
                   else chunks_per_rank)
    wire = wire or ctx.fusion.wire
    if granularity == "auto" or wire == "auto":
        raise NotImplementedError(
            f"matmul_allreduce granularity={granularity!r}, wire={wire!r}: "
            f"the 'auto' choices are {_AUTOTUNE_ITEM}")
    y = fused_matmul_allreduce(
        xf.contiguous(), w, wire=clamp_kernel_wire(wire, "matmul_allreduce"))
    return y.reshape(*lead, w.shape[1])
