"""Wrappers for the device-initiated dispatch All-to-All kernel.

A CUDA tensor launches ``csrc/fused_dispatch_a2a.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.collectives import feasible_chunks_per_rank
from repro_torch.kernels import (check_launch, clamp_kernel_wire, dtype_code, load_library,
                                 peer_flags, schedule_table, wire_dtype)
from repro_torch.kernels.fused_dispatch_a2a.ref import (fused_dispatch_a2a_ref,
                                                        fused_dispatch_a2a_ref_ranks)

MAX_DEV = 8     # size of the kernel's peer pointer tables (kMaxDev)
REAL_PEERS_ITEM = "ROADMAP Queue 1 item 1 (the multi-card tp world)"


def fused_dispatch_a2a(xt, *, comm_aware=True, chunks_per_rank=1, skew=0, wire="f32"):
    """One EP rank: xt [n, B, E_loc, C, D] stacked by destination rank ->
    the same shape stacked by source rank.

    The port's world is one card (n = 1), where the exchange keeps the
    rank's own block: the kernel copies it.  ``chunks_per_rank`` (a
    positive int) is clamped to the largest divisor of C no larger than
    it; ``wire="fp8"`` is clamped to bf16 with a one-time warning.  A CUDA
    tensor launches the kernel or raises."""
    wire, q = _check(xt, 5, chunks_per_rank, wire)
    if xt.shape[0] != 1:
        raise NotImplementedError(f"fused_dispatch_a2a over {xt.shape[0]} ranks needs "
                                  f"real peers: {REAL_PEERS_ITEM}")
    if xt.device.type == "cpu":
        return fused_dispatch_a2a_ref(xt)
    out = _launch(xt[None], q, wire, comm_aware, skew)[0]
    fused_dispatch_a2a.launches += 1
    return out


fused_dispatch_a2a.launches = 0


def fused_dispatch_a2a_ranks(x_ranks, *, comm_aware=True, chunks_per_rank=1, skew=0,
                             wire="f32"):
    """An n-rank world emulated on one device: x_ranks [n, n, B, E_loc, C, D]
    (rank, destination, ...) -> (rank, source, ...).

    On a card, one launch runs all n ranks (``gridDim.y = n``) with the full
    PUT / flag protocol between them, pointer tables aimed at per-rank
    slices of single allocations.  It exists to exercise that protocol on
    one card; the serving path calls :func:`fused_dispatch_a2a`."""
    wire, q = _check(x_ranks, 6, chunks_per_rank, wire)
    if x_ranks.shape[0] != x_ranks.shape[1]:
        raise ValueError(f"fused_dispatch_a2a: {x_ranks.shape[0]} ranks hold blocks for "
                         f"{x_ranks.shape[1]} destinations")
    if x_ranks.device.type == "cpu":
        return fused_dispatch_a2a_ref_ranks(x_ranks, wire)
    out = _launch(x_ranks, q, wire, comm_aware, skew)
    fused_dispatch_a2a_ranks.launches += 1
    return out


fused_dispatch_a2a_ranks.launches = 0


def _check(x, ndim, chunks_per_rank, wire):
    """(wire after the fp8 clamp, the feasible chunks_per_rank)."""
    wire = clamp_kernel_wire(wire, "fused_dispatch_a2a")
    wire_dtype(x.dtype, wire)
    dtype_code(x.dtype)
    if x.dim() != ndim:
        raise ValueError(f"fused_dispatch_a2a: need {ndim} dims [.., n, B, E_loc, C, D], "
                         f"got {tuple(x.shape)}")
    if isinstance(chunks_per_rank, bool) or not isinstance(chunks_per_rank, int) \
            or chunks_per_rank < 1:
        raise ValueError(f"fused_dispatch_a2a: chunks_per_rank must be a positive int, "
                         f"got {chunks_per_rank!r}")
    return wire, feasible_chunks_per_rank(x.shape[-2], 1, chunks_per_rank)


def _launch(xr, q, wire, comm_aware, skew):
    n, _, b, e, c, d = xr.shape
    if not xr.is_contiguous():
        raise ValueError("fused_dispatch_a2a: the kernel takes a contiguous x")
    if n > MAX_DEV:
        raise ValueError(f"fused_dispatch_a2a: at most {MAX_DEV} ranks")
    wdt = wire_dtype(xr.dtype, wire)
    dev = xr.device
    out = torch.empty_like(xr)
    # a narrowed wire lands in rx staging, widened into out at the end
    recv = out if n == 1 or wdt == xr.dtype else torch.empty(xr.shape, dtype=wdt, device=dev)
    ptr_array = ctypes.c_uint64 * n
    out_ptrs = ptr_array(*(out[r].data_ptr() for r in range(n)))
    recv_ptrs = ptr_array(*(recv[r].data_ptr() for r in range(n)))
    flag_ptrs, epoch = ptr_array(), 0
    if n > 1:
        flags = peer_flags(dev, n, n * b * e * c)   # one word per (source, row) on each rank
        flag_ptrs = ptr_array(*(flags.words[r].data_ptr() for r in range(n)))
        epoch = flags.next_epoch()
    sched = schedule_table(dev, n, q, bool(comm_aware), int(skew))
    with torch.cuda.device(dev):
        lib = load_library().lib
        check_launch(lib.repro_fused_dispatch_a2a(
            xr.data_ptr(), xr[0].numel(), out_ptrs, recv_ptrs, flag_ptrs, sched.data_ptr(),
            0, n, n, b, e, c, d, q, epoch, dtype_code(xr.dtype), int(wdt != xr.dtype),
            torch.cuda.current_stream().cuda_stream), "fused_dispatch_a2a")
    return out
