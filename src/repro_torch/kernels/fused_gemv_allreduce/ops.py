"""Wrappers for the device-initiated fused GEMV/GEMM + AllReduce kernel.

A CUDA tensor launches ``csrc/fused_gemv_allreduce.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (check_launch, dtype_code, load_library, peer_flags,
                                 schedule_table, wire_dtype)
from repro_torch.kernels.fused_gemv_allreduce.ref import (
    fused_matmul_allreduce_ref, fused_matmul_allreduce_ref_ranks)

TILE_N = 32     # output columns per CTA tile (kTileN in csrc/tile_gemv.cuh)
MAX_DEV = 8     # size of the kernel's peer pointer table (kMaxDev)


def fused_matmul_allreduce(x, w, *, wire="f32"):
    """tp = 1: x [B, K] @ w [K, N] -> [B, N] at x's dtype, summed in f32.

    The all-reduce over one rank is the identity, so the kernel runs as its
    tiled GEMV with no peer traffic.  ``wire`` is the PUT payload dtype of
    a larger world; it is checked here so that a bad value fails the same
    way on every device."""
    wire_dtype(x.dtype, wire)
    _check_operands(x, w, 2)
    if x.device.type == "cpu":
        return fused_matmul_allreduce_ref(x, w)
    y = _launch(x[None], w[None], wire, comm_aware=True)[0]
    fused_matmul_allreduce.launches += 1
    return y


fused_matmul_allreduce.launches = 0


def fused_matmul_allreduce_ranks(x_ranks, w_ranks, *, wire="f32",
                                 comm_aware=True):
    """An n-rank world emulated on one device: x_ranks [n, B, K_loc],
    w_ranks [n, K_loc, N] -> [n, B, N], every rank's reduced output.

    On a card, one launch runs all n ranks (``gridDim.y = n``) with the
    full PUT / flag protocol between them, pointer tables aimed at per-rank
    slices of single allocations.  It exists to exercise that protocol on
    one card; the serving path calls :func:`fused_matmul_allreduce`."""
    wire_dtype(x_ranks.dtype, wire)
    _check_operands(x_ranks, w_ranks, 3)
    if x_ranks.shape[0] != w_ranks.shape[0]:
        raise ValueError(f"x has {x_ranks.shape[0]} ranks, w {w_ranks.shape[0]}")
    if x_ranks.device.type == "cpu":
        return fused_matmul_allreduce_ref_ranks(x_ranks, w_ranks, wire,
                                                comm_aware)
    y = _launch(x_ranks, w_ranks, wire, comm_aware)
    fused_matmul_allreduce_ranks.launches += 1
    return y


fused_matmul_allreduce_ranks.launches = 0


def _check_operands(x, w, ndim):
    if x.dim() != ndim or w.dim() != ndim or x.shape[-1] != w.shape[-2]:
        raise ValueError(f"fused_matmul_allreduce: need x [.., B, K] and "
                         f"w [.., K, N] of {ndim} dims, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"fused_matmul_allreduce: x is {x.dtype}, w {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"fused_matmul_allreduce: x on {x.device}, "
                         f"w on {w.device}")


def _launch(xr, wr, wire, comm_aware):
    n, b, k = xr.shape
    big_n = wr.shape[2]
    code = dtype_code(xr.dtype)
    if not (xr.is_contiguous() and wr.is_contiguous()):
        raise ValueError("fused_matmul_allreduce: the kernel takes "
                         "contiguous operands")
    if n > MAX_DEV:
        raise ValueError(f"fused_matmul_allreduce: at most {MAX_DEV} ranks")
    if big_n % (n * TILE_N):
        raise ValueError(f"fused_matmul_allreduce: N={big_n} must split into "
                         f"{n} chunks of whole {TILE_N}-column tiles")
    bn = big_n // n
    tiles = bn // TILE_N
    wdt = wire_dtype(xr.dtype, wire)
    dev = xr.device
    out = torch.empty((n, b, big_n), dtype=xr.dtype, device=dev)
    ptr_array = ctypes.c_uint64 * n
    out_ptrs = ptr_array(*(out[r].data_ptr() for r in range(n)))
    rx_ptrs, flag_ptrs, epoch = ptr_array(), ptr_array(), 0
    if n > 1:
        rx = torch.empty((n, n, b, bn), dtype=wdt, device=dev)
        # one word per (phase, source, sub-tile) on each rank
        flags = peer_flags(dev, n, 2 * n * tiles)
        rx_ptrs = ptr_array(*(rx[r].data_ptr() for r in range(n)))
        flag_ptrs = ptr_array(*(flags.words[r].data_ptr() for r in range(n)))
        epoch = flags.next_epoch()
    sched = schedule_table(dev, n, tiles, bool(comm_aware))
    with torch.cuda.device(dev):
        lib = load_library().lib
        check_launch(lib.repro_fused_gemv_allreduce(
            xr.data_ptr(), wr.data_ptr(), b * k, k * big_n, out_ptrs, rx_ptrs,
            flag_ptrs, sched.data_ptr(), 0, n, n, b, k, big_n, tiles, epoch,
            code, int(wdt != xr.dtype), torch.cuda.current_stream().cuda_stream),
            "fused_matmul_allreduce")
    return out
