"""Wrappers for the device-initiated fused GEMV/GEMM + AllReduce kernel.

A CUDA tensor launches ``csrc/fused_gemv_allreduce.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
one to the other.  The kernel has two paths, chosen by dtype and shape in
:func:`fused_path`: the tensor-core tile path for bf16 at many rows, the
CUDA-core GEMV path for everything else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (check_launch, dtype_code, load_library, peer_flags,
                                 schedule_table, wire_dtype)
from repro_torch.kernels.fused_gemv_allreduce.ref import (
    fused_matmul_allreduce_ref, fused_matmul_allreduce_ref_ranks)

TILE_N = 32     # GEMV path: output columns per CTA strip (kTileN in csrc/tile_gemv.cuh)
MMA_BM = 128    # tile path: output tile rows (kMmaBM in csrc/tile_mma.cuh)
MMA_BN = 128    # tile path: output tile columns (kMmaBN)
# The tile path from this many rows on: the crossover of the two paths on
# chatglm3-6b's w_down [rows, 13696] @ [13696, 4096], swept from 1 to 2048
# rows by chip_smoke.py phase 18.  On an H100 the tile path was the faster
# one from 1 row on (PERF.md), so decode takes it too.
TILE_ROWS = 1
MAX_DEV = 8     # size of the kernel's peer pointer table (kMaxDev)
PATHS = ("gemv", "tile")


def tile_fits(dtype, k, n, n_dev=1, aligned=True) -> bool:
    """The tile path takes bf16 with TMA's 16-byte rows (k % 8 == 0) at
    16-byte-aligned bases, and each rank's chunk n / n_dev of whole
    128-column tiles."""
    return (dtype == torch.bfloat16 and k % 8 == 0 and n % (n_dev * MMA_BN) == 0
            and aligned)


def fused_path(dtype, rows, k, n, n_dev=1, aligned=True) -> str:
    """The kernel path of x [rows, k] @ w [k, n] over n_dev ranks:
    ``"tile"`` (tensor cores) from TILE_ROWS rows on where the tile path
    fits, else ``"gemv"`` (CUDA cores; every f32 call)."""
    if rows >= TILE_ROWS and tile_fits(dtype, k, n, n_dev, aligned):
        return "tile"
    return "gemv"


def fused_matmul_allreduce(x, w, *, wire="f32", _path=None):
    """tp = 1: x [B, K] @ w [K, N] -> [B, N] at x's dtype, summed in f32.

    The all-reduce over one rank is the identity, so the kernel runs as its
    tiled GEMV or GEMM with no peer traffic.  ``wire`` is the PUT payload
    dtype of a larger world; it is checked here so that a bad value fails
    the same way on every device.  ``_path`` forces one of :data:`PATHS`
    (for timing both; no model passes it)."""
    wire_dtype(x.dtype, wire)
    _check_operands(x, w, 2)
    if x.device.type == "cpu":
        return fused_matmul_allreduce_ref(x, w)
    y, path = _launch(x[None], w[None], wire, True, _path)
    fused_matmul_allreduce.launches += 1
    fused_matmul_allreduce.path_launches[path] += 1
    return y[0]


fused_matmul_allreduce.launches = 0
fused_matmul_allreduce.path_launches = dict.fromkeys(PATHS, 0)


def fused_matmul_allreduce_ranks(x_ranks, w_ranks, *, wire="f32",
                                 comm_aware=True, _path=None):
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
    y, path = _launch(x_ranks, w_ranks, wire, comm_aware, _path)
    fused_matmul_allreduce_ranks.launches += 1
    fused_matmul_allreduce_ranks.path_launches[path] += 1
    return y


fused_matmul_allreduce_ranks.launches = 0
fused_matmul_allreduce_ranks.path_launches = dict.fromkeys(PATHS, 0)


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


def _launch(xr, wr, wire, comm_aware, path):
    n, b, k = xr.shape
    big_n = wr.shape[2]
    dt = dtype_code(xr.dtype)
    if not (xr.is_contiguous() and wr.is_contiguous()):
        raise ValueError("fused_matmul_allreduce: the kernel takes "
                         "contiguous operands")
    if n > MAX_DEV:
        raise ValueError(f"fused_matmul_allreduce: at most {MAX_DEV} ranks")
    aligned = xr.data_ptr() % 16 == 0 and wr.data_ptr() % 16 == 0
    if path is None:
        path = fused_path(xr.dtype, b, k, big_n, n, aligned)
    elif path == "tile" and not tile_fits(xr.dtype, k, big_n, n, aligned):
        raise ValueError(f"fused_matmul_allreduce: the tile path takes bf16 with K % 8 == 0, "
                         f"aligned operands and N={big_n} in {n} chunks of whole "
                         f"{MMA_BN}-column tiles; got {xr.dtype}, K={k}")
    elif path not in PATHS:
        raise ValueError(f"fused_matmul_allreduce: path must be one of {PATHS}, got {path!r}")
    tile_n = MMA_BN if path == "tile" else TILE_N
    if big_n % (n * tile_n):
        raise ValueError(f"fused_matmul_allreduce: N={big_n} must split into "
                         f"{n} chunks of whole {tile_n}-column tiles")
    bn = big_n // n
    tiles = bn // tile_n
    wdt = wire_dtype(xr.dtype, wire)
    dev = xr.device
    out = torch.empty((n, b, big_n), dtype=xr.dtype, device=dev)
    ptr_array = ctypes.c_uint64 * n
    out_ptrs = ptr_array(*(out[r].data_ptr() for r in range(n)))
    rx_ptrs, flag_ptrs, epoch = ptr_array(), ptr_array(), 0
    if n > 1:
        rx = torch.empty((n, n, b, bn), dtype=wdt, device=dev)
        # one word per (phase, source, sub-tile), and on the tile path per
        # row block too, on each rank
        row_blocks = -(-b // MMA_BM) if path == "tile" else 1
        flags = peer_flags(dev, n, 2 * n * tiles * row_blocks)
        rx_ptrs = ptr_array(*(rx[r].data_ptr() for r in range(n)))
        flag_ptrs = ptr_array(*(flags.words[r].data_ptr() for r in range(n)))
        epoch = flags.next_epoch()
    sched = schedule_table(dev, n, tiles, bool(comm_aware))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        lib = load_library().lib
        if path == "tile":
            err = lib.repro_fused_gemm_allreduce_tile(
                xr.data_ptr(), wr.data_ptr(), out_ptrs, rx_ptrs, flag_ptrs, sched.data_ptr(),
                0, n, n, b, k, big_n, tiles, epoch, stream)
        else:
            err = lib.repro_fused_gemv_allreduce(
                xr.data_ptr(), wr.data_ptr(), b * k, k * big_n, out_ptrs, rx_ptrs,
                flag_ptrs, sched.data_ptr(), 0, n, n, b, k, big_n, tiles, epoch,
                dt, int(wdt != xr.dtype), stream)
        check_launch(err, "fused_matmul_allreduce")
    return out, path
