"""Wrappers for the device-initiated fused GEMV/GEMM + AllReduce kernel.

A CUDA tensor launches ``csrc/fused_gemv_allreduce.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
one to the other.  The kernel has three paths, chosen by dtype and shape in
:func:`fused_path`: the tensor-core tile path for bf16 from TILE_ROWS rows
on, the streaming GEMV path (``csrc/stream_gemv.cuh``) for the rest where
TMA can read w, and the CUDA-core panel path (``csrc/tile_gemv.cuh``) for
what is left.  A call launches from a plan built once per call signature.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (PlanCache, check_launch, cluster_capacity, dtype_code,
                                 launch_on, load_library, new_handle, peer_flags, schedule_table,
                                 sm_count, wire_dtype)
from repro_torch.kernels.fused_gemv_allreduce.ref import (
    fused_matmul_allreduce_ref, fused_matmul_allreduce_ref_ranks)
from repro_torch.kernels.gemv.plan import stream_fits, stream_plan

TILE_N = 32     # panel path: output columns per CTA strip (kTileN in csrc/tile_gemv.cuh)
MMA_BM = 128    # tile path: output tile rows (kMmaBM in csrc/tile_mma.cuh)
MMA_BN = 128    # tile path: output tile columns (kMmaBN)
# The tile path from this many rows on: the crossover of the tile and
# stream paths on chatglm3-6b's w_down [rows, 13696] @ [13696, 4096], swept
# from 1 to 2048 rows by chip_smoke.py phase 18 on an H100 (PERF.md): the
# stream path wins while the rows fit one row block of 8 (decode at batch 4
# among them), and past it streams the weights once per row block.
TILE_ROWS = 9
MAX_DEV = 8     # size of the kernel's peer pointer table (kMaxDev)
PATHS = ("stream", "panel", "tile")
_PLANS = PlanCache()


def tile_fits(dtype, k, n, n_dev=1, aligned=True) -> bool:
    """The tile path takes bf16 with TMA's 16-byte rows (k % 8 == 0) at
    16-byte-aligned bases, and each rank's chunk n / n_dev of whole
    128-column tiles."""
    return (dtype == torch.bfloat16 and k % 8 == 0 and n % (n_dev * MMA_BN) == 0
            and aligned)


def fused_path(dtype, rows, k, n, n_dev=1, aligned=True) -> str:
    """The kernel path of x [rows, k] @ w [k, n] over n_dev ranks
    (``aligned``: every operand at a 16-byte-aligned base): ``"tile"``
    (tensor cores) from TILE_ROWS rows on where the tile path fits, else
    ``"stream"`` where TMA can read w and x's slice fits in shared memory
    (every such f32 call), else ``"panel"``."""
    if rows >= TILE_ROWS and tile_fits(dtype, k, n, n_dev, aligned):
        return "tile"
    if stream_fits(dtype, rows, k, n, n_dev, aligned):
        return "stream"
    return "panel"


def fused_matmul_allreduce(x, w, *, wire="f32", _path=None):
    """tp = 1: x [B, K] @ w [K, N] -> [B, N] at x's dtype, summed in f32.

    The all-reduce over one rank is the identity, so the kernel runs as its
    tiled GEMV or GEMM with no peer traffic.  ``wire`` is the PUT payload
    dtype of a larger world; it is checked here so that a bad value fails
    the same way on every device.  ``_path`` forces one of :data:`PATHS`
    (for timing them; no model passes it)."""
    if not x.is_cuda:
        wire_dtype(x.dtype, wire)
        _check_operands(x, w, 2)
        return fused_matmul_allreduce_ref(x, w)
    y, path = _run(x, w, 2, wire, True, _path)
    fused_matmul_allreduce.launches += 1
    fused_matmul_allreduce.path_launches[path] += 1
    return y


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
    if not x_ranks.is_cuda:
        wire_dtype(x_ranks.dtype, wire)
        _check_operands(x_ranks, w_ranks, 3)
        return fused_matmul_allreduce_ref_ranks(x_ranks, w_ranks, wire, comm_aware)
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


def _check_ranks(x, w):
    if x.shape[0] != w.shape[0]:
        raise ValueError(f"x has {x.shape[0]} ranks, w {w.shape[0]}")


def _launch(xr, wr, wire, comm_aware, path):
    """The emulated world's call: xr [n, B, K], wr [n, K, N] -> (out, path)."""
    return _run(xr, wr, 3, wire, comm_aware, path)


def _run(x, w, ndim, wire, comm_aware, path):
    """Launch x @ w (ndim 2) or the n-rank world (ndim 3) from its plan."""
    x_ptr = x.data_ptr()
    key = (x.shape, w.shape, x.dtype, w.dtype, x.get_device(), w.get_device(), w.data_ptr(),
           x_ptr % 16 == 0, wire, comm_aware, path, ndim)
    plan = _PLANS.get(key)
    if plan is None:
        wire_dtype(x.dtype, wire)
        _check_operands(x, w, ndim)
        if ndim == 3:
            _check_ranks(x, w)
        plan = _PLANS.put(key, _FusedPlan(x, w, ndim, wire, comm_aware, path), owner=w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_matmul_allreduce: the kernel takes contiguous operands")
    out = torch.empty(plan.out_shape, dtype=x.dtype, device=plan.device)
    check_launch(plan.launch(x_ptr, out.data_ptr()), "fused_matmul_allreduce")
    return out, plan.path


class _FusedPlan:
    """What a call of one signature launches, built once: the path, the
    schedule table, the flag words and rx slots of an n-rank world, the
    pointer tables, and on the stream path a C plan holding w's tensor map
    and the grid."""

    def __init__(self, x, w, ndim, wire, comm_aware, path):
        xr, wr = (x[None], w[None]) if ndim == 2 else (x, w)
        n, b, k = xr.shape
        big_n = wr.shape[2]
        if n > MAX_DEV:
            raise ValueError(f"fused_matmul_allreduce: at most {MAX_DEV} ranks")
        aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
        if path is None:
            path = fused_path(xr.dtype, b, k, big_n, n, aligned)
        elif path == "tile" and not tile_fits(xr.dtype, k, big_n, n, aligned):
            raise ValueError(f"fused_matmul_allreduce: the tile path takes bf16 with K % 8 == 0, "
                             f"aligned operands and N={big_n} in {n} chunks of whole "
                             f"{MMA_BN}-column tiles; got {xr.dtype}, K={k}")
        elif path == "stream" and not stream_fits(xr.dtype, b, k, big_n, n, aligned):
            raise ValueError(f"fused_matmul_allreduce: the stream path takes w whose rows are a "
                             f"multiple of 16 bytes at an aligned base; got N={big_n} "
                             f"{xr.dtype}")
        elif path not in PATHS:
            raise ValueError(f"fused_matmul_allreduce: path must be one of {PATHS}, got {path!r}")
        if path == "panel" and big_n % (n * TILE_N):
            raise ValueError(f"fused_matmul_allreduce: N={big_n} must split into "
                             f"{n} chunks of whole {TILE_N}-column tiles")
        self.path, self.index, self.device = path, x.get_device(), x.device
        self.out_shape = (b, big_n) if ndim == 2 else (n, b, big_n)
        self.n, self.out_rank_bytes = n, b * big_n * xr.element_size()
        bn = big_n // n
        dt, wdt = dtype_code(xr.dtype), wire_dtype(xr.dtype, wire)
        self.lib = load_library().lib
        if path == "stream":
            with torch.cuda.device(self.index):
                sp = stream_plan(b, k, big_n, n, sm_count(self.index), n, cluster_capacity(
                    self.lib.repro_stream_capacity, 1, dt, int(wdt != xr.dtype),
                    name="fused_matmul_allreduce"))
            tiles, row_blocks = sp.tiles, sp.row_blocks
        elif path == "tile":
            tiles, row_blocks = bn // MMA_BN, -(-b // MMA_BM)
        else:
            tiles, row_blocks = bn // TILE_N, 1
        ptr_array = ctypes.c_uint64 * n
        self.out_ptrs, self.rx_ptrs, self.flag_ptrs = ptr_array(), ptr_array(), ptr_array()
        self.flags, self.rx = None, None
        if n > 1:
            # one word per (phase, source, sub-tile, row block) on each rank;
            # the rx slots are reused call after call on the stream's order
            self.flags = peer_flags(x.device, n, 2 * n * tiles * row_blocks)
            self.rx = torch.empty((n, n, b, bn), dtype=wdt, device=x.device)
            for r in range(n):
                self.rx_ptrs[r] = self.rx[r].data_ptr()
                self.flag_ptrs[r] = self.flags.words[r].data_ptr()
        self.sched = schedule_table(x.device, n, tiles, bool(comm_aware))
        self.handle = None
        if path == "stream":
            with torch.cuda.device(self.index):
                self.handle = new_handle(
                    self.lib.repro_fused_stream_plan, w.data_ptr(), self.flag_ptrs,
                    self.sched.data_ptr(), 0, n, n, b, k, big_n, tiles, sp.rows_per_block,
                    sp.splits, sp.ks, dt, int(wdt != xr.dtype), name="fused_matmul_allreduce")
        elif path == "tile":
            self.fixed = (w.data_ptr(), self.out_ptrs, self.rx_ptrs, self.flag_ptrs,
                          self.sched.data_ptr(), 0, n, n, b, k, big_n, tiles)
        else:
            self.fixed = (w.data_ptr(), b * k, k * big_n, self.out_ptrs, self.rx_ptrs,
                          self.flag_ptrs, self.sched.data_ptr(), 0, n, n, b, k, big_n, tiles)
            self.codes = (dt, int(wdt != xr.dtype))

    def launch(self, x_ptr, out_ptr) -> int:
        epoch = self.flags.next_epoch() if self.flags is not None else 0
        if self.handle is not None:
            return launch_on(self.index, self.lib.repro_stream_launch, self.handle, x_ptr,
                             out_ptr, self.rx_ptrs[0] or None, epoch)
        for r in range(self.n):
            self.out_ptrs[r] = out_ptr + r * self.out_rank_bytes
        if self.path == "tile":
            return launch_on(self.index, self.lib.repro_fused_gemm_allreduce_tile, x_ptr,
                             *self.fixed, epoch)
        return launch_on(self.index, self.lib.repro_fused_gemv_allreduce, x_ptr, *self.fixed,
                         epoch, *self.codes)

    def free(self):
        if self.handle is not None:
            self.lib.repro_stream_plan_free(self.handle)
            self.handle = None
