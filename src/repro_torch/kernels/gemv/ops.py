"""Public GEMV wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The kernel (``csrc/gemv.cu``) has two paths, chosen by :func:`gemv_path`:
``"stream"`` (``csrc/stream_gemv.cuh``: a TMA-fed weight ring, K split
over a thread-block cluster) wherever TMA can read w, ``"panel"``
(``csrc/tile_gemv.cuh``) for the rest.  A call launches from a plan built
once per call signature (:class:`~repro_torch.kernels.PlanCache`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (PlanCache, check_launch, cluster_capacity, dtype_code,
                                 launch_on, load_library, new_handle, sm_count)
from repro_torch.kernels.gemv.plan import stream_fits, stream_plan
from repro_torch.kernels.gemv.ref import gemv_ref

PATHS = ("stream", "panel")
_PLANS = PlanCache()


def gemv_path(dtype, rows, k, n, aligned=True) -> str:
    """The kernel path of x [rows, k] @ w [k, n]: ``"stream"`` where it
    fits (:func:`~repro_torch.kernels.gemv.plan.stream_fits`), else
    ``"panel"``."""
    return "stream" if stream_fits(dtype, rows, k, n, 1, aligned) else "panel"


def gemv(x, w, *, _path=None):
    """x: [K] or [B, K] small-batch; w: [K, N] -> [N] or [B, N] at x's dtype.

    Accumulates in f32.  A CUDA tensor launches the kernel in
    ``csrc/gemv.cu`` (or raises) on the path :func:`gemv_path` chooses, or
    ``_path`` (one of :data:`PATHS`, for timing both; a path that does not
    fit the call raises); a CPU tensor takes :func:`gemv_ref`."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if not x.is_cuda:
        _check(x, w)
        out = gemv_ref(x, w)
        return out[0] if squeeze else out
    key = (x.shape, w.shape, x.dtype, w.dtype, x.get_device(), w.get_device(), w.data_ptr(),
           _path)
    plan = _PLANS.get(key)
    if plan is None:
        _check(x, w)
        plan = _PLANS.put(key, _GemvPlan(x, w, _path), owner=w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemv: the kernel takes contiguous x and w")
    y = torch.empty(plan.out_shape, dtype=x.dtype, device=plan.device)
    check_launch(plan.launch(x.data_ptr(), y.data_ptr()), "gemv")
    gemv.launches += 1
    gemv.path_launches[plan.path] += 1
    return y[0] if squeeze else y


gemv.launches = 0
gemv.path_launches = dict.fromkeys(PATHS, 0)


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv: need x [B, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"gemv: x is {x.dtype} but w is {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"gemv: x on {x.device} but w on {w.device}")
    dtype_code(x.dtype)


class _GemvPlan:
    """What a call of one signature launches, built once."""

    def __init__(self, x, w, path):
        (b, k), n = x.shape, w.shape[1]
        if path is None:
            path = gemv_path(x.dtype, b, k, n, w.data_ptr() % 16 == 0)
        elif path == "stream" and not stream_fits(x.dtype, b, k, n, 1, w.data_ptr() % 16 == 0):
            raise ValueError(f"gemv: the stream path takes w whose rows are a multiple of 16 "
                             f"bytes at an aligned base; got N={n} {x.dtype}")
        elif path not in PATHS:
            raise ValueError(f"gemv: path must be one of {PATHS}, got {path!r}")
        self.path, self.index, self.device, self.out_shape = path, x.get_device(), x.device, (b, n)
        self.lib = load_library().lib
        code = dtype_code(x.dtype)
        if path == "stream":
            with torch.cuda.device(self.index):
                sp = stream_plan(b, k, n, sms=sm_count(self.index), capacity=cluster_capacity(
                    self.lib.repro_stream_capacity, 0, code, 0, name="gemv"))
                self.handle = new_handle(self.lib.repro_gemv_stream_plan, w.data_ptr(), b, k, n,
                                         sp.rows_per_block, sp.splits, sp.ks, code, name="gemv")
        else:
            self.handle = None
            self.fixed = (w.data_ptr(), b, k, n, code)

    def launch(self, x_ptr, y_ptr) -> int:
        if self.handle is not None:
            return launch_on(self.index, self.lib.repro_stream_launch, self.handle, x_ptr, y_ptr,
                             None, 0)
        w_ptr, b, k, n, code = self.fixed
        return launch_on(self.index, self.lib.repro_gemv, x_ptr, w_ptr, y_ptr, b, k, n, code)

    def free(self):
        if self.handle is not None:
            self.lib.repro_stream_plan_free(self.handle)
            self.handle = None
