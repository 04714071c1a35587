"""Public GEMV wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library
from repro_torch.kernels.gemv.ref import gemv_ref


def gemv(x, w):
    """x: [K] or [B, K] small-batch; w: [K, N] -> [N] or [B, N] at x's dtype.

    Accumulates in f32.  A CUDA tensor launches the kernel in
    ``csrc/gemv.cu`` (or raises); a CPU tensor takes :func:`gemv_ref`."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv: need x [B, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"gemv: x is {x.dtype} but w is {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"gemv: x on {x.device} but w on {w.device}")
    if x.device.type == "cpu":
        out = gemv_ref(x, w)
    else:
        out = _launch(x, w)
        gemv.launches += 1
    return out[0] if squeeze else out


gemv.launches = 0


def _launch(x, w):
    code = dtype_code(x.dtype)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemv: the kernel takes contiguous x and w")
    (b, k), n = x.shape, w.shape[1]
    y = torch.empty((b, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        lib = load_library().lib
        check_launch(lib.repro_gemv(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, k, n, code,
            torch.cuda.current_stream().cuda_stream), "gemv")
    return y
