"""Public GEMM wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.  No model path calls it, as in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library
from repro_torch.kernels.gemm.ref import gemm_ref


def gemm(x, w, *, bm=128, bn=128, bk=128):
    """x [M, K] @ w [K, N] -> [M, N] at x's dtype, summed in f32, at any M,
    N and K.  ``bm``, ``bn`` and ``bk`` are the TPU kernel's block sizes,
    accepted for the reference's signature; the CUDA kernel in
    ``csrc/gemm.cu`` picks its own tiles.  A CUDA tensor launches it (or
    raises); a CPU tensor takes :func:`gemm_ref`."""
    del bm, bn, bk
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: need x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise TypeError(f"gemm: x is {x.dtype} but w is {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"gemm: x on {x.device} but w on {w.device}")
    code = dtype_code(x.dtype)
    if x.device.type == "cpu":
        return gemm_ref(x, w)
    x, w = x.contiguous(), w.contiguous()
    (m, k), n = x.shape, w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        lib = load_library().lib
        check_launch(lib.repro_gemm(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, code,
                                    torch.cuda.current_stream().cuda_stream), "gemm")
    gemm.launches += 1
    return y


gemm.launches = 0
