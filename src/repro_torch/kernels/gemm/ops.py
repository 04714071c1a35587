"""Public GEMM wrapper: the CUDA kernels for a CUDA tensor, the plain
version for a CPU tensor.  No model path calls it, as in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library
from repro_torch.kernels.gemm.ref import gemm_ref

PATHS = ("cuda_core", "tile")


def gemm_path(dtype, k, n, aligned=True) -> str:
    """The kernel of x [M, k] @ w [k, n]: ``"tile"`` (tensor cores, the
    tile loop of ``csrc/tile_mma.cuh``) for bf16 with TMA's 16-byte rows
    (k % 8 == 0, n % 8 == 0) at 16-byte-aligned bases, else
    ``"cuda_core"`` (every f32 call: a tensor-core f32 product would be
    TF32)."""
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and aligned:
        return "tile"
    return "cuda_core"


def gemm(x, w, *, bm=128, bn=128, bk=128, _path=None):
    """x [M, K] @ w [K, N] -> [M, N] at x's dtype, summed in f32, at any M,
    N and K.  ``bm``, ``bn`` and ``bk`` are the TPU kernel's block sizes,
    accepted for the reference's signature; the CUDA kernels in
    ``csrc/gemm.cu`` pick their own tiles.  A CUDA tensor launches the one
    :func:`gemm_path` chooses (or raises); a CPU tensor takes
    :func:`gemm_ref`.  ``_path`` forces one of :data:`PATHS` (for timing
    both; no caller passes it)."""
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
    fits = gemm_path(x.dtype, k, n, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    path = _path or fits
    if path not in PATHS or (path == "tile" and fits != "tile"):
        raise ValueError(f"gemm: path {path!r} does not take {x.dtype} [{m},{k}]@[{k},{n}]")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        lib = load_library().lib
        if path == "tile":
            err = lib.repro_gemm_tile(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, stream)
        else:
            err = lib.repro_gemm(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, code, stream)
        check_launch(err, "gemm")
    gemm.launches += 1
    gemm.path_launches[path] += 1
    return y


gemm.launches = 0
gemm.path_launches = dict.fromkeys(PATHS, 0)
