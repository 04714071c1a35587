"""WKV6 wrapper: the CUDA kernel for a CUDA tensor, the plain chunked
version for a CPU tensor.

The wrapper is a ``torch.autograd.Function`` whose backward raises: the
kernel has no backward yet (training rwkv6 needs one), and a ctypes launch
is invisible to autograd, so without it a gradient would be lost silently.
It raises on the CPU too, so the op behaves the same on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, load_library
from repro_torch.kernels.rwkv6.ref import wkv6_chunked

KERNEL_N = (16, 32, 64)   # head sizes the kernel takes
MAX_CHUNK = 64            # kWkvMaxChunk in csrc/wkv6.cu
_TRAIN_ITEM = "ROADMAP Queue 1 item 7 (rwkv6 training: a WKV6 backward)"


def wkv6(r, k, v, w, u, *, chunk=32):
    """r, k, v, w: [B, T, H, N] (w = decay in (0, 1)); u: [H, N] ->
    (o [B, T, H, N] f32, state [B, H, N, N] f32), from a zero state.

    The JAX ``ops.wkv6`` returns o only; the port also returns the carried
    state after the last chunk, which the prefill needs.  As there, the
    operands are taken in f32, ``lw = log(clip(w, 1e-8, 1))`` and the chunk
    is ``min(chunk, T)``, which must divide T.  A CUDA tensor launches
    ``csrc/wkv6.cu`` (N of 16, 32 or 64, chunk at most 64; the chunks of a
    head run in parallel over a thread-block cluster, the pairwise decay
    factored through 8-step sub-chunks as
    :func:`~repro_torch.kernels.rwkv6.ref.wkv6_factored` mirrors)
    or raises; a CPU tensor takes the plain chunked version."""
    if r.dim() != 4 or any(a.shape != r.shape for a in (k, v, w)):
        raise ValueError(f"wkv6: need r, k, v, w of one shape [B, T, H, N], got "
                         f"{[tuple(a.shape) for a in (r, k, v, w)]}")
    b, t, h, n = r.shape
    if tuple(u.shape) != (h, n):
        raise ValueError(f"wkv6: u must be [H, N] = [{h}, {n}], got {tuple(u.shape)}")
    if any(a.device != r.device for a in (k, v, w, u)):
        raise ValueError("wkv6: operands on different devices")
    c = min(chunk, t)
    if c < 1 or t % c:
        raise ValueError(f"wkv6: T={t} must be a multiple of the chunk {c}")
    return _WKV6.apply(r.float(), k.float(), v.float(), w.float(), u.float(), c)


wkv6.launches = 0


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, c):
        if r.device.type == "cpu":
            b, _, h, n = r.shape
            state0 = torch.zeros((b, h, n, n), dtype=torch.float32)
            return wkv6_chunked(r, k, v, w, u, state0, c)
        out = _launch(r, k, v, w, u, c)
        wkv6.launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(f"wkv6 has no backward kernel: {_TRAIN_ITEM}")


def _launch(r, k, v, w, u, c):
    b, t, h, n = r.shape
    if n not in KERNEL_N:
        raise ValueError(f"wkv6: the kernel takes head sizes {KERNEL_N}, got {n}")
    if c > MAX_CHUNK:
        raise ValueError(f"wkv6: the kernel takes chunks of at most {MAX_CHUNK}, got {c}")
    # the kernel reads 16-byte vectors and takes log(clip(w, 1e-8, 1)) itself
    r, k, v, w, u = (_aligned(a.contiguous()) for a in (r, k, v, w, u))
    o = torch.empty_like(r)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        lib = load_library().lib
        check_launch(lib.repro_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            o.data_ptr(), state.data_ptr(), b, t, h, n, c,
            torch.cuda.current_stream().cuda_stream), "wkv6")
    return o, state


def _aligned(a):
    """``a``, copied if it does not start on a 16-byte boundary."""
    return a if a.data_ptr() % 16 == 0 else a.clone()
