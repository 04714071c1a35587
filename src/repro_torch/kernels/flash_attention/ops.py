"""Flash-attention wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The wrapper is a ``torch.autograd.Function`` whose backward raises: the
kernel has no backward yet (dense training needs one), and a ctypes launch
is invisible to autograd, so without it a gradient would be lost silently.
It raises on the CPU too, so the op behaves the same on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL_D = (64, 128)   # head sizes the kernel takes
_TRAIN_ITEM = "ROADMAP Queue 1 item 4 (dense training: a flash backward)"


def flash_attention(q, k, v, *, scale=None, causal=True, window=None, softcap=None):
    """q: [B, S, Hq, d]; k, v: [B, S, Hkv, d] with Hq a multiple of Hkv ->
    [B, S, Hq, d] at q's dtype.

    Query head h attends to kv head ``h // (Hq // Hkv)``; with equal head
    counts this is the JAX ``flash_attention``.  Any S: the kernel masks the
    tail block by bounds (the reference op needs S to have a block divisor).
    A CUDA tensor launches ``csrc/flash_attention.cu`` (d of 64 or 128, f32
    or bf16) or raises; a CPU tensor takes :func:`flash_attention_plain`.
    The TPU kernel has no sliding window and no softcap, so asking for
    either raises."""
    if window is not None or softcap is not None:
        raise NotImplementedError(
            f"flash_attention: window={window}, softcap={softcap}: the kernel, like the TPU "
            f"kernel it ports, has neither")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: need q [B, S, Hq, d] and k, v [B, S, Hkv, d], got "
                         f"{[tuple(a.shape) for a in (q, k, v)]}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"(need equal B, S and d, and Hq a multiple of Hkv)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    scale = float(scale) if scale is not None else d ** -0.5
    return _Flash.apply(q, k, v, scale, bool(causal))


flash_attention.launches = 0


def flash_attention_plain(q, k, v, *, scale=None, causal=True):
    """The op's plain version on any device: each kv head repeated over its
    query heads, heads folded into the batch, :func:`flash_attention_ref`."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    fold = lambda t: t.repeat_interleave(g, dim=2).transpose(1, 2).reshape(b * hq, s, d)
    out = flash_attention_ref(q.transpose(1, 2).reshape(b * hq, s, d), fold(k), fold(v),
                              scale=scale, causal=causal)
    return out.reshape(b, hq, s, d).transpose(1, 2)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale=scale, causal=causal)
        out = _launch(q, k, v, scale, causal)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(f"flash_attention has no backward kernel: {_TRAIN_ITEM}")


def _launch(q, k, v, scale, causal):
    b, s, hq, d = q.shape
    if d not in KERNEL_D:
        raise ValueError(f"flash_attention: the kernel takes head sizes {KERNEL_D}, got {d}")
    code = dtype_code(q.dtype)
    q, k, v = (_aligned(a) for a in (q, k, v))
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        lib = load_library().lib
        check_launch(lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, hq, k.shape[2], d,
            scale, int(causal), code, torch.cuda.current_stream().cuda_stream),
            "flash_attention")
    return o


def _aligned(a):
    """Contiguous, starting on 16 bytes: the kernel moves rows 4 elements
    at a time (a view into a larger tensor may start anywhere)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()
