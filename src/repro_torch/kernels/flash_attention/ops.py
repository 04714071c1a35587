"""Flash-attention wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The wrapper is a ``torch.autograd.Function``.  When a gradient is wanted,
the forward also returns each row's softmax statistics (m, l) and saves q,
k, v, o, m and l, the residuals of the reference's ring attention
(``src/repro/models/attention.py`` ``fwd_rule``); the backward is the
reference's analytic gradient, ``_span_flash_bwd`` recomputing the scores
block by block (``models/attention.flash_backward``).  The reference has no
backward kernel, so that backward is plain PyTorch on both devices.  Without
a gradient (prefill, serving) no statistics are written, unless the caller
asks for them with ``stats=True``: a hop of the KV ring (``models/attention``)
takes (o, m, l) without autograd and merges the hops' partials itself.  Such
a hop attends a span of keys of its own length at a position offset
(``delta``) from the queries.

A sliding window and a softcap (gemma2's local layers, and every one of its
layers) are computed inside the kernel, on both paths, with the semantics of
the model's blockwise attention (the reference's ``_span_flash``), which the
TPU kernel lacks; the plain version and the backward take them too.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import check_launch, dtype_code, load_library
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL_D = (64, 128, 224)   # head sizes the CUDA-core kernel takes (224: zamba2-7b)
TILE_D = 128           # the head size the tensor-core kernel takes
PATHS = ("cuda_core", "tile")


def flash_path(dtype, d) -> str:
    """The kernel of a flash call: ``"tile"`` (tensor cores: TMA and
    ``wgmma``, ``flash_tile_kernel``) for bf16 at d = 128, else
    ``"cuda_core"`` (every f32 call: a tensor-core f32 product would be
    TF32; and d = 64 and 224).  The launch passes every operand through
    :func:`_aligned`, so TMA's bases are 16-byte aligned, and its rows,
    ``Hq * d`` and ``Hkv * d`` elements, are 16-byte multiples at d = 128."""
    if dtype == torch.bfloat16 and d == TILE_D:
        return "tile"
    return "cuda_core"


def flash_attention(q, k, v, *, scale=None, causal=True, window=None, softcap=None, delta=0,
                    stats=False, _path=None):
    """q: [B, Sq, Hq, d]; k, v: [B, Sk, Hkv, d] with Hq a multiple of Hkv ->
    [B, Sq, Hq, d] at q's dtype.

    Query head h attends to kv head ``h // (Hq // Hkv)``; with equal head
    counts this is the JAX ``flash_attention``.  Any S: the kernel masks the
    tail block by bounds (the reference op needs S to have a block divisor).
    A CUDA tensor launches the kernel of ``csrc/flash_attention.cu`` that
    :func:`flash_path` chooses (d of 64, 128 or 224, f32 or bf16) or raises; a
    CPU tensor takes :func:`flash_attention_plain`.  ``_path`` forces one of
    :data:`PATHS` (for timing both; no caller passes it) and raises where
    that kernel does not take the call, on any device.  ``window`` (keys
    with ``qpos - kpos < window``, a positive int) and ``softcap`` (scores
    ``softcap * tanh(s / softcap)``, a positive float) are those of the
    reference's ``_span_flash``; either may be None.  ``delta`` is the
    position of query row 0 minus that of key 0: row i and key j are at
    relative distance ``i + delta - j``, so causal masks ``j > i + delta``
    (a KV-ring hop; 0 with Sk = Sq is one span of both).  A row that sees no
    key gives zeros.  ``stats=True`` returns ``(o, m, l)``, m and l [B, Hq,
    Sq] f32 in natural units (m = -1e30 and l = 0 on a row that sees no
    key), with no autograd.  The gradient (of the default call) is the
    analytic backward of the module docstring; it cannot be differentiated
    again.  A span of its own (``delta``, ``Sk != Sq``) or ``stats`` has no
    gradient here and raises under autograd: a KV-ring hop is
    differentiated through ``context_attention``'s ring
    (``models/attention._RingAttention``), which calls the op with grad mode
    off."""
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"flash_attention: window {window} is not a positive int")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} is not positive")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: need q [B, Sq, Hq, d] and k, v [B, Sk, Hkv, d], "
                         f"got {[tuple(a.shape) for a in (q, k, v)]}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or k.shape[1] < 1 or hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"(need equal B and d, and Hq a multiple of Hkv)")
    if int(delta) != delta:
        raise ValueError(f"flash_attention: delta {delta} is not an int")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    if _path is not None and (_path not in PATHS or d not in KERNEL_D or (
            _path == "tile" and flash_path(q.dtype, d) != "tile")):
        raise ValueError(f"flash_attention: path {_path!r} does not take {q.dtype} at d = {d}")
    scale = float(scale) if scale is not None else d ** -0.5
    window = None if window is None else int(window)
    softcap = None if softcap is None else float(softcap)
    delta = int(delta)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if grad and (stats or delta or k.shape[1] != s):
        raise NotImplementedError(
            "flash_attention: a span of its own (stats=True, delta or Sk != Sq) has no gradient "
            "of its own; differentiate a KV-ring hop through context_attention's ring, which "
            "calls the op without autograd")
    if stats or delta or k.shape[1] != s:     # no gradient is wanted here
        return _forward(q, k, v, scale, bool(causal), window, softcap, delta, _path, stats)
    return _Flash.apply(q, k, v, scale, bool(causal), window, softcap, _path, grad)


flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(PATHS, 0)


def flash_attention_plain(q, k, v, *, scale=None, causal=True, window=None, softcap=None,
                          delta=0, stats=False):
    """The op's plain version on any device: each kv head repeated over its
    query heads, heads folded into the batch, :func:`flash_attention_ref`.
    With ``stats`` also (m, l), each [B, Hq, Sq] f32: those of the capped,
    masked scores."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    fold = lambda t: t.repeat_interleave(g, dim=2).transpose(1, 2).reshape(b * hq, -1, d)
    out = flash_attention_ref(q.transpose(1, 2).reshape(b * hq, s, d), fold(k), fold(v),
                              scale=scale, causal=causal, window=window, softcap=softcap,
                              delta=delta, stats=stats)
    unfold = lambda o: o.reshape(b, hq, s, d).transpose(1, 2)
    if stats:
        return unfold(out[0]), out[1].reshape(b, hq, s), out[2].reshape(b, hq, s)
    return unfold(out)


def _forward(q, k, v, scale, causal, window, softcap, delta, path, stats):
    """The plain version for a CPU tensor, else the kernel (counted)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal, window=window,
                                     softcap=softcap, delta=delta, stats=stats)
    out, path = _launch(q, k, v, scale, causal, window, softcap, path, stats, delta)
    flash_attention.launches += 1
    flash_attention.path_launches[path] += 1
    return out


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap, path, stats):
        out = _forward(q, k, v, scale, causal, window, softcap, 0, path, stats)
        if not stats:
            return out
        o, m, l = out
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.args = dict(causal=causal, window=window, scale=scale, cap=softcap)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        # the model module imports this one: import it at first use
        from repro_torch.models.attention import flash_backward

        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, m, l, do, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _launch(q, k, v, scale, causal, window, softcap, path, stats=False, delta=0):
    """Launches the kernel ``path`` names, else the one :func:`flash_path`
    chooses; returns (output, the path launched).  With ``stats`` the output
    is (o, m, l), m and l [B, Hq, Sq] f32.  A window wider than every
    distance ``i + delta - j`` (at least ``Sq + delta``) is no window, and
    goes to the kernel as ``max(1, Sq + delta)`` (its int)."""
    b, s, hq, d = q.shape
    if d not in KERNEL_D:
        raise ValueError(f"flash_attention: the kernel takes head sizes {KERNEL_D}, got {d}")
    code = dtype_code(q.dtype)
    q, k, v = (_aligned(a) for a in (q, k, v))
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m, l = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device) for _ in "ml")
    path = path or flash_path(q.dtype, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ptr(m), ptr(l), b, s,
            k.shape[1], delta, hq, k.shape[2], d, scale, int(causal),
            min(window or 0, max(1, s + delta)), softcap or 0.0)
    with torch.cuda.device(q.device):
        lib = load_library().lib
        if path == "tile":
            err = lib.repro_flash_attention_tile(*args, stream)
        else:
            err = lib.repro_flash_attention(*args, code, stream)
        check_launch(err, f"flash_attention ({path} path)")
    return ((o, m, l) if stats else o), path


def _aligned(a):
    """Contiguous, starting on 16 bytes: the CUDA-core kernel moves rows 4
    elements at a time and TMA needs 16-byte-aligned bases (a view into a
    larger tensor may start anywhere)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()
