"""Rotary position embeddings: standard, 2D (chatglm), and M-RoPE (qwen2-vl)."""
from __future__ import annotations

import torch


def _rot_half_interleaved(x):
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _angles(positions, dim, theta):
    """positions [...,] -> cos/sin [..., dim//2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, *, theta: float = 10000.0,
               rotary_dim: int | None = None):
    """Standard RoPE.  x: [B, S, H, hd]; positions: [B, S] or [S]."""
    hd = x.shape[-1]
    rd = rotary_dim or hd
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = _angles(positions, rd, theta)                      # [B, S, rd//2]
    xr, xp = x[..., :rd], x[..., rd:]
    out = _rotate(xr, cos, sin)
    return torch.cat([out, xp], dim=-1) if rd < hd else out


def _rotate(x, cos, sin):
    """x [B, S, H, d] rotated by the angles' cos and sin [B, S, d//2], each
    angle applied to an interleaved pair.  Each angle is doubled to [B, S,
    1, d] by expand and reshape: no output size is read back from the
    device (serve_step stays free of host synchronisation)."""
    d = x.shape[-1]
    pair = lambda a: a[..., None].expand(*a.shape, 2).reshape(*a.shape[:-1], d)[:, :, None, :]
    return x * pair(cos).to(x.dtype) + _rot_half_interleaved(x) * pair(sin).to(x.dtype)


def apply_rope_2d(x, positions, *, theta: float = 10000.0):
    """ChatGLM-style 2D RoPE: rotary applied to the first half of head_dim
    only (the second half stays un-rotated), matching GLM's
    ``rotary_percentage=0.5`` with interleaved layout."""
    return apply_rope(x, positions, theta=theta, rotary_dim=x.shape[-1] // 2)


def apply_mrope(x, positions_thw, *, theta: float = 1_000_000.0, sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: the ``hd // 2`` frequency bands are split into
    (temporal, height, width) sections, each rotated by its own position
    stream.  x: [B, S, H, hd]; positions_thw: [3, B, S].  Where the three
    streams are equal (text) this is :func:`apply_rope` at the same theta,
    bit for bit.  The split sizes are Python ints: nothing is read back from
    the device."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to head_dim // 2 = "
                         f"{hd // 2}")
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=positions_thw.device) / hd
    ang = positions_thw[..., None].float() * (1.0 / (theta ** exps))    # [3, B, S, hd//2]
    # stream i's angles for section i
    ang = torch.cat([a[i] for i, a in enumerate(torch.split(ang, list(sections), dim=-1))],
                    dim=-1)                                               # [B, S, hd//2]
    return _rotate(x, torch.cos(ang), torch.sin(ang))
