"""Rotary position embeddings: standard and 2D (chatglm)."""
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
    # each angle twice, [B, S, 1, rd], by expand and reshape: no output size is
    # read back from the device (serve_step stays free of host synchronisation)
    pair = lambda a: a[..., None].expand(*a.shape, 2).reshape(*a.shape[:-1], rd)[:, :, None, :]
    cos, sin = pair(cos), pair(sin)
    xr, xp = x[..., :rd], x[..., rd:]
    out = xr * cos.to(x.dtype) + _rot_half_interleaved(xr) * sin.to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < hd else out


def apply_rope_2d(x, positions, *, theta: float = 10000.0):
    """ChatGLM-style 2D RoPE: rotary applied to the first half of head_dim
    only (the second half stays un-rotated), matching GLM's
    ``rotary_percentage=0.5`` with interleaved layout."""
    return apply_rope(x, positions, theta=theta, rotary_dim=x.shape[-1] // 2)
