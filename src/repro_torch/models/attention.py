"""Decode attention over a dense KV cache.

The JAX package keeps the decode KV cache sequence-sharded over tp and
merges per-rank flash partials; on one card (tp = 1) the whole sequence is
local and the merge is the identity.  The cache is updated in place, which
saves copying the whole [B, S_max, Hkv, hd] layer cache every step.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import ParallelContext

NEG_INF = -1e30


def broadcast_pos(pos, B, device=None):
    """Normalize a decode position to a per-slot vector [B] int32.

    Accepts one shared position (every slot at the same offset) or a
    per-slot ``[B]`` vector."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return p.expand(B).contiguous()


def decode_attention(
    ctx: ParallelContext,
    q,                  # [B, 1, Hq, hd]
    k_cache, v_cache,   # [B, S_max, Hkv, hd]
    pos,                # [B] (or scalar) int32 per-slot position (kv written)
    *,
    window: int | None = None,
    scale: float | None = None,
    softcap_val: float | None = None,
):
    """One-token GQA attention of each slot over its cache rows 0..pos[b]
    (the last ``window`` of them when ``window`` is set).  The QK product
    runs in the compute dtype and is then cast to f32, like the reference;
    softmax and the PV product run in f32."""
    B, S_max, Hkv, hd = k_cache.shape
    Hq = q.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    pos = broadcast_pos(pos, B, q.device)
    q5 = q.reshape(B, 1, Hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k_cache).float() * scale
    if softcap_val is not None:
        s = torch.tanh(s / softcap_val) * softcap_val
    kpos = torch.arange(S_max, device=q.device)
    valid = kpos[None, :] <= pos[:, None]              # [B, S_max] per slot
    if window is not None:
        valid &= pos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", pr, v_cache.float())
    o = o / torch.clamp_min(l, 1e-30)[..., None]      # one-rank partial merge
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, hd).to(q.dtype)


def cache_update(ctx: ParallelContext, cache, new, pos):
    """Write ``new`` [B, 1, *rest] into ``cache`` [B, S_max, *rest] in
    place, row ``b`` at its own position ``pos[b]``, and return ``cache``.

    A position at or past ``S_max`` is dropped (the engine retires a slot
    before it reaches the bound, so a write past the end must not rewrite
    the last row).  The dropped row rewrites the last row with its own
    value, so the update needs no host synchronisation."""
    B, S_max = cache.shape[:2]
    pos = broadcast_pos(pos, B, cache.device).long()
    rows = pos.clamp(max=S_max - 1)
    b = torch.arange(B, device=cache.device)
    keep = (pos < S_max).reshape((B,) + (1,) * (cache.dim() - 2))
    cache[b, rows] = torch.where(keep, new[:, 0].to(cache.dtype), cache[b, rows])
    return cache
