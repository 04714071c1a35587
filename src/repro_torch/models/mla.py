"""Multi-head Latent Attention (DeepSeek-V3), the sequence sharded over tp.

Port of the JAX package's ``repro.models.mla``.  MLA compresses a token's
keys and values into a latent: ``c`` (``kv_lora_rank`` values, normed) and
one rotary key ``k_rope`` (``qk_rope_dim``) shared by every head.  The
prefill's sequence is sharded over the tp ranks as in the reference, and
what crosses ranks is the latent stream (``kv_lora + rope`` values a token,
576 at full width, against ``2 H hd`` = 32768 for expanded K and V):

  bulk  : an all-gather of ``(c, k_rope)`` over tp, then one span over the
          whole prompt (the local span at tp = 1);
  fused and kernel : the latent ring (``ring_permute_start``): the local
          span first, each arriving chunk expanded to K and V just before its
          ``_span_flash`` update while the next is on the wire.

MLA runs the plain blockwise ``_span_flash`` in every mode, kernel mode
too, as the reference's MLA never reaches its Pallas flash kernel (the
port's flash kernel also takes a single head size, and MLA's q.k uses
``qk_nope + qk_rope`` = 192 while v uses 128).  Decode runs the absorbed
form: ``W_uk`` folds into the query, so scores and the output accumulate in
latent space over this rank's rows of the cache, and the partials merge
over tp at latent width (``attention_partial_merge`` of ``[B, H, 1,
kv_lora]``).  Every MLA weight is whole on every tp rank (the reference's
specs split only ``"fsdp"`` dims); the output projection ``w_o`` too.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.collectives import all_gather, attention_partial_merge, ring_permute_start
from repro_torch.models.attention import (KV_BLOCK, NEG_INF, Q_BLOCK, _empty_span, _finalize,
                                          _init_carry, _span_flash)
from repro_torch.models.common import dense_init
from repro_torch.models.layers import rms_norm
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import ParallelContext

# the reference's logical specs of the MLA leaves (src/repro/models/mla.py:49-57):
# no tp dim anywhere, so every rank holds them whole when serving
MLA_PARAM_SPECS = {"w_dq": ("fsdp", None), "q_norm": (None,), "w_uq": ("fsdp", None),
                   "w_dkv": ("fsdp", None), "kv_norm": (None,), "w_kr": ("fsdp", None),
                   "w_uk": ("fsdp", None, None), "w_uv": ("fsdp", None, None),
                   "w_o": (None, "fsdp")}


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self):
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen: torch.Generator, cfg: MLAConfig, dtype):
    """The leaves the reference's ``mla_init`` draws, in its order, on
    ``gen``'s device; the two norms' weights are zero (the norms scale by
    ``1 + w``)."""
    D, H = cfg.d_model, cfg.n_heads
    f32 = torch.float32
    return {
        "w_dq": dense_init(gen, (D, cfg.q_lora_rank), dtype),
        "q_norm": dense_init(gen, (cfg.q_lora_rank,), f32, scale=0.0),
        "w_uq": dense_init(gen, (cfg.q_lora_rank, H * cfg.qk_dim), dtype),
        "w_dkv": dense_init(gen, (D, cfg.kv_lora_rank), dtype),
        "kv_norm": dense_init(gen, (cfg.kv_lora_rank,), f32, scale=0.0),
        "w_kr": dense_init(gen, (D, cfg.qk_rope_dim), dtype),
        "w_uk": dense_init(gen, (cfg.kv_lora_rank, H, cfg.qk_nope_dim), dtype),
        "w_uv": dense_init(gen, (cfg.kv_lora_rank, H, cfg.v_head_dim), dtype),
        "w_o": dense_init(gen, (H * cfg.v_head_dim, D), dtype),
    }


def _mla_q(params, cfg: MLAConfig, x, positions):
    """The query heads of x [B, S, D] at ``positions`` ([B, S] or [1, S]):
    (q_nope [B, S, H, nope], q_rope [B, S, H, rope] after RoPE).  The norm
    takes rms_norm's default eps with weight ``1 + q_norm``, as the
    reference's does."""
    B, S, _ = x.shape
    q = rms_norm(x @ params["w_dq"], 1.0 + params["q_norm"])
    q = (q @ params["w_uq"]).reshape(B, S, cfg.n_heads, cfg.qk_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, theta=cfg.rope_theta)


def mla_latents_for_cache(params, cfg: MLAConfig, x, positions):
    """A token's latents, what the cache keeps: (c [B, S, kv_lora],
    k_rope [B, S, rope] after RoPE at ``positions``)."""
    c = rms_norm(x @ params["w_dkv"], 1.0 + params["kv_norm"])
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                        theta=cfg.rope_theta)[:, :, 0]
    return c, k_rope


def _mla_qkv_latent(params, cfg: MLAConfig, x, positions):
    """The shared projections: the full query heads and the per-token
    latents, (q_nope, q_rope, c, k_rope)."""
    return (*_mla_q(params, cfg, x, positions),
            *mla_latents_for_cache(params, cfg, x, positions))


def _expand(params, cfg: MLAConfig, c, k_rope):
    """Latents c [b, s, kv_lora], k_rope [b, s, rope] -> K [b, s, H, nope +
    rope] (the rotary key shared by every head) and V [b, s, H, v]."""
    H = cfg.n_heads
    k_nope = torch.einsum("bsc,chd->bshd", c, params["w_uk"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_rope.shape[:2], H,
                                                        cfg.qk_rope_dim)], dim=-1)
    return k, torch.einsum("bsc,chd->bshd", c, params["w_uv"])


def mla_context_attention(ctx: ParallelContext, params, cfg: MLAConfig, x, *,
                          mode: str | None = None):
    """Prefill MLA.  x: [B, S / tp, D], this rank's chunk of the sequence
    (rank d holds positions ``[d S / tp, (d + 1) S / tp)``).  Returns the
    attention output [B, S / tp, D] at x's dtype and this rank's latents
    (c, k_rope), the prefill's contribution to the cache.

    ``mode`` defaults to ``ctx.fusion.resolve("kv_ag")``: bulk mode
    all-gathers the latents and attends over the whole prompt at once;
    fused and kernel mode ring them, the local span first, then the chunk
    of rank ``(d - i) % tp`` at hop i, its send to the next rank posted
    before this one is expanded and consumed.  A chunk wholly above the
    diagonal is forwarded but not computed (its update would leave every
    carry as it is).  The ring has no backward: MLA's training is ROADMAP
    Queue 1 item 7."""
    mode = mode or ctx.fusion.resolve("kv_ag")
    if mode not in ("bulk", "fused", "kernel"):
        raise ValueError(f"mla_context_attention: unknown mode {mode!r}")
    n, d = ctx.tp, ctx.tp_rank
    b, s_loc, _ = x.shape
    H, dev = cfg.n_heads, x.device
    scale = cfg.qk_dim ** -0.5
    qpos = d * s_loc + torch.arange(s_loc, device=dev)
    q_nope, q_rope, c, k_rope = _mla_qkv_latent(params, cfg, x, qpos[None, :])
    q5 = torch.cat([q_nope, q_rope], dim=-1).reshape(b, s_loc, H, 1, cfg.qk_dim)

    def span(cc, kr, k0, carry):
        k, v = _expand(params, cfg, cc, kr)
        kpos = k0 + torch.arange(cc.shape[1], device=dev)
        return _span_flash(q5, k, v, qpos, kpos, carry, causal=True, window=None,
                           scale=scale, cap=None, q_block=Q_BLOCK, kv_block=KV_BLOCK)

    carry = _init_carry(b, H, 1, s_loc, cfg.v_head_dim, dev)
    if mode == "bulk":
        if n > 1:
            c_all, kr_all = all_gather(ctx, c, axis=1), all_gather(ctx, k_rope, axis=1)
        else:
            c_all, kr_all = c, k_rope
        carry = span(c_all, kr_all, 0, carry)
    else:
        cur, src = (c, k_rope), d
        for hop in range(n):
            nxt = ring_permute_start(ctx, cur) if hop < n - 1 else None
            if not _empty_span(d * s_loc, s_loc, src * s_loc, s_loc, True, None):
                carry = span(*cur, src * s_loc, carry)
            if nxt is not None:
                cur, src = nxt(), (src - 1) % n
    o = _finalize(carry, b, s_loc, H, cfg.v_head_dim)
    out = o.reshape(b, s_loc, H * cfg.v_head_dim).to(x.dtype) @ params["w_o"]
    return out, (c, k_rope)


def mla_decode_attention(ctx: ParallelContext, params, cfg: MLAConfig, x, c_cache, kr_cache,
                         pos):
    """Absorbed-form MLA decode.  x: [B, 1, D], the same on every tp rank;
    c_cache [B, S_max / tp, kv_lora] and kr_cache [B, S_max / tp, rope]:
    this rank's rows of the sequence-sharded cache, the current position
    already written; ``pos`` [B] int32, each slot's position (RoPE and the
    mask at its own length).  score_h(t) = (q_nope_h W_uk_h) . c_t +
    q_rope_h . kr_t; the softmax and the latent output accumulate in f32
    and merge over tp at latent width; W_uv and ``w_o`` follow.  Returns
    [B, 1, D] at x's dtype."""
    B, s_loc, _ = c_cache.shape
    H = cfg.n_heads
    scale = cfg.qk_dim ** -0.5
    q_nope, q_rope = _mla_q(params, cfg, x, pos[:, None])
    q_eff = torch.einsum("bqhd,chd->bqhc", q_nope, params["w_uk"])        # [B,1,H,ckv]
    kpos = ctx.tp_rank * s_loc + torch.arange(s_loc, device=x.device)
    s_lat = torch.einsum("bqhc,bkc->bhqk", q_eff, c_cache)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope, kr_cache)
    s = (s_lat + s_rope).float() * scale                                  # [B,H,1,k]
    valid = kpos[None, :] <= pos[:, None]                                 # [B, s_loc]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(dim=-1)
    o_lat = torch.einsum("bhqk,bkc->bhqc", pr, c_cache.float())
    o_lat = attention_partial_merge(ctx, o_lat, m, l)                     # [B,H,1,ckv]
    o = torch.einsum("bhqc,chv->bqhv", o_lat.to(x.dtype), params["w_uv"])
    return o.reshape(B, 1, H * cfg.v_head_dim) @ params["w_o"]
