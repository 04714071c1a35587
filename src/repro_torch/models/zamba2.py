"""Zamba2: a Mamba-2 backbone with a shared transformer block.

Structure (arXiv:2411.15242, adapted, as the reference): a stack of Mamba-2
blocks; every ``attn_every`` blocks one *shared* transformer block (one
parameter set reused at every invocation, with a small per-invocation LoRA
on its QKV projection) runs on the concatenation ``[hidden, embedding]``
(2 d_model wide) and is projected back to d_model.

The port serves it on one card (tp = 1): ``prefill_forward`` over a prompt
and ``decode_step`` from the carried state.  The shared attention's prefill
is ``context_attention`` (the hand-written flash kernel in kernel mode on a
CUDA tensor, at zamba2-7b's heads of 224), its decode ``cache_update`` and
``decode_attention`` over the group's dense KV cache.  Each Mamba block's
``w_out`` and, at decode, the shared MLP's down projection go through the
fused GEMV/GEMM + AllReduce.  Parameters hold the groups as a list of
``n_groups`` dicts (the reference stacks them for its ``lax.scan``) and
the tail as a list of ``n_tail`` blocks.  Training (item 7) and the Mamba
heads over tp or data raise (``configs/registry.py``).

The decode cache keeps the reference's leaves and shapes (:func:`init_cache`)
and is updated in place, the recurrent states as the KV rows: the cache
passed in is the one returned.  A reused engine slot must start from zero
states (:func:`reset_slot`); the reference's engine never zeroes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import mamba2 as m2
from repro_torch.models.attention import (broadcast_pos, cache_update, context_attention,
                                          decode_attention)
from repro_torch.models.common import DTYPES, dense_init
from repro_torch.models.layers import (embedding_init, embedding_lookup, mlp_apply, mlp_init,
                                       rms_norm, rms_norm_init)
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import ParallelContext

TRAIN_ITEM = "ROADMAP Queue 1 item 7 (zamba2 training)"


@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    name: str
    n_layers: int               # total mamba blocks
    d_model: int
    n_heads: int                # shared-attention heads (on 2 * d_model)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_state: int = 64
    attn_every: int = 6
    lora_r: int = 16
    rope_theta: float = 10000.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    max_seq: int = 4096
    remat: bool = True
    sub_quadratic: bool = True

    @property
    def d_attn(self):
        return 2 * self.d_model

    @property
    def hd(self):
        return self.d_attn // self.n_heads

    @property
    def n_groups(self):
        return self.n_layers // self.attn_every

    @property
    def n_tail(self):
        return self.n_layers % self.attn_every

    @property
    def mamba(self):
        return m2.Mamba2Config(d_model=self.d_model, d_state=self.d_state)

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]


def _qkv_width(cfg: Zamba2Config) -> int:
    return (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd


def _shared_block_init(gen, cfg: Zamba2Config):
    Da, pd, dev = cfg.d_attn, cfg.pdtype, gen.device
    return {
        "ln1": rms_norm_init(Da, dev),
        "w_qkv": dense_init(gen, (Da, _qkv_width(cfg)), pd),
        "w_o": dense_init(gen, (cfg.n_heads * cfg.hd, Da), pd),
        "ln2": rms_norm_init(Da, dev),
        "mlp": mlp_init(gen, Da, cfg.d_ff, pd),
        "w_down": dense_init(gen, (Da, cfg.d_model), pd),
    }


def _mamba_block_init(gen, cfg: Zamba2Config):
    return {"ln": rms_norm_init(cfg.d_model, gen.device),
            "m": m2.mamba2_init(gen, cfg.mamba, cfg.pdtype)}


def _group_init(gen, cfg: Zamba2Config):
    return {
        "mamba": [_mamba_block_init(gen, cfg) for _ in range(cfg.attn_every)],
        # the per-invocation LoRA on the shared QKV
        "lora_a": dense_init(gen, (cfg.d_attn, cfg.lora_r), cfg.pdtype, scale=0.01),
        "lora_b": dense_init(gen, (cfg.lora_r, _qkv_width(cfg)), cfg.pdtype, scale=0.01),
    }


def zamba2_init(gen: torch.Generator, cfg: Zamba2Config):
    """Random parameters on ``gen``'s device, the reference's leaves, shapes
    and init scales: {"embed", "final_norm", "shared", "groups": [n_groups
    dicts], "tail": [n_tail blocks]}."""
    params: dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "final_norm": rms_norm_init(cfg.d_model, gen.device),
        "shared": _shared_block_init(gen, cfg),
        "groups": [_group_init(gen, cfg) for _ in range(cfg.n_groups)],
        "tail": [_mamba_block_init(gen, cfg) for _ in range(cfg.n_tail)],
    }
    return params


def _shared_attn(ctx, cfg: Zamba2Config, sp, gp, xcat, *, cache=None, pos=None):
    """The shared transformer block on ``xcat`` [B, T, 2D] with group ``gp``'s
    LoRA.  Without ``cache`` (prefill) causal attention over the T
    positions; with it (decode, T = 1) each slot's k and v written at its
    ``pos`` and attention over its rows.  Returns (the block's output
    projected to [B, T, D], the group's {"k", "v"}: at prefill the prompt's
    roped k and v [B, T, Hkv, hd], at decode ``cache`` updated in place)."""
    B, T, _ = xcat.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(xcat, sp["ln1"])
    qkv = h @ sp["w_qkv"] + (h @ gp["lora_a"]) @ gp["lora_b"]
    q, k, v = torch.split(qkv, [Hq * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = q.reshape(B, T, Hq, hd)
    k = k.reshape(B, T, Hkv, hd)
    v = v.reshape(B, T, Hkv, hd)
    if cache is None:
        positions = torch.arange(T, device=xcat.device)[None]
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
        o = context_attention(ctx, q, k, v, causal=True)
        kv = {"k": k, "v": v}
    else:
        positions = pos[:, None]                      # [B, 1] per slot
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
        kc = cache_update(ctx, cache["k"], k, pos)
        vc = cache_update(ctx, cache["v"], v, pos)
        o = decode_attention(ctx, q, kc, vc, pos)
        kv = {"k": kc, "v": vc}
    x = xcat + o.reshape(B, T, Hq * hd) @ sp["w_o"]
    h2 = rms_norm(x, sp["ln2"])
    # prefill: the sequence-parallel products; decode: the FFN down through
    # the fused GEMV + AllReduce
    x = x + mlp_apply(ctx, sp["mlp"], h2, seq_sharded=cache is None)
    return x @ sp["w_down"], kv


def _lm_logits(params, x):
    """Logits [B, 1, V] in f32, tied to the embedding table."""
    return torch.einsum("bsd,vd->bsv", x, params["embed"]["table"].to(x.dtype)).float()


def train_forward(ctx: ParallelContext, params, cfg: Zamba2Config, batch):
    raise NotImplementedError(f"{cfg.name}: the training forward is {TRAIN_ITEM}")


def prefill_forward(ctx: ParallelContext, params, cfg: Zamba2Config, batch):
    """Prefill over ``batch["tokens"]`` [B, S].  Returns (last-position
    logits [B, 1, V] f32, cache {"mamba": {"ssm" [G, E, B, H, N, P] f32,
    "conv" [G, E, B, W - 1, Di + 2N]}, "attn": {"k", "v" [G, B, S, Hkv,
    hd]}, "tail": {"ssm", "conv"} of the tail blocks, or None without
    one}): the reference's leaves.  ``params["groups"]`` and
    ``params["tail"]`` may be any iterables, read one entry at a time."""
    x = embedding_lookup(ctx, params["embed"], batch["tokens"], seq_shard=False).to(cfg.cdtype)
    x0 = x
    shared = params["shared"]
    ssm, conv, ks, vs = [], [], [], []
    for gp in params["groups"]:
        g_ssm, g_conv = [], []
        for mb in gp["mamba"]:
            a, (s2, c2) = m2.mamba2_apply(ctx, mb["m"], cfg.mamba, rms_norm(x, mb["ln"]))
            x = x + a
            g_ssm.append(s2)
            g_conv.append(c2)
        delta, kv = _shared_attn(ctx, cfg, shared, gp, torch.cat([x, x0], dim=-1))
        x = x + delta
        ssm.append(torch.stack(g_ssm))
        conv.append(torch.stack(g_conv))
        ks.append(kv["k"])
        vs.append(kv["v"])
    t_ssm, t_conv = [], []
    for mb in params["tail"]:
        a, (s2, c2) = m2.mamba2_apply(ctx, mb["m"], cfg.mamba, rms_norm(x, mb["ln"]))
        x = x + a
        t_ssm.append(s2)
        t_conv.append(c2)
    cache = {"mamba": {"ssm": torch.stack(ssm), "conv": torch.stack(conv)},
             "attn": {"k": torch.stack(ks), "v": torch.stack(vs)},
             "tail": ({"ssm": torch.stack(t_ssm), "conv": torch.stack(t_conv)}
                      if t_ssm else None)}
    x = rms_norm(x[:, -1:], params["final_norm"])
    return _lm_logits(params, x), cache


def init_cache(cfg: Zamba2Config, batch_size: int, device):
    """The zeroed decode cache, the reference's leaves and shapes: the SSM and
    conv states of every group's blocks and of the tail (one zero block
    where there is no tail), and every group's dense KV cache of
    ``max_seq`` rows."""
    mc, G, E, B = cfg.mamba, cfg.n_groups, cfg.attn_every, batch_size
    f32 = dict(dtype=torch.float32, device=device)
    cd = dict(dtype=cfg.cdtype, device=device)
    conv_w = (mc.conv_width - 1, mc.d_inner + 2 * mc.d_state)
    ssm = (mc.n_heads, mc.d_state, mc.head_dim)
    kv = (G, B, cfg.max_seq, cfg.n_kv_heads, cfg.hd)
    T = max(cfg.n_tail, 1)
    return {
        "mamba": {"ssm": torch.zeros((G, E, B) + ssm, **f32),
                  "conv": torch.zeros((G, E, B) + conv_w, **cd)},
        "attn": {"k": torch.zeros(kv, **cd), "v": torch.zeros(kv, **cd)},
        "tail": {"ssm": torch.zeros((T, B) + ssm, **f32),
                 "conv": torch.zeros((T, B) + conv_w, **cd)},
    }


def reset_slot(cache, slot: int):
    """Zero slot ``slot``'s recurrent state (every block's SSM and conv state)
    in place, for a request that takes the slot; returns ``cache``.  Its KV
    rows stay: decode masks every row past the slot's position."""
    cache["mamba"]["ssm"][:, :, slot] = 0
    cache["mamba"]["conv"][:, :, slot] = 0
    cache["tail"]["ssm"][:, slot] = 0
    cache["tail"]["conv"][:, slot] = 0
    return cache


def decode_step(ctx: ParallelContext, params, cfg: Zamba2Config, tokens, cache, pos):
    """One decode step.  tokens: [B, 1]; pos: [B] (or one position) where
    each slot's k and v are written.  Returns (logits [B, 1, V] f32,
    ``cache`` updated in place)."""
    B = tokens.shape[0]
    pos = broadcast_pos(pos, B, tokens.device)
    x = embedding_lookup(ctx, params["embed"], tokens, seq_shard=False).to(cfg.cdtype)
    x0 = x
    shared = params["shared"]
    mc, ac, tc = cache["mamba"], cache["attn"], cache["tail"]
    for gi, gp in enumerate(params["groups"]):
        for i, mb in enumerate(gp["mamba"]):
            a, (s2, c2) = m2.mamba2_apply(ctx, mb["m"], cfg.mamba, rms_norm(x, mb["ln"]),
                                          state=mc["ssm"][gi, i], conv_state=mc["conv"][gi, i])
            x = x + a
            mc["ssm"][gi, i] = s2
            mc["conv"][gi, i] = c2
        delta, _ = _shared_attn(ctx, cfg, shared, gp, torch.cat([x, x0], dim=-1),
                                cache={"k": ac["k"][gi], "v": ac["v"][gi]}, pos=pos)
        x = x + delta
    for i, mb in enumerate(params["tail"]):
        a, (s2, c2) = m2.mamba2_apply(ctx, mb["m"], cfg.mamba, rms_norm(x, mb["ln"]),
                                      state=tc["ssm"][i], conv_state=tc["conv"][i])
        x = x + a
        tc["ssm"][i] = s2
        tc["conv"][i] = c2
    x = rms_norm(x, params["final_norm"])
    return _lm_logits(params, x), cache
