"""Zamba2: a Mamba-2 backbone with a shared transformer block.

Structure (arXiv:2411.15242, adapted, as the reference): a stack of Mamba-2
blocks; every ``attn_every`` blocks one *shared* transformer block (one
parameter set reused at every invocation, with a small per-invocation LoRA
on its QKV projection) runs on the concatenation ``[hidden, embedding]``
(2 d_model wide) and is projected back to d_model.

The port trains it (``train_forward``: the loss, differentiated by
autograd, each group under ``torch.utils.checkpoint`` as the reference's
scan runs it under ``jax.checkpoint``), prefills it (``prefill_forward``)
and decodes it (``decode_step``) from the carried state.  The shared
attention's prefill and training forward is ``context_attention`` (the
hand-written flash kernel in kernel mode on a CUDA tensor, at zamba2-7b's
heads of 224; its backward the analytic ``flash_backward``), its decode
``cache_update`` and ``decode_attention`` over the group's dense KV cache.
Each Mamba block's ``w_out`` and, at decode, the shared MLP's down
projection go through the fused GEMV/GEMM + AllReduce.  Parameters hold the
groups as a list of ``n_groups`` dicts (the reference stacks them for its
``lax.scan``; ``train/optimizer.leaf_groups`` hands them to the optimizer
stacked) and the tail as a list of ``n_tail`` blocks.

At tp > 1 (SPMD, one process a rank) the Mamba stream is the same on every
rank and each rank runs its heads of every Mamba block (``models/mamba2.py``,
:func:`param_specs`); the shared block is context-parallel, as in the
reference: each rank takes its ``S / tp`` chunk of ``[h, x0]``, attends over
the KV ring, runs the MLP's sequence-parallel products, and the block's
output is all-gathered over the sequence.  Prefill returns this rank's
chunk of each group's k and v; decode keeps a rank's ``S_max / tp`` rows of
each group's dense cache and merges the ranks' partials, its MLP down
through ``matmul_allreduce``; the SSM state is a rank's heads', the conv
state its heads' x channels and B and C's whole.  The logits are gathered
over the vocabulary's ranks.  Over data replicas (dp > 1) decode and
prefill split the batch's rows where dp divides them, and training splits
its rows and the train state's fsdp dims (each group, the tail's blocks and
the table gather theirs over data at their use).  Paged serving is refused,
as in the reference.

The decode cache keeps the reference's leaves and shapes (:func:`init_cache`,
a rank's part of them) and is updated in place, the recurrent states as
the KV rows: the cache passed in is the one returned.  A reused engine
slot must start from zero states (:func:`reset_slot`); the reference's
engine never zeroes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import (copy_to_tp, data_mean, fsdp_gather, gather_from_tp,
                                          gather_logits, split_to_tp)
from repro_torch.core.degrade import Pins, pinned
from repro_torch.core.loss import sharded_cross_entropy
from repro_torch.data.pipeline import batch_rows, shard_batch
from repro_torch.models import mamba2 as m2
from repro_torch.models.attention import (broadcast_pos, cache_update, context_attention,
                                          decode_attention)
from repro_torch.models.common import DTYPES, dense_init
from repro_torch.models.layers import (embedding_init, embedding_lookup, mlp_apply, mlp_init,
                                       rms_norm, rms_norm_init)
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import HeadsAxis, ParallelContext, shard_leaf
from repro_torch.train.optimizer import tree_map

# the reference's logical specs of the shared block and the table
# (src/repro/models/zamba2.py:83-96, layers.py:47-49 and :99); a norm is whole
SHARED_SPECS = {"ln1": (None,), "w_qkv": ("fsdp", None), "w_o": (None, "fsdp"), "ln2": (None,),
                "mlp": {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
                        "w_down": ("tp", "fsdp")},
                "w_down": ("fsdp", None)}
TABLE_SPEC = ("tp", "fsdp")


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


def check_supported(cfg: Zamba2Config, tp: int = 1):
    """Raise for widths tp does not divide: the Mamba heads, the shared
    MLP's d_ff, the vocabulary and the KV cache's rows."""
    m2.check_heads(cfg.mamba, tp)
    for name in ("vocab", "d_ff", "max_seq"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{cfg.name}: tp={tp} does not divide {name}={getattr(cfg, name)}")


def _block_specs(cfg: Zamba2Config) -> dict:
    return {"ln": (None,), "m": m2.param_specs(cfg.mamba)}


def _group_specs(cfg: Zamba2Config) -> dict:
    return {"mamba": [_block_specs(cfg) for _ in range(cfg.attn_every)],
            "lora_a": ("fsdp", None), "lora_b": (None, None)}


def param_specs(cfg: Zamba2Config, params) -> dict:
    """The logical spec of every parameter leaf, in a tree of ``params``'
    structure and key order (the specs are read in the leaves' order): the
    reference's, with the Mamba blocks' by heads (``mamba2.param_specs``)."""
    specs = {"embed": {"table": TABLE_SPEC}, "final_norm": (None,), "shared": SHARED_SPECS,
             "groups": [_group_specs(cfg) for _ in params["groups"]],
             "tail": [_block_specs(cfg) for _ in params["tail"]]}
    return tree_map(lambda _, sp: sp, params, specs)


def shard_params(tree, specs, ctx: ParallelContext | None, training: bool = False):
    """A parameter tree (or a part of one) sliced to this rank's shards by
    ``specs`` (``parallel.sharding.shard_leaf``: the tp dims by heads, with
    ``training`` the fsdp dims over data); the tree itself where nothing
    splits."""
    if ctx is None or (ctx.tp == 1 and (not training or ctx.dp == 1)):
        return tree
    return tree_map(lambda x, sp: shard_leaf(x, sp, ctx, training), tree, specs)


def _gathered(ctx: ParallelContext, tree, specs):
    """A part's training shards with every fsdp-split weight made whole over
    the data ranks (``collectives.fsdp_gather``); the part itself at dp = 1."""
    if ctx.dp == 1:
        return tree
    return tree_map(lambda w, sp: fsdp_gather(ctx, w, sp), tree, specs)


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


def zamba2_init(gen: torch.Generator, cfg: Zamba2Config, ctx: ParallelContext | None = None,
                training: bool = False):
    """Random parameters on ``gen``'s device, the reference's leaves, shapes
    and init scales: {"embed", "final_norm", "shared", "groups": [n_groups
    dicts], "tail": [n_tail blocks]}.  With a ``ctx`` of more than one rank
    each part is drawn whole, in the order one rank draws it, and only this
    rank's shards kept (:func:`shard_params`, ``training`` their placement),
    so the world's weights are exactly the one-rank weights."""
    check_supported(cfg, 1 if ctx is None else ctx.tp)
    shard = lambda tree, specs: shard_params(tree, specs, ctx, training)
    params: dict[str, Any] = {
        "embed": shard(embedding_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
                       {"table": TABLE_SPEC}),
        "final_norm": rms_norm_init(cfg.d_model, gen.device),
        "shared": shard(_shared_block_init(gen, cfg), SHARED_SPECS),
        "groups": [shard(_group_init(gen, cfg), _group_specs(cfg)) for _ in range(cfg.n_groups)],
        "tail": [shard(_mamba_block_init(gen, cfg), _block_specs(cfg))
                 for _ in range(cfg.n_tail)],
    }
    return params


def _shared_attn(ctx, cfg: Zamba2Config, sp, gp, xcat, *, cache=None, pos=None):
    """The shared transformer block on ``xcat`` [B, T, 2D] with group ``gp``'s
    LoRA.  Without ``cache`` (prefill and training) ``xcat`` is this rank's
    chunk of the sequence (positions ``[d T, (d + 1) T)`` on tp rank d) and
    attention is causal over the KV ring; with it (decode, T = 1) each
    slot's k and v written at its ``pos`` into this rank's rows of the
    cache and attention over the rows, the ranks' partials merged.  Returns
    (the block's output projected to [B, T, D], the group's {"k", "v"}: at
    prefill the chunk's roped k and v [B, T, Hkv, hd], at decode ``cache``
    updated in place)."""
    B, T, _ = xcat.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(xcat, sp["ln1"])
    qkv = h @ sp["w_qkv"] + (h @ gp["lora_a"]) @ gp["lora_b"]
    q, k, v = torch.split(qkv, [Hq * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = q.reshape(B, T, Hq, hd)
    k = k.reshape(B, T, Hkv, hd)
    v = v.reshape(B, T, Hkv, hd)
    if cache is None:
        q0 = ctx.tp_rank * T
        positions = torch.arange(q0, q0 + T, device=xcat.device)[None]
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


def _lm_logits(ctx, params, x, rows_split: bool):
    """Logits [B, 1, V] in f32, tied to the embedding table: this rank's
    vocabulary rows' gathered over tp, and the replicas' rows over data
    where they split the batch."""
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["table"].to(x.dtype)).float()
    return gather_logits(ctx, logits, rows_split)


def _mamba_block(ctx, cfg: Zamba2Config, mb, x, **state):
    """One Mamba block's residual branch on the stream ``x`` (the same on
    every rank), ``(out, (ssm, conv))``.  The stream enters through
    ``copy_to_tp`` before the block's norm: each rank's heads give their part
    of its gradient, summed over tp, and the norm's weight (whole on every
    rank) gets this rank's part, which the train step sums."""
    return m2.mamba2_apply(ctx, mb["m"], cfg.mamba, rms_norm(copy_to_tp(ctx, x), mb["ln"]),
                           **state)


def _group_train(ctx, cfg: Zamba2Config, shared, gp, x, x0):
    """One group: its Mamba blocks, then the shared block with its LoRA on
    this rank's chunk of ``[h, x0]``, its output gathered over the sequence;
    at dp > 1 the group and the shared block gather their fsdp-split
    weights."""
    gp = _gathered(ctx, gp, _group_specs(cfg))
    shared = _gathered(ctx, shared, SHARED_SPECS)
    for mb in gp["mamba"]:
        a, _ = _mamba_block(ctx, cfg, mb, x)
        x = x + a
    xc = split_to_tp(ctx, torch.cat([x, x0], dim=-1), axis=1)
    delta, _ = _shared_attn(ctx, cfg, shared, gp, xc)
    return x + gather_from_tp(ctx, delta, axis=1)


def _pinned_group(pins, ctx, cfg, shared, gp, x, x0):
    with pinned(pins):
        return _group_train(ctx, cfg, shared, gp, x, x0)


def _check_seq(ctx, cfg: Zamba2Config, S: int, what: str):
    if S % ctx.tp:
        raise ValueError(f"{cfg.name}: {what} at tp={ctx.tp} shards the shared block's {S} "
                         f"positions over the ranks: S must be a multiple of tp")


def train_forward(ctx: ParallelContext, params, cfg: Zamba2Config, batch):
    """batch: {"tokens" [B, S], "labels" [B, S]}, whole on every rank -> the
    scalar mean token cross-entropy over the B x S tokens against the tied
    table, the same on every rank, for autograd (the reference's
    ``train_forward``): the embedding, each group's Mamba blocks and the
    shared block on ``[h, x0]`` with the group's LoRA, the tail, the final
    norm, ``sharded_cross_entropy`` on this rank's sequence chunk.  With
    ``cfg.remat`` each group runs under ``torch.utils.checkpoint`` (only its
    input kept, its forward run again in the backward, as the reference's
    ``jax.checkpoint``), its mode and overlap decisions pinned at its first
    forward (``degrade.pinned``) so the recompute posts the same sends on
    every rank; the SSD scan's gradient is autograd's through
    ``ssd_chunked``.  At tp > 1 S must be a multiple of tp; at dp > 1 (dp
    must divide B) a replica runs its rows on its training shards and the
    replicas' means are averaged (``data_mean``)."""
    check_supported(cfg, ctx.tp)
    B, S = batch["tokens"].shape
    _check_seq(ctx, cfg, S, "training")
    if ctx.dp > 1:
        if batch_rows(ctx, B) is None:
            raise ValueError(f"{cfg.name}: training at dp={ctx.dp} splits the batch's {B} rows "
                             f"over the replicas: B must be a multiple of dp")
        batch = shard_batch(batch, ctx)
    table = fsdp_gather(ctx, params["embed"]["table"], TABLE_SPEC)
    x = embedding_lookup(ctx, {"table": table}, batch["tokens"], seq_shard=False).to(cfg.cdtype)
    x0 = x
    for gp in params["groups"]:
        if cfg.remat:
            x = checkpoint(_pinned_group, Pins(), ctx, cfg, params["shared"], gp, x, x0,
                           use_reentrant=False)
        else:
            x = _group_train(ctx, cfg, params["shared"], gp, x, x0)
    for mb in params["tail"]:
        a, _ = _mamba_block(ctx, cfg, _gathered(ctx, mb, _block_specs(cfg)), x)
        x = x + a
    x = rms_norm(split_to_tp(ctx, x, axis=1), params["final_norm"])
    return data_mean(ctx, sharded_cross_entropy(ctx, x, table, batch["labels"]))


def prefill_forward(ctx: ParallelContext, params, cfg: Zamba2Config, batch):
    """Prefill over ``batch["tokens"]`` [B, S].  Returns (last-position
    logits [B, 1, V] f32, the same on every rank, cache {"mamba": {"ssm"
    [G, E, B, H, N, P] f32, "conv" [G, E, B, W - 1, Di + 2N]}, "attn":
    {"k", "v" [G, B, S, Hkv, hd]}, "tail": {"ssm", "conv"} of the tail
    blocks, or None without one}): the reference's leaves, this rank's part
    of them at tp > 1 (its heads' states, its chunk of the sequence's k and
    v; S must be a multiple of tp) and at dp > 1 where dp divides B this
    replica's rows.  ``params["groups"]`` and ``params["tail"]`` may be any
    iterables, read one entry at a time."""
    check_supported(cfg, ctx.tp)
    B, S = batch["tokens"].shape
    _check_seq(ctx, cfg, S, "a prefill")
    split = batch_rows(ctx, B) is not None
    batch = shard_batch(batch, ctx)
    x = embedding_lookup(ctx, params["embed"], batch["tokens"], seq_shard=False).to(cfg.cdtype)
    x0 = x
    shared = params["shared"]
    ssm, conv, ks, vs = [], [], [], []
    for gp in params["groups"]:
        g_ssm, g_conv = [], []
        for mb in gp["mamba"]:
            a, (s2, c2) = _mamba_block(ctx, cfg, mb, x)
            x = x + a
            g_ssm.append(s2)
            g_conv.append(c2)
        xc = split_to_tp(ctx, torch.cat([x, x0], dim=-1), axis=1)
        delta, kv = _shared_attn(ctx, cfg, shared, gp, xc)
        x = x + gather_from_tp(ctx, delta, axis=1)
        ssm.append(torch.stack(g_ssm))
        conv.append(torch.stack(g_conv))
        ks.append(kv["k"])
        vs.append(kv["v"])
    t_ssm, t_conv = [], []
    for mb in params["tail"]:
        a, (s2, c2) = _mamba_block(ctx, cfg, mb, x)
        x = x + a
        t_ssm.append(s2)
        t_conv.append(c2)
    cache = {"mamba": {"ssm": torch.stack(ssm), "conv": torch.stack(conv)},
             "attn": {"k": torch.stack(ks), "v": torch.stack(vs)},
             "tail": ({"ssm": torch.stack(t_ssm), "conv": torch.stack(t_conv)}
                      if t_ssm else None)}
    x = rms_norm(x[:, -1:], params["final_norm"])
    return _lm_logits(ctx, params, x, split), cache


def init_cache(cfg: Zamba2Config, batch_size: int, device, tp: int = 1, dp: int = 1):
    """The zeroed decode cache, the reference's leaves and shapes: the SSM and
    conv states of every group's blocks and of the tail (one zero block
    where there is no tail), and every group's dense KV cache of
    ``max_seq`` rows.  At tp > 1 a rank's part (:func:`cache_logical_specs`):
    its heads' SSM states [.., H / tp, N, P], its conv channels [.., W - 1,
    Di / tp + 2N], its ``max_seq / tp`` rows of the KV caches; at dp > 1
    where dp divides the batch a replica's ``B / dp`` rows."""
    check_supported(cfg, tp)
    if dp > 1 and batch_size % dp == 0:
        batch_size //= dp
    mc, G, E, B = cfg.mamba, cfg.n_groups, cfg.attn_every, batch_size
    f32 = dict(dtype=torch.float32, device=device)
    cd = dict(dtype=cfg.cdtype, device=device)
    conv_w = (mc.conv_width - 1, mc.d_inner // tp + 2 * mc.d_state)
    ssm = (mc.n_heads // tp, mc.d_state, mc.head_dim)
    kv = (G, B, cfg.max_seq // tp, cfg.n_kv_heads, cfg.hd)
    T = max(cfg.n_tail, 1)
    return {
        "mamba": {"ssm": torch.zeros((G, E, B) + ssm, **f32),
                  "conv": torch.zeros((G, E, B) + conv_w, **cd)},
        "attn": {"k": torch.zeros(kv, **cd), "v": torch.zeros(kv, **cd)},
        "tail": {"ssm": torch.zeros((T, B) + ssm, **f32),
                 "conv": torch.zeros((T, B) + conv_w, **cd)},
    }


def cache_logical_specs(cfg: Zamba2Config, cache):
    """The decode cache's logical specs: the reference's
    (``src/repro/models/zamba2.py:257-265``), with the conv state's channels
    by heads (B and C whole, ``HeadsAxis``) where the reference splits them
    contiguously."""
    mc = cfg.mamba
    conv = HeadsAxis((mc.d_inner, False), (2 * mc.d_state, True))
    return {"mamba": {"ssm": (None, None, "batch", "heads", None, None),
                      "conv": (None, None, "batch", None, conv)},
            "attn": {"k": (None, "batch", "seq", None, None),
                     "v": (None, "batch", "seq", None, None)},
            "tail": {"ssm": (None, "batch", "heads", None, None),
                     "conv": (None, "batch", None, conv)}}


def reset_slot(cache, slot: int):
    """Zero slot ``slot``'s recurrent state (every block's SSM and conv state)
    in place, for a request that takes the slot; returns ``cache``.  Its KV
    rows stay: decode masks every row past the slot's position.  ``slot``
    indexes the cache's rows (a replica's own at dp > 1)."""
    cache["mamba"]["ssm"][:, :, slot] = 0
    cache["mamba"]["conv"][:, :, slot] = 0
    cache["tail"]["ssm"][:, slot] = 0
    cache["tail"]["conv"][:, slot] = 0
    return cache


def decode_step(ctx: ParallelContext, params, cfg: Zamba2Config, tokens, cache, pos):
    """One decode step.  tokens: [B, 1]; pos: [B] (or one position) where
    each slot's k and v are written.  Returns (logits [B, 1, V] f32, the
    same on every rank, ``cache`` updated in place); at dp > 1 where dp
    divides B the cache is this replica's (``init_cache(..., dp)``) and the
    replica runs its rows."""
    check_supported(cfg, ctx.tp)
    B = tokens.shape[0]
    pos = broadcast_pos(pos, B, tokens.device)
    rows = batch_rows(ctx, B)
    if rows is not None:
        tokens, pos = tokens[rows[0]:rows[0] + rows[1]], pos[rows[0]:rows[0] + rows[1]]
    x = embedding_lookup(ctx, params["embed"], tokens, seq_shard=False).to(cfg.cdtype)
    x0 = x
    shared = params["shared"]
    mc, ac, tc = cache["mamba"], cache["attn"], cache["tail"]
    for gi, gp in enumerate(params["groups"]):
        for i, mb in enumerate(gp["mamba"]):
            a, (s2, c2) = _mamba_block(ctx, cfg, mb, x, state=mc["ssm"][gi, i],
                                       conv_state=mc["conv"][gi, i])
            x = x + a
            mc["ssm"][gi, i] = s2
            mc["conv"][gi, i] = c2
        delta, _ = _shared_attn(ctx, cfg, shared, gp, torch.cat([x, x0], dim=-1),
                                cache={"k": ac["k"][gi], "v": ac["v"][gi]}, pos=pos)
        x = x + delta
    for i, mb in enumerate(params["tail"]):
        a, (s2, c2) = _mamba_block(ctx, cfg, mb, x, state=tc["ssm"][i],
                                   conv_state=tc["conv"][i])
        x = x + a
        tc["ssm"][i] = s2
        tc["conv"][i] = c2
    x = rms_norm(x, params["final_norm"])
    return _lm_logits(ctx, params, x, rows is not None), cache
