"""Decoder-only LM training, prefill and decode for GQA and MLA transformers.

The JAX package's unified decoder scans its layers with ``lax.scan``.  This
port runs GQA decode, prefill and the training forward (``train_forward``:
the loss, differentiated by autograd) with a dense or a MoE FFN, and a
Python loop over the layers; MLA (``models/mla.py``) with its dense-prefix
layers and the MoE layer's shared expert (deepseek-v3) decodes and
prefills, and trains in a later slice.

The stub front ends (``models/frontends.py``) reach the model through the
batch, as in the reference: a vision batch's ``vision_embeds`` [B, S, D]
replace the token embeddings where ``vision_mask`` [S] is set, an audio
batch's ``frame_embeds`` [B, S, D] are added to them, and an M-RoPE config
(qwen2-vl) rotates by the batch's ``positions_thw`` [3, B, S] in prefill and
training.  The batch is whole on every rank: each rank takes its rows and
its sequence chunk of every extra.  Decode and paged serving are the text
phase: their positions go to M-RoPE as three equal streams.  Decode keeps the
reference's layouts: a per-layer cache slice is [B, S_max, Hkv, hd] (MLA's:
the latents c [B, S_max, kv_lora] and kr [B, S_max, rope]), ``pos`` a [B]
int32 vector, logits [B, 1, V] in f32.

A config with ``dense_prefix`` k holds its first k layers, each with a
dense FFN, in ``params["prefix"]`` and the rest in ``params["layers"]``, as
the reference's tree does; every loop runs the prefix first.  The cache
holds all ``n_layers`` layers on its leading axis in that order (the
reference splits it into ``"prefix"`` and ``"scan"``).

Decode, prefill and training run at any tp (SPMD, one process a rank): each rank holds
the parameters' shards of ``PARAM_SPECS`` (``w_qkv`` and ``w_o`` whole, as
GSPMD runs them in the reference) and computes its vocabulary slice of the
logits, which are then gathered so every rank takes the same greedy tokens.
Decode keeps a rank's ``S_max / tp`` rows of the cache.  The prefill shards
the prompt's sequence over the ranks, as the reference does: rank d runs
positions ``[d S / tp, (d + 1) S / tp)`` through the sequence-sharded
embedding ring, the KV ring and the AG/RS products, and returns the
last-position logits [B, 1, V] in f32 (the same on every rank: rank tp - 1's
last row broadcast, each rank's vocabulary slice, gathered) and its chunk of
the cache {"k", "v"}, each [L, B, S / tp, Hkv, hd] (k after RoPE): the
decode layout with the prompt's length, rows sharded as decode's are.
Training runs the prefill's sequence-sharded layers, each ring with its
backward, and the CE ring; its loss is the same scalar on every rank, and
``param_specs`` says which gradients ``train/step.py`` sums over the ranks.

Paged serving (``serve_step``) mixes prefill chunks and decode steps in one
call over a block pool {"k", "v"}, each [L, NB / tp + 1, block, Hkv, hd] on a
rank: its stripe of the reference's ``[L, NB, block, Hkv, hd]`` (its
``pool["scan"]``, blocks split over tp, ``pool_logical_specs``) plus one
sink block per layer (``models/attention.py``).  The pool is updated in
place.  Every rank returns the same logits.

A MoE FFN (``models/moe.py``) holds ``E / tp`` experts a rank
(``MOE_PARAM_SPECS``).  Prefill and training run it sequence-sharded on the
rank's positions, its two All-to-Alls over the tp ranks of the data row;
decode at tp > 1 runs it as decode EP over the whole (data, model) world.
Paged serving of a MoE model at tp > 1 raises (ROADMAP Queue 1 item 5).

Data replicas (dp > 1): decode and prefill split the batch's rows over the
replicas where dp divides B (each replica a dense cache of ``B / dp`` rows,
``init_cache(..., dp)``) and gather the logits over data, so every rank sees
all B rows; where dp does not divide B every replica runs the whole batch,
as the reference does.  Paged serving replicates the pool and the attention
over data, as the reference's specs do.  Training runs a replica's ``B / dp``
rows on parameters whose ``"fsdp"`` dims are split over the data ranks
(``shard_params(..., training=True)``): each layer gathers its weights over
data at its start (``collectives.fsdp_gather``; under remat the recompute
gathers again), the gathers' backward reduce-scatters their gradients, and
the loss is the global mean (``collectives.data_mean``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import (all_gather, broadcast, data_mean, fsdp_gather,
                                          gather_logits)
from repro_torch.core.loss import sharded_cross_entropy
from repro_torch.models.attention import (broadcast_pos, cache_update, context_attention,
                                          decode_attention, paged_attention,
                                          paged_cache_update)
from repro_torch.models.common import DTYPES, dense_init
from repro_torch.models.layers import (embedding_init, embedding_lookup, mlp_apply,
                                       mlp_init, rms_norm, rms_norm_init)
from repro_torch.models.mla import (MLA_PARAM_SPECS, mla_context_attention,
                                    mla_decode_attention, mla_init, mla_latents_for_cache)
from repro_torch.models.moe import MOE_PARAM_SPECS, SHARED_PARAM_SPECS, moe_apply, moe_init
from repro_torch.models.rope import apply_mrope, apply_rope, apply_rope_2d
from repro_torch.core.degrade import Pins, pinned
from repro_torch.data.pipeline import batch_rows, shard_batch
from repro_torch.parallel.sharding import ParallelContext, shard_leaf

# The reference's logical specs of the dense transformer's parameters
# (src/repro/models/transformer.py:107-108, layers.py:47-49 and :99), by leaf
# name within a dict; a leaf not named (the norms) is whole on every rank.  A
# MoE FFN's dict (the one holding a "router") takes ``MOE_PARAM_SPECS``
# instead: its expert leaves share the MLP's names, not its layout; its
# shared expert's dict (under "shared") ``SHARED_PARAM_SPECS``, whole over
# tp; an MLA attention dict (the one holding "w_dkv") ``MLA_PARAM_SPECS``.
PARAM_SPECS = {"w_qkv": ("fsdp", None), "w_o": (None, "fsdp"),
               "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
               "table": ("tp", "fsdp")}
_PAGED_MOE_ITEM = ("paged serving of a MoE model at tp > 1 (the MoE layer on the step's "
                   "replicated chunks over striped pools) is ROADMAP Queue 1 item 5")
# the reference refuses a paged pool for MLA (src/repro/models/transformer.py:442-444)
_PAGED_MLA = "paged KV requires attn_type='gqa' (the reference keeps MLA's dense latent cache)"
_MLA_TRAIN_ITEM = ("training with MLA or a dense prefix (deepseek-v3: MLA's backward through "
                   "the latent ring, Adafactor with 4 microbatches) is ROADMAP Queue 1 item 7")


def leaf_spec(d: dict, key: str, leaf, name: str | None = None):
    """The logical spec of ``d[key]``, ``d`` held under ``name`` in its
    parent: by its name in the table of ``d``'s kind (``SHARED_PARAM_SPECS``
    for a shared expert's dict, ``MOE_PARAM_SPECS`` for a MoE FFN's,
    ``MLA_PARAM_SPECS`` for an MLA attention's, else ``PARAM_SPECS``), whole
    where it is not named."""
    if name == "shared":
        table = SHARED_PARAM_SPECS
    elif "router" in d:
        table = MOE_PARAM_SPECS
    elif "w_dkv" in d:
        table = MLA_PARAM_SPECS
    else:
        table = PARAM_SPECS
    return table.get(key, (None,) * leaf.dim())


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    act: str = "silu"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_style: str = "full"           # full | 2d | mrope
    mrope_sections: tuple = (16, 24, 24)
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    window: int | None = None          # sliding window for local layers
    local_global_period: int = 0       # gemma2: 2 -> [local, global] pattern
    query_scale: float | None = None
    embed_scale: bool = False          # gemma: x *= sqrt(d_model)
    post_norms: bool = False           # gemma2 post-attn/ffn norms
    norm_plus_one: bool = False        # gemma (1+w) RMSNorm
    attn_type: str = "gqa"             # gqa | mla
    mla: Any = None
    moe: Any = None
    dense_prefix: int = 0              # deepseek-v3: first k layers dense
    frontend: str | None = None        # None | audio | vision
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    max_seq: int = 4096                # KV-cache length for decode
    remat: bool = True
    sub_quadratic: bool = False        # True for SSM/hybrid (long_500k ok)

    @property
    def hd(self):
        return self.head_dim or self.d_model // self.n_heads

    def layer_window(self, layer: int):
        if not self.local_global_period:
            return self.window if self.window else None
        # gemma2 style: even layers local, odd layers global
        idx_in_pattern = layer % self.local_global_period
        return self.window if idx_in_pattern % 2 == 0 else None

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]


def check_supported(cfg: TransformerConfig, tp: int = 1):
    """Raise for a config field the port does not know, so that none is
    silently ignored, and for widths tp does not divide."""
    for name in ("vocab", "d_ff", "max_seq"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{cfg.name}: tp={tp} does not divide {name}={getattr(cfg, name)}")
    if cfg.moe is not None and cfg.moe.n_experts % tp:
        raise ValueError(f"{cfg.name}: tp={tp} does not divide the {cfg.moe.n_experts} experts")
    if cfg.attn_type not in ("gqa", "mla") or (cfg.attn_type == "mla") != (cfg.mla is not None):
        raise ValueError(f"{cfg.name}: attn_type={cfg.attn_type!r} with mla={cfg.mla!r}")
    if not 0 <= cfg.dense_prefix <= cfg.n_layers:
        raise ValueError(f"{cfg.name}: dense_prefix={cfg.dense_prefix} of {cfg.n_layers} layers")
    if cfg.rope_style not in ("full", "2d", "mrope"):
        raise ValueError(f"{cfg.name}: rope_style={cfg.rope_style!r}")
    if cfg.frontend not in (None, "audio", "vision"):
        raise ValueError(f"{cfg.name}: frontend={cfg.frontend!r}")


def check_trainable(cfg: TransformerConfig, tp: int = 1):
    """:func:`check_supported`, and raise for what trains only in a later
    slice: MLA and the dense prefix (deepseek-v3)."""
    check_supported(cfg, tp)
    if cfg.attn_type == "mla" or cfg.dense_prefix:
        raise NotImplementedError(f"{cfg.name}: {_MLA_TRAIN_ITEM}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_init(gen, cfg: TransformerConfig, dense: bool = False):
    """One layer: norms, attention (GQA's fused QKV or MLA's), and the FFN:
    the MoE layer where the config has one and ``dense`` is false, else the
    dense SwiGLU (deepseek-v3's prefix layers)."""
    D, dev = cfg.d_model, gen.device
    p: dict[str, Any] = {"ln1": rms_norm_init(D, dev, zero=cfg.norm_plus_one),
                         "ln2": rms_norm_init(D, dev, zero=cfg.norm_plus_one)}
    if cfg.post_norms:
        p["post_ln1"] = rms_norm_init(D, dev, zero=cfg.norm_plus_one)
        p["post_ln2"] = rms_norm_init(D, dev, zero=cfg.norm_plus_one)
    if cfg.attn_type == "mla":
        p["attn"] = mla_init(gen, cfg.mla, cfg.pdtype)
    else:
        qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
        p["attn"] = {
            "w_qkv": dense_init(gen, (D, qkv), cfg.pdtype),
            "w_o": dense_init(gen, (cfg.n_heads * cfg.hd, D), cfg.pdtype),
        }
    if cfg.moe is not None and not dense:
        p["ffn"] = moe_init(gen, cfg.moe, cfg.pdtype)
    else:
        p["ffn"] = mlp_init(gen, D, cfg.d_ff, cfg.pdtype)
    return p


def param_specs(tree, name: str | None = None):
    """The logical spec of every leaf of a parameter tree, in a tree of the
    same structure (:func:`leaf_spec`: by name within its dict's kind, a
    leaf not named whole on every rank)."""
    if isinstance(tree, dict):
        return {k: param_specs(v, k) if isinstance(v, (dict, list)) else
                leaf_spec(tree, k, v, name) for k, v in tree.items()}
    return [param_specs(v) for v in tree]


def shard_params(tree, ctx: ParallelContext | None, training: bool = False,
                 name: str | None = None):
    """A parameter tree (or a part of one, held under ``name``) sliced to
    this rank's shards by :func:`leaf_spec`: the tp dims over the tp ranks,
    and with ``training`` the ``"fsdp"`` dims over the data ranks (the train
    state's placement; serving keeps them whole).  The tree itself where
    nothing splits."""
    if ctx is None or (ctx.tp == 1 and (not training or getattr(ctx, "dp", 1) == 1)):
        return tree
    return {k: shard_params(v, ctx, training, k) if isinstance(v, dict) else
            shard_leaf(v, leaf_spec(tree, k, v, name), ctx, training)
            for k, v in tree.items()}


def transformer_init(gen: torch.Generator, cfg: TransformerConfig,
                     ctx: ParallelContext | None = None, training: bool = False):
    """Random parameters on ``gen``'s device: {"embed": {"table"},
    "final_norm", "layers": [per-layer dict, ...]}, and with
    ``dense_prefix`` k the first k layers (dense FFN) in ``"prefix"``, drawn
    after the others as the reference draws them.

    With a ``ctx`` of more than one rank each part is drawn whole, in the
    order one rank draws it, and only this rank's shard kept
    (``shard_params``, ``training`` its placement), so the world's weights
    are exactly the one-rank weights; a rank's peak is its shards and one
    layer drawn whole."""
    tp = 1 if ctx is None else ctx.tp
    check_supported(cfg, tp)
    shard = lambda tree: shard_params(tree, ctx, training)
    params = {
        "embed": shard(embedding_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype)),
        "final_norm": rms_norm_init(cfg.d_model, gen.device, zero=cfg.norm_plus_one),
        "layers": [shard(_layer_init(gen, cfg))
                   for _ in range(cfg.n_layers - cfg.dense_prefix)],
    }
    if cfg.dense_prefix:
        params["prefix"] = [shard(_layer_init(gen, cfg, dense=True))
                            for _ in range(cfg.dense_prefix)]
    return params


def decoder_layers(params, cfg: TransformerConfig):
    """Yield (layer dict, window) for every layer in the order they run: the
    dense prefix (the reference's ``layer_window(0)``), then
    ``params["layers"]``; the i-th is the cache's layer i.  One layer at a
    time: ``params["layers"]`` may be any iterable of layer dicts, one that
    frees a layer when the next is asked for too."""
    for lp in params.get("prefix", []):
        yield lp, cfg.layer_window(0)
    for i, lp in enumerate(params["layers"]):
        yield lp, cfg.layer_window(i)


def gather_layer(ctx: ParallelContext, lp, name: str | None = None):
    """A layer's training shards with every fsdp-split weight made whole over
    the data ranks (``collectives.fsdp_gather``): the one place a layer
    gathers, at its start.  The layer dict itself at dp = 1."""
    if ctx.dp == 1:
        return lp
    return {k: gather_layer(ctx, v, k) if isinstance(v, dict) else
            fsdp_gather(ctx, v, leaf_spec(lp, k, v, name))
            for k, v in lp.items()}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _attn_train(ctx, cfg: TransformerConfig, lp, x, positions, window, collect_kv=False):
    B, S, D = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    if cfg.attn_type == "mla":
        out, (c, kr) = mla_context_attention(ctx, lp["attn"], cfg.mla, h)
        return out, ({"c": c, "kr": kr} if collect_kv else None)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = h @ lp["attn"]["w_qkv"]
    q, k, v = torch.split(qkv, [Hq * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = _apply_rope_any(cfg, q.reshape(B, S, Hq, hd), positions)
    k = _apply_rope_any(cfg, k.reshape(B, S, Hkv, hd), positions)
    v = v.reshape(B, S, Hkv, hd)
    o = context_attention(ctx, q, k, v, causal=True, window=window,
                          scale=cfg.query_scale, softcap_val=cfg.attn_softcap)
    kv = {"k": k, "v": v} if collect_kv else None
    return o.reshape(B, S, Hq * hd) @ lp["attn"]["w_o"], kv


def _layer_train(ctx, cfg: TransformerConfig, lp, x, positions, window, collect_kv=False,
                 fsdp=False):
    if fsdp:
        lp = gather_layer(ctx, lp)
    a, kv = _attn_train(ctx, cfg, lp, x, positions, window, collect_kv)
    if cfg.post_norms:
        a = rms_norm(a, lp["post_ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    if "router" in lp["ffn"]:
        f = moe_apply(ctx, lp["ffn"], h, cfg.moe, seq_sharded=True)
    else:
        f = mlp_apply(ctx, lp["ffn"], h, act=cfg.act, seq_sharded=True)
    if cfg.post_norms:
        f = rms_norm(f, lp["post_ln2"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return x + f, kv


def _seq_chunk(ctx: ParallelContext, S: int) -> slice:
    """This rank's positions ``[d S / tp, (d + 1) S / tp)`` of a sequence of S."""
    n, d = ctx.tp, ctx.tp_rank
    return slice(d * (S // n), (d + 1) * (S // n))


def _embed_inputs(ctx, params, cfg: TransformerConfig, batch, fsdp=False):
    """tokens and the front end's embeddings -> x [B, S / tp, D], this
    rank's sequence chunk (the batch holds this replica's rows: rows and
    chunk are cut from each extra here, as the reference's global arrays
    are placed by GSPMD); ``fsdp``: the table is a training shard, gathered
    over data for the lookup."""
    tokens = batch["tokens"]
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    embed = gather_layer(ctx, params["embed"]) if fsdp else params["embed"]
    x = embedding_lookup(ctx, embed, tokens, seq_shard=True, scale=scale).to(cfg.cdtype)
    chunk = _seq_chunk(ctx, tokens.shape[1])
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        is_v = batch["vision_mask"][chunk]
        x = torch.where(is_v[None, :, None], batch["vision_embeds"][:, chunk].to(cfg.cdtype), x)
    if cfg.frontend == "audio" and "frame_embeds" in batch:
        x = x + batch["frame_embeds"][:, chunk].to(cfg.cdtype)
    return x


def _positions_for(ctx: ParallelContext, cfg: TransformerConfig, batch):
    """This rank's positions of the batch's sequence of S: M-RoPE's streams
    ``positions_thw[:, :, chunk]`` [3, B, S / tp] (the batch holds this
    replica's rows), else [1, S / tp]."""
    tokens = batch["tokens"]
    chunk = _seq_chunk(ctx, tokens.shape[1])
    if cfg.rope_style == "mrope":
        if "positions_thw" not in batch:
            raise ValueError(f"{cfg.name}: M-RoPE needs the batch's positions_thw [3, B, S] "
                             f"(models.frontends.mrope_positions)")
        return batch["positions_thw"][:, :, chunk]
    return torch.arange(chunk.start, chunk.stop, device=tokens.device)[None, :]


def _group_train(ctx, cfg, layers, x, positions, first):
    """One remat group of consecutive layers (a period of the layer
    pattern, as the reference's scan groups them); at dp > 1 each layer
    gathers its fsdp-split weights."""
    for i, lp in enumerate(layers):
        x, _ = _layer_train(ctx, cfg, lp, x, positions, cfg.layer_window(first + i),
                            fsdp=ctx.dp > 1)
    return x


def train_forward(ctx: ParallelContext, params, cfg: TransformerConfig, batch):
    """batch: {"tokens" [B, S], "labels" [B, S], and the front end's extras},
    whole on every rank -> the scalar mean token cross-entropy over the B x
    S tokens, the same on every rank, for autograd.  At tp > 1 rank d runs
    positions ``[d S / tp, (d + 1) S / tp)`` (S must be a multiple of tp),
    as the prefill does, and
    this rank's gradients are its shards' (a leaf whole on every rank gets
    this rank's partial: ``train/step.py`` sums those over the ranks).  At
    dp > 1 (dp must divide B) a replica runs its ``B / dp`` rows
    (``data.pipeline.shard_batch``) on its training shards
    (``shard_params(..., training=True)``), the layers and the CE gathering
    their fsdp-split weights over data, and the replicas' means are
    averaged (``collectives.data_mean``): the loss and its gradients are
    the global mean's.
    With ``cfg.remat`` each group of layers (``local_global_period``
    layers, else one) runs under ``torch.utils.checkpoint``: only its input
    is kept, and backward runs its forward again, as the reference's
    ``jax.checkpoint`` does; the group's mode and overlap decisions are
    pinned at its first forward (``degrade.pinned``), so that the recompute
    posts the same sends and receives on every rank."""
    check_trainable(cfg, ctx.tp)
    tokens = batch["tokens"]
    (B, S), n, fsdp = tokens.shape, ctx.tp, ctx.dp > 1
    if S % n:
        raise ValueError(f"{cfg.name}: training at tp={n} shards the batch's {S} positions over "
                         f"the ranks: S must be a multiple of tp")
    if fsdp:
        if batch_rows(ctx, B) is None:
            raise ValueError(f"{cfg.name}: training at dp={ctx.dp} splits the batch's {B} rows "
                             f"over the replicas: B must be a multiple of dp")
        batch = shard_batch(batch, ctx)
    x = _embed_inputs(ctx, params, cfg, batch, fsdp)
    positions = _positions_for(ctx, cfg, batch)
    period = cfg.local_global_period or 1
    group = []
    for i, lp in enumerate(params["layers"]):      # any iterable of layer dicts
        group.append(lp)
        if len(group) < period:
            continue
        first = i + 1 - period
        if cfg.remat:
            x = checkpoint(_pinned_group, Pins(), ctx, cfg, group, x, positions, first,
                           use_reentrant=False)
        else:
            x = _group_train(ctx, cfg, group, x, positions, first)
        group = []
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    table = params["embed"]["table"]
    if fsdp:
        table = fsdp_gather(ctx, table, PARAM_SPECS["table"])
    return data_mean(ctx, sharded_cross_entropy(ctx, x, table, batch["labels"],
                                                logit_softcap=cfg.logit_softcap))


def _pinned_group(pins, ctx, cfg, layers, x, positions, first):
    with pinned(pins):
        return _group_train(ctx, cfg, layers, x, positions, first)


def prefill_forward(ctx: ParallelContext, params, cfg: TransformerConfig, batch):
    """Inference prefill: forward over the prompt {"tokens": [B, S], and the
    front end's extras} (every rank the whole prompt), returning last-position logits [B, 1, V] f32,
    the same on every rank, and this rank's chunk of the cache {"k", "v"},
    each [L, B, S / tp, Hkv, hd] at the compute dtype (MLA's {"c", "kr"},
    [L, B, S / tp, kv_lora] and [L, B, S / tp, rope]; at dp > 1 where dp
    divides B, this replica's ``B / dp`` rows of it; the logits are gathered
    over data).  S must be a multiple of tp (the reference's ``s_loc = S //
    n``)."""
    check_supported(cfg, ctx.tp)
    split = batch_rows(ctx, batch["tokens"].shape[0]) is not None
    batch = shard_batch(batch, ctx)
    S, n = batch["tokens"].shape[1], ctx.tp
    if S % n:
        raise ValueError(f"{cfg.name}: a prefill at tp={n} shards the prompt's {S} positions "
                         f"over the ranks: S must be a multiple of tp")
    x = _embed_inputs(ctx, params, cfg, batch)
    positions = _positions_for(ctx, cfg, batch)
    parts: dict[str, list] = {}
    for lp, window in decoder_layers(params, cfg):
        x, kv = _layer_train(ctx, cfg, lp, x, positions, window, collect_kv=True)
        for k_, v_ in kv.items():
            parts.setdefault(k_, []).append(v_)
    cache = {k_: torch.stack(v_) for k_, v_ in parts.items()}
    del parts
    # position S - 1 is the last row of rank tp - 1's chunk
    x = broadcast(ctx, x[:, -1:].contiguous(), n - 1)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return gather_logits(ctx, _lm_logits(params, cfg, x), split), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: TransformerConfig, batch_size: int, device, tp: int = 1, dp: int = 1):
    """Zeroed decode caches {"k", "v"}: [L, B, S_max / tp, Hkv, hd] each, a
    rank's rows of the sequence-sharded cache (MLA's latents {"c", "kr"}:
    [L, B, S_max / tp, kv_lora] and [L, B, S_max / tp, rope]); at dp > 1
    where dp divides B a replica's ``B / dp`` of its rows
    (``data.pipeline.batch_rows``).  L counts every layer, the dense prefix
    first."""
    check_supported(cfg, tp)
    if dp > 1 and batch_size % dp == 0:
        batch_size //= dp
    lead = (cfg.n_layers, batch_size, cfg.max_seq // tp)
    zeros = lambda *rest: torch.zeros(lead + rest, dtype=cfg.cdtype, device=device)
    if cfg.attn_type == "mla":
        return {"c": zeros(cfg.mla.kv_lora_rank), "kr": zeros(cfg.mla.qk_rope_dim)}
    return {"k": zeros(cfg.n_kv_heads, cfg.hd), "v": zeros(cfg.n_kv_heads, cfg.hd)}


def _apply_rope_any(cfg, x, positions):
    if cfg.rope_style == "2d":
        return apply_rope_2d(x, positions, theta=cfg.rope_theta)
    if cfg.rope_style == "mrope":
        return apply_mrope(x, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    return apply_rope(x, positions, theta=cfg.rope_theta)


def _text_positions(cfg, positions):
    """Decode's and serving's [B, C] positions, as M-RoPE's three equal
    streams [3, B, C] where the config has it (the text phase, as in the
    reference): a view, nothing read back from the device."""
    if cfg.rope_style == "mrope":
        return positions[None].expand(3, *positions.shape)
    return positions


def _attn_decode(ctx, cfg: TransformerConfig, lp, x, layer_cache, pos, window):
    """One decode-attention step on a layer's cache ({"k", "v"} or MLA's
    {"c", "kr"}, each updated in place); ``pos`` is the per-slot position
    [B]."""
    B = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    if cfg.attn_type == "mla":
        c_new, kr_new = mla_latents_for_cache(lp["attn"], cfg.mla, h, pos[:, None])
        cache_update(ctx, layer_cache["c"], c_new, pos)
        cache_update(ctx, layer_cache["kr"], kr_new, pos)
        return mla_decode_attention(ctx, lp["attn"], cfg.mla, h, layer_cache["c"],
                                    layer_cache["kr"], pos)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = h @ lp["attn"]["w_qkv"]
    q, k, v = torch.split(qkv, [Hq * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = q.reshape(B, 1, Hq, hd)
    k = k.reshape(B, 1, Hkv, hd)
    v = v.reshape(B, 1, Hkv, hd)
    positions = _text_positions(cfg, pos[:, None])   # [B, 1] per-slot
    q = _apply_rope_any(cfg, q, positions)
    k = _apply_rope_any(cfg, k, positions)
    cache_update(ctx, layer_cache["k"], k, pos)
    cache_update(ctx, layer_cache["v"], v, pos)
    o = decode_attention(ctx, q, layer_cache["k"], layer_cache["v"], pos, window=window,
                         scale=cfg.query_scale, softcap_val=cfg.attn_softcap)
    return o.reshape(B, 1, Hq * hd) @ lp["attn"]["w_o"]


def _layer_decode(ctx, cfg, lp, x, layer_cache, pos, window, rows_split=False):
    a = _attn_decode(ctx, cfg, lp, x, layer_cache, pos, window)
    if cfg.post_norms:
        a = rms_norm(a, lp["post_ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    if "router" in lp["ffn"]:
        # rows replicated over the tp ranks: decode EP at tp > 1
        f = moe_apply(ctx, lp["ffn"], h, cfg.moe, seq_sharded=False, rows_split=rows_split)
    else:
        f = mlp_apply(ctx, lp["ffn"], h, act=cfg.act, seq_sharded=False)
    if cfg.post_norms:
        f = rms_norm(f, lp["post_ln2"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return x + f


def decode_step(ctx: ParallelContext, params, cfg: TransformerConfig,
                tokens, cache, pos):
    """One decode step.  tokens: [B, 1]; pos: [B] int32 (0-based position
    of each slot's new token; a scalar broadcasts).  Returns
    (logits [B, 1, V] f32, the same on every rank, and cache); the cache is
    updated in place.  At dp > 1 where dp divides B the cache is this
    replica's (``init_cache(..., dp)``) and the replica runs its rows."""
    check_supported(cfg, ctx.tp)
    B = tokens.shape[0]
    pos = broadcast_pos(pos, B, tokens.device)
    rows = batch_rows(ctx, B)
    if rows is not None:
        tokens, pos = tokens[rows[0]:rows[0] + rows[1]], pos[rows[0]:rows[0] + rows[1]]
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    x = embedding_lookup(ctx, params["embed"], tokens, seq_shard=False,
                         scale=scale).to(cfg.cdtype)
    for i, (lp, window) in enumerate(decoder_layers(params, cfg)):
        x = _layer_decode(ctx, cfg, lp, x, {k_: v_[i] for k_, v_ in cache.items()}, pos,
                          window, rows is not None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return gather_logits(ctx, _lm_logits(params, cfg, x), rows is not None), cache


def _lm_logits(params, cfg, x):
    """Decode-time logits [B, 1, V_local] in f32, tied to the embedding table
    (this rank's vocabulary rows; all of them at tp = 1)."""
    table = params["embed"]["table"]
    logits = torch.einsum("bsd,vd->bsv", x.to(cfg.cdtype),
                          table.to(cfg.cdtype)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# paged serving (continuous batching)
# ---------------------------------------------------------------------------
def init_paged_pool(cfg: TransformerConfig, num_blocks: int, block_size: int, device,
                    tp: int = 1):
    """Zeroed paged KV block pools shared by all in-flight requests:
    {"k", "v"}, each [L, num_blocks / tp + 1, block_size, Hkv, hd] at the
    compute dtype: this rank's stripe of the ``num_blocks`` global blocks
    (``pool_logical_specs``; tp must divide them) and its sink, the last
    block of each layer, that dropped writes land in
    (``models/attention.paged_cache_update``).  Blocks map to requests
    through host-side block tables (``serve/kv_cache.py``).  GQA only: MLA
    keeps the dense latent cache, as in the reference (the registry gates
    on ``supports_paged``)."""
    check_supported(cfg, tp)
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{_PAGED_MLA} ({cfg.name} is {cfg.attn_type})")
    if num_blocks % tp:
        raise ValueError(f"{num_blocks} pool blocks do not stripe over tp={tp}")
    shape = (cfg.n_layers, num_blocks // tp + 1, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def pool_logical_specs(cfg: TransformerConfig, pool):
    """Logical sharding specs of a paged pool, the reference's: [L, blocks
    over tp ("seq"), ...], whole over data.  A rank's sink block rides
    beside its stripe and is no global block."""
    return {k: (None, "seq") + (None,) * (v.dim() - 2) for k, v in pool.items()}


def _attn_serve(ctx, cfg: TransformerConfig, lp, x, k_pool, v_pool, tables, positions,
                valid, window):
    """Chunked attention against the paged pool.  x: [B, C, D]; positions
    [B, C] are per-slot global offsets (decode: C = 1 at pos; prefill: a
    C-token chunk starting at pos); ``valid`` drops padding and idle rows
    from the cache write.  The chunk's own KV lands in the pool before
    attention, so one causal pass covers the cache and the chunk."""
    B, C, D = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = h @ lp["attn"]["w_qkv"]
    q, k, v = torch.split(qkv, [Hq * hd, Hkv * hd, Hkv * hd], dim=-1)
    rpos = _text_positions(cfg, positions)
    q = _apply_rope_any(cfg, q.reshape(B, C, Hq, hd), rpos)
    k = _apply_rope_any(cfg, k.reshape(B, C, Hkv, hd), rpos)
    v = v.reshape(B, C, Hkv, hd)
    paged_cache_update(ctx, k_pool, k, tables, positions, valid)
    paged_cache_update(ctx, v_pool, v, tables, positions, valid)
    o = paged_attention(ctx, q, k_pool, v_pool, tables, positions, window=window,
                        scale=cfg.query_scale, softcap_val=cfg.attn_softcap)
    return o.reshape(B, C, Hq * hd) @ lp["attn"]["w_o"]


def _layer_serve(ctx, cfg, lp, x, k_pool, v_pool, tables, positions, valid, window):
    a = _attn_serve(ctx, cfg, lp, x, k_pool, v_pool, tables, positions, valid, window)
    if cfg.post_norms:
        a = rms_norm(a, lp["post_ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    if "router" in lp["ffn"]:
        f = moe_apply(ctx, lp["ffn"], h, cfg.moe, seq_sharded=False)
    else:
        f = mlp_apply(ctx, lp["ffn"], h, act=cfg.act, seq_sharded=False)
    if cfg.post_norms:
        f = rms_norm(f, lp["post_ln2"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return x + f


def serve_step(ctx: ParallelContext, params, cfg: TransformerConfig,
               tokens, pool, tables, pos, n_new):
    """One continuous-batching step mixing prefill chunks and decode.

    tokens: [B, C] (slot i's next n_new[i] tokens, zero-padded); tables:
    [B, MB] block ids; pos: [B] first new position per slot; n_new: [B]
    with 0 = idle slot, 1 = decode step, >1 = prefill chunk.  Each slot's
    logits come from its last valid token (``n_new - 1``, clipped; an idle
    slot's row is discarded by the caller).  Returns (logits [B, V] f32,
    pool); the pool is updated in place.  Nothing here synchronises with
    the host, given tensors on one device.  At tp > 1 ``pool`` is this
    rank's stripe (``init_paged_pool(..., tp)``), ``tables`` hold global
    block ids, and the logits are gathered over the vocabulary's ranks: the
    same on every rank.  At dp > 1 every replica runs the whole step on a
    pool of its own, as the reference replicates both over data.  A MoE
    model at tp > 1 raises (``_PAGED_MOE_ITEM``)."""
    check_supported(cfg, ctx.tp)
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{_PAGED_MLA} ({cfg.name} is {cfg.attn_type})")
    if cfg.moe is not None and ctx.tp > 1:
        raise NotImplementedError(f"{cfg.name} at tp={ctx.tp}: {_PAGED_MOE_ITEM}")
    B, C = tokens.shape
    dev = tokens.device
    pos = broadcast_pos(pos, B, dev)
    n_new = torch.as_tensor(n_new, dtype=torch.int32, device=dev)
    steps = torch.arange(C, dtype=torch.int32, device=dev)
    positions = pos[:, None] + steps[None, :]
    valid = steps[None, :] < n_new[:, None]
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    x = embedding_lookup(ctx, params["embed"], tokens, seq_shard=False,
                         scale=scale).to(cfg.cdtype)
    for i, (lp, window) in enumerate(decoder_layers(params, cfg)):
        x = _layer_serve(ctx, cfg, lp, x, pool["k"][i], pool["v"][i], tables, positions,
                         valid, window)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
    idx = (n_new.long() - 1).clamp(0, C - 1)
    x_last = torch.take_along_dim(x, idx[:, None, None], dim=1)      # [B, 1, D]
    return all_gather(ctx, _lm_logits(params, cfg, x_last), axis=-1)[:, 0], pool
