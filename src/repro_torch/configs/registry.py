"""Architecture registry: a uniform bundle over the ported configs.

The port serves the dense transformers (chatglm3-6b, phi3-medium-14b,
gemma2-27b with its sliding-window and softcapped attention, deepseek-67b)
and dbrx-132b (MoE), through the dense engine or the paged one
(``serve_step_fn``), trains and prefills them all (``loss_fn``,
``prefill_fn``; dbrx's MoE layers sequence-sharded), runs rwkv6-7b's
prefill and decode (``prefill_fn``, ``decode_fn``; no launcher serves it
yet, and its training is item 7), and runs DLRM, the paper's own
architecture: its ``loss_fn`` scores a batch in every mode and trains in
bulk and fused mode (kernel mode's pooling has no backward, as the
reference's has none).  deepseek-v3-671b (MLA, a dense prefix of 3 layers,
256 routed experts and a shared one) prefills and decodes through the same
entries, dense engine only (its latent cache is not paged, as in the
reference); its ``loss_fn`` raises (training is item 7).  zamba2-7b
(Mamba-2 blocks and a shared attention block with per-group LoRA) trains,
prefills and decodes at any (dp, tp) where tp divides its Mamba heads (its
heads split over tp, ``models/mamba2.py``; its shared block
context-parallel), through the dense engine, which zeroes a reused slot's
recurrent state (``reset_slot_fn``); it is not paged (as in the
reference).  qwen2-vl-2b (M-RoPE, the stub vision front end) and
musicgen-medium (the stub audio front end) are dense transformers: they
serve, prefill and train through the same entries, their front-end inputs
in the batch (``models/frontends.py``).  Every architecture of the
reference is ported.

At tp > 1 (a ``ParallelContext`` over a tp world) the transformers run:
their decode (dbrx's MoE as decode EP over the whole world), their prefill,
their paged serving (the pool's blocks striped over the ranks; a MoE
model's raises, item 5) and their training (sequence-sharded: the KV ring,
the embedding ring, the CE ring and the MoE All-to-Alls, each with its
backward; ``param_specs`` gives the leaves' logical specs the train step
reads).  Over data replicas (dp > 1) the same holds: decode and prefill
split the batch's rows, paged serving is replicated, and training splits
the rows and the fsdp dims of the train state (``init_params(...,
training=True)``).  DLRM runs at any (dp, tp) over the flattened world:
its tables split over all ``dp * tp`` ranks (``"world"``), its batch's rows
too.  rwkv6's heads over ranks and rwkv6 over data are item 7
(``check_tp``).  Kernel mode over more than one tp rank raises where it
reaches the fused GEMV (item 1).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

from repro_torch.parallel.sharding import ParallelContext

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

DLRM_SHAPES = {
    "train_8k": {"batch": 8192, "kind": "dlrm_train"},
}

_MODULES = {
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "dlrm": "repro_torch.configs.dlrm",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
}
# what a recurrent family needs before it trains
_TRAIN_ITEMS = {
    "rwkv6": "ROADMAP Queue 1 item 7 (rwkv6 training: train_forward with a WKV6 backward)",
}
# what a family needs before it runs over several ranks
_MULTI_RANK_ITEMS = {
    "rwkv6": "rwkv6's heads sharded over tp (state_logical_specs) are ROADMAP Queue 1 item 7",
}
# what a family needs before it runs over data replicas
_DATA_ITEMS = {
    "rwkv6": "rwkv6 over data replicas is ROADMAP Queue 1 item 7",
}
# the model module of each family that prefills and decodes
_DECODERS = {"transformer": "repro_torch.models.transformer",
             "rwkv6": "repro_torch.models.rwkv6",
             "zamba2": "repro_torch.models.zamba2"}


@dataclasses.dataclass
class ArchBundle:
    name: str
    family: str
    config: Any
    optimizer: str = "adamw"
    microbatches: int = 1   # train-time gradient accumulation (memory knob)

    def check_tp(self, ctx: ParallelContext | None):
        """Raise for a family that does not run over ``ctx``'s tp ranks or
        data replicas, and for a zamba2 whose Mamba heads (or shared MLP,
        vocabulary, cache rows) tp does not divide."""
        if ctx is not None and self.family == "zamba2":
            from repro_torch.models.zamba2 import check_supported

            check_supported(self.config, ctx.tp)
        if ctx is not None and ctx.tp > 1 and self.family in _MULTI_RANK_ITEMS:
            raise NotImplementedError(f"{self.name} at tp={ctx.tp}: "
                                      f"{_MULTI_RANK_ITEMS[self.family]}")
        if ctx is not None and getattr(ctx, "dp", 1) > 1 and self.family in _DATA_ITEMS:
            raise NotImplementedError(f"{self.name} at dp={ctx.dp}: {_DATA_ITEMS[self.family]}")

    def init_params(self, gen: torch.Generator, ctx: ParallelContext | None = None,
                    training: bool = False):
        """Random parameters on the generator's device; with a ``ctx`` of
        more than one rank, this rank's shards of the one-rank weights
        (drawn a part at a time, each part whole, the rest freed):
        ``training`` places the fsdp dims over the data ranks, as the train
        state is placed; serving keeps them whole.  DLRM's tables are split
        over the whole world either way."""
        self.check_tp(ctx)
        if self.family == "transformer":
            from repro_torch.models.transformer import transformer_init

            return transformer_init(gen, self.config, ctx, training)
        if self.family == "rwkv6":
            from repro_torch.models.rwkv6 import rwkv6_init

            return rwkv6_init(gen, self.config)
        if self.family == "zamba2":
            from repro_torch.models.zamba2 import zamba2_init

            return zamba2_init(gen, self.config, ctx, training)
        if self.family == "dlrm":
            from repro_torch.models.dlrm import dlrm_init

            return dlrm_init(gen, self.config, ctx)
        raise ValueError(self.family)

    def loss_fn(self, ctx: ParallelContext) -> Callable:
        """(params, batch) -> scalar loss, for autograd; the batch is the
        global one, whole on every rank.  DLRM's is the mean BCE over the
        global batch in any mode (in kernel mode its gradient raises: the
        pooling kernel has no backward).  zamba2's is its
        ``train_forward`` (remat by group, the shared block context-parallel
        at tp > 1).  rwkv6 and deepseek-v3 (MLA) raise (ROADMAP Queue 1
        item 7)."""
        cfg = self.config
        self.check_tp(ctx)
        if self.family == "transformer":
            from repro_torch.models.transformer import check_trainable, train_forward

            check_trainable(cfg, ctx.tp)
            return lambda p, b: train_forward(ctx, p, cfg, b)
        if self.family == "dlrm":
            from repro_torch.models.dlrm import dlrm_loss

            return lambda p, b: dlrm_loss(ctx, p, cfg, b)
        if self.family == "zamba2":
            from repro_torch.models.zamba2 import train_forward

            return lambda p, b: train_forward(ctx, p, cfg, b)
        raise NotImplementedError(f"{self.name}: the training forward is "
                                  f"{_TRAIN_ITEMS[self.family]}")

    def param_specs(self, params):
        """The logical spec of every parameter leaf, in a tree of
        ``params``' structure (a transformer's ``PARAM_SPECS``); what
        ``build_train_step`` reads to sum the gradients of whole leaves over
        the tp ranks; DLRM's tables ``("world", None, None)``; zamba2's the
        reference's, its Mamba blocks' by heads (``models/zamba2.py``).
        rwkv6 runs at tp = 1 and holds every leaf whole."""
        if self.family == "zamba2":
            from repro_torch.models.zamba2 import param_specs

            return param_specs(self.config, params)
        if self.family == "transformer":
            from repro_torch.models.transformer import param_specs

            return param_specs(params)
        if self.family == "dlrm":
            from repro_torch.models.dlrm import param_specs

            return param_specs(params)
        from repro_torch.train.optimizer import tree_map

        return tree_map(lambda p: (None,) * p.dim(), params)

    def prefill_fn(self, ctx: ParallelContext) -> Callable:
        """(params, {"tokens": [B, S]}) -> (last logits [B, 1, V], state):
        a transformer's KV cache, rwkv6's recurrent state, zamba2's states
        and its groups' k and v."""
        if self.family not in _DECODERS:
            raise ValueError(f"{self.name}: a {self.family} model does not prefill")
        mod = self._decoder()
        cfg = self.config
        self.check_tp(ctx)
        if self.family == "transformer":
            mod.check_supported(cfg, ctx.tp)
        fn = mod.prefill_forward
        return lambda p, b: fn(ctx, p, cfg, b)

    def decode_fn(self, ctx: ParallelContext) -> Callable:
        """(params, tokens [B,1], cache, pos [B]) -> (logits [B,1,V], cache)."""
        self.check_tp(ctx)
        fn = self._decoder().decode_step
        cfg = self.config
        return lambda p, t, c, pos: fn(ctx, p, cfg, t, c, pos)

    def init_cache(self, batch_size: int, device, tp: int = 1, dp: int = 1):
        """The decode cache: a transformer's KV cache (at tp > 1 a rank's
        ``S_max / tp`` rows of it; at dp > 1 where dp divides the batch a
        replica's rows of it), rwkv6's recurrent state, zamba2's states and
        its groups' dense KV caches (a rank's part, as the transformer's)."""
        decoder = self._decoder()
        if tp == 1 and dp == 1:
            return decoder.init_cache(self.config, batch_size, device)
        if self.family in _MULTI_RANK_ITEMS:
            raise NotImplementedError(f"{self.name} at tp={tp}, dp={dp}: "
                                      f"{_MULTI_RANK_ITEMS[self.family]}")
        return decoder.init_cache(self.config, batch_size, device, tp, dp)

    def reset_slot_fn(self, ctx: ParallelContext | None = None, batch_size: int = 0
                      ) -> Callable | None:
        """``(cache, slot) -> cache`` zeroing a slot's recurrent state, for the
        dense engine to call when a request takes a slot: zamba2's.  Over
        data replicas that split the engine's ``batch_size`` rows the slot is
        a global one and a replica zeroes it where its rows hold it.  None
        for the transformers, whose KV rows past a slot's position are
        masked."""
        if self.family != "zamba2":
            return None
        from repro_torch.data.pipeline import batch_rows
        from repro_torch.models.zamba2 import reset_slot

        rows = None if ctx is None else batch_rows(ctx, batch_size)
        if rows is None:
            return reset_slot
        lo, n = rows
        return lambda cache, slot: reset_slot(cache, slot - lo) if lo <= slot < lo + n else cache

    # ---- paged serving (continuous batching) -----------------------------
    @property
    def supports_paged(self) -> bool:
        """Paged KV is implemented for GQA transformers; MLA and the
        recurrent families keep their dense caches or states."""
        return (self.family == "transformer"
                and getattr(self.config, "attn_type", None) == "gqa")

    def serve_step_fn(self, ctx: ParallelContext) -> Callable:
        """Mixed prefill-chunk/decode step over the paged pool:
        (params, tokens [B,C], pool, tables [B,MB], pos [B], n_new [B])
        -> (last-valid logits [B,V], pool)."""
        from repro_torch.models.transformer import serve_step

        self.check_tp(ctx)
        cfg = self.config
        return lambda p, t, pool, tbl, pos, nn: serve_step(ctx, p, cfg, t, pool, tbl, pos, nn)

    def init_paged_pool(self, num_blocks: int, block_size: int, device, tp: int = 1):
        """A rank's stripe of a pool of ``num_blocks`` blocks, and its sink."""
        from repro_torch.models.transformer import init_paged_pool

        return init_paged_pool(self.config, num_blocks, block_size, device, tp)

    def pool_specs(self, pool):
        from repro_torch.models.transformer import pool_logical_specs

        return pool_logical_specs(self.config, pool)

    def _decoder(self):
        if self.family not in _DECODERS:
            raise ValueError(f"{self.name}: a {self.family} model does not decode")
        return importlib.import_module(_DECODERS[self.family])

    def shapes(self):
        if self.family == "dlrm":
            return dict(DLRM_SHAPES)
        sub_quadratic = bool(getattr(self.config, "sub_quadratic", False))
        # quadratic attention skips the 500k context, as the reference does
        return {k: v for k, v in SHAPES.items() if k != "long_500k" or sub_quadratic}

    def reduced(self) -> "ArchBundle":
        """The reference's reduced smoke config (same overrides)."""
        c = self.config
        if self.family == "dlrm":
            return dataclasses.replace(self, config=dataclasses.replace(
                c, n_tables=8, table_vocab=128, embed_dim=16, n_dense=4,
                bottom_mlp=(32, 16), top_mlp=(32, 1), pooling=5))
        if self.family == "rwkv6":
            return dataclasses.replace(self, config=dataclasses.replace(
                c, n_layers=2, d_model=64, d_ff=128, vocab=512, head_size=16,
                lora_r=8, chunk=8, param_dtype="float32", compute_dtype="float32"))
        if self.family == "zamba2":
            return dataclasses.replace(self, config=dataclasses.replace(
                c, n_layers=5, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                vocab=256, d_state=8, attn_every=2, lora_r=4, max_seq=64,
                param_dtype="float32", compute_dtype="float32"))
        hd = 16
        over = dict(n_layers=2 * (c.local_global_period or 1), d_model=64,
                    d_ff=128, vocab=512, head_dim=hd, max_seq=64,
                    param_dtype="float32", compute_dtype="float32")
        over["n_heads"] = max(4, min(c.n_heads, 4))
        kv = min(c.n_kv_heads, over["n_heads"])
        over["n_kv_heads"] = kv if over["n_heads"] % kv == 0 else over["n_heads"]
        if c.window:
            over["window"] = 16
        if c.mla is not None:
            over["mla"] = dataclasses.replace(
                c.mla, d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                qk_nope_dim=hd, qk_rope_dim=8, v_head_dim=hd)
        if c.moe is not None:
            over["moe"] = dataclasses.replace(
                c.moe, n_experts=8, top_k=min(c.moe.top_k, 2), d_model=64,
                d_ff=32)
        if c.rope_style == "mrope":
            over.update(mrope_sections=(4, 6, 6), head_dim=32)
        if c.dense_prefix:
            over.update(dense_prefix=1, n_layers=3)
        return dataclasses.replace(self, config=dataclasses.replace(c, **over))


def get_arch(name: str) -> ArchBundle:
    mod = importlib.import_module(_MODULES[name])
    return ArchBundle(name=name, family=mod.FAMILY, config=mod.CONFIG,
                      optimizer=getattr(mod, "OPTIMIZER", "adamw"),
                      microbatches=getattr(mod, "MICROBATCHES", 1))
