"""DLRM, the paper's own architecture (Fig. 2).

Embedding tables are model parallel across the *whole* world; the bottom
and top MLPs are data parallel.  The switch between the two is the
All-to-All the paper fuses into embedding pooling
(:mod:`repro_torch.core.embedding_all_to_all`).  The interaction consumes
that output directly in its {local batch, tables x dim} layout.

Over a world of ``n = dp * tp`` ranks (world rank ``r = dp_rank * tp +
tp_rank``) rank r holds tables ``[r T / n, (r + 1) T / n)`` (the reference's
``("world", None, None)``: ``DLRM_PARAM_SPECS``) and every MLP leaf whole;
it runs rows ``[r B / n, (r + 1) B / n)`` of the batch
(``data.pipeline.shard_batch``), and the loss is the mean over the global
batch, the same on every rank.  Bulk and fused mode train (the exchange and
the pooling have their backward); kernel mode scores batches, and its
gradient raises, as ``jax.grad`` through the reference's Pallas pooling
does.  Plain products stay ``torch.matmul``, as the reference leaves them to
XLA.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.collectives import world_mean
from repro_torch.core.embedding_all_to_all import embedding_all_to_all
from repro_torch.data.pipeline import shard_batch
from repro_torch.models.common import DTYPES, dense_init, embed_init
from repro_torch.parallel.sharding import ParallelContext, shard_leaf

# the reference's logical specs (src/repro/models/dlrm.py:43-56): the tables
# split over the flattened world, every MLP leaf whole
DLRM_PARAM_SPECS = {"tables": ("world", None, None), "w": (None, None), "b": (None,)}


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_tables: int = 64            # global embedding table count
    table_vocab: int = 100_000
    embed_dim: int = 92           # paper Table II
    n_dense: int = 13
    bottom_mlp: tuple = (512, 256, 92)
    top_mlp: tuple = (682, 682, 682, 1)   # paper Table II average size 682
    pooling: int = 70             # average pooling size (lookups per bag)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]


def param_specs(params):
    """The logical spec of every leaf, in a tree of ``params``' structure."""
    mlp = lambda key: [{k: DLRM_PARAM_SPECS[k] for k in layer} for layer in params[key]]
    return {"tables": DLRM_PARAM_SPECS["tables"], "bottom": mlp("bottom"), "top": mlp("top")}


def dlrm_init(gen: torch.Generator, cfg: DLRMConfig, ctx: ParallelContext | None = None):
    """Tables (normal, std 0.02), MLP weights (truncated-normal fan-in) and
    zero biases on ``gen``'s device, in the reference's tree and order; with
    a ``ctx`` of more than one rank, this rank's world shard of the
    one-rank tables (drawn whole, then sliced and the rest freed), so every
    rank draws the same MLP."""
    dt = cfg.pdtype
    tables = embed_init(gen, (cfg.n_tables, cfg.table_vocab, cfg.embed_dim), dt)
    if ctx is not None:
        tables = shard_leaf(tables, DLRM_PARAM_SPECS["tables"], ctx)
    params = {"tables": tables, "bottom": [], "top": []}
    d = cfg.n_dense
    for h in cfg.bottom_mlp:
        params["bottom"].append({"w": dense_init(gen, (d, h), dt),
                                 "b": torch.zeros((h,), dtype=dt, device=gen.device)})
        d = h
    if d != cfg.embed_dim:
        raise ValueError("the bottom MLP must end at embed_dim")
    n_vec = cfg.n_tables + 1
    d = n_vec * (n_vec - 1) // 2 + cfg.embed_dim
    for h in cfg.top_mlp:
        params["top"].append({"w": dense_init(gen, (d, h), dt),
                              "b": torch.zeros((h,), dtype=dt, device=gen.device)})
        d = h
    return params


def _mlp(layers, x):
    for i, layer in enumerate(layers):
        x = torch.matmul(x, layer["w"]) + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _interaction(bottom, pooled):
    """Dot-product interaction.  bottom [B, D]; pooled [B, T, D] ->
    [B, D + (T + 1) T / 2]: the bottom vector, then every pair i < j of the
    T + 1 vectors in row-major order (``jnp.triu_indices`` order)."""
    T = pooled.shape[1]
    z = torch.cat([bottom[:, None], pooled], dim=1)          # [B, T+1, D]
    zz = torch.bmm(z, z.transpose(1, 2))                      # [B, T+1, T+1]
    iu, ju = torch.triu_indices(T + 1, T + 1, 1, device=zz.device)
    return torch.cat([bottom, zz[:, iu, ju]], dim=-1)


def dlrm_forward(ctx: ParallelContext, params, cfg: DLRMConfig, batch, *,
                 mode: str | None = None):
    """batch: the global batch, dense [B, n_dense] and indices [B, T, L]
    int32 (and labels [B]), whole on every rank.  Returns this rank's
    logits [B / n]: rows ``[r B / n, (r + 1) B / n)`` of world rank r (all B
    in a world of one rank)."""
    return _forward_rows(ctx, params, shard_batch(batch, ctx), mode)


def _forward_rows(ctx, params, mine, mode):
    """The forward on this rank's part of the batch (``shard_batch``)."""
    bottom = _mlp(params["bottom"], mine["dense"])            # [B / n, D]
    pooled = embedding_all_to_all(ctx, mine["indices"], params["tables"], mode=mode)
    return _mlp(params["top"], _interaction(bottom, pooled))[:, 0]


def dlrm_loss(ctx: ParallelContext, params, cfg: DLRMConfig, batch, *,
              mode: str | None = None):
    """Mean binary cross-entropy of the logits against ``batch["labels"]``
    over the global batch, the same on every rank (each rank's mean over its
    rows, averaged over the world: ``collectives.world_mean``), so the
    gradients of the leaves whole on every rank, summed over the world,
    are the global mean's."""
    mine = shard_batch(batch, ctx)
    z = _forward_rows(ctx, params, mine, mode).float()
    y = mine["labels"].float()
    # numerically stable BCE-with-logits, the reference's formula
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return world_mean(ctx, loss.mean())
