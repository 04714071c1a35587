"""DLRM, the paper's own architecture (Fig. 2).

Embedding tables are model parallel across the *whole* world; the bottom
and top MLPs are data parallel.  The switch between the two is the
All-to-All the paper fuses into embedding pooling
(:mod:`repro_torch.core.embedding_all_to_all`).  The interaction consumes
that output directly in its {local batch, tables x dim} layout.

This slice runs the forward on one card: scoring a batch, which is what
recommendation inference runs and the first half of a training step.  In
kernel mode the pooling has no backward (neither has the TPU kernel), so
training DLRM waits for ROADMAP Queue 1 item 6.  Plain products stay
``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.embedding_all_to_all import embedding_all_to_all
from repro_torch.models.common import DTYPES, dense_init, embed_init
from repro_torch.parallel.sharding import ParallelContext

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


def dlrm_init(gen: torch.Generator, cfg: DLRMConfig):
    """Tables (normal, std 0.02), MLP weights (truncated-normal fan-in) and
    zero biases on ``gen``'s device, in the reference's tree and order."""
    dt = cfg.pdtype
    params = {
        "tables": embed_init(gen, (cfg.n_tables, cfg.table_vocab, cfg.embed_dim), dt),
        "bottom": [], "top": [],
    }
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
    """batch: dense [B, n_dense], indices [B, T, L] int32.  Returns logits [B]."""
    bottom = _mlp(params["bottom"], batch["dense"])           # [B, D]
    pooled = embedding_all_to_all(ctx, batch["indices"], params["tables"], mode=mode)
    return _mlp(params["top"], _interaction(bottom, pooled))[:, 0]


def dlrm_loss(ctx: ParallelContext, params, cfg: DLRMConfig, batch, *,
              mode: str | None = None):
    """Mean binary cross-entropy of the logits against ``batch["labels"]``."""
    z = dlrm_forward(ctx, params, cfg, batch, mode=mode).float()
    y = batch["labels"].float()
    # numerically stable BCE-with-logits, the reference's formula
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return loss.mean()
