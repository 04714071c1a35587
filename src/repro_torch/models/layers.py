"""Shared NN layers: norms, gated MLPs, the token embedding."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.matmul_allreduce import matmul_allreduce
from repro_torch.models.common import dense_init, embed_init
from repro_torch.parallel.sharding import ParallelContext

_TRAIN_ITEM = "ROADMAP Queue 1 item 4 (dense training)"


# ---------------------------------------------------------------------------
# norms (always computed in f32)
# ---------------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6, *, plus_one: bool = False):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:  # gemma-style (1 + w) parameterization
        w = 1.0 + w
    return (y * w).to(x.dtype)


def rms_norm_init(dim, device, *, zero: bool = False):
    init = torch.zeros if zero else torch.ones
    return init((dim,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU) — the paper's GEMM/GEMV + AllReduce target
# ---------------------------------------------------------------------------
def mlp_init(gen, d_model, d_ff, dtype):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


# jax.nn.gelu is the tanh approximation by default
_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def mlp_apply(ctx: ParallelContext, params, x, *, act="silu", seq_sharded: bool):
    """Column-parallel up/gate, row-parallel down.

    Decode (``seq_sharded=False``, S = 1): the column products are plain
    matmuls (at tp = 1 the columns are not split) and the down projection
    is the fused GEMV+AllReduce — the paper's flagship operator."""
    if seq_sharded:
        raise NotImplementedError(f"sequence-sharded mlp_apply: {_TRAIN_ITEM}")
    fn = _ACTS[act]
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = fn(g) * u
    return matmul_allreduce(ctx, h, params["w_down"])


# ---------------------------------------------------------------------------
# token embedding
# ---------------------------------------------------------------------------
def embedding_init(gen, vocab, d_model, dtype):
    return {"table": embed_init(gen, (vocab, d_model), dtype)}


def embedding_lookup(ctx: ParallelContext, params, tokens, *, seq_shard: bool,
                     scale: float | None = None):
    """tokens [B, S] -> x [B, S, D].  An id outside the vocabulary embeds
    as zeros, as in the vocab-sharded reference."""
    if seq_shard:
        raise NotImplementedError(f"sequence-sharded embedding: {_TRAIN_ITEM}")
    table = params["table"]
    V = table.shape[0]
    ok = (tokens >= 0) & (tokens < V)
    x = table[tokens.clamp(0, V - 1)].masked_fill(~ok[..., None], 0)
    if scale is not None:
        x = (x.float() * scale).to(x.dtype)
    return x
