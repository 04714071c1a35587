"""Shared NN layers: norms, gated MLPs, the token embedding.

At tp > 1 the parameters are this rank's shards (``models/transformer.py``
``PARAM_SPECS``): the MLP's gate and up columns, its down rows, the
embedding's vocabulary rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.allgather_matmul import allgather_matmul, matmul_reducescatter
from repro_torch.core.collectives import all_reduce
from repro_torch.core.matmul_allreduce import matmul_allreduce
from repro_torch.models.common import dense_init, embed_init
from repro_torch.parallel.sharding import ParallelContext


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


def check_seq_sharded(ctx: ParallelContext, what: str):
    """Refuse the sequence-sharded layers (prefill, training) at tp > 1 and in
    fused mode: their rings (the KV ring, the CE ring, the sequence-sharded
    embedding) are ROADMAP Queue 1 items 1 and 4's left part."""
    if ctx.tp > 1 or ctx.fusion.mode == "fused":
        raise NotImplementedError(
            f"{what} at tp={ctx.tp} in {ctx.fusion.mode} mode: ROADMAP Queue 1 items 1 and 4 "
            f"(left: prefill and training at tp > 1 and in fused mode, the KV ring and the "
            f"CE ring)")


def mlp_apply(ctx: ParallelContext, params, x, *, act="silu", seq_sharded: bool):
    """Column-parallel up/gate, row-parallel down.

    Prefill (``seq_sharded=True``): AG&matmul in, matmul&RS out — the SP
    split of the paper's GEMM+AllReduce, at tp = 1 in kernel or bulk mode
    (:func:`check_seq_sharded`).  Decode (``seq_sharded=False``, S = 1): x
    is the same on every rank, the gate and up products take this rank's
    columns, and the down projection its rows through the fused
    GEMV+AllReduce — the paper's flagship operator."""
    fn = _ACTS[act]
    if seq_sharded:
        check_seq_sharded(ctx, "mlp_apply(seq_sharded=True)")
        g = allgather_matmul(ctx, x, params["w_gate"])
        u = allgather_matmul(ctx, x, params["w_up"])
        return matmul_reducescatter(ctx, fn(g) * u, params["w_down"])
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
    """tokens [B, S] -> x [B, S, D].

    The table holds this rank's vocabulary rows ``[d * V_local, (d + 1) *
    V_local)``: an id outside them embeds as zeros and a SUM all-reduce
    over the ranks completes the lookup (one rank contributes each row, so
    the sum is exact); an id outside the vocabulary embeds as zeros, as in
    the reference.  At tp = 1 the sequence-sharded lookup (``seq_shard``,
    the prefill's) is the same lookup: its reduce-scatter over one rank is
    the identity; at tp > 1 it is refused (:func:`check_seq_sharded`)."""
    if seq_shard and ctx.tp > 1:
        check_seq_sharded(ctx, "embedding_lookup(seq_shard=True)")
    table = params["table"]
    V = table.shape[0]
    rel = tokens - ctx.tp_rank * V if ctx.tp > 1 else tokens
    ok = (rel >= 0) & (rel < V)
    x = all_reduce(ctx, table[rel.clamp(0, V - 1)].masked_fill(~ok[..., None], 0))
    if scale is not None:
        x = (x.float() * scale).to(x.dtype)
    return x
