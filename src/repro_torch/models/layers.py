"""Shared NN layers: norms, gated MLPs, the token embedding.

At tp > 1 the parameters are this rank's shards (``models/transformer.py``
``PARAM_SPECS``): the MLP's gate and up columns, its down rows, the
embedding's vocabulary rows.  The sequence-sharded forms (prefill) take and
give this rank's chunk of the sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.allgather_matmul import allgather_matmul, matmul_reducescatter
from repro_torch.core.collectives import (_no_grad_over_ranks, all_reduce,
                                          ring_reduce_scatter_compute)
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


def mlp_apply(ctx: ParallelContext, params, x, *, act="silu", seq_sharded: bool):
    """Column-parallel up/gate, row-parallel down.

    Prefill (``seq_sharded=True``): AG&matmul in, matmul&RS out — the SP
    split of the paper's GEMM+AllReduce, in every mode; at tp > 1 not under
    autograd (the collectives carry no gradient: a bulk all-gather would cut
    the graph without a word; training at tp > 1 is ROADMAP Queue 1 item 1's
    left part).  Decode (``seq_sharded=False``, S = 1): x
    is the same on every rank, the gate and up products take this rank's
    columns, and the down projection its rows through the fused
    GEMV+AllReduce — the paper's flagship operator."""
    fn = _ACTS[act]
    if seq_sharded:
        _no_grad_over_ranks(ctx, "mlp_apply(seq_sharded=True)", x, *params.values())
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
    """tokens [B, S] -> x [B, S, D], or this rank's sequence chunk [B, S / tp,
    D] of it with ``seq_shard`` (the prefill's).

    The table holds this rank's vocabulary rows ``[d * V_local, (d + 1) *
    V_local)``: an id outside them embeds as zeros, and a sum over the ranks
    completes the lookup (one rank contributes each row, so the sum is
    exact); an id outside the vocabulary embeds as zeros, as in the
    reference.  The sum is an all-reduce, or with ``seq_shard`` at tp > 1
    the reference's compute-interleaved ring reduce-scatter over sequence
    chunks (``ring_reduce_scatter_compute`` under ``ctx.fusion.schedule``,
    in every mode: the fused embedding+collective shape of the paper's DLRM
    operator), each hop adding this rank's partial embedding of the chunk
    in flight.  Where S does not split over the ranks (``S % tp`` or ``S <
    tp``) the reference falls back to the all-reduce and returns the whole
    sequence, and so does this."""
    table = params["table"]
    V = table.shape[0]
    n = ctx.tp
    S = tokens.shape[1]

    def partial(ids):
        rel = ids - ctx.tp_rank * V if n > 1 else ids
        ok = (rel >= 0) & (rel < V)
        return table[rel.clamp(0, V - 1)].masked_fill(~ok[..., None], 0)

    if seq_shard and n > 1 and S % n == 0 and S >= n:
        _no_grad_over_ranks(ctx, "embedding_lookup(seq_shard=True)", table)
        s_loc = S // n
        x = ring_reduce_scatter_compute(
            ctx, lambda c: partial(tokens[:, c * s_loc:(c + 1) * s_loc]),
            schedule=ctx.fusion.schedule, sub_axis=1)
    else:
        x = all_reduce(ctx, partial(tokens))
    if scale is not None:
        x = (x.float() * scale).to(x.dtype)
    return x
