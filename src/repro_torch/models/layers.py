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
from repro_torch.core.collectives import (all_reduce, ring_all_gather_compute,
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

    Prefill and training (``seq_sharded=True``): AG&matmul in, matmul&RS
    out — the SP split of the paper's GEMM+AllReduce, in every mode, each
    with its backward at any tp.  Decode (``seq_sharded=False``, S = 1): x
    is the same on every rank, the gate and up products take this rank's
    columns, and the down projection its rows through the fused
    GEMV+AllReduce — the paper's flagship operator."""
    fn = _ACTS[act]
    if seq_sharded:
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
    sequence, and so does this.

    Gradients at tp > 1: the ring is one ``torch.autograd.Function``
    (:class:`_EmbeddingRing`) whose backward is an all-gather ring of the
    output's cotangent chunks, each chunk's rows ``index_add_``-ed into the
    table rows this rank holds; the all-reduce passes the replicated
    cotangent through, and autograd scatters it into this rank's rows."""
    table = params["table"]
    n = ctx.tp
    S = tokens.shape[1]
    if seq_shard and n > 1 and S % n == 0 and S >= n:
        x = _EmbeddingRing.apply(ctx, table, tokens)
    else:
        x = all_reduce(ctx, _partial(table, tokens, ctx))
    if scale is not None:
        x = (x.float() * scale).to(x.dtype)
    return x


def _local_ids(ids, ctx: ParallelContext, v):
    """ids relative to this rank's vocabulary rows, clipped into them, and
    which ones lie in them."""
    rel = ids - ctx.tp_rank * v if ctx.tp > 1 else ids
    ok = (rel >= 0) & (rel < v)
    return rel.clamp(0, v - 1), ok


def _partial(table, ids, ctx: ParallelContext):
    """This rank's part of the lookup: its rows, zeros elsewhere."""
    rel, ok = _local_ids(ids, ctx, table.shape[0])
    return table[rel].masked_fill(~ok[..., None], 0)


class _EmbeddingRing(torch.autograd.Function):
    """The sequence-sharded lookup's ring reduce-scatter (both schedules),
    and its backward: an all-gather ring of the cotangent's chunks, each
    arriving chunk's rows whose ids fall in this rank's vocabulary rows
    ``index_add_``-ed (in f32) into the table's gradient."""

    @staticmethod
    def forward(fctx, ctx, table, tokens):
        s_loc = tokens.shape[1] // ctx.tp
        fctx.save_for_backward(tokens)
        fctx.args = (ctx, table.shape, table.dtype)
        return ring_reduce_scatter_compute(
            ctx, lambda c: _partial(table, tokens[:, c * s_loc:(c + 1) * s_loc], ctx),
            schedule=ctx.fusion.schedule, sub_axis=1)

    @staticmethod
    def backward(fctx, dx):
        tokens, = fctx.saved_tensors
        ctx, shape, dtype = fctx.args
        s_loc = dx.shape[1]

        def consume(src, dx_src, dt):
            rel, ok = _local_ids(tokens[:, src * s_loc:(src + 1) * s_loc], ctx, shape[0])
            rows = dx_src.float().masked_fill(~ok[..., None], 0)
            return dt.index_add_(0, rel.reshape(-1), rows.reshape(-1, shape[1]))

        dt = ring_all_gather_compute(ctx, dx.contiguous(), consume,
                                     out_init=torch.zeros(shape, dtype=torch.float32,
                                                          device=dx.device))
        return None, dt.to(dtype), None
