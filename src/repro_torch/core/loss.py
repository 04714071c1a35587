"""Vocab-sharded cross-entropy whose logits stay chunk-local in forward and
backward.

The JAX package shards the sequence over tp and the table's vocabulary,
rings the sequence chunks past every rank and reduces each arriving chunk
to per-token softmax statistics (max, sumexp, label logit) at once, so the
[tokens, V] logits never exist whole; its custom VJP recomputes one chunk's
logits at a time.  On one card (tp = 1) the ring has no hops: the local
sequence is split into ``chunks_per_rank`` sub-chunks, each reduced to its
statistics, and the backward recomputes each sub-chunk's logits in turn.
The label (one-hot) term of the gradient is a row gather of the table (dx)
and a scatter-add (dE), never a [tokens, V] one-hot.  ``fused`` mode's ring
over tp comes with the multi-card world.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import resolve_overlap, tune_ce_ring
from repro_torch.parallel.sharding import ParallelContext

_WIRE_ITEM = "ROADMAP Queue 1 item 1 (left: training at tp > 1, wire_cast on the CE ring)"


def _cap_fwd(lg, cap):
    return torch.tanh(lg / cap) * cap if cap else lg


def _cap_bwd(lg_raw, cap):
    """d capped / d raw."""
    if not cap:
        return 1.0
    t = torch.tanh(lg_raw / cap)
    return 1.0 - t * t


def _label_index(yc, v):
    """Label ids clipped into the table, and which ones lie in it."""
    ok = (yc >= 0) & (yc < v)
    return yc.long().clamp(0, v - 1), ok


def _stats_chunk(xc, yc, embed, cap):
    """One sub-chunk's (max, sumexp, label logit), each [B, sub] f32: the
    product at the inputs' dtype, then f32, as the reference computes it."""
    lg = _cap_fwd((xc @ embed.T).float(), cap)
    m = lg.amax(dim=-1)
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    clip, ok = _label_index(yc, embed.shape[0])
    picked = torch.take_along_dim(lg, clip[..., None], dim=-1)[..., 0]
    return m, se, torch.where(ok, picked, 0.0)


def _chunk_grads(xc, yc, mc, sec, embed, gt, cap, dE):
    """d logits = gt (p - onehot(label)) for one sub-chunk: returns dx [B,
    sub, D] f32 and adds the chunk's table gradient into ``dE`` (f32)."""
    raw = (xc @ embed.T).float()
    p = torch.exp(_cap_fwd(raw, cap) - mc[..., None]) / sec[..., None]
    draw = (p * _cap_bwd(raw, cap) * gt).to(xc.dtype)
    del p
    dxc = (draw @ embed).float()
    dE += torch.einsum("bsv,bsd->vd", draw, xc.to(draw.dtype)).float()
    del draw
    # the label corrections: a row gather (dx) and a scatter-add (dE)
    clip, ok = _label_index(yc, embed.shape[0])
    cb = _cap_bwd(torch.take_along_dim(raw, clip[..., None], dim=-1)[..., 0], cap) if cap else 1.0
    w_lab = torch.where(ok, gt * cb, 0.0)                          # [B, sub]
    dxc -= w_lab[..., None] * embed[clip].float()
    dE.index_add_(0, clip.reshape(-1), -(w_lab[..., None] * xc.float()).reshape(-1, xc.shape[-1]))
    return dxc


class _LocalCE(torch.autograd.Function):
    """The reference's ``local_ce`` at n = 1: the mean token CE, with the
    analytic backward that recomputes one sub-chunk's logits at a time."""

    @staticmethod
    def forward(ctx, x, embed, labels, cap, n_sub):
        sub = x.shape[1] // n_sub
        stats = [_stats_chunk(x[:, j * sub:(j + 1) * sub], labels[:, j * sub:(j + 1) * sub],
                              embed, cap) for j in range(n_sub)]
        m, se, lab = (torch.cat(parts, dim=1) for parts in zip(*stats))
        loss = (torch.log(se) + m - lab).mean()
        ctx.save_for_backward(x, embed, labels, m, se)
        ctx.cap, ctx.n_sub = cap, n_sub
        return loss

    @staticmethod
    def backward(ctx, g):
        x, embed, labels, m, se = ctx.saved_tensors
        B, S, _ = x.shape
        sub = S // ctx.n_sub
        gt = g.float() / (B * S)
        dE = torch.zeros(embed.shape, dtype=torch.float32, device=embed.device)
        dx = []
        for j in range(ctx.n_sub):
            cols = slice(j * sub, (j + 1) * sub)
            dx.append(_chunk_grads(x[:, cols], labels[:, cols], m[:, cols], se[:, cols], embed,
                                   gt, ctx.cap, dE).to(x.dtype))
        return torch.cat(dx, dim=1), dE.to(embed.dtype), None, None, None


def sharded_cross_entropy(
    ctx: ParallelContext,
    x,          # [B, S, D]
    embed,      # [V, D]
    labels,     # [B, S] integer ids
    *,
    mode: str | None = None,
    logit_softcap: float | None = None,
    chunks_per_rank: int | str | None = None,
    skew: int | None = None,
    wire: str | None = None,
):
    """Mean token cross-entropy of ``x @ embed.T`` against ``labels``; a label
    outside the vocabulary contributes its logsumexp alone, as in the
    reference.  ``chunks_per_rank`` (``None``: ``ctx.fusion.granularity``)
    splits the sequence into sub-chunks, clamped to a divisor of S;
    ``"auto"`` granularity or wire resolves through :func:`tune_ce_ring`
    (the reference's key: this rank's sequence and vocabulary rows).
    ``mode`` changes nothing at tp = 1 (the ring has no hops to order); a
    compressed wire, asked for or chosen, raises."""
    del mode
    n = ctx.tp
    b, s, d = x.shape
    skew = ctx.fusion.skew if skew is None else int(skew)
    n_sub, wire = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_ce_ring(b, s // n, d, embed.shape[0], dtype_bytes=x.element_size(),
                                    n_dev=n, hw=ctx.hw, skew=skew, wire=wr, fixed_q=fq),
        dim=s // n, ring=1)
    if wire != "f32":
        raise NotImplementedError(f"sharded_cross_entropy wire={wire!r}: {_WIRE_ITEM}")
    return _LocalCE.apply(x, embed, labels, logit_softcap, n_sub)
