"""Vocab-sharded cross-entropy whose logits stay chunk-local in forward and
backward.

The JAX package shards the sequence over tp and the table's vocabulary,
rings the sequence chunks past every rank and reduces each arriving chunk
to per-token softmax statistics (max, sumexp, label logit) against this
rank's vocabulary slice at once, so the [tokens, V] logits never exist
whole; its custom VJP replays the ring and recomputes one chunk's logits at
a time, each chunk's dx accumulator travelling with it.  The port's
:class:`_LocalCE` is that custom VJP as one ``torch.autograd.Function``, on
this rank's sequence chunk x [B, S / tp, D], its vocabulary rows embed
[V / tp, D] and the whole labels [B, S].  On one card (tp = 1) the ring has
no hops: the local sequence is split into ``chunks_per_rank`` sub-chunks,
each reduced to its statistics, and the backward recomputes each
sub-chunk's logits in turn.  The label (one-hot) term of the gradient is a
row gather of the table (dx) and a scatter-add (dE), never a [tokens, V]
one-hot.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import resolve_overlap, tune_ce_ring
from repro_torch.core.collectives import (_all_reduce, accumulator_permute_start,
                                          ring_permute_start, split_ring_payload, wire_cast,
                                          wire_uncast)
from repro_torch.core.scheduling import sub_chunk_service_order
from repro_torch.parallel.sharding import ParallelContext

NEG = -1e30


def _cap_fwd(lg, cap):
    return torch.tanh(lg / cap) * cap if cap else lg


def _cap_bwd(lg_raw, cap):
    """d capped / d raw."""
    if not cap:
        return 1.0
    t = torch.tanh(lg_raw / cap)
    return 1.0 - t * t


def _label_index(yc, v_off, v):
    """Label ids relative to this rank's vocabulary rows ``[v_off, v_off +
    v)``, clipped into them, and which ones lie in them."""
    rel = yc.long() - v_off
    ok = (rel >= 0) & (rel < v)
    return rel.clamp(0, v - 1), ok


def _stats_chunk(xc, yc, embed, cap, v_off):
    """One sub-chunk's (max, sumexp, label logit) against this rank's
    vocabulary slice, each [B, sub] f32: the product at the inputs' dtype,
    then f32, as the reference computes it."""
    lg = _cap_fwd((xc @ embed.T).float(), cap)
    m = lg.amax(dim=-1)
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    clip, ok = _label_index(yc, v_off, embed.shape[0])
    picked = torch.take_along_dim(lg, clip[..., None], dim=-1)[..., 0]
    return m, se, torch.where(ok, picked, 0.0)


def _chunk_grads(xc, yc, mc, sec, embed, gt, cap, dE, v_off):
    """d logits = gt (p - onehot(label)) for one sub-chunk against this
    rank's vocabulary slice: returns dx [B, sub, D] f32 and adds the chunk's
    table gradient into ``dE`` (f32)."""
    raw = (xc @ embed.T).float()
    p = torch.exp(_cap_fwd(raw, cap) - mc[..., None]) / sec[..., None]
    draw = (p * _cap_bwd(raw, cap) * gt).to(xc.dtype)
    del p
    dxc = (draw @ embed).float()
    dE += torch.einsum("bsv,bsd->vd", draw, xc.to(draw.dtype)).float()
    del draw
    # the label corrections: a row gather (dx) and a scatter-add (dE)
    clip, ok = _label_index(yc, v_off, embed.shape[0])
    cb = _cap_bwd(torch.take_along_dim(raw, clip[..., None], dim=-1)[..., 0], cap) if cap else 1.0
    w_lab = torch.where(ok, gt * cb, 0.0)                          # [B, sub]
    dxc -= w_lab[..., None] * embed[clip].float()
    dE.index_add_(0, clip.reshape(-1), -(w_lab[..., None] * xc.float()).reshape(-1, xc.shape[-1]))
    return dxc


class _LocalCE(torch.autograd.Function):
    """The reference's ``local_ce``: the mean token CE over the B x S global
    tokens, the same scalar on every rank.

    Sequence-sharded (``seq``): the stats ring over this rank's x
    sub-chunks, in ``sub_chunk_service_order``, the wire cast once at the
    source; each arriving sub-chunk is reduced at once.  Then an all-reduce
    MAX of m and SUM of the rescaled sumexp and of the label term (plain
    collectives, no autograd).  The backward replays the x ring, each
    sub-chunk's dx accumulator travelling with it (at the operand dtype with
    an f32 wire, else cast to the wire on every send while the local add
    stays f32), and one final hop home; dE stays local.  The cotangent
    scale is g / (B S) over the global tokens: the loss is a true replicated
    scalar here, so the reference's ``n_world`` factor (which undoes a
    ``shard_map`` artefact) has no counterpart.

    Replicated (``not seq``: S does not split over the ranks): x is whole
    on every rank; the statistics are reduced as above, and the backward's
    dx is all-reduced so that each rank holds the whole dx of its
    replicated x."""

    @staticmethod
    def forward(fctx, ctx, x, embed, labels, cap, seq, skew, wire, n_sub):
        n, d = ctx.tp, ctx.tp_rank
        B, S = labels.shape
        v_loc = embed.shape[0]
        v_off = d * v_loc
        stats = (torch.full((B, S), NEG, dtype=torch.float32, device=x.device),
                 torch.zeros((B, S), dtype=torch.float32, device=x.device),
                 torch.zeros((B, S), dtype=torch.float32, device=x.device))

        def place(xc, start):
            for buf, val in zip(stats, _stats_chunk(xc, labels[:, start:start + xc.shape[1]],
                                                    embed, cap, v_off)):
                buf[:, start:start + xc.shape[1]] = val

        if not seq:
            place(x, 0)
        else:
            s_loc = x.shape[1]
            sub = s_loc // n_sub
            order = sub_chunk_service_order(n_sub, skew)
            bufs = [wire_cast(t, wire) for t in split_ring_payload(x, n_sub, axis=1)]
            pending = {j: ring_permute_start(ctx, bufs[j]) for j in order} if n > 1 else {}
            for j, xc in enumerate(split_ring_payload(x, n_sub, axis=1)):
                place(xc, d * s_loc + j * sub)
            for i in range(1, n):
                src = (d - i) % n
                for j in order:
                    bufs[j] = pending[j]()
                    if i < n - 1:
                        pending[j] = ring_permute_start(ctx, bufs[j])
                    place(wire_uncast(bufs[j], x.dtype), src * s_loc + j * sub)
        m, se, lab = stats
        if n > 1:
            m_g = _all_reduce(ctx, m, "max")
            se = _all_reduce(ctx, se * torch.exp(m - m_g))
            lab = _all_reduce(ctx, lab)
            m = m_g
        loss = (torch.log(se) + m - lab).mean()
        fctx.save_for_backward(x, embed, labels, m, se)
        fctx.pctx, fctx.args = ctx, (cap, seq, skew, wire, n_sub)
        return loss

    @staticmethod
    def backward(fctx, g):
        x, embed, labels, m, se = fctx.saved_tensors
        ctx, (cap, seq, skew, wire, n_sub) = fctx.pctx, fctx.args
        n, d = ctx.tp, ctx.tp_rank
        B, S = labels.shape
        v_off = d * embed.shape[0]
        gt = g.float() / (B * S)
        dE = torch.zeros(embed.shape, dtype=torch.float32, device=embed.device)

        def grads(xc, start, acc=dE):
            cols = slice(start, start + xc.shape[1])
            return _chunk_grads(xc, labels[:, cols], m[:, cols], se[:, cols], embed, gt, cap, acc,
                                v_off)

        if not seq:
            dx = grads(x, 0)
            if n > 1:
                dx = _all_reduce(ctx, dx)
            return None, dx.to(x.dtype), dE.to(embed.dtype), None, None, None, None, None, None
        compress = wire not in (None, "f32")
        s_loc = x.shape[1]
        sub = s_loc // n_sub
        order = sub_chunk_service_order(n_sub, skew)
        rest = (lambda t: t) if compress else (lambda t: t.to(x.dtype))

        dsend = lambda t: accumulator_permute_start(ctx, t, wire)
        xbufs = split_ring_payload(x, n_sub, axis=1)
        dxs = [rest(grads(xc, d * s_loc + j * sub)) for j, xc in enumerate(xbufs)]
        xbufs = [wire_cast(t, wire) for t in xbufs]
        x_wait = {j: ring_permute_start(ctx, xbufs[j]) for j in order} if n > 1 else {}
        d_wait = {j: dsend(dxs[j]) for j in order}
        # with sub-chunks each sub-chunk ring adds into a dE of its own,
        # summed in sub-chunk order at the end: a skew changes no bit
        dE_ring = [dE] * n_sub if n_sub == 1 or n == 1 else [torch.zeros_like(dE)
                                                             for _ in range(n_sub)]
        for i in range(1, n):
            src = (d - i) % n
            for j in order:
                xbufs[j] = x_wait[j]()
                if i < n - 1:
                    x_wait[j] = ring_permute_start(ctx, xbufs[j])
                acc = d_wait[j]().float()
                dxs[j] = rest(acc + grads(wire_uncast(xbufs[j], x.dtype), src * s_loc + j * sub,
                                          dE_ring[j]))
                d_wait[j] = dsend(dxs[j])
        if dE_ring[0] is not dE:
            for part in dE_ring:
                dE += part
        # the final hop takes each sub-chunk's accumulated dx home (at n = 1
        # it only rounds through the wire, as the reference's does)
        dxs = [d_wait[j]() for j in range(n_sub)]
        dx = dxs[0] if n_sub == 1 else torch.cat(dxs, dim=1)
        return None, dx.to(x.dtype), dE.to(embed.dtype), None, None, None, None, None, None


def sharded_cross_entropy(
    ctx: ParallelContext,
    x,          # [B, S / tp, D]: this rank's sequence chunk (whole [B, S, D] if S does not split)
    embed,      # [V / tp, D]: this rank's vocabulary rows
    labels,     # [B, S] integer ids, whole on every rank
    *,
    mode: str | None = None,
    logit_softcap: float | None = None,
    chunks_per_rank: int | str | None = None,
    skew: int | None = None,
    wire: str | None = None,
):
    """Mean token cross-entropy of ``x @ embed.T`` against ``labels`` over
    the B x S global tokens, the same scalar on every rank; a label outside
    the vocabulary contributes its logsumexp alone, as in the reference.

    Where S splits over the ranks (``S % tp == 0`` and ``S >= tp``) x is this
    rank's sequence chunk and the CE ring runs (:class:`_LocalCE`); else x
    is the whole sequence on every rank (the reference's replicated path).
    ``chunks_per_rank`` (``None``: ``ctx.fusion.granularity``) splits the
    ring payload, the local sequence chunk, into sub-chunks, clamped to a
    divisor of it; ``skew`` rotates their service order and ``wire``
    compresses the x ring and the travelling dx accumulators (``None``:
    ``ctx.fusion``'s).  ``"auto"`` granularity or wire resolves through
    :func:`tune_ce_ring` (the reference's key: this rank's sequence chunk
    and vocabulary rows).  ``mode`` changes nothing: the ring is the only
    path, as in the reference."""
    del mode
    n = ctx.tp
    B, S = labels.shape
    d_model = x.shape[-1]
    seq = S % n == 0 and S >= n
    want = S // n if seq else S
    if x.shape[:2] != (B, want):
        raise ValueError(f"sharded_cross_entropy at tp={n}: x {tuple(x.shape)} for labels "
                         f"{tuple(labels.shape)}; expected [B, {want}, D]")
    skew = ctx.fusion.skew if skew is None else int(skew)
    n_sub, wire_dt = 1, "f32"
    if seq:
        n_sub, wire_dt = resolve_overlap(
            chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
            lambda fq, wr: tune_ce_ring(B, S // n, d_model, embed.shape[0],
                                        dtype_bytes=x.element_size(), n_dev=n, hw=ctx.hw,
                                        skew=skew, wire=wr, fixed_q=fq),
            dim=S // n, ring=1)
    return _LocalCE.apply(ctx, x, embed, labels, logit_softcap, seq, skew, wire_dt, n_sub)
