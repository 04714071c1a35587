"""Train/prefill attention over the sequence, and decode attention over a
dense KV cache.

Train/prefill (``context_attention``): the sequence is sharded over tp, as
in the JAX package, and each rank attends its chunk of queries over the
prompt.  ``bulk`` mode all-gathers k and v and runs the plain blockwise
online softmax (``_span_flash``) over them, as the reference's bulk branch
does, on any device.  ``fused`` and ``kernel`` mode run the KV ring of the
reference's ``_make_ring_attention``: the local chunk first, then each
arriving KV sub-chunk while the next is on the wire.  Fused mode consumes a
hop with ``_span_flash``; kernel mode with the hand-written flash kernel
(``kernels/flash_attention``; its plain version on a CPU tensor), whose
per-hop (o, m, l) fold into one carry by the online-softmax merge
(``attention_path``).  On one card (tp = 1) the ring has no hops: kernel
mode on a CUDA tensor is one flash launch over the span.  Gradients follow
the reference at tp = 1: bulk mode differentiates through ``_span_flash``
by autograd, as its bulk branch does; kernel and fused mode are its ring
attention at n = 1, whose analytic backward (``flash_backward``, the port of
``_span_flash_bwd``) recomputes the scores block by block from the forward's
softmax statistics (on a card the flash kernel writes them; on the CPU
``_SpanFlash`` keeps the plain loop's carries).  At tp > 1 bulk mode's
gradient is autograd through the all-gather (a reduce-scatter of the
cotangents) and ``_span_flash``; fused and kernel mode's ring is one
``torch.autograd.Function`` (:class:`_RingAttention`) whose backward is the
reference's ``bwd_rule``: the analytic ``_span_flash_bwd`` over the local
span, then the KV sub-chunk rings replayed, each sub-chunk's (dk, dv)
accumulator travelling with it and sent home at the end, in plain PyTorch
on every device (the reference has no backward kernel).

Decode: the KV cache is sequence-sharded over tp, as in the reference (GQA
with 2 KV heads cannot split its heads over 4 ranks): rank ``d`` holds rows
``[d * S_max / tp, (d + 1) * S_max / tp)`` of every slot, attends over them
and merges its flash partial with the others' (``attention_partial_merge``);
at tp = 1 the merge is a division.  The cache is updated in place, which
saves copying the whole [B, S_local, Hkv, hd] layer cache every step.

Paged serving (``paged_cache_update``, ``paged_attention``): a pool of
fixed-size KV blocks shared by every request, mapped by per-request block
tables, in plain PyTorch (the reference has no kernel here: its attention is
``_flash_update`` over the table's blocks).  At tp > 1 the blocks are
striped over the ranks as the reference's are: rank d holds global blocks
``[d NB / tp, (d + 1) NB / tp)``, writes and attends only those, and the
partials merge across the ranks (``attention_partial_merge``).  Neither
synchronises with the host (``chip_smoke.py`` phase 23(e) holds
``serve_step`` to that).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.autotune import resolve_overlap, tune_ring_attention
from repro_torch.core.collectives import (accumulator_permute_start, all_gather,
                                          attention_partial_merge, ring_permute_start,
                                          split_ring_payload, wire_cast, wire_uncast)
from repro_torch.core.scheduling import sub_chunk_service_order
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel.sharding import ParallelContext

NEG_INF = -1e30
Q_BLOCK, KV_BLOCK = 256, 1024   # the reference context_attention's default blocks


# ---------------------------------------------------------------------------
# blockwise online softmax (the plain version of the flash kernel's loop)
# ---------------------------------------------------------------------------
def _flash_update(carry, q5, k, v, mask, scale, cap):
    """One flash-attention accumulation step (f32 carries).

    carry = (m, l, o): [b,hk,g,sq], [b,hk,g,sq], [b,hk,g,sq,d]
    q5: [b,sq,hk,g,d]; k, v: [b,sk,hk,d]; mask: [sq,sk] bool, or [b,sq,sk].
    As in the reference, QK runs in the inputs' dtype and is then cast to
    f32; the softmax and the PV product run in f32."""
    m, l, o = carry
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k).float() * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    bias = torch.where(mask, 0.0, NEG_INF)
    s = s + (bias[:, None, None] if mask.dim() == 3 else bias)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return m_new, l, o


def _span_mask(qp, kp, causal, window):
    mask = torch.ones((len(qp), len(kp)), dtype=torch.bool, device=qp.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= qp[:, None] - kp[None, :] < window
    return mask


def _span_flash(q5, k, v, qpos, kpos, carry, *, causal, window, scale, cap,
                q_block, kv_block):
    """Accumulate flash carries of q5 against one KV span, blocked so the
    score matrix never exceeds [b, hk, g, q_block, kv_block].

    Unlike the reference, whose loops run ``sq // q_block`` and
    ``sk // kv_block`` times, the last query and key blocks may be short,
    so no row or key past the last whole block is dropped.  Each query
    block's carries are new tensors, joined at the end, so autograd can
    differentiate through the loop (bulk mode's gradient)."""
    m, l, o = carry
    sq, sk = q5.shape[1], k.shape[1]
    qb, kb = min(q_block, sq), min(kv_block, sk)
    out = []
    for q0 in range(0, sq, qb):
        rows = slice(q0, min(q0 + qb, sq))
        qp = qpos[rows]
        c = (m[..., rows], l[..., rows], o[..., rows, :])
        for k0 in range(0, sk, kb):
            keys = slice(k0, min(k0 + kb, sk))
            mask = _span_mask(qp, kpos[keys], causal, window)
            c = _flash_update(c, q5[:, rows], k[:, keys], v[:, keys], mask, scale, cap)
        out.append(c)
    if len(out) == 1:
        return out[0]
    return tuple(torch.cat(parts, dim=3) for parts in zip(*out))


# ---------------------------------------------------------------------------
# flash backward over one KV span (blocked; recompute-in-backward)
# ---------------------------------------------------------------------------
def _span_flash_bwd(q5, kc, vc, do5, delta, m, l, qpos, kpos, dq5, *, causal, window,
                    scale, cap, q_block, kv_block, dk0=None, dv0=None):
    """Accumulate flash gradients of q5 against one KV span; returns (dq5,
    dk, dv), dk and dv [b,skc,hk,d] f32.

    q5/do5/dq5: [b,sq,hk,g,d]; kc, vc: [b,skc,hk,d]; delta, m, l:
    [b,hk,g,sq].  dq5 is a running accumulator, updated in place, and so
    are ``dk0`` and ``dv0`` where given (f32; the accumulators that travel
    the KV ring with their chunk).  Scores are recomputed per (q_block,
    kv_block) tile, never materialized whole.  The dtypes follow the reference: the QK product at
    the inputs' dtype, then f32; do, v, p and ds in f32.  As in
    ``_span_flash``, the last query and key blocks may be short."""
    b, sq, hk, g, dd = q5.shape
    skc = kc.shape[1]
    qb, kb = min(q_block, sq), min(kv_block, skc)
    f32 = torch.float32
    dk = torch.zeros((b, skc, hk, dd), dtype=f32, device=q5.device) if dk0 is None else dk0
    dv = torch.zeros((b, skc, hk, dd), dtype=f32, device=q5.device) if dv0 is None else dv0
    for q0 in range(0, sq, qb):
        rows = slice(q0, min(q0 + qb, sq))
        qs, dos = q5[:, rows], do5[:, rows].float()
        ms, dls = m[..., rows], delta[..., rows]
        ls = torch.clamp_min(l[..., rows], 1e-30)
        dq_blk = torch.zeros(qs.shape, dtype=f32, device=q5.device)
        for k0 in range(0, skc, kb):
            keys = slice(k0, min(k0 + kb, skc))
            ks, vs = kc[:, keys], vc[:, keys]
            raw = torch.einsum("bqhgd,bkhd->bhgqk", qs, ks).float() * scale
            s = raw if cap is None else torch.tanh(raw / cap) * cap
            s = s + torch.where(_span_mask(qpos[rows], kpos[keys], causal, window), 0.0, NEG_INF)
            p = torch.exp(s - ms[..., None]) / ls[..., None]
            dv[:, keys] += torch.einsum("bhgqk,bqhgd->bkhd", p, dos)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dos, vs.float())
            ds = p * (dp - dls[..., None])
            if cap is not None:
                t = torch.tanh(raw / cap)
                ds = ds * (1.0 - t * t)
            ds = ds * scale
            dq_blk += torch.einsum("bhgqk,bkhd->bqhgd", ds, ks.float())
            dk[:, keys] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qs.float())
        dq5[:, rows] += dq_blk
    return dq5, dk, dv


def flash_backward(q, k, v, o, m, l, do, *, causal, window, scale, cap):
    """The analytic gradient of one whole span's attention: the reference's
    ring-attention ``bwd_rule`` at n = 1 (no hops), at its default blocks.  q, o, do [B, S, Hq, hd];
    k, v [B, S, Hkv, hd]; m, l the forward's softmax statistics, [B, Hq, S]
    or [B, Hkv, g, S] f32.  Returns (dq, dk, dv) at q's, k's and v's dtypes."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    q5 = q.reshape(B, S, Hkv, g, hd)
    do5 = do.float().reshape(B, S, Hkv, g, hd)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do5, o.reshape(B, S, Hkv, g, hd).float())
    pos = torch.arange(S, device=q.device)
    dq5, dk, dv = _span_flash_bwd(
        q5, k, v, do5, delta, m.reshape(B, Hkv, g, S), l.reshape(B, Hkv, g, S), pos, pos,
        torch.zeros(q5.shape, dtype=torch.float32, device=q.device), causal=causal,
        window=window, scale=scale, cap=cap, q_block=Q_BLOCK, kv_block=KV_BLOCK)
    return dq5.reshape(B, S, Hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _SpanFlash(torch.autograd.Function):
    """The ring attention at n = 1 in plain PyTorch (fused mode, and kernel
    mode off the card): the span forward, keeping its m and l, with the
    analytic backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, cap, q_block=Q_BLOCK, kv_block=KV_BLOCK):
        B, S, Hq, hd = q.shape
        Hkv = k.shape[2]
        g = Hq // Hkv
        pos = torch.arange(S, device=q.device)
        carry = _span_flash(q.reshape(B, S, Hkv, g, hd), k, v, pos, pos,
                            _init_carry(B, Hkv, g, S, hd, q.device), causal=causal,
                            window=window, scale=scale, cap=cap, q_block=q_block,
                            kv_block=kv_block)
        o = _finalize(carry, B, S, Hq, hd).to(q.dtype)
        ctx.save_for_backward(q, k, v, o, carry[0], carry[1])
        ctx.args = dict(causal=causal, window=window, scale=scale, cap=cap)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        dq, dk, dv = flash_backward(*ctx.saved_tensors, do, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _init_carry(b, hk, g, sq, d, device=None):
    return (torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, hk, g, sq), dtype=torch.float32, device=device),
            torch.zeros((b, hk, g, sq, d), dtype=torch.float32, device=device))


def _finalize(carry, b, sq, hq, d):
    m, l, o = carry
    o = o / torch.clamp_min(l, 1e-30)[..., None]          # [b,hk,g,sq,d]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


# ---------------------------------------------------------------------------
# train/prefill: context attention, the sequence sharded over tp
# ---------------------------------------------------------------------------
def attention_path(mode: str, device: torch.device, tp: int = 1) -> str:
    """What computes ``context_attention``'s spans: ``"flash"``, the flash
    op, or ``"span"``, the plain blockwise ``_span_flash``.

    Kernel mode takes the op: at tp = 1 on a CUDA tensor (the whole span,
    one launch), and at tp > 1 on every device (one call a KV-ring hop that
    holds a key it may see; the op runs its plain version on a CPU tensor),
    in the forward and in a remat recompute; the ring's backward is the
    plain ``_span_flash_bwd`` on every path.
    Every other call takes ``_span_flash``: bulk mode (the reference's bulk
    branch, after an all-gather at tp > 1), fused mode (the reference's ring,
    one span a hop) and kernel mode on the CPU at tp = 1 (``_SpanFlash``, for
    its analytic backward)."""
    if mode == "kernel" and (tp > 1 or device.type != "cpu"):
        return "flash"
    return "span"


def _empty_span(q0, sq, k0, sk, causal, window) -> bool:
    """Whether no query in [q0, q0 + sq) sees a key in [k0, k0 + sk): the
    span lies wholly above the diagonal or left of every row's window."""
    return (causal and k0 > q0 + sq - 1) or (window is not None and q0 - (k0 + sk - 1) >= window)


def _merge(a, b):
    """Two online-softmax carries (m, l, o) over disjoint keys, as one (the
    rescaling of decode's ``attention_partial_merge``, without the
    collective).  A carry whose rows saw no key (m = -1e30, l = 0, o = 0)
    leaves the other as it is, to the bit."""
    (ma, la, oa), (mb, lb, ob) = a, b
    m = torch.maximum(ma, mb)
    ca, cb = torch.exp(ma - m), torch.exp(mb - m)
    return m, la * ca + lb * cb, oa * ca[..., None] + ob * cb[..., None]


def _flash_carry(q, k, v, delta, *, causal, window, scale, cap):
    """One span through the flash op with its statistics, as a carry (m, l,
    o) in the layout ``_span_flash`` keeps: m, l [b, hk, g, sq] and o
    unnormalized [b, hk, g, sq, d], f32."""
    B, sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    o, m, l = flash_attention(q, k, v, scale=scale, causal=causal, window=window, softcap=cap,
                              delta=delta, stats=True)
    m, l = m.reshape(B, Hkv, g, sq), l.reshape(B, Hkv, g, sq)
    o = o.float().reshape(B, sq, Hkv, g, hd).permute(0, 2, 3, 1, 4) * l[..., None]
    return m, l, o


def _ring_attention(ctx: ParallelContext, q, k, v, *, mode, hops, causal, window, scale, cap,
                    q_block, kv_block, n_sub, skew, wire):
    """The reference's ``_make_ring_attention`` on this rank's chunks q [B,
    s_loc, Hq, hd], k, v [B, s_loc, Hkv, hd] -> [B, s_loc, Hq, hd]: one
    autograd node (:class:`_RingAttention`), its forward
    :func:`_ring_forward`."""
    return _RingAttention.apply(ctx, q, k, v, dict(
        mode=mode, hops=hops, causal=causal, window=window, scale=scale, cap=cap,
        q_block=q_block, kv_block=kv_block, n_sub=n_sub, skew=skew, wire=wire))


def _ring_forward(ctx: ParallelContext, q, k, v, *, mode, hops, causal, window, scale, cap,
                  q_block, kv_block, n_sub, skew, wire):
    """The ring's forward: returns (o, m, l), m and l the merged softmax
    statistics in ``_span_flash``'s carry layout [B, Hkv, g, s_loc].

    The local chunk is consumed first (it is there at once); its KV is split
    into ``n_sub`` sub-chunks, each rounded once to the wire dtype at its
    source and put on the ring before the local span is computed.  At each
    of ``hops`` hops every sub-chunk is waited on in
    ``sub_chunk_service_order`` (``skew`` rotates it), forwarded at once
    (but after the last hop) and then consumed: sub-chunk j of source rank
    ``src = (d - i) % n`` holds positions ``src * s_loc + j * sub +
    arange(sub)``.  Each sub-chunk ring keeps a carry of its own, merged
    into the local one at the end in sub-chunk order, so the rotation
    reorders only waits and sends: the result has the same bits under any
    ``skew``.

    Fused mode consumes a span with ``_span_flash``, as the reference does;
    kernel mode with the flash op (``stats=True``; on a card the kernel),
    whose (o, m, l) fold into the carry by the online-softmax merge, and
    launches nothing for a span no row sees (wholly above the diagonal or
    left of the window): its partial is exactly empty.  The payload still
    rings on."""
    n, d = ctx.tp, ctx.tp_rank
    B, s_loc, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    sub = s_loc // n_sub
    q0 = d * s_loc
    q5 = q.reshape(B, s_loc, Hkv, g, hd)
    qpos = q0 + torch.arange(s_loc, device=q.device)
    kw = dict(causal=causal, window=window, scale=scale, cap=cap)
    flash = attention_path(mode, q.device, n) == "flash"

    def consume(carry, kc, vc, k0):
        if flash:
            if _empty_span(q0, s_loc, k0, kc.shape[1], causal, window):
                return carry
            part = _flash_carry(q, kc, vc, q0 - k0, **kw)
            return part if carry is None else _merge(carry, part)
        if carry is None:
            carry = _init_carry(B, Hkv, g, s_loc, hd, q.device)
        kpos = k0 + torch.arange(kc.shape[1], device=q.device)
        return _span_flash(q5, kc, vc, qpos, kpos, carry, q_block=q_block, kv_block=kv_block,
                           **kw)

    order = sub_chunk_service_order(n_sub, skew)
    bufs = {j: (wire_cast(ks, wire), wire_cast(vs, wire)) for j, (ks, vs) in
            enumerate(zip(split_ring_payload(k, n_sub), split_ring_payload(v, n_sub)))}
    pending = {}

    def send(j):
        pending[j] = (ring_permute_start(ctx, bufs[j][0]), ring_permute_start(ctx, bufs[j][1]))

    if hops:
        for j in order:
            send(j)
    local = consume(None, k, v, q0)
    rings = [None] * n_sub
    for i in range(1, hops + 1):
        src = (d - i) % n
        for j in order:
            bufs[j] = (pending[j][0](), pending[j][1]())
            if i < hops:
                send(j)
            rings[j] = consume(rings[j], wire_uncast(bufs[j][0], k.dtype),
                               wire_uncast(bufs[j][1], v.dtype), src * s_loc + j * sub)
    for part in rings:
        if part is not None:
            local = _merge(local, part)
    return _finalize(local, B, s_loc, Hq, hd).to(q.dtype), local[0], local[1]


class _RingAttention(torch.autograd.Function):
    """The KV ring as one autograd node.  Forward: :func:`_ring_forward`,
    saving q, k, v, o and the merged (m, l), as the reference's ``fwd_rule``
    does.  Backward: the reference's ``bwd_rule``.  delta = rowsum(do * o);
    ``_span_flash_bwd`` over the local span; then the KV sub-chunk rings
    replayed under the forward's hop bound, service order and wire (the
    payloads round once at their source), each sub-chunk's (dk, dv)
    accumulator travelling with it; one offset permute by ``-hops`` takes
    each accumulator home.  The accumulators travel at the operand dtype
    with an f32 wire, else are cast to the wire on every send; the local
    accumulation is f32.  Every rank posts the same sends and receives in
    the same order; kernel mode skips the compute of a hop no row sees,
    never its sends."""

    @staticmethod
    def forward(fctx, ctx, q, k, v, args):
        o, m, l = _ring_forward(ctx, q, k, v, **args)
        fctx.save_for_backward(q, k, v, o, m, l)
        fctx.pctx, fctx.args = ctx, args
        return o

    @staticmethod
    @once_differentiable
    def backward(fctx, do):
        q, k, v, o, m, l = fctx.saved_tensors
        ctx, a = fctx.pctx, fctx.args
        n, d = ctx.tp, ctx.tp_rank
        B, s_loc, Hq, hd = q.shape
        Hkv = k.shape[2]
        g = Hq // Hkv
        n_sub, hops, wire = a["n_sub"], a["hops"], a["wire"]
        sub = s_loc // n_sub
        compress = wire not in (None, "f32")
        kw = dict(causal=a["causal"], window=a["window"], scale=a["scale"], cap=a["cap"],
                  q_block=a["q_block"], kv_block=a["kv_block"])
        skip = attention_path(a["mode"], q.device, n) == "flash"
        q0 = d * s_loc
        qpos = q0 + torch.arange(s_loc, device=q.device)
        q5 = q.reshape(B, s_loc, Hkv, g, hd)
        do5 = do.float().reshape(B, s_loc, Hkv, g, hd)
        delta = torch.einsum("bqhgd,bqhgd->bhgq", do5, o.reshape(B, s_loc, Hkv, g, hd).float())
        dq5 = torch.zeros(q5.shape, dtype=torch.float32, device=q.device)
        dq5, dk, dv = _span_flash_bwd(q5, k, v, do5, delta, m, l, qpos, qpos, dq5, **kw)
        # the travelling accumulators: at the operand dtype with an f32 wire,
        # f32 (cast to the wire on each send) with a compressed one
        rest = (lambda t, ref: t) if compress else (lambda t, ref: t.to(ref.dtype))
        dks = [rest(t, k) for t in split_ring_payload(dk, n_sub)]
        dvs = [rest(t, v) for t in split_ring_payload(dv, n_sub)]
        kbufs = [wire_cast(t, wire) for t in split_ring_payload(k, n_sub)]
        vbufs = [wire_cast(t, wire) for t in split_ring_payload(v, n_sub)]
        order = sub_chunk_service_order(n_sub, a["skew"])

        dsend = lambda t, shift=1: accumulator_permute_start(ctx, t, wire, shift)
        # with sub-chunks, each sub-chunk ring adds its dq into an
        # accumulator of its own, summed in sub-chunk order at the end, so
        # that a skew (which reorders the service) changes no bit
        dq_ring = [dq5] * n_sub if n_sub == 1 else [None] * n_sub
        kv_wait, d_wait = {}, {}
        if hops:
            for j in order:
                kv_wait[j] = (ring_permute_start(ctx, kbufs[j]), ring_permute_start(ctx, vbufs[j]))
                d_wait[j] = (dsend(dks[j]), dsend(dvs[j]))
        for i in range(1, hops + 1):
            src = (d - i) % n
            for j in order:
                kbufs[j], vbufs[j] = kv_wait[j][0](), kv_wait[j][1]()
                if i < hops:
                    kv_wait[j] = (ring_permute_start(ctx, kbufs[j]),
                                  ring_permute_start(ctx, vbufs[j]))
                dk_j, dv_j = d_wait[j][0]().float(), d_wait[j][1]().float()
                k0 = src * s_loc + j * sub
                if not (skip and _empty_span(q0, s_loc, k0, sub, a["causal"], a["window"])):
                    kpos = k0 + torch.arange(sub, device=q.device)
                    if dq_ring[j] is None:
                        dq_ring[j] = torch.zeros_like(dq5)
                    dq_ring[j], dk_j, dv_j = _span_flash_bwd(
                        q5, wire_uncast(kbufs[j], k.dtype), wire_uncast(vbufs[j], v.dtype), do5,
                        delta, m, l, qpos, kpos, dq_ring[j], dk0=dk_j, dv0=dv_j, **kw)
                dks[j], dvs[j] = rest(dk_j, k), rest(dv_j, v)
                if i < hops:
                    d_wait[j] = (dsend(dks[j]), dsend(dvs[j]))
        # each accumulator rests hops ranks ahead of its chunk's owner: one
        # offset permute home
        if hops % n:
            home = [(dsend(dks[j], -hops), dsend(dvs[j], -hops)) for j in range(n_sub)]
            for j, (wk, wv) in enumerate(home):
                dks[j], dvs[j] = wk(), wv()
        if n_sub > 1:
            for part in dq_ring:
                if part is not None:
                    dq5 += part
        dk = dks[0] if n_sub == 1 else torch.cat(dks, dim=1)
        dv = dvs[0] if n_sub == 1 else torch.cat(dvs, dim=1)
        return (None, dq5.reshape(B, s_loc, Hq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None)


def context_attention(
    ctx: ParallelContext,
    q, k, v,                  # [B, S / tp, Hq|Hkv, hd]: this rank's chunk of the sequence
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    softcap_val: float | None = None,
    mode: str | None = None,
    q_block: int = Q_BLOCK,
    kv_block: int = KV_BLOCK,
    chunks_per_rank: int | str | None = None,
    skew: int | None = None,
    wire: str | None = None,
):
    """Attention of every position of this rank's chunk over the prompt, at
    q's dtype.  Rank d holds positions ``[d * S / tp, (d + 1) * S / tp)``.

    ``mode`` defaults to ``ctx.fusion.resolve("kv_ag")``.  ``bulk``: the
    reference's bulk branch, an all-gather of k and v (none at tp = 1) and
    ``span_attention`` over all S keys, on any device.  ``fused`` and
    ``kernel``: the KV ring (:func:`_ring_attention`) at tp > 1; at tp = 1
    it has no hop, and kernel mode on a CUDA tensor runs the whole span in
    the flash kernel, ``window`` and ``softcap_val`` included, while fused
    mode, and kernel mode on the CPU, run ``_SpanFlash`` (the plain span;
    :func:`attention_path`).  A windowed causal layer bounds the ring at
    ``ceil(window / s_loc)`` hops, as the reference's does (not in bulk
    mode).  ``chunks_per_rank`` (``None``: ``ctx.fusion.granularity``;
    ``"auto"``: ``tune_ring_attention``), ``skew`` and ``wire`` are the
    ring's, defaulting to ``ctx.fusion``'s.

    Gradients: bulk mode's is autograd through ``_span_flash`` (and at tp >
    1 through the all-gather, whose backward reduce-scatters the cotangents
    of k and v), as the reference's bulk branch; fused and kernel mode's the
    analytic one of the reference's ring ``bwd_rule``: at tp = 1
    ``flash_backward`` (on a card in kernel mode the flash op's backward),
    at tp > 1 :class:`_RingAttention`'s, which replays the ring (the same
    hop bound, sub-chunks, skew and wire) with each sub-chunk's (dk, dv)
    accumulator travelling with it.  Kernel mode's backward is that plain
    backward on every hop, the flash kernel running only in the forward
    (and in a remat recompute)."""
    mode = mode or ctx.fusion.resolve("kv_ag")
    if mode not in ("bulk", "fused", "kernel"):
        raise ValueError(f"context_attention: unknown mode {mode!r}")
    n = ctx.tp
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if mode == "bulk":
        if n > 1:
            k, v = all_gather(ctx, k, axis=1), all_gather(ctx, v, axis=1)
        return span_attention(q, k, v, causal=causal, window=window, scale=scale,
                              cap=softcap_val, q_block=q_block, kv_block=kv_block,
                              q0=ctx.tp_rank * q.shape[1])
    if n == 1:
        if attention_path(mode, q.device) == "flash":
            return flash_attention(q, k, v, scale=scale, causal=causal, window=window,
                                   softcap=softcap_val)
        return _SpanFlash.apply(q, k, v, causal, window, scale, softcap_val, q_block, kv_block)
    B, s_loc, Hq, hd = q.shape
    hops = n - 1
    if window is not None and causal:
        hops = min(n - 1, -(-window // s_loc))
    skew = ctx.fusion.skew if skew is None else int(skew)
    dec = resolve_overlap(
        chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
        lambda fq, wr: tune_ring_attention(
            B, s_loc, Hq, k.shape[2], hd, dtype_bytes=k.element_size(), n_dev=n, hops=hops,
            hw=ctx.hw, skew=skew, wire=wr, fixed_q=fq),
        dim=s_loc, ring=1)
    return _ring_attention(ctx, q, k, v, mode=mode, hops=hops, causal=causal, window=window,
                           scale=scale, cap=softcap_val, q_block=q_block, kv_block=kv_block,
                           n_sub=dec.q, skew=skew, wire=dec.wire)


def span_attention(q, k, v, *, causal, window, scale, cap, q_block=Q_BLOCK, kv_block=KV_BLOCK,
                   q0=0):
    """The plain blockwise attention of queries at positions ``q0 + arange(Sq)``
    over keys at ``arange(Sk)``, on any device: q [B, Sq, Hq, hd], k, v [B,
    Sk, Hkv, hd] -> [B, Sq, Hq, hd] at q's dtype."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qpos = q0 + torch.arange(S, device=q.device)
    carry = _span_flash(q.reshape(B, S, Hkv, g, hd), k, v, qpos,
                        torch.arange(k.shape[1], device=q.device),
                        _init_carry(B, Hkv, g, S, hd, q.device), causal=causal,
                        window=window, scale=scale, cap=cap, q_block=q_block,
                        kv_block=kv_block)
    return _finalize(carry, B, S, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# decode: dense KV cache
# ---------------------------------------------------------------------------
def broadcast_pos(pos, B, device=None):
    """Normalize a decode position to a per-slot vector [B] int32.

    Accepts one shared position (every slot at the same offset) or a
    per-slot ``[B]`` vector."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return p.expand(B).contiguous()


def decode_attention(
    ctx: ParallelContext,
    q,                  # [B, 1, Hq, hd], the same on every rank
    k_cache, v_cache,   # [B, S_local, Hkv, hd]: this rank's rows of the cache
    pos,                # [B] (or scalar) int32 per-slot position (kv written)
    *,
    window: int | None = None,
    scale: float | None = None,
    softcap_val: float | None = None,
):
    """One-token GQA attention of each slot over its cache rows 0..pos[b]
    (the last ``window`` of them when ``window`` is set).  Each rank attends
    over its ``S_local`` rows and the partials merge across the ranks.  The
    QK product runs in the compute dtype and is then cast to f32, like the
    reference; softmax and the PV product run in f32."""
    B, s_loc, Hkv, hd = k_cache.shape
    Hq = q.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    pos = broadcast_pos(pos, B, q.device)
    q5 = q.reshape(B, 1, Hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k_cache).float() * scale
    if softcap_val is not None:
        s = torch.tanh(s / softcap_val) * softcap_val
    kpos = torch.arange(s_loc, device=q.device)
    if ctx.tp > 1:
        kpos = kpos + ctx.tp_rank * s_loc
    valid = kpos[None, :] <= pos[:, None]              # [B, S_local] per slot
    if window is not None:
        valid &= pos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", pr, v_cache.float())
    o = attention_partial_merge(ctx, o, m, l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, hd).to(q.dtype)


def cache_update(ctx: ParallelContext, cache, new, pos):
    """Write ``new`` [B, 1, *rest] into this rank's rows of a
    sequence-sharded cache [B, S_local, *rest] in place, row ``b`` at its
    own position ``pos[b]``, and return ``cache``.

    Only the rank owning the position writes (``pos - d * S_local`` inside
    ``[0, S_local)``); a position at or past ``S_max`` is dropped (the
    engine retires a slot before it reaches the bound, so a write past the
    end must not rewrite the last row).  A dropped row rewrites a row with
    its own value, so the update needs no host synchronisation."""
    B, s_loc = cache.shape[:2]
    pos = broadcast_pos(pos, B, cache.device).long()
    local = pos - ctx.tp_rank * s_loc if ctx.tp > 1 else pos
    keep = local < s_loc
    if ctx.tp > 1:
        keep &= local >= 0
    rows = local.clamp(0, s_loc - 1)
    b = torch.arange(B, device=cache.device)
    keep = keep.reshape((B,) + (1,) * (cache.dim() - 2))
    cache[b, rows] = torch.where(keep, new[:, 0].to(cache.dtype), cache[b, rows])
    return cache


# ---------------------------------------------------------------------------
# paged KV: block pool + per-request block tables (continuous batching)
# ---------------------------------------------------------------------------
# The dense decode cache above is [B, S_max, ...]: every slot pays for the
# longest request it might serve.  The paged layout shares one pool of
# fixed-size blocks among all in-flight requests; a per-request block table
# [B, MB] maps the request's sequence block m to the pool block that holds
# it (allocation lives host-side in repro_torch.serve.kv_cache, which
# stripes a request's blocks over the ranks).  The reference shards the
# blocks contiguously over tp and merges per-rank partials; on one card
# every block is local and the merge is the one-rank normalisation.
#
# Layout: a rank's layer pool is [NB / tp + 1, block, *rest].  Blocks
# 0..NB/tp-1 are its stripe of the allocator's global blocks (global block
# g is local block g - d NB / tp on rank d), laid out as the reference's
# shard of [NB, block, *rest]; the last block is this rank's sink, which no
# table names.  Every write the reference drops (a row past a
# slot's n_new, an idle slot, a sentinel (-1) table entry, a position past
# the table) is aimed at the sink instead: a boolean filter would call
# nonzero (a host synchronisation), an out-of-range index is a device-side
# assert on CUDA, and clamping a dropped write onto a live block could alias
# a live write to the same (block, slot), where index_put_'s winner is
# undefined.  A write to another rank's block is dropped the same way.  The
# sink alone takes duplicate writes, and no read gathers it.


def _stripe(ctx: ParallelContext, nb_loc: int, g):
    """Global block ids ``g`` (-1 for none) -> (this rank's local ids,
    whether this rank holds each): rank d holds ``[d nb_loc, (d + 1)
    nb_loc)``."""
    local = g - ctx.tp_rank * nb_loc if ctx.tp > 1 else g
    return local, (g >= 0) & (local >= 0) & (local < nb_loc)

def paged_cache_update(ctx: ParallelContext, pool, new, tables, pos, valid):
    """Scatter a token chunk into this rank's stripe of the block pool, in
    place; returns ``pool``.

    pool: [NB / tp + 1, block, *rest] (the last block this rank's sink);
    new: [B, C, *rest], the same on every rank; tables: [B, MB] global
    block ids (-1 for none); pos: [B, C] global positions; valid: [B, C]
    bool (False rows, padding past a slot's ``n_new`` or idle slots, are
    dropped).  A position whose block index falls outside the table, or
    whose table entry is not a block of this rank's stripe, is dropped too,
    never clamped: all dropped rows land in the sink block."""
    nb_loc, block = pool.shape[0] - 1, pool.shape[1]
    B, C = pos.shape
    MB = tables.shape[1]
    pos = pos.long()
    blk = pos // block                                 # [B, C] sequence block
    g = torch.gather(tables.long(), 1, blk.clamp(0, MB - 1))
    local, own = _stripe(ctx, nb_loc, g)
    keep = valid & (blk < MB) & own
    rows = torch.where(keep, local, nb_loc).reshape(-1)
    slots = (pos % block).reshape(-1)
    pool[rows, slots] = new.reshape((B * C,) + tuple(new.shape[2:])).to(pool.dtype)
    return pool


def paged_attention(
    ctx: ParallelContext,
    q,                  # [B, C, Hq, hd], the same on every rank
    pool_k, pool_v,     # [NB / tp + 1, block, Hkv, hd], the last block the sink
    tables,             # [B, MB] int32 global block ids (-1 for none)
    pos,                # [B, C] global position of each query token
    *,
    window: int | None = None,
    scale: float | None = None,
    softcap_val: float | None = None,
    kv_block: int = 1024,
):
    """Flash attention of a token chunk against a paged KV pool.

    The table's blocks this rank holds are gathered (any other entry as
    local block 0, masked out) and run through ``_flash_update`` span by
    span, ``kv_block // block`` table blocks a span, with per-query causal
    and window masks: the chunk's own KV is already in the pool, so one
    pass covers both the cache and causality within the chunk; the ranks'
    partials then merge (``attention_partial_merge``).  C = 1 is the decode
    step; C > 1 a prefill chunk; one call mixes both through the per-slot
    positions.  QK runs in q's dtype and is then cast to f32; softmax and
    PV run in f32; the output is at q's dtype."""
    nb_loc, block, Hkv, hd = pool_k.shape[0] - 1, *pool_k.shape[1:]
    B, C, Hq, _ = q.shape
    g = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    MB = tables.shape[1]
    span = max(1, min(MB, kv_block // block))   # table blocks per flash span
    q5 = q.reshape(B, C, Hkv, g, hd)
    local, own = _stripe(ctx, nb_loc, tables.long())
    rows = torch.where(own, local, 0)
    kg, vg = pool_k[rows], pool_v[rows]                 # [B, MB, block, Hkv, hd]
    p = pos[:, :, None]
    carry = _init_carry(B, Hkv, g, C, hd, q.device)
    for m0 in range(0, MB, span):
        me = min(MB, m0 + span)
        sk = (me - m0) * block
        ks = kg[:, m0:me].reshape(B, sk, Hkv, hd)
        vs = vg[:, m0:me].reshape(B, sk, Hkv, hd)
        kpos = m0 * block + torch.arange(sk, device=q.device)
        ownmask = own[:, m0:me, None].expand(B, me - m0, block).reshape(B, sk)
        mask = ownmask[:, None, :] & (kpos <= p)            # [B, C, sk]
        if window is not None:
            mask &= p - kpos < window
        carry = _flash_update(carry, q5, ks, vs, mask, scale, softcap_val)
    m, l, o = carry
    o = attention_partial_merge(ctx, o, m, l)               # [B, Hkv, g, C, hd]
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, hd).to(q.dtype)
