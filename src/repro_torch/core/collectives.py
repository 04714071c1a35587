"""Decomposed compute-collective combinators (the paper's core, SPMD).

The paper's GPU kernels put each output slice on the wire the moment its
workgroups finish it.  ``fused`` mode does the same at the level of whole
products: the op is cut into chunks, each chunk's point-to-point send (a
ring hop, or a direct send at an offset) is issued right after the chunk
is computed, and waited on only where the value it carries is consumed,
so the next chunk's product runs while the send is in flight.  On a host
with several cards and NCCL that order lets the two overlap; a world of
processes sharing one card, whose gloo wire goes through host memory,
cannot show it, and nothing here has been timed with real peers.

Every function runs on every rank of the tp world (``ctx.tp`` ranks in
``ctx.group``) on that rank's shard, like the body of the reference's
``shard_map``.  A world of one rank makes no call to ``torch.distributed``.

Every payload meets the backend in one place, :func:`_on_wire`: a gloo
world handed CUDA tensors moves them through pinned host buffers (gloo
takes CPU tensors), which :func:`wire_staged` decides from the world's
backend and the tensor's device alone; an NCCL world never stages.  fp8
payloads travel as their ``uint8`` bytes (gloo has no float8 type).

The bulk collectives are differentiable (their backward is the reference's
transpose: an all-gather's is a reduce-scatter of the cotangents, an
all-reduce passes its replicated cotangent through); the rings are not, on
their own: each op that runs a ring is one ``torch.autograd.Function``
whose backward runs the dual ring, so that every rank posts the same sends
and receives in the same order.  :func:`all_reduce_grads` sums the
gradients of the leaves every rank holds whole.

The data axis (dp > 1): ``ctx.data`` is the data group as a context of its
own, so the same collectives run over it (:func:`all_gather_data`,
:func:`reduce_scatter_data`, :func:`data_mean`, :func:`fsdp_gather`).  The
flattened (dp, tp) world is ``ctx.world`` (world rank ``d * tp + m``): the
all-to-alls take ``group="world"`` (DLRM's exchange) and :func:`world_mean`
averages over it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.scheduling import ring_offsets, sub_chunk_service_order
from repro_torch.parallel.sharding import ParallelContext, segmented_dims, split_contexts

# ---------------------------------------------------------------------------
# wire-fault injection hook (chaos engineering)
# ---------------------------------------------------------------------------
# Applied to every payload leaf as it goes on the wire (ring hops, direct
# sends and the phase-2 all-gather), as in the reference.  ``None``, the
# default, leaves the payload as it is.  The chaos runtime
# (``runtime/chaos.wire_faults``) installs a corruptor here to reproduce
# flipped-link / NaN-payload faults inside the real rings; it is read as
# each payload is sent, so a step run inside it runs poisoned.
_WIRE_FAULT_HOOK = None


def set_wire_fault_hook(hook):
    """Install (or clear, with ``None``) the wire-fault hook.  Returns the
    previous hook so scoped injectors can restore it."""
    global _WIRE_FAULT_HOOK
    prev = _WIRE_FAULT_HOOK
    _WIRE_FAULT_HOOK = hook
    return prev


def _wire_fault(leaf):
    return leaf if _WIRE_FAULT_HOOK is None else _WIRE_FAULT_HOOK(leaf)


# ---------------------------------------------------------------------------
# the one place a payload meets the backend
# ---------------------------------------------------------------------------
def wire_staged(backend: str | None, device) -> bool:
    """Whether payloads go through host memory: in a gloo world handed CUDA
    tensors (gloo's send, receive and reductions take CPU tensors).  An
    NCCL world, and a CPU tensor, never stage."""
    return backend == "gloo" and torch.device(device).type == "cuda"


def _bytes(t):
    """The tensor the backend takes: fp8 as its uint8 bytes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _like(t):
    """A new contiguous tensor of t's shape, dtype and device (the backends
    take contiguous tensors)."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _on_wire(ctx: ParallelContext, op: Callable, ins, outs) -> Callable:
    """Run the collective ``op(ins, outs)`` (it returns its ``Work``
    handles) on tensors the world's backend takes, and return the function
    that finishes it: it waits, moves staged results into ``outs`` and
    returns ``outs``.

    Staging (:func:`wire_staged`) copies each input to a pinned host buffer
    and receives into pinned host buffers, which the finisher copies back
    to the card."""
    ins = [_bytes(t.contiguous()) for t in ins]
    outs_b = [_bytes(t) for t in outs]
    staged = wire_staged(ctx.backend, outs_b[0].device)
    if staged:
        host = lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        # the copy to the host waits for the card, so the payload is complete
        ins = [host(t).copy_(t) for t in ins]
        bufs = [host(t) for t in outs_b]
    else:
        bufs = outs_b
    works = op(ins, bufs)

    def finish():
        for w in works:
            w.wait()
        if staged:
            for o, b in zip(outs_b, bufs):
                o.copy_(b, non_blocking=True)
        return outs
    return finish


def _all_reduce(ctx: ParallelContext, x, op: str = "sum"):
    """``x`` reduced over the tp ranks at x's dtype, into a new tensor; no
    autograd."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def run(ins, bufs):
        bufs[0].copy_(ins[0])
        return [dist.all_reduce(bufs[0], red, group=ctx.group, async_op=True)]
    return _on_wire(ctx, run, [x], [_like(x)])()[0]


class _AllReduce(torch.autograd.Function):
    """The SUM all-reduce of a replicated result: its backward passes the
    cotangent through unchanged (Megatron's "g").  The output is the same on
    every rank and every rank consumes it in the same way, so each rank
    already holds the whole cotangent; summing it again would make the
    gradient tp times too large."""

    @staticmethod
    def forward(fctx, ctx, x):
        return _all_reduce(ctx, x)

    @staticmethod
    def backward(fctx, g):
        return None, g


def all_reduce(ctx: ParallelContext, x):
    """``x`` summed over the tp ranks at x's dtype, into a new tensor; ``x``
    itself at tp = 1.  Differentiable (:class:`_AllReduce`)."""
    return x if ctx.tp == 1 else _AllReduce.apply(ctx, x)


def broadcast(ctx: ParallelContext, x, src: int):
    """tp rank ``src``'s ``x`` on every rank, into a new tensor (every rank
    passes a tensor of its shape and dtype; the others' values are unread);
    ``x`` itself at tp = 1."""
    if ctx.tp == 1:
        return x

    def run(ins, bufs):
        bufs[0].copy_(ins[0])
        return [dist.broadcast(bufs[0], ctx.peer(src), group=ctx.group, async_op=True)]
    return _on_wire(ctx, run, [x], [_like(x)])()[0]


def _all_gather(ctx: ParallelContext, x) -> list:
    """Every rank's ``x``, in tp-rank order."""
    return _on_wire(ctx, lambda ins, bufs: [dist.all_gather(bufs, ins[0], group=ctx.group,
                                                            async_op=True)],
                    [x], [_like(x) for _ in range(ctx.tp)])()


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``axis``.  Every rank consumes
    the gathered tensor in its own way (its own query rows), so the
    backward is a reduce-scatter of the cotangents: the sum over the ranks
    of this rank's slice."""

    @staticmethod
    def forward(fctx, ctx, x, axis):
        fctx.pctx, fctx.axis = ctx, axis
        return torch.cat(_all_gather(ctx, x), dim=axis)

    @staticmethod
    def backward(fctx, g):
        return None, _reduce_scatter(fctx.pctx, g, fctx.axis), None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the ranks of ``x``, this rank's slice along ``axis``;
    the backward is an all-gather of the cotangents."""

    @staticmethod
    def forward(fctx, ctx, x, axis):
        fctx.pctx, fctx.axis = ctx, axis
        return _reduce_scatter(ctx, x, axis)

    @staticmethod
    def backward(fctx, g):
        return None, torch.cat(_all_gather(fctx.pctx, g), dim=fctx.axis), None


def _reduce_scatter(ctx: ParallelContext, x, axis: int):
    """This rank's slice along ``axis`` of the sum over the ranks (a SUM
    all-reduce, then the slice: gloo has no reduce-scatter of its own)."""
    size = x.shape[axis] // ctx.tp
    return _all_reduce(ctx, x).narrow(axis, ctx.tp_rank * size, size).contiguous()


class _CopyToTp(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the tp ranks
    (Megatron's "f").  For a value the same on every rank that each rank
    consumes in its own way (its own heads): each rank's cotangent is its
    own part of the whole one."""

    @staticmethod
    def forward(fctx, ctx, x):
        fctx.pctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return None, _all_reduce(fctx.pctx, g.contiguous())


def copy_to_tp(ctx: ParallelContext, x):
    """``x`` itself, whose gradient is summed over the tp ranks
    (:class:`_CopyToTp`); ``x`` at tp = 1."""
    return x if ctx.tp == 1 else _CopyToTp.apply(ctx, x)


class _SplitToTp(torch.autograd.Function):
    """This rank's chunk along ``axis`` of a value the same on every rank;
    the backward all-gathers the chunks' cotangents, each the whole one of
    its chunk."""

    @staticmethod
    def forward(fctx, ctx, x, axis):
        fctx.pctx, fctx.axis = ctx, axis
        size = x.shape[axis] // ctx.tp
        return x.narrow(axis, ctx.tp_rank * size, size).contiguous()

    @staticmethod
    def backward(fctx, g):
        return None, torch.cat(_all_gather(fctx.pctx, g.contiguous()), dim=fctx.axis), None


class _GatherFromTp(torch.autograd.Function):
    """Every rank's chunk joined along ``axis`` into a value that every rank
    then consumes in the same way; the backward keeps this rank's chunk of
    the cotangent, which every rank holds whole."""

    @staticmethod
    def forward(fctx, ctx, x, axis):
        fctx.pctx, fctx.axis = ctx, axis
        return torch.cat(_all_gather(ctx, x.contiguous()), dim=axis)

    @staticmethod
    def backward(fctx, g):
        ctx, axis = fctx.pctx, fctx.axis
        size = g.shape[axis] // ctx.tp
        return None, g.narrow(axis, ctx.tp_rank * size, size).contiguous(), None


def split_to_tp(ctx: ParallelContext, x, *, axis: int):
    """This rank's chunk along ``axis`` of ``x``, the same on every rank
    (:class:`_SplitToTp`); ``x`` at tp = 1."""
    return x if ctx.tp == 1 else _SplitToTp.apply(ctx, x, axis)


def gather_from_tp(ctx: ParallelContext, x, *, axis: int):
    """Every rank's chunk ``x`` joined along ``axis``, for a use that every
    rank makes alike (:class:`_GatherFromTp`); ``x`` at tp = 1."""
    return x if ctx.tp == 1 else _GatherFromTp.apply(ctx, x, axis)


def all_gather(ctx: ParallelContext, x, *, axis: int = 0):
    """Every rank's ``x`` concatenated along ``axis`` in tp-rank order (the
    gather GSPMD inserts where the reference reads a sharded array whole);
    ``x`` itself at tp = 1.  Differentiable (:class:`_AllGather`)."""
    if ctx.tp == 1:
        return x
    return _AllGather.apply(ctx, x, axis)


def reduce_scatter(ctx: ParallelContext, x, *, axis: int = 0):
    """This rank's slice along ``axis`` of the sum of ``x`` over the tp
    ranks (``axis`` must split into tp equal slices); ``x`` itself at tp =
    1.  Differentiable (:class:`_ReduceScatter`)."""
    if ctx.tp == 1:
        return x
    if x.shape[axis] % ctx.tp:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} does not split over "
                         f"tp={ctx.tp}")
    return _ReduceScatter.apply(ctx, x, axis)


def all_reduce_grads(ctx: ParallelContext, grads: list, specs: list) -> list:
    """Sum, in place, each gradient over the ranks that hold its leaf whole
    (``grads`` and ``specs``, the leaves' logical specs, are aligned
    lists): over the tp ranks a leaf whose spec names no tp axis (each
    rank's gradient a partial over its own tokens), then over the data
    ranks a leaf whose spec names no data axis (each replica's a partial
    over its own rows; an fsdp-sharded leaf's gradient was reduce-scattered
    over the data ranks by :class:`_FsdpGather`'s backward).  The loss a
    replica differentiates is already the global mean (:func:`data_mean`),
    so the sums are the gradient of the global mean loss.  The gradients of
    each dtype travel flattened in one buffer: one all-reduce a dtype and
    axis.  A no-op in a world of one rank.  Returns ``grads``."""
    from repro_torch.parallel.sharding import splits_over_data, splits_over_tp

    if ctx.tp > 1:
        _sum_flat(ctx, [g for g, spec in zip(grads, specs) if not splits_over_tp(spec)])
    if ctx.dp > 1:
        _sum_flat(ctx.data, [g for g, spec in zip(grads, specs) if not splits_over_data(spec)])
    return grads


def _sum_flat(ctx: ParallelContext, grads: list):
    """``grads`` summed in place over ``ctx``'s tp ranks, one flattened
    all-reduce a dtype."""
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = _all_reduce(ctx, torch.cat([g.reshape(-1) for g in group]))
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


# ---------------------------------------------------------------------------
# the data axis: the same collectives over the data group
# ---------------------------------------------------------------------------
def all_gather_data(ctx: ParallelContext, x, *, axis: int = 0):
    """Every data replica's ``x`` concatenated along ``axis`` in data-rank
    order (the rows of a batch split over data); ``x`` itself at dp = 1.
    Differentiable (a reduce-scatter of the cotangents over data)."""
    return x if ctx.dp == 1 else all_gather(ctx.data, x, axis=axis)


def gather_logits(ctx: ParallelContext, logits, rows_split: bool):
    """A rank's logits [b, 1, V_local] -> [B, 1, V] on every rank: gathered
    over the vocabulary's tp ranks, and over data where the replicas split
    the rows."""
    logits = all_gather(ctx, logits, axis=-1)
    return all_gather_data(ctx, logits) if rows_split else logits


def reduce_scatter_data(ctx: ParallelContext, x, *, axis: int = 0):
    """This data rank's slice along ``axis`` of the sum of ``x`` over the
    data replicas; ``x`` itself at dp = 1.  Differentiable."""
    return x if ctx.dp == 1 else reduce_scatter(ctx.data, x, axis=axis)


def data_mean(ctx: ParallelContext, x):
    """The mean of ``x`` over the data replicas, the same on every rank (a
    replica's mean loss -> the global mean); ``x`` itself at dp = 1.  Its
    backward hands each replica ``1 / dp`` of the cotangent."""
    return x if ctx.dp == 1 else all_reduce(ctx.data, x) / ctx.dp


def world_mean(ctx: ParallelContext, x):
    """The mean of ``x`` over all ``dp * tp`` ranks of the flattened world,
    the same on every rank (a rank's mean loss over its rows -> the global
    mean); ``x`` itself in a world of one rank.  Its backward hands each
    rank ``1 / (dp * tp)`` of the cotangent."""
    n = ctx.tp * ctx.dp
    return x if n == 1 else all_reduce(ctx.world, x) / n


class _FsdpGather(_AllGather):
    """An fsdp-sharded weight made whole for its use: the data replicas'
    shards all-gathered along ``axis``; the backward reduce-scatters the
    whole weight's gradient over the data ranks (each replica's partial
    over its rows), leaving this rank its shard's sum.  Every rank of a data
    group runs the same layers in the same order, so the gathers and,
    in the backward, the reduce-scatters come in the same order on each."""


def fsdp_gather(ctx: ParallelContext, w, spec):
    """``w``, this rank's training shard of a leaf of logical ``spec``, whole
    over the data ranks (:class:`_FsdpGather` along its ``"fsdp"`` dim);
    ``w`` itself at dp = 1 or where the spec names no data axis."""
    from repro_torch.parallel.sharding import _DATA_AXES

    dims = [i for i, ax in enumerate(spec) if ax in _DATA_AXES]
    if ctx.dp == 1 or not dims:
        return w
    return _FsdpGather.apply(ctx.data, w, dims[0])


@torch.no_grad()
def gather_leaf(ctx: ParallelContext, x, spec, training: bool = False):
    """The whole leaf from every rank's part ``x`` under its logical
    ``spec`` (the inverse of ``parallel.sharding.shard_leaf``): one
    all-gather over each group that splits a dim, a segmented dim first
    (joined segment by segment, a whole segment taken from tp rank 0), then
    the others in dim order, so every rank of the world must call it; ``x``
    itself where nothing splits."""
    for dim, ax in segmented_dims(spec, ctx):
        parts, out, off = _all_gather(ctx, x.contiguous()), [], 0
        for size, whole in ax.local(ctx.tp):
            out += [parts[0].narrow(dim, off, size)] if whole else \
                [p.narrow(dim, off, size) for p in parts]
            off += size
        x = torch.cat(out, dim=dim)
    for dim, sub in split_contexts(spec, ctx, training):
        x = torch.cat(_all_gather(sub, x.contiguous()), dim=dim)
    return x


def _leaves(payload):
    return list(payload) if isinstance(payload, tuple) else [payload]


def ring_permute_start(ctx: ParallelContext, x, shift: int = 1) -> Callable:
    """Send ``x`` to tp rank ``(d + shift) % n`` and receive the payload of
    rank ``(d - shift) % n`` (the reference's ``_ring_perm``); returns the
    function that waits and gives the received payload.  A tuple payload
    (fp8 values and their scale) permutes each leaf."""
    n, d = ctx.tp, ctx.tp_rank
    if shift % n == 0:        # every rank keeps its own payload
        return lambda: x
    leaves = [_wire_fault(t) for t in _leaves(x)]
    outs = [_like(t) for t in leaves]
    dst, src = ctx.peer((d + shift) % n), ctx.peer((d - shift) % n)

    def op(ins, bufs):
        ops = [dist.P2POp(dist.isend, t, dst, ctx.group) for t in ins]
        ops += [dist.P2POp(dist.irecv, b, src, ctx.group) for b in bufs]
        return dist.batch_isend_irecv(ops)

    finish = _on_wire(ctx, op, leaves, outs)

    def wait():
        got = finish()
        return tuple(got) if isinstance(x, tuple) else got[0]
    return wait


def ring_permute(ctx: ParallelContext, x, shift: int = 1):
    """:func:`ring_permute_start`, waited on at once."""
    return ring_permute_start(ctx, x, shift)()


def accumulator_permute_start(ctx: ParallelContext, acc, wire: str, shift: int = 1) -> Callable:
    """:func:`ring_permute_start` of a gradient accumulator that travels a
    backward ring with its chunk (the KV ring's dk and dv, the CE ring's
    dx): with an f32 wire it travels as it is (the callers keep it at the
    operand dtype); with a compressed one it is cast to the wire on this
    send and lands back in f32 for the next local add."""
    if wire in (None, "f32"):
        return ring_permute_start(ctx, acc, shift)
    wait = ring_permute_start(ctx, wire_cast(acc, wire), shift)
    return lambda: wire_uncast(wait(), torch.float32)


# ---------------------------------------------------------------------------
# wire-dtype compression (CoCoNet-style fused precision conversion)
# ---------------------------------------------------------------------------
# "f32" is the uncompressed setting: the payload travels at the op's
# compute dtype.
WIRE_DTYPES = ("f32", "bf16", "fp8")
WIRE_SETTINGS = WIRE_DTYPES + ("auto",)
FP8_MAX = 448.0  # float8_e4m3fn finite max


def wire_itemsize(wire: str, dtype_bytes: int) -> int:
    """Bytes per element on the wire.  The wire is never widened: a bf16
    model under ``wire="bf16"`` already travels at 2 bytes."""
    if wire == "bf16":
        return min(2, int(dtype_bytes))
    if wire == "fp8":
        return min(1, int(dtype_bytes))
    return int(dtype_bytes)


def _passthrough(x, wire: str) -> bool:
    if wire in (None, "f32"):
        return True
    if not x.dtype.is_floating_point:
        return True  # integer payloads (routing ids, ...) stay exact
    return x.element_size() <= wire_itemsize(wire, x.element_size())


def wire_cast(x, wire: str):
    """Compress one ring/A2A payload chunk for the wire.

    bf16: a plain narrowing cast.  fp8: ``float8_e4m3fn`` values with a
    per-chunk max-abs scale riding alongside as a ``(values, scale)`` pair;
    the scale is a [1] f32 tensor, so it travels like any payload.
    ``wire="f32"`` (and any non-narrowing combination) returns ``x``."""
    if wire not in WIRE_DTYPES and wire is not None:
        raise ValueError(f"unknown wire dtype {wire!r}; expected one of {WIRE_DTYPES}")
    if _passthrough(x, wire):
        return x
    if wire == "bf16":
        return x.to(torch.bfloat16)
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-30) / FP8_MAX
    return (xf / scale).to(torch.float8_e4m3fn), scale.reshape(1)


def wire_uncast(payload, dtype):
    """Decompress a :func:`wire_cast` payload back to ``dtype`` (callers pass
    f32 where the value feeds a local accumulation)."""
    if isinstance(payload, tuple):
        q, scale = payload
        return (q.float() * scale[0]).to(dtype)
    return payload.to(dtype)


def all_gather_wire(ctx: ParallelContext, x, *, axis: int = 0, wire: str = "f32"):
    """Every rank's ``x`` concatenated along ``axis`` in tp-rank order (the
    reference's tiled ``all_gather``), each rank's chunk compressed to the
    wire dtype (the phase-2 all-gather of the fused AllReduce).
    ``wire="f32"`` is the exact gather; at tp = 1 a compressing wire still
    rounds, as the reference's does."""
    p = x if _passthrough(x, wire) else wire_cast(x, wire)
    if ctx.tp == 1:
        return x if p is x else wire_uncast(p, x.dtype)
    if isinstance(p, tuple):
        qs, ss = _all_gather(ctx, _wire_fault(p[0])), _all_gather(ctx, p[1])
        return torch.cat([wire_uncast((q, s), torch.float32) for q, s in zip(qs, ss)],
                         dim=axis).to(x.dtype)
    return torch.cat(_all_gather(ctx, _wire_fault(p)), dim=axis).to(x.dtype)


def feasible_chunks_per_rank(dim: int, n: int, q: int) -> int:
    """Largest q' <= q such that ``dim`` splits evenly into ``n * q'``
    fine chunks (sub-chunk granularity must divide the chunked dim)."""
    q = max(1, int(q))
    while q > 1 and dim % (n * q) != 0:
        q -= 1
    return q


def split_ring_payload(a, n_sub: int, axis: int = 1):
    """Split a ring payload into ``n_sub`` equal sub-chunks along ``axis``
    so each can ring (and be consumed) on its own, the paper's Fig. 13
    sub-chunk granularity.  ``n_sub`` must divide the axis (callers clamp
    with :func:`feasible_chunks_per_rank` first)."""
    if n_sub == 1:
        return [a]
    if a.shape[axis] % n_sub:
        raise ValueError(
            f"sub-chunk factor {n_sub} does not divide ring-payload axis {axis} of size "
            f"{a.shape[axis]}; clamp via feasible_chunks_per_rank first")
    return list(a.chunk(n_sub, dim=axis))


# ---------------------------------------------------------------------------
# reduce-scatter fused with per-chunk compute (GEMV/GEMM + AllReduce core)
# ---------------------------------------------------------------------------
def ring_reduce_scatter_compute(
    ctx: ParallelContext,
    partial_fn: Callable[[int], torch.Tensor],
    *,
    schedule: str = "comm_aware",
    chunks_per_rank: int = 1,
    sub_axis: int = 0,
    skew: int = 0,
    wire: str = "f32",
):
    """sum over ranks of ``partial_fn(chunk)`` -> this rank's reduced chunks.

    ``partial_fn(f)`` returns this rank's partial contribution to fine
    output chunk ``f``.  The output is split into ``n * q`` fine chunks
    (``q = chunks_per_rank``); rank ``r`` owns fine chunks ``r*q ..
    r*q+q-1``, returned concatenated along ``sub_axis``.  Each ring step's
    payload is ``q`` sub-chunks, each put on the wire the moment it is
    produced (paper Fig. 13).

    comm_aware: the carry destined for rank ``d`` starts at ``d + 1``, each
    hop adds the local partial of the chunk in flight, and a rank's own
    chunk is added last (paper Fig. 7b).  Each hop's send is issued before
    the next partial is computed and waited on only where the carry is
    consumed.  oblivious: every partial is computed first, then a bare ring
    reduce (the paper's communication-oblivious baseline).  Both add the
    same values in the same order, so they give the same bits.

    ``skew`` rotates the service order of the ``q`` sub-chunk rings
    (Fig. 14); each sub-ring's chain is untouched, so the result is
    bit-identical under any skew.  ``wire`` compresses the carry on the
    send side of every hop while the local accumulation runs in f32;
    ``wire="f32"`` carries and accumulates partials at their own dtype, as
    the reference does."""
    n, d, q = ctx.tp, ctx.tp_rank, chunks_per_rank
    if schedule not in ("comm_aware", "oblivious"):
        raise ValueError(f"unknown schedule {schedule!r}")
    order = sub_chunk_service_order(q, skew)
    compress = wire not in (None, "f32")

    def merge(accs, dtype=None):
        out = accs[0] if q == 1 else torch.cat(accs, dim=sub_axis)
        return out if dtype is None else out.to(dtype)

    if n == 1:
        return merge([partial_fn(s) for s in range(q)])
    widen = (lambda p: p.float()) if compress else (lambda p: p)
    if schedule == "oblivious":
        # all compute up front (own chunk first), then the bare ring
        parts = [[partial_fn(((d - 1 - i) % n) * q + s) for s in range(q)]
                 for i in reversed(range(n))]
        part = lambda i, s: parts[-(i + 1)][s]
    else:
        part = lambda i, s: partial_fn(((d - 1 - i) % n) * q + s)
    accs: list = [None] * q
    out_dtype = None
    for s in order:
        p = part(0, s)
        out_dtype = p.dtype
        accs[s] = widen(p)

    def send(acc):
        return ring_permute_start(ctx, wire_cast(acc, wire) if compress else acc)

    inflight = {s: send(accs[s]) for s in order}
    for i in range(1, n):
        for s in order:
            p = widen(part(i, s))
            got = inflight[s]()
            accs[s] = (wire_uncast(got, torch.float32) if compress else got) + p
            if i < n - 1:
                inflight[s] = send(accs[s])
    return merge(accs, out_dtype if compress else None)


# ---------------------------------------------------------------------------
# all-gather fused with per-chunk consumption (AG + matmul / KV-gather core)
# ---------------------------------------------------------------------------
def ring_all_gather_compute(
    ctx: ParallelContext,
    x_local,
    consume_fn: Callable,
    *,
    out_init=None,
    wire: str = "f32",
):
    """Gather ``x_local`` around the ring, applying
    ``consume_fn(src_rank, x_src, acc) -> acc`` to each arriving shard while
    the next hop is in flight.  The local shard is consumed first (it is
    there at once, so its compute hides the first hop).

    ``wire`` compresses the forwarded shard once at its source (the payload
    then rings unchanged, so a remote shard rounds once however many hops it
    rides); the local shard is consumed uncompressed."""
    n, d = ctx.tp, ctx.tp_rank
    if n == 1:
        return consume_fn(0, x_local, out_init)
    buf = wire_cast(x_local, wire) if wire not in (None, "f32") else x_local
    pending = ring_permute_start(ctx, buf)
    acc = consume_fn(d, x_local, out_init)
    for i in range(1, n):
        buf = pending()
        if i < n - 1:
            pending = ring_permute_start(ctx, buf)
        acc = consume_fn((d - i) % n, wire_uncast(buf, x_local.dtype), acc)
    return acc


# ---------------------------------------------------------------------------
# direct all-to-all fused with per-destination compute (GEMM/embedding + A2A)
# ---------------------------------------------------------------------------
def _a2a_group(ctx: ParallelContext, group: str | None, name: str) -> ParallelContext:
    """The context an all-to-all runs over: ``"tp"``, the tp group of this
    rank's data row (MoE's experts), at any dp; ``"world"``, all ``dp * tp``
    ranks in world order (``ctx.world``: DLRM's exchange); ``None``, the tp
    world, only where it is the whole world (dp = 1): over data replicas the
    caller names its group."""
    if group not in (None, "tp", "world"):
        raise ValueError(f"{name}: group must be None, 'tp' or 'world', got {group!r}")
    if group is None and ctx.dp != 1:
        raise ValueError(f"{name} at dp={ctx.dp}: name the group, 'tp' (this replica's tp "
                         f"ranks) or 'world' (all dp * tp ranks)")
    return ctx.world if group == "world" else ctx


def _all_to_all(ctx: ParallelContext, x):
    out = _like(x)
    return _on_wire(ctx, lambda ins, bufs: [dist.all_to_all_single(
        bufs[0], ins[0], group=ctx.group, async_op=True)], [x], [out])()[0]


class _BulkAllToAll(torch.autograd.Function):
    """The exchange of ``bulk_all_to_all``; it is its own adjoint, so the
    backward exchanges the cotangent the same way."""

    @staticmethod
    def forward(fctx, ctx, x):
        fctx.pctx = ctx
        return _all_to_all(ctx, x)

    @staticmethod
    def backward(fctx, g):
        return None, _all_to_all(fctx.pctx, g)


def bulk_all_to_all(ctx: ParallelContext, x, *, group: str | None = None):
    """Baseline: one All-to-All over the leading dim [n, ...] -> [n, ...]
    across the tp ranks (block ``j`` goes to rank ``j``; the result is
    stacked by source).  ``group="tp"`` runs it over the tp group of this
    rank's data row at any dp, ``group="world"`` over all ``dp * tp`` ranks
    in world order (:func:`_a2a_group`).  On a one-rank world it is the
    identity.  Differentiable (:class:`_BulkAllToAll`, over the same
    group)."""
    ctx = _a2a_group(ctx, group, "bulk_all_to_all")
    if ctx.tp == 1:
        return x
    return _BulkAllToAll.apply(ctx, x)


class _DirectSends(torch.autograd.Function):
    """The remote sends of :func:`direct_all_to_all_compute` as one autograd
    node: the inputs are the produced slices (``ys``, in send order), the
    outputs the slices received for them (already on this rank: the forward
    posted the sends as each slice was produced).  The backward sends each
    received slice's cotangent back along ``-off``, in the forward's order
    on every rank, and returns what came back as the cotangent of the slice
    this rank sent."""

    @staticmethod
    def forward(fctx, ctx, offs, wire, received, *ys):
        fctx.pctx, fctx.offs, fctx.wire = ctx, offs, wire
        return tuple(received)

    @staticmethod
    def backward(fctx, *gs):
        # undefined cotangents come as zeros
        return (None, None, None, None) + tuple(
            _send_back(fctx.pctx, zip(fctx.offs, gs), fctx.wire))


def _send_back(ctx: ParallelContext, sent, wire: str) -> list:
    """Each (off, cotangent) of ``sent`` back along ``-off``, all posted in
    that order, each rounded to the wire as the forward's payload was; the
    cotangents received, in the same order."""
    waits = [(ring_permute_start(ctx, wire_cast(g.contiguous(), wire), shift=-off), g.dtype)
             for off, g in sent]
    return [wire_uncast(w(), dt) for w, dt in waits]


def direct_all_to_all_compute(
    ctx: ParallelContext,
    produce_fn: Callable[[int], torch.Tensor],
    chunk_shape,
    *,
    schedule: str = "comm_aware",
    chunks_per_rank: int = 1,
    sub_axis: int = 0,
    skew: int = 0,
    wire: str = "f32",
    group: str | None = None,
):
    """Fused compute + All-to-All by per-destination direct sends.

    ``produce_fn(f)`` computes the fine chunk ``f = dest * q + s``: the
    ``s``-th of ``q = chunks_per_rank`` slices along ``sub_axis`` of the
    chunk this rank owes rank ``dest`` (``chunk_shape`` describes the whole
    chunk).  Destinations are visited in ``ring_offsets(n, schedule,
    skew)`` order, remote ones first under comm_aware; each remote slice is
    sent (at offset ``off``: to ``d + off``, from ``d - off``) the moment it
    is produced and received at the end.  Returns ``[n, *chunk_shape]``
    stacked by source rank.  ``group="tp"`` runs over the tp group of this
    rank's data row at any dp, ``group="world"`` over all ``dp * tp`` ranks
    in world order, the destinations world ranks (:func:`_a2a_group`).

    ``wire`` compresses each remote send on the producer side (one rounding
    per value); the local chunk never touches the wire.  On a one-rank
    world with q = 1 the produced chunk is returned without a copy.

    Differentiable: the local slices through their copies, the remote ones
    through :class:`_DirectSends`, whose backward returns each cotangent
    along ``-off`` (rounded to the wire as the forward's payload was), over
    the same group."""
    ctx = _a2a_group(ctx, group, "direct_all_to_all_compute")
    n, d = ctx.tp, ctx.tp_rank
    q = chunks_per_rank
    if chunk_shape[sub_axis] % q:
        raise ValueError(
            f"sub-chunk factor {q} does not divide destination-chunk axis "
            f"{sub_axis} of size {chunk_shape[sub_axis]}; clamp via "
            f"feasible_chunks_per_rank first")
    if n == 1:
        pieces = [produce_fn(s) for s in range(q)]
        own = pieces[0] if q == 1 else torch.cat(pieces, dim=sub_axis)
        return own.unsqueeze(0)
    sub = chunk_shape[sub_axis] // q
    out, pending, sent = None, [], []
    for off in ring_offsets(n, schedule, skew):
        dest = (d + off) % n
        for s in range(q):
            y = produce_fn(dest * q + s)
            if out is None:
                out = torch.empty((n,) + tuple(chunk_shape), dtype=y.dtype, device=y.device)
            if off == 0:
                out[d].narrow(sub_axis, s * sub, sub).copy_(y)
            else:
                pending.append((ring_permute_start(ctx, wire_cast(y.detach(), wire), shift=off),
                                (d - off) % n, s))
                sent.append((off, y))
    received = [wire_uncast(wait(), out.dtype) for wait, _, _ in pending]
    if torch.is_grad_enabled() and any(y.requires_grad for _, y in sent):
        received = _DirectSends.apply(ctx, [off for off, _ in sent], wire, received,
                                      *(y for _, y in sent))
    for (_, src, s), r in zip(pending, received):
        out[src].narrow(sub_axis, s * sub, sub).copy_(r)
    return out


def direct_all_to_all_transpose(
    ctx: ParallelContext,
    g,
    *,
    schedule: str = "comm_aware",
    chunks_per_rank: int = 1,
    sub_axis: int = 0,
    skew: int = 0,
    wire: str = "f32",
    group: str | None = None,
):
    """The adjoint of :func:`direct_all_to_all_compute` on the same
    arguments: ``g`` [n, *chunk] is the cotangent of its result (stacked by
    source); returns [n, *chunk] stacked by destination, the cotangent of
    each chunk this rank produced.  Each remote slice's cotangent goes back
    along ``-off`` in the forward's order on every rank, rounded to the wire
    as the forward's payload was (:class:`_DirectSends`' backward, for a
    caller that produced its chunks without autograd)."""
    ctx = _a2a_group(ctx, group, "direct_all_to_all_transpose")
    n, d, q = ctx.tp, ctx.tp_rank, chunks_per_rank
    if n == 1:
        return g
    sub = g.shape[1 + sub_axis] // q
    piece = lambda t, s: t.narrow(sub_axis, s * sub, sub)
    out, sent, places = torch.empty_like(g), [], []
    for off in ring_offsets(n, schedule, skew):
        for s in range(q):
            if off == 0:
                piece(out[d], s).copy_(piece(g[d], s))
            else:
                sent.append((off, piece(g[(d - off) % n], s)))
                places.append(((d + off) % n, s))
    for (dest, s), got in zip(places, _send_back(ctx, sent, wire)):
        piece(out[dest], s).copy_(got)
    return out


# ---------------------------------------------------------------------------
# partial-softmax merge (sequence-sharded decode attention)
# ---------------------------------------------------------------------------
def attention_partial_merge(ctx: ParallelContext, o, m, l):
    """Merge flash-attention partials across the sequence-sharded tp ranks.

    o: [..., d] unnormalized partial output (sum of exp(s - m) * v);
    m: [...] local running max; l: [...] local sum of exp(s - m).

    A MAX all-reduce of m, then SUM all-reduces of the rescaled l and o: the
    collective itself is the readiness signal (the paper's ``sliceRdy``).
    At tp = 1 the rescaling is by exp(0) = 1 and is skipped."""
    if ctx.tp == 1:
        return o / torch.clamp_min(l, 1e-30)[..., None]
    m_glob = _all_reduce(ctx, m, "max")
    corr = torch.exp(m - m_glob)
    l_glob = _all_reduce(ctx, l * corr)
    o_glob = _all_reduce(ctx, o * corr[..., None])
    return o_glob / torch.clamp_min(l_glob, 1e-30)[..., None]
