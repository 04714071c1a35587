"""Fused embedding pooling + All-to-All (paper Sec. III-A, Fig. 6: DLRM).

DLRM splits its embedding tables over the whole world (model parallel)
while the MLPs run data parallel; the switch between the two is an
All-to-All of pooled embeddings.  The paper's kernel pools a *slice* (a
batch fragment of the rank's tables) and PUTs it to the rank that owns
those batch rows the moment the slice is done, remote slices first.

The world is the flattened (dp, tp) world, ``ctx.world``: world rank ``d *
tp + m`` (the reference's ``dp_axes + (tp_axis,)``), the port's rank order.

  bulk   : pool every local table (one library call,
           ``F.embedding_bag(mode="mean")``), then one All-to-All
  fused  : the direct per-destination loop of ``core/collectives.py``: each
           fragment (a destination's batch rows, or a ``chunks_per_rank``
           slice of them) pooled by the same library call and sent the
           moment it is pooled, remote fragments first
  kernel : the same loop, each fragment pooled by the hand-written
           ``embedding_pool`` kernel: one launch per fragment over all local
           tables

Shapes: indices [B, T_local, L] int32 (the global batch on this rank's
tables; fixed-size bags, mean-pooled, as the DLRM data generator the paper
evaluates with), tables [T_local, V, D], output [B / n, T_global, D]: this
rank's batch rows, every table.

Bulk and fused mode are differentiable.  Bulk mode's backward is the
All-to-All's (itself) and the library's pooling backward.  Fused mode pools
its fragments outside autograd and differentiates through
:class:`_PooledExchange`: the exchange's adjoint in the forward's order
(``collectives.direct_all_to_all_transpose``), then one pooling backward over
the whole batch in row order, so the tables' gradient does not depend on
the order the fragments were sent in (``skew``), and equals bulk mode's
where the wire is exact.  Kernel mode's backward raises, as ``jax.grad``
through the reference's Pallas pooling does, before any rank exchanges a
cotangent.  The call consults the degradation policy (``core/degrade.py``)
before its mode branch, and ``"auto"`` granularity or wire resolves through
``tune_all_to_all`` (``core/autotune.py``) over the world's axes, as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.autotune import resolve_overlap, tune_all_to_all
from repro_torch.core.collectives import (bulk_all_to_all, direct_all_to_all_compute,
                                          direct_all_to_all_transpose)
from repro_torch.core.degrade import degrade_mode
from repro_torch.kernels.embedding_pool.ops import NO_BACKWARD, embedding_pool_tables
from repro_torch.parallel.sharding import WORLD_AXES, ParallelContext


def _pool(tables, idx, kernel: bool):
    """Mean-pool the bags of every table: tables [T, V, D], idx [b, T, L]
    -> [b, T, D]."""
    if kernel:
        return embedding_pool_tables(tables, idx)
    n_tab, v, d = tables.shape
    b, _, L = idx.shape
    # one library call: the tables as one [T * V, D] weight (more than 2^31
    # elements at full width, which it takes), table t's rows offset by t * V
    offs = torch.arange(n_tab, device=idx.device, dtype=idx.dtype)[None, :, None] * v
    flat = (idx + offs).reshape(b * n_tab, L)
    return F.embedding_bag(flat, tables.reshape(n_tab * v, d), mode="mean").view(b, n_tab, d)


class _PooledExchange(torch.autograd.Function):
    """The fused loop's result, pooled and exchanged outside autograd, as
    one node.  Its backward sends each received fragment's cotangent back
    to the rank that pooled it (the direct sends' adjoint, in the forward's
    order on every rank), then differentiates the pooling of the whole
    batch once: the cotangents of this rank's fragments in batch-row order
    through one ``_pool`` backward.  In kernel mode it raises at once: the
    pooling kernel has no backward."""

    @staticmethod
    def forward(fctx, tables, indices, recv, plan):
        fctx.save_for_backward(tables, indices)
        fctx.plan = plan
        return recv

    @staticmethod
    def backward(fctx, g):
        kernel, wctx, kw = fctx.plan
        if kernel:
            raise NotImplementedError(f"embedding_all_to_all in kernel mode: {NO_BACKWARD}")
        tables, indices = fctx.saved_tensors
        g_frag = direct_all_to_all_transpose(wctx, g.contiguous(), **kw)
        with torch.enable_grad():
            tab = tables.detach().requires_grad_(True)
            (g_tab,) = torch.autograd.grad(_pool(tab, indices, kernel=False), tab,
                                           g_frag.reshape(indices.shape[0], *g.shape[2:]))
        return g_tab, None, None, None


def embedding_all_to_all(
    ctx: ParallelContext,
    indices,
    tables,
    *,
    mode: str | None = None,
    schedule: str | None = None,
    chunks_per_rank: int | str | None = None,
    skew: int | None = None,
    wire: str | None = None,
):
    """Pooled embeddings exchanged table-parallel -> data-parallel over the
    flattened world of ``n = dp * tp`` ranks.

    Every rank holds T_local tables and the indices of the *global* batch
    on them; it pools all of them and owes each peer the fragment for that
    peer's batch rows.  Returns [B / n, n * T_local, D]: world rank r's rows
    ``[r B / n, (r + 1) B / n)``, every table in world order.

    ``mode`` defaults to ``ctx.fusion.resolve("embed_a2a")``.  In fused and
    kernel mode ``chunks_per_rank`` (``None`` = ``ctx.fusion.granularity``)
    splits each destination's batch fragment into that many sub-fragments,
    one pooling each, clamped to a divisor of the fragment; ``schedule`` and
    ``skew`` (``None`` = ``ctx.fusion.skew_world``: this op rings over the
    world, not the tp ring) order the destinations and change no bit of the
    result; ``wire`` (``None`` = ``ctx.fusion.wire``) is the remote
    payloads' dtype.  ``"auto"`` (either knob) resolves through
    :func:`tune_all_to_all` under the reference's key, its link model
    resolved for the world's axes."""
    mode = mode or ctx.fusion.resolve("embed_a2a")
    mode = degrade_mode("embedding_a2a", tuple(indices.shape) + tuple(tables.shape), mode)
    if mode not in ("bulk", "fused", "kernel"):
        raise ValueError(f"embedding_all_to_all: unknown mode {mode!r}")
    schedule = schedule or ctx.fusion.schedule
    skew = ctx.fusion.skew_world if skew is None else int(skew)
    n = ctx.tp * ctx.dp
    B, _, L = indices.shape
    t_local, _, D = tables.shape
    if B % n:
        raise ValueError(f"embedding_all_to_all: the batch's {B} rows do not split over the "
                         f"world's {n} ranks")
    b_chunk = B // n

    if mode == "bulk":
        # pool everything, then one All-to-All (the NCCL-style baseline)
        full = _pool(tables, indices, kernel=False)              # [B, T_local, D]
        recv = bulk_all_to_all(ctx, full.view(n, b_chunk, t_local, D), group="world")
    else:
        q, wire_dt = resolve_overlap(
            chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
            lambda fq, wr: tune_all_to_all(
                b_chunk * t_local * D, float(b_chunk * t_local * L * D),
                dtype_bytes=tables.element_size(), n_dev=n, sub_dim=b_chunk, hw=ctx.hw,
                axis=WORLD_AXES, skew=skew, wire=wr, fixed_q=fq),
            dim=b_chunk, ring=1)
        rows = b_chunk // q
        kernel = mode == "kernel"
        kw = dict(schedule=schedule, chunks_per_rank=q, sub_axis=0, skew=skew, wire=wire_dt)

        def pool_fragment(f):
            # this rank's tables pooled for fine chunk f = dest * q + s:
            # batch rows [f * rows, (f + 1) * rows)
            return _pool(tables, indices[f * rows:(f + 1) * rows], kernel)

        with torch.no_grad():
            recv = direct_all_to_all_compute(ctx, pool_fragment, (b_chunk, t_local, D),
                                             group="world", **kw)
        if torch.is_grad_enabled() and tables.requires_grad:
            recv = _PooledExchange.apply(tables, indices, recv, (kernel, ctx.world, kw))
    # recv: [n_src, b_chunk, T_local, D] -> [b_chunk, T_global, D]
    return recv.movedim(0, 1).reshape(b_chunk, n * t_local, D)
