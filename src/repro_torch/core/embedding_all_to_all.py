"""Fused embedding pooling + All-to-All (paper Sec. III-A, Fig. 6: DLRM).

DLRM splits its embedding tables over the whole world (model parallel)
while the MLPs run data parallel; the switch between the two is an
All-to-All of pooled embeddings.  The paper's kernel pools a *slice* (a
batch fragment of the rank's tables) and PUTs it to the rank that owns
those batch rows the moment the slice is done, remote slices first.

  bulk   : pool every local table (one library call,
           ``F.embedding_bag(mode="mean")``), then one All-to-All
  kernel : the direct per-destination loop, each fragment pooled by the
           hand-written ``embedding_pool`` kernel: one launch per fragment
           over all local tables

Shapes (global): indices [B, T, L] int32 (fixed-size bags, mean-pooled, as
the DLRM data generator the paper evaluates with), tables [T, V, D],
output [B, T, D].

This port runs it on one rank (world n = 1): the All-to-All keeps the
rank's own block.  Tables split over several ranks, and ``fused`` mode (the
direct sends of ``core/collectives.py``), are ROADMAP Queue 1 item 6.  The
call consults the degradation policy (``core/degrade.py``) before its mode
branch, and ``"auto"`` granularity or wire resolves through
``tune_all_to_all`` (``core/autotune.py``), as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.autotune import resolve_overlap, tune_all_to_all
from repro_torch.core.collectives import bulk_all_to_all, direct_all_to_all_compute
from repro_torch.core.degrade import degrade_mode
from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables
from repro_torch.parallel.sharding import ParallelContext

_FUSED_ITEM = ("ROADMAP Queue 1 item 1 (left: fused mode of the embedding All-to-All) and "
               "item 6 (DLRM's tables over several ranks)")


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
    """Pooled embeddings exchanged table-parallel -> data-parallel.

    Every rank holds T_local tables and the indices of the *global* batch
    on them; it pools all of them and owes each peer the fragment for that
    peer's batch shard.  Returns [B, T_global, D].

    ``mode`` defaults to ``ctx.fusion.resolve("embed_a2a")``.  In kernel
    mode ``chunks_per_rank`` (``None`` = ``ctx.fusion.granularity``) splits
    each destination's batch fragment into that many sub-fragments, one
    kernel launch each, clamped to a divisor of the fragment; ``schedule``
    and ``skew`` (``None`` = ``ctx.fusion.skew_world``) order the
    destinations; ``wire`` (``None`` = ``ctx.fusion.wire``) is the remote
    payload's dtype, which a one-card world never uses.  ``"auto"`` (either
    knob) resolves through :func:`tune_all_to_all` under the reference's
    key."""
    mode = mode or ctx.fusion.resolve("embed_a2a")
    mode = degrade_mode("embedding_a2a", tuple(indices.shape) + tuple(tables.shape), mode)
    if mode not in ("bulk", "kernel") or ctx.tp * ctx.dp > 1:
        raise NotImplementedError(f"embedding_all_to_all mode={mode!r} over "
                                  f"{ctx.tp * ctx.dp} ranks: {_FUSED_ITEM}")
    schedule = schedule or ctx.fusion.schedule
    skew = ctx.fusion.skew_world if skew is None else int(skew)
    n = ctx.tp * ctx.dp
    B, _, L = indices.shape
    t_local, _, D = tables.shape
    b_chunk = B // n

    if mode == "bulk":
        # pool everything, then one All-to-All (the NCCL-style baseline)
        full = _pool(tables, indices, kernel=False)              # [B, T_local, D]
        recv = bulk_all_to_all(ctx, full.view(n, b_chunk, t_local, D))
    else:
        q, _ = resolve_overlap(
            chunks_per_rank, ctx.fusion.granularity, wire, ctx.fusion.wire,
            lambda fq, wr: tune_all_to_all(
                b_chunk * t_local * D, float(b_chunk * t_local * L * D),
                dtype_bytes=tables.element_size(), n_dev=n, sub_dim=b_chunk, hw=ctx.hw,
                skew=skew, wire=wr, fixed_q=fq),
            dim=b_chunk, ring=1)
        rows = b_chunk // q

        def pool_fragment(f):
            # this rank's tables pooled for fine chunk f = dest * q + s:
            # batch rows [f * rows, (f + 1) * rows)
            return _pool(tables, indices[f * rows:(f + 1) * rows], kernel=True)

        recv = direct_all_to_all_compute(
            ctx, pool_fragment, (b_chunk, t_local, D), schedule=schedule,
            chunks_per_rank=q, sub_axis=0, skew=skew)
    # recv: [n_src, b_chunk, T_local, D] -> [b_chunk, T_global, D]
    return recv.movedim(0, 1).reshape(b_chunk, n * t_local, D)
