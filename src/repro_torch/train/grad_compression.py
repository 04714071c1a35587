"""Compressed gradient reduction with error feedback.

Two schemes, both with error-feedback residuals so the compression error
is re-injected next step:

  int8:  per-tensor symmetric quantization (scale max|g| / 127);
  topk:  magnitude top-k sparsification (k = ``topk_ratio`` of the entries);
         everything else accumulates in the residual.

They wrap the gradients before the optimizer, after the JAX package's
``train/grad_compression.py``, which models the compression loss and the
error feedback of the data axis's reduction (its gradients are already
reduced); so does this, gradients and residuals updated in place.  As in
the reference, whose layers are stacked, a layer leaf is compressed
together with the same leaf of every other layer at its position of the
layer pattern (one int8 scale, one top-k over the stack:
``optimizer.leaf_groups``).

Over a world (``ctx`` and the leaves' ``specs``) a stack split over tp,
over the data ranks (the train state's fsdp dims) or both is compressed as
the reference compresses the whole stack: the int8 scale is the MAX over
the ranks that hold its parts; the top-k keeps the whole stack's k largest
magnitudes, the larger global index losing a tie as in ``lax.top_k``: each
rank's k best candidates (ties by the lower index) with their global flat
indices are gathered over those ranks and the k best of them kept.  The
residuals live on the shards.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train.optimizer import leaf_groups, spec_tree, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"          # none | int8 | topk
    topk_ratio: float = 0.01


def init_residuals(cfg: CompressionConfig, params):
    if cfg.scheme == "none":
        return {}
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _int8_scale(gs):
    return torch.clamp_min(torch.stack([g.abs().max() for g in gs]).max(), 1e-12) / 127.0


def _quantize_int8(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _dequantize_int8(q, scale):
    return q.float() * scale


def _split_axes(ctx, spec) -> list:
    """The contexts whose ranks hold the parts of a leaf of ``spec`` (its tp
    world, its data world), tp first."""
    from repro_torch.parallel.sharding import splits_over_data, splits_over_tp

    if ctx is None:
        return []
    return ([ctx] if ctx.tp > 1 and splits_over_tp(spec) else []) + (
        [ctx.data] if ctx.dp > 1 and splits_over_data(spec) else [])


def _global_index(shape, spec, ctx):
    """The flat index in the whole leaf of each element of this rank's shard
    (of ``shape``), as int64 [numel], and the whole leaf's numel."""
    from repro_torch.parallel.sharding import segmented_dims, split_dims

    if segmented_dims(spec, ctx):
        raise NotImplementedError(f"top-k compression over a segmented tp dim {spec} (zamba2's "
                                  f"Mamba heads): the whole leaf's index of a shard needs the "
                                  f"segments")
    whole, offs = list(shape), [0] * len(shape)
    for dim, n, r in split_dims(spec, ctx, training=True):
        whole[dim] *= n
        offs[dim] = r * shape[dim]
    idx = torch.zeros((), dtype=torch.int64)
    for size, off, w in zip(shape, offs, whole):
        idx = idx[..., None] * w + (torch.arange(size, dtype=torch.int64) + off)
    return idx.reshape(-1), math.prod(whole)


def _local_top(flat, k: int):
    """The indices of the ``k`` largest magnitudes of ``flat``, a tie lost
    by the larger index: the selection ``lax.top_k`` makes."""
    a = flat.abs()
    kth = torch.topk(a, k, sorted=True).values[-1]
    above = torch.nonzero(a > kth).reshape(-1)
    ties = torch.nonzero(a == kth).reshape(-1)[:k - above.numel()]
    return torch.cat([above, ties])


def _topk_keep(flat, k: int, gidx, axes) -> torch.Tensor:
    """The positions of ``flat`` (this rank's part of a stack, ``gidx`` their
    global indices) that the whole stack's top-k keeps."""
    local = _local_top(flat, min(k, flat.numel()))
    if not axes:
        return local
    from repro_torch.core.collectives import _all_gather

    vals = flat.abs()[local]
    gids = gidx.to(flat.device)[local]
    me = 0
    for ax in axes:            # gather over tp, then over data
        me = ax.tp_rank * (vals.numel()) + me
        vals = torch.cat(_all_gather(ax, vals))
        gids = torch.cat(_all_gather(ax, gids))
    # the k best: by magnitude, then by the lower global index
    order = torch.argsort(gids, stable=True)
    best = order[torch.argsort(vals[order], descending=True, stable=True)[:k]]
    n_loc = local.numel()
    mine = best[(best >= me) & (best < me + n_loc)] - me
    return local[mine]


@torch.no_grad()
def compress_decompress(cfg: CompressionConfig, grads, residuals, period: int = 1, ctx=None,
                        specs=None):
    """Compress each gradient group plus its residuals; returns (the
    gradients, overwritten with their decompressed values, and the
    residuals, updated in place with what the compression dropped).
    ``period``: the model's layer pattern (``optimizer.leaf_groups``).
    ``ctx`` and ``specs`` (a tree of the leaves' logical specs, in their
    training placement) compress the stacks split over the world's ranks
    as whole stacks."""
    if cfg.scheme == "none":
        return grads, residuals
    if cfg.scheme not in ("int8", "topk"):
        raise ValueError(cfg.scheme)
    from repro_torch.core.collectives import _all_reduce

    spec_groups = (leaf_groups(tree_map(lambda g: None, grads), period) if specs is None else
                   leaf_groups(spec_tree(specs), period))
    for (_, gs, _), (_, rs, _), (_, sps, _) in zip(leaf_groups(grads, period),
                                                   leaf_groups(residuals, period), spec_groups):
        spec = None if sps[0] is None else sps[0].spec
        axes = [] if spec is None else _split_axes(ctx, spec)
        g32 = [g.float() + r for g, r in zip(gs, rs)]
        if cfg.scheme == "int8":
            scale = _int8_scale(g32)
            for ax in axes:
                scale = _all_reduce(ax, scale.reshape(1), "max")[0]
            kept = [_dequantize_int8(_quantize_int8(x, scale), scale) for x in g32]
        else:
            flat = torch.cat([x.reshape(-1) for x in g32])
            gidx, total = None, flat.numel()
            if axes:            # the stack's layers one after another
                idx, numel = _global_index(g32[0].shape, spec, ctx)
                gidx = torch.cat([idx + i * numel for i in range(len(g32))])
                total = numel * len(g32)
            k = max(1, int(total * cfg.topk_ratio))
            idx = _topk_keep(flat, k, gidx, axes)
            flat = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
            kept = [c.view(x.shape) for c, x in zip(flat.split([x.numel() for x in g32]), g32)]
        for g, r, x, c in zip(gs, rs, g32, kept):
            r.copy_(x - c)
            g.copy_(c)
    return grads, residuals
