"""Elastic scaling: re-place a live state tree onto a smaller world.

The port of the JAX package's ``runtime/elastic.py``.  When the world
shrinks (a lost rank), training resumes by (1) making the survivors' world
(:func:`shrink_context`: a context over a subset of the default group, with
groups of its own), (2) re-deriving each leaf's placement from its
*logical* spec, which is world-independent, and (3) re-placing the live
state (:func:`reshard_tree`) or restoring the latest checkpoint onto it.
Divisibility is re-checked; batch sizes rescale to keep the per-rank load.

A world's groups are made collectively over the default group, so every
rank of it calls :func:`shrink_context` with the same arguments, the lost
ranks too.  The reference simulates a loss on one host, where the lost
device's buffers stay readable; the port does the same: the lost ranks
still take part in :func:`reshard_tree`'s gathers, then leave.  A real
loss, where the lost rank's memory is gone and the survivors restore from
a checkpoint in a respawned world, is the multi-process runtime's
(ROADMAP Queue 3 records the difference).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Placement
from repro_torch.core.collectives import gather_leaf
from repro_torch.parallel.sharding import ParallelContext, make_subworld_groups, shard_leaf
from repro_torch.train.optimizer import spec_leaves

# the reference's mesh axis names: the data axis, then the tp axis
AXES = ("data", "model")


def shrink_context(ctx: ParallelContext, factor: int = 2, axis: str | None = None,
                   fusion=None, lost=None) -> ParallelContext:
    """A smaller-world ``ParallelContext`` after losing capacity.

    Shrinks one axis by ``factor`` and makes the world of the first
    surviving ranks in world order (the healthy prefix of the old world).
    Prefers the data axis (``"data"``): a dp shrink changes only how many
    batch shards run concurrently, while a tp shrink (``"model"``) changes
    every sharded product's decomposition; falls back to tp when dp does
    not divide.  The hardware model carries over.

    ``lost`` names the dead ranks as world ranks of the old world (e.g.
    ``range(0, 2)`` when the first replica died: a non-prefix survivor
    set); the new world is then the first ``keep`` ranks that are **not**
    lost.  Raises ``ValueError`` where no axis divides (a world of one
    rank has nothing to shrink to).

    Every rank of the default group calls this, with the same arguments,
    the lost ranks too (``dist.new_group`` is collective over it); on a
    rank the new world does not keep the context's ``member`` is False,
    and that rank leaves without a further collective.  The new world
    never uses the default group: its lost ranks are still members."""
    if factor < 2:
        raise ValueError(f"shrink factor must be >= 2, got {factor}")
    sizes = {"data": ctx.dp, "model": ctx.tp}
    if axis is None:
        axis = next((a for a in AXES if sizes[a] % factor == 0 and sizes[a] >= factor), None)
        if axis is None:
            raise ValueError(f"no mesh axis divisible by {factor} in {sizes}")
    elif axis not in sizes:
        raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
    elif sizes[axis] % factor or sizes[axis] < factor:
        raise ValueError(f"axis {axis!r} ({sizes[axis]}) not divisible by shrink factor "
                         f"{factor}")
    shape = {a: n // factor if a == axis else n for a, n in sizes.items()}
    keep = shape["data"] * shape["model"]
    old = list(ctx.ranks) if ctx.ranks is not None else list(range(ctx.dp * ctx.tp))
    alive = old
    if lost is not None:
        dead = {int(i) for i in lost}
        bad = dead - set(range(len(old)))
        if bad:
            raise ValueError(f"lost indices {sorted(bad)} outside the flattened world of "
                             f"{len(old)} ranks")
        alive = [r for i, r in enumerate(old) if i not in dead]
        if len(alive) < keep:
            raise ValueError(f"only {len(alive)} ranks survive ({len(dead)} lost) but the "
                             f"shrunk world {shape} needs {keep}; shrink by a larger factor")
    ranks = alive[:keep]
    dp, tp = shape["data"], shape["model"]
    group, data_group, world_group = make_subworld_groups(dp, tp, ranks)
    return ParallelContext(device=ctx.device, fusion=fusion if fusion is not None else ctx.fusion,
                           tp=tp, dp=dp, group=group, data_group=data_group,
                           world_group=world_group, hw=ctx.hw, ranks=tuple(ranks))


def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, tuple(specs))


def reshard_tree(tree, logical_specs, new_ctx: ParallelContext, *, old_ctx=None,
                 training: bool = False):
    """Place every leaf as its logical spec implies on ``new_ctx``'s world.
    Returns ``(tree, placement)``: the new tree (``None`` on a rank the new
    world does not keep) and its :class:`~repro_torch.checkpoint.
    checkpointer.Placement` (the reference returns the shardings).

    With ``old_ctx`` (a live resize) each leaf is gathered whole over the
    old world first, a collective every rank of the old world takes part
    in, the lost ranks too; without it the leaves are whole (numpy arrays
    or tensors: the host-to-device restore path).  A leaf that required a
    gradient still does."""
    spec_leaves(logical_specs)        # every leaf has a spec
    gather = old_ctx is not None and old_ctx.member and old_ctx.world.tp > 1

    def whole(x, spec):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return gather_leaf(old_ctx, x.detach(), spec, training) if gather else x.detach()

    wholes = _tree_map(whole, tree, logical_specs)
    placement = Placement(new_ctx, logical_specs, training)
    if not new_ctx.member:
        return None, placement

    def place(x, spec, src):
        # a leaf kept on the host (the optimizer's step count) stays there
        host = isinstance(src, torch.Tensor) and src.device.type == "cpu"
        out = shard_leaf(x, spec, new_ctx, training).to(
            "cpu" if host else new_ctx.device, copy=True)
        if isinstance(src, torch.Tensor) and src.requires_grad:
            out.requires_grad_(True)
        return out

    def place_tree(w, t, s):
        if isinstance(w, dict):
            return {k: place_tree(w[k], t[k], s[k]) for k in w}
        if isinstance(w, list):
            return [place_tree(a, b, c) for a, b, c in zip(w, t, s)]
        return place(w, tuple(s), t)

    return place_tree(wholes, tree, logical_specs), placement


def rescale_batch(global_batch: int, old_dp: int, new_dp: int,
                  microbatches: int = 1) -> int:
    """Keep per-rank batch constant under world resize.

    ``global_batch`` must shard evenly over ``old_dp`` — otherwise "per-
    rank batch" is ill-defined and the round trip does not invert
    (e.g. batch 4 on dp 8 clamps to 1/rank, returning 8 on re-grow).
    That silent 2x batch change corrupts the learning-rate/batch coupling,
    so it warns loudly instead of passing unnoticed.

    ``microbatches`` is the per-step grad-accumulation split: when a dp
    shrink drops the rescaled batch below (or off a multiple of) the
    microbatch count, some microbatches would be empty and the split
    no longer divides — the new batch is rounded **up** to the next
    multiple so accumulation stays well-formed, again with a loud
    warning (the effective batch grew; the LR schedule may need a
    touch)."""
    if global_batch % old_dp:
        warnings.warn(
            f"global batch {global_batch} does not divide over dp={old_dp}; "
            f"per-device batch clamps to {max(1, global_batch // old_dp)} "
            f"and the effective global batch changes under resize",
            RuntimeWarning, stacklevel=2)
    per_dev = max(1, global_batch // old_dp)
    new_batch = per_dev * new_dp
    if microbatches > 1 and new_batch % microbatches:
        rounded = -(-new_batch // microbatches) * microbatches
        warnings.warn(
            f"rescaled batch {new_batch} (dp {old_dp} -> {new_dp}) no "
            f"longer divides into {microbatches} microbatches; rounding up "
            f"to {rounded} — the effective global batch changes under "
            f"resize", RuntimeWarning, stacklevel=2)
        new_batch = rounded
    return new_batch


def check_divisibility(ctx: ParallelContext, d_ff: int, vocab: int, seq: int):
    problems = []
    if d_ff % ctx.tp:
        problems.append(f"d_ff {d_ff} % tp {ctx.tp}")
    if vocab % ctx.tp:
        problems.append(f"vocab {vocab} % tp {ctx.tp}")
    if seq % ctx.tp:
        problems.append(f"seq {seq} % tp {ctx.tp}")
    return problems
