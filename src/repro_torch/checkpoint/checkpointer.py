"""Checkpoints: atomic, async-capable, restored onto any (dp, tp) world.

The port of the JAX package's ``checkpoint/checkpointer.py``, on its
on-disk format: one directory a step, ``step_%08d``, holding

  manifest.json          - {"step", "leaves": [{"path", "file", "shape", "dtype"}]}
  arr_<i>.npy            - one file a leaf, its whole value

A leaf's path joins its dict keys and list indices with ``/``.  numpy has
no bfloat16: a bf16 leaf's 2-byte words are saved as numpy's 2-byte void
type, its manifest dtype ``"bfloat16"``, which is what ``np.save`` writes
for the JAX package's bf16 leaves, so the port reads those bit for bit.
Writes go to ``<dir>.tmp`` and are renamed: a crash mid-write never
corrupts the latest checkpoint.

A world's state is sharded: each rank holds its part of each leaf, cut by
``parallel/sharding.shard_leaf`` under the leaf's logical spec.  A
:class:`Placement` names the world, the specs and whether fsdp dims are
split (``training``).  Saving gathers each split leaf whole over the groups
that split it (``core/collectives.gather_leaf``, a collective: every rank
of the world reaches the save), and only world rank 0 writes.  Restoring
reads the whole leaves (of a file, only this rank's slice) and keeps this
rank's shard under the *target* placement, so a checkpoint saved at one
(dp, tp) restores at any other.  A tensor leaf of the target is
overwritten in place (its identity and ``requires_grad`` kept, no second
copy of the state on the card), a numpy leaf replaced; every file is
checked before any leaf is touched.

``AsyncCheckpointer`` writes on a worker thread.  The port's optimizer
(``adamw_update``) updates the state in place, so the device-to-host copy
must be complete before the next step writes: on a card the copies go into
pinned host buffers (kept from one save to the next) on the current
stream, so the next step's in-place updates, queued after them on the same
stream, cannot reach them; the worker waits for the copies' event before
it writes.  On the CPU the copy is made before
``save`` returns.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import gather_leaf
from repro_torch.parallel.sharding import segmented_dims, split_dims
from repro_torch.train.optimizer import spec_leaves

_BF16 = "bfloat16"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tree's leaves live: ``ctx``'s world, each leaf split under its
    logical spec in ``specs`` (a tree of the state's structure, a tuple at
    each leaf), ``training`` splitting the ``"fsdp"`` dims over data."""

    ctx: Any
    specs: Any
    training: bool = False

    @property
    def world(self) -> int:
        w = self.ctx.world
        return 1 if w is None else w.tp

    @property
    def writer(self) -> bool:
        """World rank 0 of a kept rank writes."""
        return self.ctx.member and (self.world == 1 or self.ctx.world.tp_rank == 0)


def _flatten(tree, path=()):
    """[(path, leaf)] in tree order: dict keys in their order, list indices."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _flatten(v, path + (i,))]
    return [("/".join(str(k) for k in path), tree)]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)
    return rebuild(tree)


def _specs(placement: Placement | None, n: int) -> list:
    if placement is None:
        return [None] * n
    specs = spec_leaves(placement.specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for a tree of {n} leaves")
    return specs


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _numpy(x) -> np.ndarray:
    """A host tensor (or array) as numpy, sharing memory; bf16 as 2-byte voids."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _snapshot(leaves, specs, placement, pinned: dict | None):
    """Host copies of the whole leaves, or ``None`` on a rank that does not
    write, and the event after the last copy to pinned memory (or None).
    Gathers each split leaf over its groups first (a collective)."""
    writer = placement is None or placement.writer
    host, queued = [], False
    for i, (x, spec) in enumerate(zip(leaves, specs)):
        if not isinstance(x, torch.Tensor):
            host.append(np.array(x))
            continue
        x = x.detach()
        if placement is not None and placement.world > 1:
            x = gather_leaf(placement.ctx, x, spec, placement.training)
        if not writer:
            continue
        if not x.is_cuda:
            host.append(x.clone())      # the state is updated in place next step
        elif pinned is None:
            host.append(x.cpu())
        else:
            buf = pinned.get(i)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = pinned[i] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x, non_blocking=True)
            host.append(buf)
            queued = True
    if not writer:
        return None, None
    done = None
    if queued:
        done = torch.cuda.Event()
        done.record()
    return host, done


def _write(directory: str, step: int, paths, host) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (p, x) in enumerate(zip(paths, host)):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), _numpy(x))
        manifest["leaves"].append({"path": p, "file": f"arr_{i}.npy",
                                   "shape": list(x.shape), "dtype": _dtype_name(x)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def tree_bytes(tree) -> int:
    """Bytes of a tree's leaves as this rank holds them."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for _, x in _flatten(tree))


def save_checkpoint(directory: str, step: int, tree: Any, placement: Placement | None = None
                    ) -> str:
    """Synchronous save with atomic rename.  Returns the final path.

    Over a world (``placement``) every rank takes part in gathering each
    split leaf; only world rank 0 touches the file system."""
    final = os.path.join(directory, f"step_{step:08d}")
    flat = _flatten(tree)
    paths, leaves = [p for p, _ in flat], [x for _, x in flat]
    host, _ = _snapshot(leaves, _specs(placement, len(leaves)), placement, None)
    if host is None:
        return final
    return _write(directory, step, paths, host)


def tree_to_host(tree: Any, placement: Placement | None = None):
    """Every leaf whole, as a host tensor (numpy leaves copied), on every
    rank: each split leaf gathered over its groups first, as a save gathers
    it (a collective: every rank of the world calls it)."""
    flat = _flatten(tree)
    out = []
    for (_, x), spec in zip(flat, _specs(placement, len(flat))):
        if not isinstance(x, torch.Tensor):
            out.append(np.array(x))
            continue
        x = x.detach()
        if placement is not None and placement.world > 1:
            x = gather_leaf(placement.ctx, x, spec, placement.training)
        out.append(x.to("cpu", copy=True))
    return _unflatten(tree, out)


def world_barrier(placement: Placement | None) -> None:
    """A barrier over the placement's world (none at one rank): after it,
    every file world rank 0 wrote before it is on disk for every rank."""
    if placement is None or placement.world == 1:
        return
    dist.barrier(group=placement.ctx.world.group)


class AsyncCheckpointer:
    """Overlaps checkpoint writing with training.

    ``history`` keeps one entry a save: its step, bytes, the seconds
    ``save`` held the caller (the gather and the copies' enqueueing) and
    the seconds from the call until the checkpoint was renamed into place
    (``total_s``, on the writer)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None
        self._error: Exception | None = None
        self._pinned: dict = {}
        self.history: list[dict] = []

    def save(self, directory: str, step: int, tree: Any, placement: Placement | None = None):
        self.wait()
        t0 = time.perf_counter()
        flat = _flatten(tree)
        paths, leaves = [p for p, _ in flat], [x for _, x in flat]
        host, done = _snapshot(leaves, _specs(placement, len(leaves)), placement, self._pinned)
        entry = {"step": step, "bytes": tree_bytes(tree),
                 "block_s": time.perf_counter() - t0}
        self.history.append(entry)
        if host is None:
            return

        def work():
            try:
                if done is not None:
                    done.synchronize()
                self.last_path = _write(directory, step, paths, host)
                entry["total_s"] = time.perf_counter() - t0
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _slices(shape, spec, placement: Placement | None):
    """This rank's slice of a whole leaf of ``shape`` under ``spec``: a
    slice a dim, or an index array for a segmented dim (by its segments)."""
    sl = [slice(None)] * len(shape)
    if placement is None or spec is None:
        return tuple(sl)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a leaf of shape {tuple(shape)}")
    ctx = placement.ctx
    for dim, ax in segmented_dims(spec, ctx):
        sl[dim] = ax.index(ctx.tp, ctx.tp_rank).numpy()
    for dim, n, r in split_dims(spec, placement.ctx, placement.training):
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} does not split over {n} ranks")
        size = shape[dim] // n
        sl[dim] = slice(r * size, (r + 1) * size)
    return tuple(sl)


def _host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr)      # read (this rank's slice) into memory
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(path: str, target_tree: Any, shardings: Placement | None = None):
    """Restore into the structure of ``target_tree``; returns (tree, step).

    ``shardings`` (a :class:`Placement`, the reference's name for the
    target's shardings) is the target world: each rank keeps its shard of
    each whole leaf.  Every leaf's file, shape and dtype is checked before
    any target leaf is written."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    flat = _flatten(target_tree)
    specs = _specs(shardings, len(flat))
    plan = []
    for (p, leaf), spec in zip(flat, specs):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
        if list(arr.shape) != list(entry["shape"]):
            raise ValueError(f"{p}: file shape {arr.shape}, manifest {entry['shape']}")
        sl = _slices(arr.shape, spec, shardings)
        shape = tuple(len(range(*s.indices(n))) if isinstance(s, slice) else len(s)
                      for s, n in zip(sl, arr.shape))
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if shape != tuple(want):
            raise ValueError(f"shape mismatch for {p}: {shape} vs {tuple(want)}")
        if isinstance(leaf, torch.Tensor) and _dtype_name(leaf) != entry["dtype"]:
            raise ValueError(f"dtype mismatch for {p}: {entry['dtype']} vs {_dtype_name(leaf)}")
        plan.append((leaf, arr, sl, entry["dtype"]))
    out = []
    with torch.no_grad():
        for leaf, arr, sl, dtype in plan:
            value = _host_tensor(arr[sl], dtype)
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(value)
                out.append(leaf)
            else:
                out.append(_numpy(value).copy() if dtype != _BF16 else value)
    return _unflatten(target_tree, out), manifest["step"]
