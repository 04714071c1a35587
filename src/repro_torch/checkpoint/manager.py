"""Checkpoint lifecycle: keep-k garbage collection, latest discovery, resume.

The port of the JAX package's ``checkpoint/manager.py``.  Over a world
every rank holds a manager on the same directory: every rank takes part in
a save's gathers, world rank 0 writes and collects, and a restore first
waits for the writer (a barrier over the world), so every rank lists the
same steps and restores the same one.  The writer must not write again
before every rank has listed: a save that follows a restore with no
collective between them (the supervisor's first save) is preceded by a
barrier of its own.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import time

from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer, Placement, restore_checkpoint,
                                                 save_checkpoint, tree_bytes, world_barrier)

log = logging.getLogger("repro_torch.checkpoint")

_STEP_RE = re.compile(r"step_(\d{8})$")


class CheckpointManager:
    """``stats`` keeps one entry a restore (its step, bytes and seconds);
    the async saves' entries are the checkpointer's ``history``."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async = AsyncCheckpointer() if async_save else None
        self.stats: list[dict] = []
        # the steps the last restore listed (after its barrier: the same on
        # every rank)
        self.listed: list[int] = []

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and not name.endswith(".tmp"):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_path(self):
        steps = self.all_steps()
        if not steps:
            return None
        return os.path.join(self.directory, f"step_{steps[-1]:08d}")

    def save(self, step: int, tree, placement: Placement | None = None):
        """Save ``tree`` (this rank's parts under ``placement``) as ``step``."""
        if self._async is not None:
            self._async.save(self.directory, step, tree, placement)
        else:
            save_checkpoint(self.directory, step, tree, placement)
        if placement is None or placement.writer:
            self._gc()

    def wait(self):
        if self._async is not None:
            self._async.wait()

    @property
    def history(self) -> list[dict]:
        """The async saves' entries (``AsyncCheckpointer.history``)."""
        return [] if self._async is None else self._async.history

    def restore_latest(self, target_tree, shardings: Placement | None = None):
        """Restore the newest readable checkpoint, or None.

        A crash mid-write leaves only a ``.tmp`` dir (the atomic rename
        never happened), but a finalized checkpoint can still rot on disk
        (truncated manifest, missing/garbled array file).  Walk newest to
        oldest and fall back past any step that fails to load, so one bad
        entry does not brick the run."""
        self.wait()
        world_barrier(shardings)
        self.listed = self.all_steps()
        for step in reversed(self.listed):
            path = os.path.join(self.directory, f"step_{step:08d}")
            t0 = time.perf_counter()
            try:
                out = restore_checkpoint(path, target_tree, shardings)
            except Exception as e:
                log.warning("checkpoint %s unreadable (%s); trying previous", path, e)
                continue
            self.stats.append({"step": step, "bytes": tree_bytes(out[0]),
                               "seconds": time.perf_counter() - t0})
            return out
        return None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
