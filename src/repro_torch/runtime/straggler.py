"""Straggler detection + execution-skew telemetry -> fused-op schedules.

The port of the JAX package's ``runtime/straggler.py``.  The paper's
Fig. 14 measures inter-node execution skew under communication-aware vs
-oblivious scheduling.  This module closes that loop at run time:

  1. :class:`StragglerMonitor` — per-process step-time window: flags steps
     slower than ``threshold x`` the median of the *other* samples in the
     window (the current step is excluded from its own baseline, which
     would bias detection at small windows), and exposes a windowed flag
     rate so a recovered rank stops reading as a straggler.
  2. :class:`SkewEstimator` — cross-rank: per-rank EWMA step times are
     reduced through the discrete-event schedule model
     (:func:`repro_torch.core.scheduling.best_skew_rotation`) to one
     integer schedule rotation per ring axis — the ``FusionConfig.skew``
     bucket.
  3. :class:`SkewScheduler` — bucket -> rebuilt step: the reference bakes a
     schedule into the lowered HLO and re-jits on a bucket change; the
     port's ops read ``ctx.fusion.skew`` at call time, so a bucket is a
     step built over a context with that skew.  The scheduler memoises one
     build per bucket, as the reference memoises one jit: a changed bucket
     builds exactly once, and returning to a seen bucket costs nothing.
     The port's rule is that ``skew`` only reorders sends, so a rebuilt
     step keeps the step's bits.

In a world of several ranks the per-rank times of step 2 come from
:class:`ProcessTelemetry`: each rank's ``StragglerMonitor`` EWMA gathered
over the context's world group (one process a rank, in world order), so
the estimator runs on measured times, the same vector on every rank;
single-process harnesses inject times directly.
"""
from __future__ import annotations

import statistics
from collections import deque
from typing import Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.scheduling import (best_skew_rotation, modeled_execution_skew,
                                         skew_statistic)


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 1.5,
                 min_baseline: int = 9, ewma_alpha: float = 0.25):
        self.window = deque(maxlen=window)
        self.flag_window = deque(maxlen=window)
        self.threshold = threshold
        self.min_baseline = min_baseline
        self.ewma_alpha = ewma_alpha
        self.ewma: float | None = None
        self.flags = 0

    def record(self, step_time: float) -> bool:
        # the baseline is the window *before* this step: a sample must not
        # vote on its own outlier-ness (at small windows a slow step drags
        # the median up enough to mask itself)
        baseline = list(self.window)
        self.window.append(step_time)
        a = self.ewma_alpha
        self.ewma = (step_time if self.ewma is None
                     else (1 - a) * self.ewma + a * step_time)
        flagged = False
        if len(baseline) >= self.min_baseline:
            med = statistics.median(baseline)
            flagged = step_time > self.threshold * med
        self.flag_window.append(flagged)
        if flagged:
            self.flags += 1
        return flagged

    @property
    def flag_rate(self) -> float:
        """Fraction of the last ``window`` steps flagged — decays to 0 when
        a rank recovers (the cumulative ``flags`` count never does)."""
        if not self.flag_window:
            return 0.0
        return sum(self.flag_window) / len(self.flag_window)

    @property
    def skew(self) -> float:
        """max/median - 1 over the window (the Fig. 14 metric)."""
        if len(self.window) < 2:
            return 0.0
        med = statistics.median(self.window)
        return max(self.window) / med - 1.0 if med > 0 else 0.0

    def summary(self):
        if not self.window:
            return {}
        return {"median_s": statistics.median(self.window),
                "max_s": max(self.window),
                "skew": self.skew,
                "flags": self.flags,
                "flag_rate": self.flag_rate,
                "ewma_s": self.ewma}


class SkewEstimator:
    """Per-rank EWMA step times -> integer schedule rotation per ring axis.

    ``axis_sizes`` maps each ring axis name to its world size (e.g.
    ``{"data": 2, "model": 4}``).  :meth:`observe` takes one *per-rank*
    step-time vector in row-major order (the port's world order: world rank
    ``d * tp + m`` for ``{"data": dp, "model": tp}``); per-axis times are
    reduced by averaging over the other axes, so a straggling rank skews
    exactly the rings it sits on.  The rotation
    for an axis is the ``skew`` minimizing the modeled schedule-induced
    execution skew under the measured EWMA times
    (:func:`repro_torch.core.scheduling.best_skew_rotation`), with a dead
    band: rotations only move once the modeled improvement over the current
    bucket exceeds ``hysteresis``, so jitter cannot thrash the rebuild
    loop.  ``link_scales`` optionally maps an axis to per-link cost
    multipliers (static topology — a slow inter-node link), which
    is what couples the measured straggler *position* to a non-trivial
    rotation.
    """

    def __init__(self, axis_sizes: Mapping[str, int], *, alpha: float = 0.25,
                 min_obs: int = 2, hysteresis: float = 0.005,
                 schedule: str = "comm_aware",
                 link_scales: Mapping[str, Sequence[float]] | None = None,
                 reduce_every: int = 1):
        """``reduce_every``: run the rotation sweep only every N
        observations (the EWMA moves slowly, so re-reducing each step is
        wasted work — the sweep is O(world^3) Python per axis, which at
        cluster scale should not sit in the per-step loop)."""
        self.axis_sizes = dict(axis_sizes)
        self.link_scales = {a: list(v) for a, v in (link_scales or {}).items()}
        self.world = 1
        for s in self.axis_sizes.values():
            self.world *= s
        self.alpha = alpha
        self.min_obs = min_obs
        self.hysteresis = hysteresis
        self.schedule = schedule
        self.reduce_every = max(1, int(reduce_every))
        self.ewma: list[float] | None = None
        self.n_obs = 0
        self._rotation = {a: 0 for a in self.axis_sizes}

    def observe(self, per_rank_times: Sequence[float]) -> None:
        t = [float(x) for x in per_rank_times]
        if len(t) != self.world:
            raise ValueError(f"expected {self.world} per-rank times, got "
                             f"{len(t)}")
        if any(x <= 0 for x in t):
            raise ValueError("step times must be positive")
        if self.ewma is None:
            self.ewma = t
        else:
            a = self.alpha
            self.ewma = [(1 - a) * e + a * x for e, x in zip(self.ewma, t)]
        self.n_obs += 1
        if self.n_obs == self.min_obs or self.n_obs % self.reduce_every == 0:
            self._reduce()

    def _axis_times(self, axis: str) -> list[float]:
        """Mean EWMA per position along ``axis`` (row-major world order)."""
        sizes = list(self.axis_sizes.values())
        names = list(self.axis_sizes)
        i = names.index(axis)
        stride = 1
        for s in sizes[i + 1:]:
            stride *= s
        n = sizes[i]
        sums = [0.0] * n
        counts = [0] * n
        for flat, t in enumerate(self.ewma):
            pos = (flat // stride) % n
            sums[pos] += t
            counts[pos] += 1
        return [s / c for s, c in zip(sums, counts)]

    def _reduce(self) -> None:
        if self.n_obs < self.min_obs:
            return
        for axis, n in self.axis_sizes.items():
            if n < 2:
                continue
            times = self._axis_times(axis)
            ls = self.link_scales.get(axis)
            cand = best_skew_rotation(n, times, schedule=self.schedule,
                                      link_scale=ls)
            cur = self._rotation[axis]
            if cand == cur:
                continue
            s_cur = modeled_execution_skew(n, self.schedule, cur, times,
                                           link_scale=ls)
            s_new = modeled_execution_skew(n, self.schedule, cand, times,
                                           link_scale=ls)
            if s_cur - s_new > self.hysteresis:
                self._rotation[axis] = cand

    def rotation(self, axis: str) -> int:
        """Current schedule rotation bucket for one ring axis."""
        return self._rotation[axis]

    def rotations(self) -> dict[str, int]:
        return dict(self._rotation)

    def axis_skew(self, axis: str) -> float:
        """Measured max/median - 1 of the EWMA times along ``axis``."""
        if self.ewma is None:
            return 0.0
        return skew_statistic(self._axis_times(axis))


def world_allgather(ctx, local: float) -> list[float]:
    """Every rank's ``local`` over ``ctx``'s world group, in world order
    (a collective: every rank of the world calls it); ``[local]`` where the
    world is one rank or there is no context."""
    world = None if ctx is None else ctx.world
    if world is None or world.tp == 1:
        return [float(local)]
    dev = ctx.device if ctx.backend == "nccl" else "cpu"
    t = torch.tensor([float(local)], dtype=torch.float64, device=dev)
    outs = [torch.empty_like(t) for _ in range(world.tp)]
    dist.all_gather(outs, t, group=world.group)
    return [float(o) for o in outs]


class ProcessTelemetry:
    """Multi-rank ``per_rank_times`` provider for :class:`~repro_torch.
    runtime.fault_tolerance.TrainSupervisor`: gathers the local
    :class:`StragglerMonitor` EWMA over the world (:func:`world_allgather`
    over ``ctx``'s world group; the reference all-gathers over processes)
    and replicates each process's time over the ranks it holds (one, in the
    port), yielding the per-rank vector ``SkewEstimator`` reduces.

    The EWMA (not the raw step time) is what travels: it is already
    jitter-smoothed, so one slow pause on a healthy rank cannot flip the
    schedule bucket.  Before the monitor has any sample the current step
    time stands in.  ``allgather`` is injectable for tests (and for
    runtimes with their own gather primitive).
    """

    def __init__(self, monitor: StragglerMonitor, world: int, *,
                 allgather: Callable[[float], Sequence[float]] | None = None,
                 ctx=None):
        self.monitor = monitor
        self.world = int(world)
        self.allgather = allgather or (lambda local: world_allgather(ctx, local))

    def __call__(self, dt: float) -> list[float]:
        local = self.monitor.ewma if self.monitor.ewma is not None else dt
        per_proc = [float(t) for t in self.allgather(float(local))]
        n_proc = len(per_proc)
        if n_proc == 0 or self.world % n_proc:
            raise ValueError(
                f"cannot spread {n_proc} process times over a world of "
                f"{self.world} ranks (world must be a process multiple)")
        rep = self.world // n_proc
        return [t for t in per_proc for _ in range(rep)]


class SkewScheduler:
    """Bucket-keyed rebuild loop: telemetry in, current step out.

    ``build(skew: int) -> fn`` builds the step for one skew bucket —
    typically ``lambda s: build_train_step(bundle.loss_fn(ctx.with_fusion(
    dataclasses.replace(fusion, skew=s))), ...)``.  Builds are memoised per
    bucket: a changed bucket triggers exactly one rebuild, and flipping
    back to an already-seen bucket reuses its step.
    """

    def __init__(self, build: Callable[[int], Callable],
                 estimator: SkewEstimator, axis: str):
        self.build = build
        self.estimator = estimator
        self.axis = axis
        self._fns: dict[int, Callable] = {}
        self.bucket = 0
        self.rebuilds = 0

    def fn(self) -> Callable:
        """The step for the current bucket (building on first use)."""
        if self.bucket not in self._fns:
            self._fns[self.bucket] = self.build(self.bucket)
            self.rebuilds += 1
        return self._fns[self.bucket]

    def invalidate(self) -> None:
        """Drop every memoised build, for a change *outside* the bucket key
        that a build may hold (the reference's cached traces bake in the
        degradation policy's modes; the port's ops read the policy at call
        time, so this only costs a rebuild).  The next ``fn()`` builds."""
        self._fns.clear()

    def observe(self, per_rank_times: Sequence[float]) -> bool:
        """Feed one all-gathered per-rank step-time vector; returns True
        when the schedule bucket changed (callers swap in ``fn()``)."""
        self.estimator.observe(per_rank_times)
        new = self.estimator.rotation(self.axis)
        if new == self.bucket:
            return False
        self.bucket = new
        return True
