"""Fault-tolerant training supervisor.

The port of the JAX package's ``runtime/fault_tolerance.py``.  Wraps the
step loop with: periodic (async) checkpoints, automatic restore-and-retry
on failure with exponentially backed-off restarts, a restart budget that
heals after sustained healthy running, batch replay so a restored step
sees the same data it saw before the failure, and a straggler watchdog.
On a real cluster the inner failure is a lost host / NCCL timeout
surfacing as a RuntimeError from the collective; here any exception from
the step function triggers the same path, which is what the chaos tests
inject (:mod:`repro_torch.runtime.chaos`).

Failure taxonomy, mapped to recovery actions:

=============  =======================================  ==================
fault          surfaces as                              recovery
=============  =======================================  ==================
transient      ``CollectiveTimeout`` / any exception    backoff, restore
               from the step                            latest checkpoint,
                                                        replay batches
non-finite     ``NonFiniteLoss`` (NaN/inf loss — e.g.   same as transient;
loss           a corrupt wire payload)                  the poisoned state
                                                        is never saved
permanent      ``RankLost``                             ``on_rank_loss``
rank loss                                               shrinks the world,
                                                        reshards state,
                                                        replays the step
=============  =======================================  ==================

The port's step updates the state in place (``train/step.py``), as the
reference's donates its buffers: a step that failed has consumed its
state, so recovery always restores, and the save before the first step
gives it something to restore.

Over a world every rank runs a supervisor on its shards, and every rank
must take the same recovery path, or their collectives deadlock.  The
fault plan is the same on every rank, the loss is a replicated scalar,
and restores read the same checkpoint (``checkpoint/manager.py``), so the
decisions agree; no rank-local timing decides a restore.  The skew
bucket is decided from times gathered over the world, the same vector on
every rank.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.checkpoint.checkpointer import world_barrier
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import ReplayBuffer
from repro_torch.runtime.chaos import CollectiveTimeout, RankLost, wire_faults
from repro_torch.runtime.straggler import ProcessTelemetry, StragglerMonitor, world_allgather
from repro_torch.runtime.watchdog import from_liveness, verdict_for

log = logging.getLogger("repro_torch.runtime")


class NonFiniteLoss(RuntimeError):
    """The step produced a NaN/inf loss — treated as a fault, not a result.

    The supervisor restores from the last checkpoint instead of letting a
    poisoned optimizer state propagate (and never checkpoints it)."""


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    async_save: bool = True
    # Restart pacing: sleep min(backoff_max_s, backoff_base_s * 2**(k-1))
    # * (1 + backoff_jitter * U[0,1)) before the k-th consecutive restart
    # (jitter decorrelates a fleet of supervisors hammering shared storage).
    backoff_base_s: float = 0.1
    backoff_max_s: float = 30.0
    backoff_jitter: float = 0.25
    # Budget healing: after this many consecutive healthy steps, forgive
    # one restart — sporadic transient faults over a long run no longer
    # exhaust the same budget that guards against crash loops.
    heal_after: int = 25
    seed: int = 0


class TrainSupervisor:
    """Drives (state, batch) -> (state, metrics) with checkpoint/restart."""

    def __init__(self, cfg: SupervisorConfig, step_fn: Callable,
                 state_shardings=None, skew_scheduler=None,
                 per_rank_times: Callable | str | None = None,
                 fault_plan=None, degradation=None,
                 rebuild_step: Callable[[], Callable] | None = None,
                 on_rank_loss: Callable | None = None,
                 liveness=None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        """``state_shardings`` — the state's :class:`~repro_torch.checkpoint.
        Placement` (its world, the leaves' logical specs, ``training``):
        saves gather the shards whole over it and restores keep this
        rank's shards under it.  ``None``: a state whole on one rank.

        ``skew_scheduler`` (a :class:`~repro_torch.runtime.straggler.
        SkewScheduler`) closes the Fig. 14 loop: each step's wall time is
        fed to it (expanded to a per-rank vector by ``per_rank_times`` —
        by default the local time replicated, which keeps the rotation at
        0) and on a bucket change the supervisor swaps in the step built
        for the new schedule.  When set, it also *owns* the step function
        — ``step_fn`` is ignored in favour of ``skew_scheduler.fn()``.

        ``per_rank_times="process"`` installs the multi-rank provider:
        this supervisor's straggler-monitor EWMA gathered over the world of
        ``state_shardings`` (:class:`~repro_torch.runtime.straggler.
        ProcessTelemetry`), so the estimator runs on *measured* cross-rank
        times instead of injected ones.

        Chaos/degradation wiring (all optional):

        ``fault_plan`` — a :class:`~repro_torch.runtime.chaos.FaultPlan`;
        its events are injected at the matching step, each exactly once
        (the replay of a recovered step runs clean, so transient faults
        terminate).

        ``degradation`` — a :class:`~repro_torch.core.degrade.
        DegradationPolicy`; failures strike the op keys of the last step
        that ran (the policy's active ledger is reset as each step starts,
        the port's counterpart of the reference's "before every trace"; a
        fault injected before the step blames the keys of the one before)
        and quarantined families run their bulk collective until the
        cooldown releases them.

        ``rebuild_step`` — zero-arg callable returning a fresh step; used
        after a degradation change.  The port is eager: the ops read the
        policy and the wire-fault hook at call time, so no step needs a
        rebuild to see either, and a ``nan_wire`` event runs the current
        step under :func:`~repro_torch.runtime.chaos.wire_faults`.  Where
        that step sent no payload the hook could corrupt (a world of one
        rank), the event's effect is the NaN loss a corrupt payload gives,
        as the reference's is without ``rebuild_step``.

        ``on_rank_loss`` — ``(state, RankLost) -> (state, step_fn|None)``
        elastic handler: shrink the world, reshard ``state``, return the
        step for the new world.  ``None`` re-raises (rank loss is then
        fatal).  On a rank the shrunk world does not keep it returns
        ``(None, None)``: the supervisor then leaves its loop with no
        further collective (``left`` True) and ``run`` returns ``(None,
        step)``.

        ``liveness`` — a :class:`~repro_torch.runtime.watchdog.
        LivenessMonitor`: each step, each save and each restore first
        ``check()`` the peers, then run under ``guarded``, as the
        reference's step and save do.  A fault the watchdog names
        (``RankLost`` or ``CollectiveTimeout`` from liveness) leaves ``run``
        at once, whatever ``on_rank_loss`` says: the abandoned step may
        have half updated the in-place state, and the in-process restart's
        restore begins with a barrier over the world that a dead or stopped
        peer never reaches.  The caller exits with the respawn protocol's
        code (``runtime/multiprocess.py``).  A step's own error under
        liveness (gloo's, as a dead peer's socket closes) first waits one
        staleness deadline for the watchdog's verdict, which then leaves
        instead; without a verdict it takes the ordinary restart path.  The
        reference's supervisor sends a liveness ``CollectiveTimeout`` down
        its restart path (ROADMAP Queue 3 records the difference).

        ``sleep_fn`` — injection point for the backoff clock (tests
        record delays instead of sleeping)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.state_shardings = state_shardings
        self.manager = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep,
                                         async_save=cfg.async_save)
        self.straggler = StragglerMonitor()
        self.skew_scheduler = skew_scheduler
        if per_rank_times == "process":
            if skew_scheduler is None:
                raise ValueError("per_rank_times='process' needs a "
                                 "skew_scheduler (its estimator defines "
                                 "the world size)")
            per_rank_times = ProcessTelemetry(
                self.straggler, skew_scheduler.estimator.world,
                allgather=lambda local: world_allgather(self._ctx(), local))
        self.per_rank_times = per_rank_times
        if skew_scheduler is not None:
            self.step_fn = skew_scheduler.fn()
        self.fault_plan = fault_plan
        self.degradation = degradation
        self.rebuild_step = rebuild_step
        self.on_rank_loss = on_rank_loss
        self.liveness = liveness
        self.sleep_fn = sleep_fn
        self._rng = np.random.default_rng(cfg.seed)
        self._fired: set = set()   # (step, event) pairs already injected
        self.restarts = 0
        self.healthy_streak = 0
        self.backoffs: list[float] = []
        self.faults_injected = 0
        self.rank_losses = 0
        self.failures: list[tuple[int, str]] = []   # (step, exception type) a restart
        self.left = False
        self.start_step = 0     # where the last run began, a restored checkpoint's step

    def _ctx(self):
        sh = self.state_shardings
        return None if sh is None else sh.ctx

    def _begin_trace(self) -> None:
        """Reset the degradation policy's active-key ledger as a step starts
        to run: the step repopulates it through ``effective_mode``, so a
        later ``record_failure(None)`` blames only ops that step ran."""
        if self.degradation is not None:
            self.degradation.begin_trace()

    def _feed_skew(self, dt: float) -> None:
        sched = self.skew_scheduler
        if sched is None:
            return
        world = sched.estimator.world
        times = (self.per_rank_times(dt) if self.per_rank_times is not None
                 else [dt] * world)
        if sched.observe(times):
            log.info("skew bucket -> %d (axis %r); rebuilding the step",
                     sched.bucket, sched.axis)
            self.step_fn = sched.fn()

    def _guard(self, fn, *args):
        """``fn(*args)``; under liveness, after a check of the peers and
        guarded by the monitor."""
        if self.liveness is None:
            return fn(*args)
        self.liveness.check()
        return self.liveness.guarded(fn, *args)

    def _leave_on_liveness(self, e: Exception) -> None:
        """Under liveness, raise the watchdog's verdict on ``e``
        (:func:`~repro_torch.runtime.watchdog.verdict_for`), which leaves
        ``run`` at once.  Injected faults and a non-finite loss keep the
        in-process paths."""
        if self.liveness is None or isinstance(e, NonFiniteLoss):
            return
        verdict = verdict_for(self.liveness, e)
        if verdict is e:
            raise e
        if verdict is not None:
            raise verdict from e

    def maybe_restore(self, state):
        restored = self._guard(self.manager.restore_latest, state, self.state_shardings)
        if restored is None:
            return state, 0
        new_state, step = restored
        log.info("restored checkpoint at step %d", step)
        return new_state, step

    # -- fault injection -------------------------------------------------

    def _events_for(self, step: int):
        """This step's not-yet-fired plan events (replay runs clean)."""
        if self.fault_plan is None:
            return ()
        fresh = tuple(ev for ev in self.fault_plan.at(step)
                      if (step, ev) not in self._fired)
        for ev in fresh:
            self._fired.add((step, ev))
        return fresh

    def _poisoned_step(self, state, batch, ev):
        """Run one step with a NaN in its ``ev.nth_send``-th wire payload
        (the hook is read as each payload goes on the wire)."""
        with wire_faults(nth_send=ev.nth_send) as inj:
            state, metrics = self.step_fn(state, batch)
        if not inj.fired:
            metrics = dict(metrics)
            metrics["loss"] = float("nan")
        return state, metrics

    def _run_step(self, state, batch, events):
        nan_ev = None
        for ev in events:
            self.faults_injected += 1
            if ev.kind == "slow_link":
                self.sleep_fn(ev.delay_s)
            elif ev.kind == "rank_loss":
                raise RankLost(ev.rank)
            elif ev.kind in ("timeout", "rank_fail"):
                raise CollectiveTimeout(
                    f"injected {ev.kind} (rank {ev.rank})")
            else:  # nan_wire
                nan_ev = ev
        # a fault injected before the step blames the previous step's keys,
        # as the reference's blames the live trace's
        self._begin_trace()
        if nan_ev is not None:
            return self._guard(self._poisoned_step, state, batch, nan_ev)
        return self._guard(self.step_fn, state, batch)

    def _save(self, step, state):
        # a save's gathers are collectives: guarded like a step
        self._guard(self.manager.save, step, state, self.state_shardings)

    # -- recovery --------------------------------------------------------

    def _maybe_rebuild(self) -> None:
        """Rebuild after a quarantine-set change.  The ops read the policy
        at call time, so this only refreshes what a build may hold."""
        if self.degradation is None or not self.degradation.consume_dirty():
            return
        if self.skew_scheduler is not None:
            self.skew_scheduler.invalidate()
            self.step_fn = self.skew_scheduler.fn()
        elif self.rebuild_step is not None:
            self.step_fn = self.rebuild_step()

    def _backoff(self) -> None:
        delay = min(self.cfg.backoff_max_s,
                    self.cfg.backoff_base_s * 2.0 ** (self.restarts - 1))
        delay *= 1.0 + self.cfg.backoff_jitter * float(self._rng.random())
        self.backoffs.append(delay)
        self.sleep_fn(delay)

    def _handle_failure(self, step: int, e: Exception) -> None:
        self.restarts += 1
        self.healthy_streak = 0
        self.failures.append((step, type(e).__name__))
        log.error("step %d failed (%s); restart %d/%d", step, e,
                  self.restarts, self.cfg.max_restarts)
        if self.degradation is not None:
            jailed = self.degradation.record_failure()
            if jailed:
                log.warning("quarantined to bulk collectives: %s", jailed)
            self._maybe_rebuild()
        if self.restarts > self.cfg.max_restarts:
            raise e
        self._backoff()

    # -- main loop -------------------------------------------------------

    def run(self, state, batches: Iterator, num_steps: int,
            start_step: int = 0, on_metrics: Callable | None = None):
        """Run to ``num_steps``; returns ``(state, step)``.  ``batches``
        serves step ``start_step`` first.  Where a checkpoint of a later
        step is restored at the start (a resumed run), the batches of the
        steps it already took are drawn and dropped (a port difference: the
        reference serves them again), so a seeded iterator gives each step
        the batch an uninterrupted run gave it, in a fresh process too."""
        step = start_step
        state, ckpt_step = self.maybe_restore(state)
        step = self.start_step = max(step, ckpt_step)
        batches = iter(batches)
        for _ in range(step - start_step):
            next(batches, None)
        if not self.manager.listed:
            # Failures before the first periodic save need something to
            # restore onto — the step updates the state in place, so the
            # pre-step state is gone once a step has run.  The decision is
            # the restore's listing, the same on every rank, and the writer
            # waits at a barrier until every rank has listed: a rank that
            # listed after the writer's save would skip the save's gathers.
            world_barrier(self.state_shardings)
            self._save(step, state)
        last_saved = step
        replay = ReplayBuffer(batches, base_step=step)
        while step < num_steps:
            try:
                batch = replay.next_batch()
            except StopIteration:
                log.warning("data exhausted at step %d/%d; saving partial "
                            "run and draining", step, num_steps)
                if step != last_saved:
                    self._save(step, state)
                break
            events = self._events_for(step)
            t0 = time.monotonic()
            try:
                state, metrics = self._run_step(state, batch, events)
                # the host read waits for the step's kernels and
                # collectives (a save's gathers must not start while one is
                # in flight), surfaces their errors and gates on a finite
                # loss
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise NonFiniteLoss(
                        f"loss={loss!r} at step {step}")
            except RankLost as e:
                self.rank_losses += 1
                if self.on_rank_loss is None or from_liveness(e):
                    raise
                log.error("rank %d lost at step %d; shrinking the world",
                          e.rank, step)
                # every checkpoint in flight lands before any rank leaves (the
                # writer may be one of them)
                self.manager.wait()
                world_barrier(self.state_shardings)
                state, new_fn = self.on_rank_loss(state, e)
                if state is None:
                    # this rank is not in the shrunk world: leave
                    self.left = True
                    self.manager.wait()
                    return None, step
                if new_fn is not None:
                    self.step_fn = new_fn
                replay.rewind(step)
                continue
            except Exception as e:  # node failure path
                self._leave_on_liveness(e)
                self._handle_failure(step, e)
                state, ckpt_step = self.maybe_restore(state)
                step = ckpt_step
                replay.rewind(step)
                continue
            dt = time.monotonic() - t0
            self.straggler.record(dt)
            self._feed_skew(dt)
            self.healthy_streak += 1
            if self.degradation is not None:
                released = self.degradation.record_healthy()
                if released:
                    log.info("cooldown over; re-probing fused path for %s",
                             released)
                self._maybe_rebuild()
            if self.restarts > 0 and self.healthy_streak >= self.cfg.heal_after:
                self.restarts -= 1
                self.healthy_streak = 0
                log.info("sustained healthy run; restart budget healed "
                         "to %d/%d", self.restarts, self.cfg.max_restarts)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % self.cfg.checkpoint_every == 0:
                self._save(step, state)
                last_saved = step
                replay.commit(step)
        self.manager.wait()
        return state, step
