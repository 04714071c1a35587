"""Liveness: heartbeat files and a watchdog that raises the chaos surface.

The port of the JAX package's ``runtime/watchdog.py``, with its file format:
``hb_<rank>.json`` holding the keys of :class:`Heartbeat`, so that either
package reads the other's heartbeats.  The supervisor's recovery paths
(:mod:`repro_torch.runtime.fault_tolerance`, the serve launcher's journal)
fire on :class:`~repro_torch.runtime.chaos.CollectiveTimeout` and
:class:`~repro_torch.runtime.chaos.RankLost`; here they come from process
liveness, not from an injected plan.

:class:`HeartbeatWriter`
    A daemon thread that atomically rewrites ``hb_<rank>.json`` every
    ``interval_s`` with (rank, pid, wall time, step, generation, status).  It
    keeps beating while the main thread waits inside a collective (torch
    releases the interpreter lock there), so "alive but wedged" and "gone"
    look different from outside.

:class:`LivenessMonitor`
    Classifies every peer's heartbeat: fresh -> ``alive``; stale with its
    pid gone, or a ``leaving`` status -> ``dead``; stale with its pid alive
    (stopped, wedged) -> ``stalled``; none yet -> ``starting`` until the
    grace ends, then ``dead``.  ``check()`` raises the first non-alive peer
    as the fault surface (``dead`` wins over ``stalled``); ``guarded(fn)``
    runs one step on a side thread while polling, so a peer killed between
    two sends surfaces within a poll of its detection.

:class:`Watchdog`
    ``check()`` on a background thread, for loops that cannot poll inline.

:func:`diagnose`
    A gloo transport error (a peer's socket closed) usually arrives before
    the peer's heartbeat goes stale: it waits one staleness deadline for the
    watchdog's verdict and raises that instead.

Every raise from liveness carries ``liveness = True`` (:func:`from_liveness`),
so a supervisor tells it from an injected fault of the same class.  The
clock, the pid prober and the directory are injectable: the classification
and both raise paths are tested without processes
(``tests/test_torch_watchdog.py``); the drills with real processes are
``tests/test_torch_respawn_*.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Mapping

import torch

from repro_torch.runtime.chaos import CollectiveTimeout, RankLost

log = logging.getLogger("repro_torch.runtime")

#: heartbeat file name for one rank (all ranks share one directory)
HEARTBEAT_FMT = "hb_{rank}.json"

#: classification states returned by :meth:`LivenessMonitor.observe`
ALIVE, STARTING, STALLED, DEAD = "alive", "starting", "stalled", "dead"


@dataclasses.dataclass
class Heartbeat:
    """One rank's most recent liveness record."""

    rank: int
    pid: int
    time: float
    step: int = 0
    generation: int = 0
    status: str = "up"           # "up" | "leaving"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, HEARTBEAT_FMT.format(rank=rank))


def write_heartbeat(directory: str, hb: Heartbeat) -> None:
    """Atomic single-file write: a reader never sees a torn record."""
    path = heartbeat_path(directory, hb.rank)
    tmp = f"{path}.tmp.{hb.pid}"
    with open(tmp, "w") as f:
        f.write(hb.to_json())
    os.replace(tmp, path)


def read_heartbeat(directory: str, rank: int) -> Heartbeat | None:
    """Best-effort read; a missing or garbled file reads as "no heartbeat
    yet" (a torn write cannot happen, but a crashed writer leaves nothing)."""
    try:
        with open(heartbeat_path(directory, rank)) as f:
            return Heartbeat(**json.load(f))
    except (OSError, ValueError, TypeError):
        return None


def default_pid_alive(pid: int) -> bool:
    """Is ``pid`` running (stopped included)?  Signal 0 probes without
    delivering; it means something only for a process on this host — a
    deployment over several hosts passes a prober of its own."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # exists, owned by someone else
        return True
    return True


def from_liveness(exc: BaseException) -> bool:
    """Did the watchdog raise ``exc`` (not a fault plan, not the step)?"""
    return getattr(exc, "liveness", False)


def _verdict(exc: Exception) -> Exception:
    exc.liveness = True
    return exc


class HeartbeatWriter:
    """Daemon thread beating ``hb_<rank>.json`` every ``interval_s``."""

    def __init__(self, directory: str, rank: int, *, generation: int = 0,
                 interval_s: float = 0.25, pid: int | None = None,
                 clock: Callable[[], float] = time.time):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.rank = rank
        self.generation = generation
        self.interval_s = interval_s
        self.pid = os.getpid() if pid is None else pid
        self.clock = clock
        self.step = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self, step: int | None = None, status: str = "up") -> None:
        # the thread and the caller both beat: one writes the file at a time
        with self._lock:
            if step is not None:
                self.step = int(step)
            write_heartbeat(self.directory, Heartbeat(
                rank=self.rank, pid=self.pid, time=self.clock(), step=self.step,
                generation=self.generation, status=status))

    def start(self) -> "HeartbeatWriter":
        self.beat()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heartbeat-r{self.rank}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self, status: str = "leaving") -> None:
        """Final beat with ``status``, so peers tell a clean departure from
        a crash."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
            self._thread = None
        try:
            self.beat(status=status)
        except OSError:  # the heartbeat directory went first: nothing to say
            pass

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclasses.dataclass
class PeerState:
    """One peer's classification at one ``observe()`` instant."""

    rank: int
    state: str                   # ALIVE | STARTING | STALLED | DEAD
    age_s: float = 0.0
    pid: int | None = None
    step: int = 0


def _caller_state():
    """A context manager that enters, on another thread, the torch state the
    calling thread runs under, which is per thread: grad mode, inference
    mode and, where CUDA is initialised, the current device and its current
    stream (a prefetched batch is handed over on the caller's stream, and a
    checkpoint's copies are ordered on it)."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    stream = None
    if torch.cuda.is_initialized():
        stream = torch.cuda.current_stream()

    @contextlib.contextmanager
    def enter():
        with contextlib.ExitStack() as stack:
            if inference:     # inference_mode(False) would turn grad mode on
                stack.enter_context(torch.inference_mode())
            stack.enter_context(torch.set_grad_enabled(grad))
            if stream is not None:
                stack.enter_context(torch.cuda.device(stream.device))
                stack.enter_context(torch.cuda.stream(stream))
            yield
    return enter


class LivenessMonitor:
    """Classify peers from their heartbeat files; raise the chaos surface.

    ``stall_after_s`` is the staleness deadline: a heartbeat older than this
    marks the peer non-alive (the writer beats every 0.25 s by default, so
    2 s tolerates 8 missed beats).  A non-alive peer whose pid is gone — or
    which wrote a ``leaving`` status — is ``DEAD`` (:class:`RankLost`,
    permanent); one whose pid still exists is ``STALLED``
    (:class:`CollectiveTimeout`, transient).  A peer without a first
    heartbeat of this generation stays ``STARTING`` until ``start_grace_s``,
    then counts as dead.

    ``enabled`` gates ``check()``: a worker arms the monitor after its first
    whole step, so a slow start is never read as a stall."""

    def __init__(self, directory: str, rank: int, world: int, *,
                 generation: int = 0, stall_after_s: float = 2.0,
                 start_grace_s: float = 120.0,
                 step_deadline_s: float | None = None,
                 pid_alive: Callable[[int], bool] = default_pid_alive,
                 clock: Callable[[], float] = time.time):
        self.directory = directory
        self.rank = rank
        self.world = world
        self.generation = generation
        self.stall_after_s = stall_after_s
        self.start_grace_s = start_grace_s
        self.step_deadline_s = step_deadline_s
        self.pid_alive = pid_alive
        self.clock = clock
        self.enabled = True
        self._t0 = clock()

    def _classify(self, rank: int, now: float) -> PeerState:
        hb = read_heartbeat(self.directory, rank)
        if hb is None or hb.generation < self.generation:
            state = STARTING if now - self._t0 < self.start_grace_s else DEAD
            return PeerState(rank=rank, state=state, age_s=now - self._t0)
        age = now - hb.time
        if hb.status != "up":
            return PeerState(rank=rank, state=DEAD, age_s=age, pid=hb.pid, step=hb.step)
        if age <= self.stall_after_s:
            return PeerState(rank=rank, state=ALIVE, age_s=age, pid=hb.pid, step=hb.step)
        state = STALLED if self.pid_alive(hb.pid) else DEAD
        return PeerState(rank=rank, state=state, age_s=age, pid=hb.pid, step=hb.step)

    def observe(self) -> Mapping[int, PeerState]:
        """Classification for every peer rank (not this one)."""
        now = self.clock()
        return {r: self._classify(r, now) for r in range(self.world) if r != self.rank}

    def check(self) -> None:
        """Raise for the first lost or stalled peer: ``DEAD`` ->
        :class:`RankLost`, ``STALLED`` -> :class:`CollectiveTimeout`.  Dead
        peers win over stalled ones: a dead rank is the stronger diagnosis,
        and its recovery covers the restart."""
        if not self.enabled:
            return
        peers = self.observe()
        for st in peers.values():
            if st.state == DEAD:
                log.error("liveness: rank %d lost (pid %s, heartbeat %.1fs stale)",
                          st.rank, st.pid, st.age_s)
                raise _verdict(RankLost(st.rank, f"liveness: rank {st.rank} lost (heartbeat "
                                                 f"{st.age_s:.1f}s stale, pid gone)"))
        for st in peers.values():
            if st.state == STALLED:
                log.error("liveness: rank %d stalled (pid %s alive, heartbeat %.1fs stale)",
                          st.rank, st.pid, st.age_s)
                raise _verdict(CollectiveTimeout(
                    f"liveness: rank {st.rank} stalled (pid {st.pid} alive, heartbeat "
                    f"{st.age_s:.1f}s stale)"))

    def guarded(self, fn: Callable, *args, deadline_s: float | None = None,
                poll_s: float = 0.05, **kwargs):
        """Run ``fn(*args, **kwargs)`` while polling peer liveness.

        The call runs on a daemon thread under the caller's torch state
        (grad and inference mode, CUDA device and stream); the caller polls
        ``check()`` while joining it, so a hang inside a collective (a peer
        died between two sends) raises within ``poll_s`` of detection.
        ``deadline_s`` (default :attr:`step_deadline_s`) bounds the call
        even with every peer heartbeating: the deadlocked-collective case.

        On a liveness raise the thread is abandoned mid-call (it waits in
        native code and cannot be cancelled).  A step that updates its state
        in place (the port's AdamW) leaves that state half updated, so the
        caller reuses nothing and leaves the process: the respawn protocol
        of :mod:`repro_torch.runtime.multiprocess`."""
        if deadline_s is None:
            deadline_s = self.step_deadline_s
        box: list = [None, None]   # [result, exception]
        done = threading.Event()
        state = _caller_state()

        def work():
            try:
                with state():
                    box[0] = fn(*args, **kwargs)
            except BaseException as e:  # surfaced on the caller's thread
                box[1] = e
            finally:
                done.set()

        t = threading.Thread(target=work, daemon=True, name="guarded-step")
        start = self.clock()
        t.start()
        while not done.wait(poll_s):
            self.check()
            if deadline_s is not None and self.clock() - start > deadline_s:
                raise _verdict(CollectiveTimeout(
                    f"step exceeded deadline {deadline_s:.1f}s with all peers heartbeating "
                    f"(deadlocked collective?)"))
        if box[1] is not None:
            raise box[1]
        return box[0]


def await_verdict(monitor: LivenessMonitor, *, extra_wait_s: float = 3.0,
                  poll_s: float = 0.1) -> Exception | None:
    """The watchdog's verdict within one staleness deadline plus
    ``extra_wait_s`` (the monitor armed for the while), or None where every
    peer stayed alive."""
    deadline = time.monotonic() + monitor.stall_after_s + extra_wait_s
    enabled, monitor.enabled = monitor.enabled, True
    try:
        while time.monotonic() < deadline:
            monitor.check()
            time.sleep(poll_s)
    except (RankLost, CollectiveTimeout) as verdict:
        return verdict
    finally:
        monitor.enabled = enabled
    return None


def verdict_for(monitor: LivenessMonitor, exc: BaseException) -> Exception | None:
    """The watchdog's verdict on a failure ``exc``: ``exc`` itself where the
    watchdog raised it; None for a fault of the chaos surface it did not
    raise (an injected one); else, for the step's own error (gloo's, as a
    peer's socket closes), :func:`await_verdict`'s."""
    if from_liveness(exc):
        return exc
    if isinstance(exc, (RankLost, CollectiveTimeout)):
        return None
    return await_verdict(monitor)


def diagnose(monitor: LivenessMonitor, exc: BaseException, *, extra_wait_s: float = 3.0):
    """Translate a transport failure into the watchdog's verdict.

    A peer that dies inside a collective surfaces first as gloo's own error
    (its socket closed), often before its heartbeat goes stale: raise the
    verdict of :func:`await_verdict` (chained to ``exc``) where a peer is
    ``DEAD`` or ``STALLED``, else ``exc`` again."""
    verdict = await_verdict(monitor, extra_wait_s=extra_wait_s)
    if verdict is not None:
        raise verdict from exc
    raise exc


class Watchdog:
    """Background-thread watchdog for loops that cannot poll inline.

    Polls ``monitor.check()`` every ``poll_s``; the first raise is parked
    and raised again from :meth:`maybe_raise` (call it once a tick)."""

    def __init__(self, monitor: LivenessMonitor, *, poll_s: float = 0.25):
        self.monitor = monitor
        self.poll_s = poll_s
        self.failure: Exception | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="watchdog")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.monitor.check()
            except (RankLost, CollectiveTimeout) as e:
                self.failure = e
                return

    def maybe_raise(self) -> None:
        if self.failure is not None:
            raise self.failure

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
