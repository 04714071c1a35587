"""Real multi-process scale-out: the respawn driver and the worker's side.

The port of the JAX package's ``runtime/multiprocess.py``.  The reference's
workers are ``jax.distributed`` processes holding several CPU devices each;
the port's are one process a rank joined by ``torch.distributed`` (gloo on
the CPU, or gloo ranks sharing a card, or NCCL with a card a rank), each on
its one device by ``launch/mesh.world_device``'s rule, so the reference's
``configure`` (which set ``XLA_FLAGS``) has no counterpart.  The launchers
themselves are the workers (``-m repro_torch.launch.train ...``).

A :class:`MultiprocessDriver` spawns a generation of workers, collects
their logs and exit codes, and runs the respawn protocol:

1. Workers heartbeat (:mod:`repro_torch.runtime.watchdog`) and run every
   step under the liveness monitor.  A SIGKILLed peer first breaks a gloo
   collective (its socket closes); :func:`~repro_torch.runtime.watchdog.
   diagnose` turns that into :class:`~repro_torch.runtime.chaos.RankLost`
   once the peer's heartbeat is stale and its pid gone.  A stopped peer
   (SIGSTOP, a wedged runtime) surfaces as :class:`~repro_torch.runtime.
   chaos.CollectiveTimeout`.
2. The worker exits with a protocol code: :data:`EXIT_RESHARD` (a peer is
   gone: relaunch the survivors on a smaller world) or :data:`EXIT_RESTART`
   (a transient stall: relaunch the same world).  Surviving in the process
   is impossible: a gloo world with a dead member cannot be torn down or
   reused, and an abandoned step has half updated the in-place state.
3. The driver reaps stragglers (SIGCONT, then SIGKILL), picks a fresh port
   and launches the next generation with dense ranks.  Workers restore from
   the shared checkpoint directory and fast-forward the seeded batches, so a
   recovered run's final state equals, bit for bit, a fault-free run's on
   the smaller world from the same checkpoint
   (``tests/test_torch_respawn_train.py``).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.perfmodel import GLOO_HOST, HardwareModel
from repro_torch.runtime.watchdog import (HeartbeatWriter, LivenessMonitor, diagnose,
                                          read_heartbeat)

log = logging.getLogger("repro_torch.runtime")

#: worker exit codes: the driver's respawn protocol
EXIT_OK = 0
EXIT_RESTART = 16   # transient stall (CollectiveTimeout): same-world respawn
EXIT_RESHARD = 17   # permanent peer loss (RankLost): shrunk-world respawn

_ENV_PREFIX = "REPRO_MP_"


def pick_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def current_generation() -> int:
    """The respawn generation this process belongs to (0 outside a driver)."""
    return int(os.environ.get(f"{_ENV_PREFIX}GEN", "0"))


@dataclasses.dataclass
class WorkerEnv:
    """Per-worker contract, shipped through the environment.  Besides the
    reference's keys it sets torch's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, so a launcher joins the world as under
    ``torch.distributed.run`` (``env://``)."""

    rank: int
    world: int
    coordinator: str
    generation: int = 0
    heartbeat_dir: str = ""
    extra: dict = dataclasses.field(default_factory=dict)

    def to_env(self) -> dict[str, str]:
        addr, port = self.coordinator.rsplit(":", 1)
        return {
            f"{_ENV_PREFIX}RANK": str(self.rank),
            f"{_ENV_PREFIX}WORLD": str(self.world),
            f"{_ENV_PREFIX}COORD": self.coordinator,
            f"{_ENV_PREFIX}GEN": str(self.generation),
            f"{_ENV_PREFIX}HBDIR": self.heartbeat_dir,
            f"{_ENV_PREFIX}EXTRA": json.dumps(self.extra),
            "RANK": str(self.rank), "WORLD_SIZE": str(self.world),
            "LOCAL_RANK": str(self.rank), "LOCAL_WORLD_SIZE": str(self.world),
            "MASTER_ADDR": addr, "MASTER_PORT": port,
        }

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "WorkerEnv":
        env = os.environ if env is None else env
        return cls(
            rank=int(env[f"{_ENV_PREFIX}RANK"]),
            world=int(env[f"{_ENV_PREFIX}WORLD"]),
            coordinator=env[f"{_ENV_PREFIX}COORD"],
            generation=int(env.get(f"{_ENV_PREFIX}GEN", "0")),
            heartbeat_dir=env.get(f"{_ENV_PREFIX}HBDIR", ""),
            extra=json.loads(env.get(f"{_ENV_PREFIX}EXTRA", "{}")),
        )


# -- worker side -----------------------------------------------------------

@dataclasses.dataclass
class WorkerRuntime:
    """Live per-worker handles returned by :func:`init_worker`."""

    cfg: WorkerEnv
    writer: HeartbeatWriter
    monitor: LivenessMonitor
    device: torch.device

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def host_gather(self, tree, placement=None):
        """Every leaf whole on the host, split leaves gathered over
        ``placement``'s world through the checkpointer's gathers (a
        collective: every rank calls it)."""
        from repro_torch.checkpoint.checkpointer import tree_to_host

        return tree_to_host(tree, placement)

    def diagnose(self, exc: BaseException, *, extra_wait_s: float = 3.0):
        """A transport error turned into the watchdog's verdict
        (:func:`~repro_torch.runtime.watchdog.diagnose`)."""
        diagnose(self.monitor, exc, extra_wait_s=extra_wait_s)

    def leave(self, code: int = EXIT_OK, status: str = "leaving") -> None:
        """End this worker with a protocol exit code, after a final beat.

        ``os._exit`` on purpose, and no ``destroy_process_group``: with a
        dead peer the group's teardown hangs, and on a healthy world the
        last barrier has already ordered everything that matters."""
        sys.stdout.flush()
        sys.stderr.flush()
        self.writer.stop(status=status)
        os._exit(code)


def init_worker(cfg: WorkerEnv, *, backend: str = "gloo", device="cpu",
                initialization_timeout: float = 60, stall_after_s: float = 2.0,
                step_deadline_s: float | None = None) -> WorkerRuntime:
    """Join this process to its generation's world and start liveness.

    The monitor starts disarmed (``enabled=False``): arm it after the first
    whole step, so a slow start is never read as a peer stall."""
    from repro_torch.launch.distributed import initialize_distributed
    from repro_torch.launch.mesh import world_device

    if cfg.world > 1:
        initialize_distributed(cfg.coordinator, cfg.world, cfg.rank, backend=backend,
                               initialization_timeout=initialization_timeout)
    dev = world_device(backend, device, cfg.rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    writer = HeartbeatWriter(cfg.heartbeat_dir or ".", cfg.rank,
                             generation=cfg.generation).start()
    monitor = LivenessMonitor(cfg.heartbeat_dir or ".", cfg.rank, cfg.world,
                              generation=cfg.generation, stall_after_s=stall_after_s,
                              step_deadline_s=step_deadline_s)
    monitor.enabled = False
    return WorkerRuntime(cfg=cfg, writer=writer, monitor=monitor, device=dev)


def exit_for_respawn(exc: BaseException, writer: HeartbeatWriter) -> None:
    """End the process with the protocol's code for the watchdog's verdict
    ``exc`` (:data:`EXIT_RESHARD` for a lost peer, :data:`EXIT_RESTART`
    for a stall), after a line saying so and a final ``leaving`` beat.
    ``os._exit``: a world with a dead member cannot be torn down."""
    from repro_torch.runtime.chaos import RankLost

    code = EXIT_RESHARD if isinstance(exc, RankLost) else EXIT_RESTART
    print(f"liveness failure ({type(exc).__name__} from liveness): {exc}; exiting with "
          f"respawn code {code}", flush=True)
    sys.stderr.flush()
    writer.stop()
    os._exit(code)


# -- driver side -----------------------------------------------------------

@dataclasses.dataclass
class ProcHandle:
    rank: int
    popen: subprocess.Popen
    log_path: str
    reaped_by_driver: bool = False
    exited_at: float | None = None      # wall time the driver saw it exit

    @property
    def returncode(self):
        return self.popen.returncode


@dataclasses.dataclass
class GenerationResult:
    generation: int
    world: int
    codes: dict            # rank -> exit code (negative = killed by signal)
    duration_s: float
    heartbeat_dir: str
    exit_times: dict = dataclasses.field(default_factory=dict)   # rank -> wall time


@dataclasses.dataclass
class ElasticReport:
    """Outcome of :meth:`MultiprocessDriver.run_elastic`."""

    completed: bool
    generations: list
    timeline: list         # (event, detail, wall_time) tuples

    def events(self, kind: str):
        return [t for t in self.timeline if t[0] == kind]


class MultiprocessDriver:
    """Spawn, watch, reap and respawn generations of worker processes.

    ``worker_argv`` is the worker command after the interpreter (a script
    and its flags, or ``["-m", "repro_torch.launch.train", ...]``); in each
    element ``{heartbeat_dir}`` becomes the generation's heartbeat directory
    and ``{generation}`` its number.  Per generation, under ``workdir``:
    ``logs/g<gen>_r<rank>.log`` and the heartbeat directory ``hb_g<gen>``.
    ``env`` is the workers' base environment (default: this process's);
    the driver adds each worker's :class:`WorkerEnv`, puts this package's
    ``src`` first on ``PYTHONPATH`` and keeps gloo on the loopback device
    unless ``GLOO_SOCKET_IFNAME`` says otherwise (the workers share this
    host).

    While waiting on a generation the driver polls its workers; once any
    has exited abnormally the rest get ``hang_grace_s`` to run their own
    detection and leave, then are reaped (SIGCONT + SIGKILL: a stopped
    straggler would hold the generation open for ever).  :meth:`close`
    reaps whatever still runs."""

    def __init__(self, worker_argv: Sequence[str], nproc: int, *, workdir: str = ".",
                 extra: dict | None = None, env: Mapping[str, str] | None = None,
                 hang_grace_s: float = 30.0):
        self.worker_argv = list(worker_argv)
        self.nproc = nproc
        self.workdir = workdir
        self.extra = dict(extra or {})
        self.base_env = dict(os.environ if env is None else env)
        self.hang_grace_s = hang_grace_s
        self.procs: list[ProcHandle] = []
        self.generation = -1
        self.heartbeat_dir = ""
        self.timeline: list = []
        os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)

    # -- spawn ----------------------------------------------------------
    def launch_generation(self, generation: int, world: int, extra: dict | None = None) -> None:
        if any(p.popen.poll() is None for p in self.procs):
            raise RuntimeError("previous generation still running")
        self.generation = generation
        self.heartbeat_dir = os.path.join(self.workdir, f"hb_g{generation}")
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        coordinator = f"127.0.0.1:{pick_free_port()}"
        argv = [a.replace("{heartbeat_dir}", self.heartbeat_dir)
                .replace("{generation}", str(generation)) for a in self.worker_argv]
        src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.procs = []
        self._mark("launch", {"generation": generation, "world": world})
        for rank in range(world):
            cfg = WorkerEnv(rank=rank, world=world, coordinator=coordinator,
                            generation=generation, heartbeat_dir=self.heartbeat_dir,
                            extra={**self.extra, **(extra or {})})
            env = dict(self.base_env)
            env.update(cfg.to_env())
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            env["PYTHONPATH"] = os.pathsep.join(
                [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
            log_path = os.path.join(self.workdir, "logs", f"g{generation}_r{rank}.log")
            with open(log_path, "w") as f:
                popen = subprocess.Popen([sys.executable, "-u"] + argv, stdout=f,
                                         stderr=subprocess.STDOUT, env=env)
            self.procs.append(ProcHandle(rank=rank, popen=popen, log_path=log_path))

    # -- observe / fault ------------------------------------------------
    def _mark(self, event: str, detail) -> None:
        self.timeline.append((event, detail, time.time()))

    def heartbeat_step(self, rank: int) -> int | None:
        hb = read_heartbeat(self.heartbeat_dir, rank)
        return None if hb is None or hb.generation != self.generation else hb.step

    def wait_for_step(self, rank: int, step: int, timeout_s: float = 300.0) -> int:
        """Block until ``rank``'s heartbeat reports ``step`` or later."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            seen = self.heartbeat_step(rank)
            if seen is not None and seen >= step:
                return seen
            if self.procs[rank].popen.poll() is not None:
                raise RuntimeError(f"rank {rank} exited (code {self.procs[rank].returncode}) "
                                   f"before reaching step {step}")
            time.sleep(0.02)
        raise TimeoutError(f"rank {rank} never reached step {step} within {timeout_s:.0f}s")

    def kill(self, rank: int, sig: int = signal.SIGKILL) -> float:
        """Signal one worker; returns the wall time of delivery."""
        self.procs[rank].popen.send_signal(sig)
        t = time.time()
        self._mark("kill", {"generation": self.generation, "rank": rank, "signal": int(sig)})
        return t

    def kill_at_step(self, rank: int, step: int, sig: int = signal.SIGKILL,
                     timeout_s: float = 300.0) -> float:
        self.wait_for_step(rank, step, timeout_s)
        return self.kill(rank, sig)

    # -- reap -----------------------------------------------------------
    def _reap(self, proc: ProcHandle) -> None:
        for sig in (signal.SIGCONT, signal.SIGKILL):
            try:
                proc.popen.send_signal(sig)
            except ProcessLookupError:
                pass
        proc.popen.wait()
        proc.exited_at = proc.exited_at or time.time()
        proc.reaped_by_driver = True
        self._mark("reap", {"generation": self.generation, "rank": proc.rank})

    def close(self) -> None:
        """Reap every worker still running (a drill that failed midway)."""
        for p in self.procs:
            if p.popen.poll() is None:
                self._reap(p)

    def wait_generation(self, timeout_s: float = 600.0) -> GenerationResult:
        """Wait for every worker to exit, reaping stragglers.

        Once any worker exits abnormally (a protocol code, a crash, a kill),
        the rest get ``hang_grace_s`` to detect it and leave; whoever is
        still up after that (a stopped rank) is reaped.  Polling also reaps
        an exited worker at once, so its pid reads as gone to its peers'
        monitors."""
        t0 = time.time()
        abnormal_at: float | None = None
        while True:
            for p in self.procs:
                if p.exited_at is None and p.popen.poll() is not None:
                    p.exited_at = time.time()
            running = [p for p in self.procs if p.exited_at is None]
            if not running:
                break
            codes = [p.returncode for p in self.procs if p.popen.poll() is not None]
            if abnormal_at is None and any(c != EXIT_OK for c in codes):
                abnormal_at = time.time()
            now = time.time()
            if now - t0 > timeout_s:
                for p in running:
                    self._reap(p)
                raise TimeoutError(f"generation {self.generation} exceeded {timeout_s:.0f}s "
                                   f"({len(running)} workers still up)")
            if abnormal_at is not None and now - abnormal_at > self.hang_grace_s:
                for p in running:
                    log.warning("reaping rank %d (no exit %.0fs after the first abnormal exit)",
                                p.rank, self.hang_grace_s)
                    self._reap(p)
                break
            time.sleep(0.05)
        result = GenerationResult(generation=self.generation, world=len(self.procs),
                                  codes={p.rank: p.returncode for p in self.procs},
                                  duration_s=time.time() - t0,
                                  heartbeat_dir=self.heartbeat_dir,
                                  exit_times={p.rank: p.exited_at for p in self.procs})
        self._mark("generation_end", {"generation": self.generation,
                                      "codes": dict(result.codes)})
        return result

    # -- the respawn loop -----------------------------------------------
    def run_elastic(self, *, max_generations: int = 4, gen_timeout_s: float = 600.0,
                    faults: Mapping[int, Callable] | None = None,
                    on_generation_end: Callable | None = None) -> ElasticReport:
        """The generation loop of the respawn protocol.

        ``faults`` maps a generation to a callable run on a side thread
        after it launches (``lambda d: d.kill_at_step(1, 3)``: the real
        fault).  ``on_generation_end(driver, result)`` runs between
        generations (a drill copies the checkpoint directory there for its
        fault-free twin).

        Every worker exiting :data:`EXIT_OK` completes the run.  Any
        :data:`EXIT_RESHARD` shrinks the next world to the cooperating
        survivors; otherwise any :data:`EXIT_RESTART` relaunches the same
        world; anything else (every worker crashed or killed) stops.  A
        failure inside the loop reaps the generation before it propagates."""
        world = self.nproc
        generations: list[GenerationResult] = []
        try:
            for gen in range(max_generations):
                self.launch_generation(gen, world)
                fault = (faults or {}).get(gen)
                fault_thread = None
                if fault is not None:
                    fault_thread = threading.Thread(target=fault, args=(self,), daemon=True,
                                                    name=f"fault-g{gen}")
                    fault_thread.start()
                result = self.wait_generation(gen_timeout_s)
                generations.append(result)
                if fault_thread is not None:
                    fault_thread.join(timeout=10)
                if on_generation_end is not None:
                    on_generation_end(self, result)
                if all(c == EXIT_OK for c in result.codes.values()):
                    return ElasticReport(completed=True, generations=generations,
                                         timeline=list(self.timeline))
                next_world = next_generation_world(result.codes)
                if next_world is None:
                    break
                world = next_world
        finally:
            self.close()
        return ElasticReport(completed=False, generations=generations,
                             timeline=list(self.timeline))


def next_generation_world(codes: Mapping[int, int]) -> int | None:
    """The respawn decision from one generation's exit codes.

    Reshard voters shrink the world to the cooperating survivors, restart
    voters keep it, and a generation with no protocol exit at all
    (everyone crashed or was killed) returns None: nothing to respawn
    around."""
    vals = list(codes.values())
    # a process that left through the protocol (or drained cleanly) is one
    # the next generation can be built around, a restart voter included
    # when a peer's stronger reshard diagnosis wins
    survivors = sum(1 for c in vals if c in (EXIT_OK, EXIT_RESHARD, EXIT_RESTART))
    if any(c == EXIT_RESHARD for c in vals):
        return survivors if survivors > 0 else None
    if any(c == EXIT_RESTART for c in vals):
        return len(vals)
    return None


# -- the measured cross-process link ---------------------------------------

def fit_alpha_beta(sizes_bytes: Sequence[float],
                   times_s: Sequence[float]) -> tuple[float, float]:
    """Least-squares fit ``t = alpha + beta * bytes``; both clamped
    non-negative (noise on small payloads can drive the free fit below 0)."""
    b = np.asarray(sizes_bytes, np.float64)
    t = np.asarray(times_s, np.float64)
    A = np.stack([np.ones_like(b), b], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    return float(max(alpha, 0.0)), float(max(beta, 1e-15))


def measured_hardware_model(sizes_bytes, times_s, *,
                            base: HardwareModel = GLOO_HOST) -> HardwareModel:
    """A :class:`~repro_torch.core.perfmodel.HardwareModel` whose link
    constants come from measured ring times; the compute constants carry
    over from ``base`` (a link measurement says nothing about the chip).
    The base is the host-staged gloo class where the reference's is its
    pod-crossing ``DCN``."""
    alpha, beta = fit_alpha_beta(sizes_bytes, times_s)
    return dataclasses.replace(base, ici_bw=1.0 / beta, ici_lat=alpha)


def measure_ring(sizes_bytes: Sequence[int], *, group=None, device="cpu", iters: int = 5,
                 warmup: int = 2) -> list[float]:
    """Median seconds of a ``dist.all_reduce`` of each payload size over
    ``group`` (default: the whole world), f32 payloads; every rank of the
    group calls it.  Returns one time a size."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    out: list[float] = []
    for nbytes in sizes_bytes:
        x = torch.ones(max(1, int(nbytes) // 4), dtype=torch.float32, device=device)
        for _ in range(warmup):
            dist.all_reduce(x, group=group)
        sync()
        dist.barrier(group=group)
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            dist.all_reduce(x, group=group)
            sync()
            ts.append(time.perf_counter() - t0)
        out.append(float(np.median(ts)))
    return out
