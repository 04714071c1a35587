"""Joining a world of processes, and the launchers' liveness flags.

The port of the JAX package's ``launch/distributed.py``.  The reference
wires hosts together with ``jax.distributed.initialize``, each process
holding several devices; the port runs one process a rank, joined by
``torch.distributed``:

  # on every host i of N (rank i)
  python -m repro_torch.launch.train --coordinator host0:29500 \\
      --num-processes N --process-id i --dp N --heartbeat-dir D --ckpt-dir C

:func:`initialize_distributed` makes the default process group once
(``tcp://<coordinator>``, else torch's ``MASTER_ADDR``/``MASTER_PORT``/
``RANK``/``WORLD_SIZE``, which ``torch.distributed.run`` and the respawn
driver set); :func:`~repro_torch.launch.mesh.init_world` then takes the
world it made and makes the tp and data groups on every rank, in one order.
"""
from __future__ import annotations

import logging
import os

import torch.distributed as dist

log = logging.getLogger("repro_torch.launch")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str = "gloo",
                           initialization_timeout: float | None = None) -> bool:
    """Idempotent: make this process's default group once.  Returns True
    when this call (or an earlier one, or the caller's own) made a world.

    ``coordinator`` is ``host:port`` of rank 0's store, with
    ``num_processes`` and ``process_id``.  Without it, the environment of
    ``torch.distributed.run`` or of the respawn driver (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) makes the world through
    ``env://`` where it holds more than one process.

    The reference's failure policy: with an explicit coordinator, any
    failure is a misconfiguration — a bad address, a port in use, a peer
    missing — and propagates, since a configured multi-process run silently
    falling back to one process would train on 1/N of the data while
    looking healthy; a coordinator without the world size or rank raises
    ``ValueError``.  Nothing configured is one process: no group is made
    and False returned."""
    if dist.is_initialized():
        return True
    kwargs = {}
    if initialization_timeout is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator address set but num_processes/process_id missing "
                             "(pass --num-processes and --process-id)")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, **kwargs)
    elif (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")
          and (_env_int("WORLD_SIZE") or 1) > 1 and _env_int("RANK") is not None):
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        log.info("single-process mode (no coordinator configured)")
        return False
    log.info("distributed init: process %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def add_distributed_cli_args(ap) -> None:
    """Coordinator and liveness flags shared by the train and serve launchers."""
    g = ap.add_argument_group("distributed / liveness")
    g.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (or set MASTER_ADDR and "
                        "MASTER_PORT); omit for one process or under torch.distributed.run")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)
    g.add_argument("--heartbeat-dir", default=None,
                   help="shared directory for per-process heartbeat files; enables the "
                        "liveness watchdog: a dead peer raises RankLost and the launcher "
                        "exits with the respawn protocol's code instead of hanging")
    g.add_argument("--heartbeat-interval", type=float, default=0.25,
                   help="seconds between heartbeats")
    g.add_argument("--stall-after", type=float, default=2.0,
                   help="heartbeat staleness that marks a peer stalled or lost")
    g.add_argument("--step-deadline", type=float, default=None,
                   help="hard per-step deadline even with peers heartbeating "
                        "(deadlocked-collective backstop)")


def init_distributed_from_args(args, backend: str = "gloo") -> bool:
    """:func:`initialize_distributed` from the flags and the environment
    (a no-op when nothing is configured: one process)."""
    return initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                  backend=backend)


def build_liveness_from_args(args):
    """(HeartbeatWriter, LivenessMonitor) when ``--heartbeat-dir`` is set,
    else (None, None).  The rank and world come from ``torch.distributed``,
    or (0, 1) without a world; the generation from the respawn driver's
    ``REPRO_MP_GEN`` (0 without it).  The writer is started; the monitor
    starts disarmed — arm it (``monitor.enabled = True``) after the first
    whole step, so a slow start is never read as a stall."""
    if not getattr(args, "heartbeat_dir", None):
        return None, None
    from repro_torch.runtime.multiprocess import current_generation
    from repro_torch.runtime.watchdog import HeartbeatWriter, LivenessMonitor

    generation = current_generation()
    rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                   else (0, 1))
    writer = HeartbeatWriter(args.heartbeat_dir, rank, generation=generation,
                             interval_s=args.heartbeat_interval).start()
    monitor = LivenessMonitor(args.heartbeat_dir, rank, world, generation=generation,
                              stall_after_s=args.stall_after,
                              step_deadline_s=args.step_deadline)
    monitor.enabled = False
    return writer, monitor


def join_world(args):
    """The launchers' start: :func:`init_distributed_from_args` on the
    world's backend (``--backend``, else nccl on a card and gloo on the
    CPU), ``args.dp``/``args.tp`` shrunk by :func:`fit_world` where the
    world is smaller (rank 0 says so), then ``launch/mesh.init_world``'s
    groups; returns this rank's device."""
    from repro_torch.launch.mesh import default_backend, init_world

    backend = args.backend or default_backend(args.device)
    init_distributed_from_args(args, backend)
    size = dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE")
    if size is not None and size < args.dp * args.tp:
        dp, tp = fit_world(args.dp, args.tp, size)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"world size {size}: (dp, tp) = ({dp}, {tp}), shrunk from --dp "
                  f"{args.dp} --tp {args.tp}", flush=True)
        args.dp, args.tp = dp, tp
    return init_world(args.tp, backend, args.device, dp=args.dp)


def fit_world(dp: int, tp: int, size: int) -> tuple[int, int]:
    """(dp, tp) shrunk until ``dp * tp`` is the world's ``size``, by the rule
    of ``runtime/elastic.shrink_context``: halve the data axis while it
    divides, else tp.  A respawned generation can be smaller than the flags
    say; the reference's mesh takes the devices there are, the port has one
    process a rank.  Raises ``ValueError`` where no halving reaches ``size``."""
    want = (dp, tp)
    while dp * tp > size:
        if dp % 2 == 0:
            dp //= 2
        elif tp % 2 == 0:
            tp //= 2
        else:
            break
    if dp * tp != size:
        raise ValueError(f"(dp, tp) = {want} does not shrink to a world of {size} processes")
    return dp, tp
