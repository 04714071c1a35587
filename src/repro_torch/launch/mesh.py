"""Starting the (dp, tp) world.

The JAX package builds a device mesh over the devices one process sees
(``make_host_mesh``); the port runs one process per rank instead, joined by
``torch.distributed``:

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.serve --tp 4 --backend gloo

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --dp 2 --tp 2 --backend gloo

A world of ``dp * tp`` ranks holds ``dp`` replicas of a tp world: global
rank ``r`` is tp rank ``r % tp`` of replica ``r // tp``
(``parallel.sharding.make_world_groups`` makes the groups).  A world of one
rank needs no process group, so every (1, 1) path runs as it did without
one.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import forget_world_groups, make_world_groups

BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    """NCCL on a card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def world_device(backend: str, device, local_rank: int) -> torch.device:
    """The device rank ``local_rank`` of a host computes on.

    An NCCL world takes one card a rank (``cuda:LOCAL_RANK``; NCCL refuses
    two ranks on one card).  A gloo world on cards spreads its ranks over
    the cards there are, so on a one-card host every rank shares the one
    card.  ``cpu`` only when asked for."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA tensors (use --backend gloo on the CPU)")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    count = torch.cuda.device_count()
    if backend == "nccl":
        if local_rank >= count:
            raise ValueError(f"an NCCL world needs a card a rank: local rank {local_rank} "
                             f"of a host with {count} cards (a gloo world can share one)")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % count)


def init_world(tp: int, backend: str | None, device, *, dp: int = 1, rank: int | None = None,
               init_method: str | None = None) -> torch.device:
    """Join a world of ``dp * tp`` ranks and return this rank's device; at
    dp > 1 and tp > 1 every rank makes every tp and data group here, in the
    same order, before any collective.

    Under ``torch.distributed.run`` the rank, the world size and the local
    rank come from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and the
    rendezvous from ``MASTER_ADDR``/``MASTER_PORT``); a caller that spawns
    its own ranks passes ``rank`` and an ``init_method`` (a ``file://``
    path or a ``tcp://localhost:<port>`` address).  A world already made
    (``launch/distributed.py``) gives the rank and the size.  ``backend``
    ``None`` picks :func:`default_backend`.  In a world of one rank no
    process group is made."""
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    world = dp * tp
    if dist.is_initialized():
        # a world already made (launch/distributed.initialize_distributed)
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        env_rank = os.environ.get("RANK")
        rank = int(env_rank) if rank is None and env_rank is not None else rank
        size = int(os.environ.get("WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    if size != world:
        raise ValueError(f"--dp {dp} --tp {tp} is {world} ranks, in a world of {size} processes")
    if world == 1:
        return world_device(backend, device, 0)
    if rank is None:
        raise ValueError(f"(dp, tp) = ({dp}, {tp}): no rank given and RANK is not set (run "
                         f"under torch.distributed.run, or pass rank= and init_method=)")
    dev = world_device(backend, device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rank)
    make_world_groups(dp, tp)
    return dev


def close_world():
    """Leave the world (a no-op where none was started)."""
    if dist.is_initialized():
        forget_world_groups()
        dist.destroy_process_group()
