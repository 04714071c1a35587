"""Tile-pipeline schedule shared by the device-initiated kernels.

The TPU package's module of the same name also holds the Pallas DMA
helpers (panel streaming, remote PUT descriptors, semaphore drains); on
Hopper those become code inside each CUDA kernel (coalesced loads, peer
stores, release/acquire flags).  What stays shared is the schedule.
"""
from __future__ import annotations


def step_schedule(n_dev: int, tiles_per_rank: int, comm_aware: bool,
                  skew: int = 0):
    """Static per-grid-step (offset, sub-tile) lists.

    Remote tiles first — farthest peer first under comm-aware scheduling
    (paper Fig. 7b), natural order otherwise — and the locally-reduced
    tiles always last, so local compute hides remote wire time.  ``skew``
    rotates the remote portion of the offset order by the measured
    straggler bucket (Fig. 14), mirroring
    :func:`repro.core.scheduling.ring_offsets`; the local tiles keep
    their final position so the remote-ahead-of-local rule (and the
    kernels' tx-slot indexing, which relies on remote steps preceding the
    local one) is preserved.  The lists are meant to ride in the
    scalar-prefetch operand (a Pallas kernel body cannot capture array
    constants), indexed by the traced ``program_id``.
    """
    offs = (list(range(n_dev - 1, 0, -1)) if comm_aware
            else list(range(1, n_dev))) + [0]
    if skew and n_dev > 1:
        remote = offs[:-1]
        r = skew % len(remote)
        offs = remote[r:] + remote[:r] + [0]
    step_off = []
    step_sub = []
    for off in offs:
        for sub in range(tiles_per_rank):
            step_off.append(off)
            step_sub.append(sub)
    return step_off, step_sub
