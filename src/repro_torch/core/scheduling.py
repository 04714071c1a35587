"""Communication-aware chunk scheduling (paper Sec. III, Fig. 6b/7b/14).

The paper schedules the workgroups that produce *remote* slices ahead of
those producing locally consumed slices, so remote wire time hides behind
local compute.  These are the orders in which a fused loop visits its
destinations and services its sub-chunk rings, on every rank of the tp
world alike (so each peer pair's point-to-point messages match in issue
order).  The reference's modeled finish times and skew statistics come with
the straggler loop of the runtime (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations


def ring_offsets(world: int, schedule: str = "comm_aware",
                 skew: int = 0) -> list[int]:
    """Order in which a rank visits destination offsets 0..world-1.

    Offset 0 is the locally consumed chunk; offsets 1..world-1 are remote.

    comm_aware: farthest-first remote chunks, local chunk last (the paper's
      remote-ahead-of-local rule).
    oblivious: natural order starting at the local chunk (the paper's
      baseline scheduling, for the Fig. 14 skew benchmark).

    ``skew`` rotates the *remote* portion of the order (Fig. 14: a measured
    straggler offset goes first); the local chunk keeps its position.
    """
    if schedule == "comm_aware":
        offs = list(range(world - 1, 0, -1)) + [0]
    elif schedule == "oblivious":
        offs = list(range(world))
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if skew and world > 1:
        remote = [o for o in offs if o != 0]
        r = skew % len(remote)
        remote = remote[r:] + remote[:r]
        it = iter(remote)
        offs = [o if o == 0 else next(it) for o in offs]
    return offs


def sub_chunk_send_events(world: int, chunks_per_rank: int,
                          schedule: str = "comm_aware",
                          skew: int = 0) -> list[list[tuple[int, int]]]:
    """Per-rank (destination, fine-chunk) send events of the sub-chunked
    direct-send schedule (``direct_all_to_all_compute`` with
    ``chunks_per_rank=q``), in issue order.

    Fine chunk ``f = dest * q + s`` is the ``s``-th sub-slice of the payload
    rank ``r`` owes rank ``dest``.  The schedule is a permutation: every
    (rank, fine-chunk) pair is sent exactly once and lands at the rank that
    owns it."""
    q = chunks_per_rank
    offs = ring_offsets(world, schedule, skew)
    return [[((r + off) % world, ((r + off) % world) * q + s) for off in offs for s in range(q)]
            for r in range(world)]


def expected_send_cover(world: int, chunks_per_rank: int) -> set:
    """The (destination, fine-chunk) pairs every rank's send schedule must
    emit exactly once: fine chunk ``dest * q + s`` for each destination's
    ``q`` sub-slices."""
    q = chunks_per_rank
    return {(d, d * q + s) for d in range(world) for s in range(q)}


def sub_chunk_service_order(n_sub: int, skew: int = 0) -> list[int]:
    """Service order of the ``n_sub`` independent sub-chunk rings inside a
    ring-carry op (reduce-scatter, all-gather).

    The ring fixes which chunk a rank touches at each hop, so the only
    freedom a measured skew can use is the order in which the sub-chunk
    rings are serviced within a hop: rotating it by ``skew`` puts the
    straggler-facing sub-ring on the wire first.  Each sub-ring's compute
    chain is untouched, so outputs are unchanged."""
    if n_sub <= 1:
        return [0]
    r = skew % n_sub
    return list(range(r, n_sub)) + list(range(r))


def reduce_ring_chunk_order(world: int, schedule: str = "comm_aware") -> list[int]:
    """Chunk index (relative to the own rank) computed at each step of a
    reduce-scatter ring.

    In the overlapped ring the carry that lands on rank ``d`` starts at
    rank ``d + 1``; at step ``i`` rank ``d`` adds its partial for chunk
    ``(d - i - 1) mod world``, its own chunk last (comm-aware).  The
    oblivious order takes its own chunk first, exposing the whole ring's
    latency at the end (the Fig. 14 baseline)."""
    if schedule == "comm_aware":
        return [-(i + 1) % world for i in range(world)]
    if schedule == "oblivious":
        return [i % world for i in range(world)]
    raise ValueError(f"unknown schedule {schedule!r}")
