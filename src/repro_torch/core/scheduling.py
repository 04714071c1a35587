"""Communication-aware chunk scheduling (paper Sec. III, Fig. 6b/7b/14).

The paper schedules the workgroups that produce *remote* slices ahead of
those producing locally consumed slices, so remote wire time hides behind
local compute.  These are the orders in which a fused loop visits its
destinations and services its sub-chunk rings, on every rank of the tp
world alike (so each peer pair's point-to-point messages match in issue
order).  The modeled finish times and the skew statistics below are the
Fig. 14 model that ``runtime/straggler.py``'s estimator reduces measured
per-rank step times through, to one integer rotation (``FusionConfig.skew``).
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


def modeled_finish_times(world: int, schedule: str, skew: int,
                         step_times: list[float], *,
                         compute: float = 1.0,
                         wire: float = 0.3,
                         link_scale: list[float] | None = None) -> list[float]:
    """Per-rank finish times of one fused direct-A2A round (Fig. 14 model).

    ``step_times`` are measured per-rank step times (only ratios matter);
    rank ``r`` produces its ``j``-th scheduled chunk ``compute * rate[r]``
    after the previous one and the send departs when the chunk is
    produced.  Wire time is the shortest-direction ring traversal with an
    optional per-link cost multiplier ``link_scale`` (``link_scale[l]``
    scales the link from rank ``l`` to ``l+1`` — a slow inter-node
    link at cluster scale).  A rank finishes when its own chunks are
    produced and every incoming chunk has arrived — the spread of these
    finish times is the paper's inter-node execution skew.

    The offset order is the shared SPMD schedule, so a straggler's send
    for offset ``off`` departs at its (slowed) position of ``off`` in that
    order.  Which of the straggler's sends are wire-expensive depends on
    where it sits relative to the slow links — that coupling between the
    *measured* straggler position and the static topology is what the
    schedule rotation exploits.
    """
    offs = ring_offsets(world, schedule, skew)
    t_min = min(step_times)
    if t_min <= 0:
        raise ValueError("step times must be positive")
    rate = [t / t_min for t in step_times]
    ls = list(link_scale) if link_scale is not None else [1.0] * world
    if len(ls) != world:
        raise ValueError(f"need {world} link scales, got {len(ls)}")
    pos = {off: j for j, off in enumerate(offs)}
    # O(1) per-pair link sums: the forward path src..src+off-1 and the
    # backward path together traverse the whole ring exactly once, so
    # bwd = total - fwd; fwd comes from a doubled prefix array.
    cum = [0.0]
    for l in ls + ls:
        cum.append(cum[-1] + l)
    total = cum[world]

    def wire_cost(src: int, off: int) -> float:
        fwd = cum[src + off] - cum[src]
        return wire * min(fwd, total - fwd)

    finish = []
    for d in range(world):
        t = world * compute * rate[d]        # own chunks all produced
        for src in range(world):
            if src == d:
                continue
            off = (d - src) % world
            depart = (pos[off] + 1) * compute * rate[src]
            t = max(t, depart + wire_cost(src, off))
        finish.append(t)
    return finish


def skew_statistic(times: list[float]) -> float:
    """max/median - 1 (the Fig. 14 inter-node execution-skew metric)."""
    if len(times) < 2:
        return 0.0
    s = sorted(times)
    k = len(s)
    med = s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])
    return s[-1] / med - 1.0 if med > 0 else 0.0


def modeled_execution_skew(world: int, schedule: str, skew: int,
                           step_times: list[float], *,
                           compute: float = 1.0, wire: float = 0.3,
                           link_scale: list[float] | None = None) -> float:
    """Schedule-induced execution skew: the max/median - 1 statistic over
    *rate-normalized* modeled finish times.  Dividing each rank's finish
    by its measured compute rate removes the injected/measured imbalance
    itself, so what remains is the skew the *schedule* creates by leaving
    wire time exposed unevenly — 0 for a perfectly hidden schedule,
    largest for the communication-oblivious baseline (Fig. 14)."""
    t_min = min(step_times)
    if t_min <= 0:
        raise ValueError("step times must be positive")
    rate = [t / t_min for t in step_times]
    fin = modeled_finish_times(world, schedule, skew, step_times,
                               compute=compute, wire=wire,
                               link_scale=link_scale)
    return skew_statistic([f / r for f, r in zip(fin, rate)])


def best_skew_rotation(world: int, step_times: list[float], *,
                       schedule: str = "comm_aware",
                       compute: float = 1.0, wire: float = 0.3,
                       link_scale: list[float] | None = None) -> int:
    """Reduce measured per-rank step times to an integer schedule rotation:
    the ``skew`` minimizing the modeled execution-skew statistic (ties go
    to the smaller rotation, so uniform times yield 0 — no rebuild churn).
    Candidates include 0, so the measured rotation can never model worse
    than the un-skewed comm-aware schedule."""
    best, best_s = 0, float("inf")
    for r in range(max(world - 1, 1)):
        s = modeled_execution_skew(world, schedule, r, step_times,
                                   compute=compute, wire=wire,
                                   link_scale=link_scale)
        if s < best_s - 1e-12:
            best, best_s = r, s
    return best
