"""Communication-aware chunk scheduling (paper Sec. III, Fig. 6b/7b/14).

The paper schedules the workgroups that produce *remote* slices ahead of
those producing locally consumed slices, so remote wire time hides behind
local compute.  This is the order in which a fused loop visits its
destinations.  Only ``ring_offsets`` is ported so far: the sub-chunk event
lists come with ROADMAP Queue 1 item 1 (the multi-card tp world).
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
