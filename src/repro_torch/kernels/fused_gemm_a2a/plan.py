"""The partition of the expert FFN's stream path (``csrc/fused_gemm_a2a.cu``),
computed in plain Python so that the CPU tests check the same units, split
and order the card runs.

One EP rank's call over ``n_dev`` destinations, ``b`` x ``e`` groups each
(a group is one expert's [C, D] block of tokens), is cut into units of
``TILE_N`` columns: per group ``f_tiles`` up/gate units (columns of u, over
K = D) and ``d_tiles`` down units (columns of y, over K = F).  Each unit is
one thread-block cluster of ``splits`` CTAs, CTA s streaming K rows
[s * ks, min(K, (s + 1) * ks)) with ks = ``ks_up`` or ``ks_down``.
Clusters are persistent: cluster c of a rank takes units c, c + clusters,
... of :func:`unit_order`.  A down unit waits for its group's up/gate
units, so the resident clusters must fit in one group's up/gate units: a
down unit's group was then dealt at least a round earlier.  Among such
splits the planner takes the one that keeps the most CTAs resident, the
smallest on a tie: on an H100 at dbrx's shape a cluster of 2 CTAs (one an
SM) took 2.1940 ms, of 3 or 4 (two an SM) 2.1041-2.1084 ms (chip_smoke.py
phase 10's split sweep, PERF.md section 6; phase 7 prints the capacities).  The tile, stage, ring and limits
are the streaming GEMV loop's (:mod:`repro_torch.kernels.gemv.plan`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.kernels.gemv.plan import (H100_SMS, MAX_ROWS, MAX_SPLITS, RING_BYTES,
                                           SM_SMEM, SMEM_LIMIT, STAGE_ROWS, TILE_N)

CONSUMER_WARPS = 8      # kStreamConsumerWarps
# ffn_smem_bytes: alignment slack, the ring, 2 x 8 ring barriers and the
# `ready` and `freed` barriers; per row of the row block the warps' partials
# and two partial tiles; then x's [rows_per_block, ks] f32 slice
FIXED_SMEM = 128 + RING_BYTES + (2 * 8 + 2) * 8
ROW_SMEM = 4 * (CONSUMER_WARPS + 2) * TILE_N


class FfnPlan(NamedTuple):
    rows_per_block: int   # R: 1, 2, 4 or 8, at least C
    f_tiles: int          # up/gate units per group
    d_tiles: int          # down units per group
    groups: int           # n_dev * b * e
    splits: int           # CTAs per cluster along K
    ks_up: int            # rows of D per CTA, a multiple of STAGE_ROWS
    ks_down: int          # rows of F per CTA
    smem: int             # dynamic shared memory per CTA, bytes
    clusters: int         # persistent clusters per rank

    @property
    def units(self) -> int:
        """Units per rank."""
        return self.groups * (self.f_tiles + self.d_tiles)


def smem_bytes(rows_per_block: int, ks: int) -> int:
    return FIXED_SMEM + rows_per_block * (ROW_SMEM + 4 * ks)


def model_capacity(sms: int = H100_SMS):
    """Clusters resident at once, from shared memory alone (as
    :func:`repro_torch.kernels.gemv.plan.model_capacity`); on a card the
    wrapper asks the runtime instead (cudaOccupancyMaxActiveClusters)."""
    def capacity(splits, rows_per_block, ks):
        return sms * (SM_SMEM // (smem_bytes(rows_per_block, ks) + 1024)) // splits
    return capacity


def unit_order(groups: int, f_tiles: int, d_tiles: int):
    """The kernel's static order as (up, group, tile): up(0) | up(1) down(0)
    | ... | up(G-1) down(G-2) | down(G-1), group k being the k-th of the
    step schedule's order."""
    order = [(True, 0, t) for t in range(f_tiles)]
    for k in range(1, groups + 1):
        if k < groups:
            order += [(True, k, t) for t in range(f_tiles)]
        order += [(False, k - 1, t) for t in range(d_tiles)]
    return order


def ffn_plan(n_dev: int, b: int, e: int, c: int, d: int, f: int, ranks_in_launch: int = 1,
             sms: int = H100_SMS, capacity=None) -> FfnPlan | None:
    """The stream path's partition of one rank's call, or None where it
    cannot run it (C above MAX_ROWS, or x's slice past shared memory at
    every split).

    Of the splits (at most MAX_SPLITS, and no more than the stages of the
    shorter K) whose clusters per rank, the resident ones
    (``capacity(splits, rows_per_block, ks) // ranks_in_launch``) up to one
    per unit, are at most ``f_tiles``, the one with the most resident CTAs,
    the smallest on a tie; where none is, the one with the fewest
    clusters, the largest on a tie."""
    if min(n_dev, b, e, c, d, f, ranks_in_launch) < 1:
        raise ValueError(f"ffn_plan: n_dev={n_dev}, b={b}, e={e}, c={c}, d={d}, f={f}")
    if c > MAX_ROWS:
        return None
    capacity = capacity or model_capacity(sms)
    r = 1 << (c - 1).bit_length()
    f_tiles, d_tiles, groups = math.ceil(f / TILE_N), math.ceil(d / TILE_N), n_dev * b * e
    units = groups * (f_tiles + d_tiles)
    plans = []
    for s in range(1, max(1, min(MAX_SPLITS, math.ceil(min(d, f) / STAGE_ROWS))) + 1):
        ks_up, ks_down = (math.ceil(math.ceil(k / s) / STAGE_ROWS) * STAGE_ROWS for k in (d, f))
        smem = smem_bytes(r, max(ks_up, ks_down))
        resident = capacity(s, r, max(ks_up, ks_down)) // ranks_in_launch
        if smem <= SMEM_LIMIT and resident >= 1:
            plans.append(FfnPlan(r, f_tiles, d_tiles, groups, s, ks_up, ks_down, smem,
                                 min(units, resident)))
    if not plans:
        return None
    fitting = [p for p in plans if p.clusters <= f_tiles]
    if fitting:
        return max(fitting, key=lambda p: (p.clusters * p.splits, -p.splits))
    return min(plans, key=lambda p: (p.clusters, -p.splits))


def ffn_stream_fits(dtype, n_dev, b, e, c, d, f, aligned=True) -> bool:
    """Whether the stream path takes a call (``dtype``: anything with an
    ``itemsize``; ``aligned``: every weight at a 16-byte-aligned base): TMA
    can read the weights (rows of D and F elements a multiple of 16 bytes)
    and :func:`ffn_plan` has a partition."""
    return (aligned and (d * dtype.itemsize) % 16 == 0 and (f * dtype.itemsize) % 16 == 0
            and ffn_plan(n_dev, b, e, c, d, f, ranks_in_launch=n_dev) is not None)
