"""The path choice and the partition of the mean-pooled embedding-bag gather
(``csrc/embedding_bag.cuh``, launched by ``embedding_pool.cu`` and
``fused_embedding_a2a.cu``), computed in plain Python so that the CPU tests
check the same units, order and ring the card runs.

A call pools the bags of ``n_dev`` fragments (one per destination; 1 for
``embedding_pool``), ``b_loc`` x ``t_loc`` bags each, cut into units of
``WARPS`` bags, one a warp.  The ring path's CTAs are persistent: CTA c of
a rank takes units c, c + ctas, ... (:func:`cta_units`; a unit's
destination and bags: :func:`unit_dest`, :func:`unit_bags`), and each warp
keeps ``slots`` rows in flight in its slice of a ring of ``RING_BYTES``
in shared memory.  The warp path runs one CTA a unit, rows through
registers.  Both walk a fragment's bags table major (bag t * b_loc + b),
so the bags that run at once share one table's rows in L2.  The ring's
size is fixed from chip_smoke.py phase 14's sweep (``RING_SWEEP``), the
path choice from its timings (PERF.md section 6).
"""
from __future__ import annotations

import math
from typing import NamedTuple

WARPS = 8                # bags per unit, one a warp (kBagWarps)
RING_BYTES = 24 * 1024   # row slots of a CTA (kRingBytes)
MAX_SLOTS = 64           # row slots per warp at most (kRingMaxSlots)
GROUP = 8                # slots under one mbarrier (kRingGroup)
MAX_COLS = 8             # elements per lane: D <= 32 * MAX_COLS (kRingCols)
SMEM_LIMIT = 232448      # 227 KB, the most a CTA may take on an H100 (kRingSmemLimit)
SM_SMEM = 233472         # 228 KB of shared memory per SM
H100_SMS = 132
# ring sizes phase 14 times: at D = 92 f32 8, 16, 24, 32 and 64 slots a
# warp, four (registers bound the first), four, three, two and one CTA an SM
RING_SWEEP = (24 * 1024, 48 * 1024, 72 * 1024, 96 * 1024, 192 * 1024)
PATHS = ("ring", "warp")


class BagPlan(NamedTuple):
    path: str             # "ring" or "warp"
    n_dev: int            # fragments (destinations)
    units_per_frag: int   # units of WARPS bags per fragment: its tickets, one a unit
    slots: int            # row slots per warp (ring path; 0 on the warp path)
    smem: int             # dynamic shared memory per CTA, bytes (0 on the warp path)
    ctas: int             # CTAs per rank: persistent on the ring path, one a unit else

    @property
    def units(self) -> int:
        """Units per rank."""
        return self.n_dev * self.units_per_frag


def ring_slots(row_bytes: int, ring_bytes: int = RING_BYTES) -> int:
    """Row slots per warp in a ring of ``ring_bytes`` a CTA, in whole
    groups, at least one (a row of at most 32 x MAX_COLS f32 elements
    keeps one group per warp within 64 KB)."""
    return max(GROUP, min(MAX_SLOTS, ring_bytes // (WARPS * row_bytes)) // GROUP * GROUP)


def smem_bytes(slots: int, row_bytes: int) -> int:
    """ring_smem_bytes: alignment slack, one mbarrier per group of slots,
    the slots."""
    return 128 + WARPS * (slots // GROUP * 8 + slots * row_bytes)


def ring_fits(dtype, d: int, aligned: bool = True, bags: int = 1) -> bool:
    """Whether the ring path can take rows of ``d`` elements of ``dtype``
    (anything with an ``itemsize``): the bulk copies read whole 16-byte
    vectors at 16-byte-aligned tables and outputs (``aligned``), a lane's
    share of a row fits its registers, and the bags number below 2^31."""
    row = d * dtype.itemsize
    return aligned and row % 16 == 0 and d <= 32 * MAX_COLS and bags < 2 ** 31


def bag_path(dtype, d: int, aligned: bool = True, bags: int = 1, n_dev: int = 1) -> str:
    """The path of a call over ``n_dev`` ranks: ``"ring"`` where the ring
    path fits (:func:`ring_fits`) and the call runs the peer protocol (n_dev
    > 1), ``"warp"`` otherwise.  On an H100 the warp path is the faster at
    one rank, the ring path in the emulated 4-rank world on one card
    (chip_smoke.py phase 14, PERF.md section 6); with real peers the n_dev
    > 1 choice is untested (ROADMAP Queue 1 item 1 re-decides it)."""
    return "ring" if n_dev > 1 and ring_fits(dtype, d, aligned, bags) else "warp"


def model_capacity(sms: int = H100_SMS):
    """CTAs resident at once from shared memory alone (1 KB of each SM's
    228 KB kept by the system per CTA); on a card the wrappers ask the
    runtime instead (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    def capacity(smem):
        return sms * (SM_SMEM // (smem + 1024))
    return capacity


def bag_plan(n_dev: int, b_loc: int, t_loc: int, d: int, itemsize: int, path: str = "ring", *,
             ring_bytes: int = RING_BYTES, capacity=None, sms: int = H100_SMS,
             ranks_in_launch: int = 1) -> BagPlan:
    """The partition of one rank's call on ``path``.  The ring path's grid
    is the CTAs the card holds at once (``capacity(smem)``, default
    :func:`model_capacity`) shared by the ranks of one launch, at most one
    a unit; the warp path's is one CTA a unit."""
    if min(n_dev, b_loc, t_loc, d, itemsize, ranks_in_launch) < 1:
        raise ValueError(f"bag_plan: n_dev={n_dev}, b_loc={b_loc}, t_loc={t_loc}, d={d}")
    if path not in PATHS:
        raise ValueError(f"bag_plan: path {path!r} is not one of {PATHS}")
    upf = math.ceil(b_loc * t_loc / WARPS)
    if path == "warp":
        return BagPlan("warp", n_dev, upf, 0, 0, n_dev * upf)
    row = d * itemsize
    slots = ring_slots(row, ring_bytes)
    smem = smem_bytes(slots, row)
    if row % 16 or d > 32 * MAX_COLS or smem > SMEM_LIMIT:
        raise ValueError(f"bag_plan: the ring path does not take rows of {d} x {itemsize} "
                         f"bytes in a ring of {ring_bytes}")
    resident = (capacity or model_capacity(sms))(smem) // ranks_in_launch
    return BagPlan("ring", n_dev, upf, slots, smem, max(1, min(n_dev * upf, resident)))


def call_plan(name: str, tables, n_dev: int, b_loc: int, t_loc: int, path=None,
              ring_bytes: int = RING_BYTES, *, capacity=None, ranks_in_launch: int = 1) -> BagPlan:
    """The plan of a call of the wrapper ``name`` over ``n_dev`` ranks on
    ``tables`` (a tensor ``[..., V, D]``): on the path :func:`bag_path`
    chooses, or ``path``, which must fit; the ring path's grid from
    ``capacity(smem)``, the kernel's CTAs the card holds at once (None:
    :func:`model_capacity`)."""
    d, aligned, bags = tables.shape[-1], tables.data_ptr() % 16 == 0, n_dev * b_loc * t_loc
    if path is None:
        path = bag_path(tables.dtype, d, aligned, bags, n_dev)
    elif path not in PATHS:
        raise ValueError(f"{name}: path must be one of {PATHS}, got {path!r}")
    elif path == "ring" and not ring_fits(tables.dtype, d, aligned, bags):
        raise ValueError(f"{name}: the ring path takes rows of a multiple of 16 bytes, at most "
                         f"{32 * MAX_COLS} elements, at an aligned base; got D={d} {tables.dtype}")
    return bag_plan(n_dev, b_loc, t_loc, d, tables.element_size(), path, ring_bytes=ring_bytes,
                    capacity=capacity, ranks_in_launch=ranks_in_launch)


def unit_dest(plan: BagPlan, unit: int, comm_aware: bool = True, my: int = 0) -> int:
    """The destination of unit ``unit`` of rank ``my``: step unit //
    units_per_frag of the schedule, farthest first and the own fragment
    last (``comm_aware``) or in plain order (the kernels' unit_dest)."""
    step = unit // plan.units_per_frag
    off = plan.n_dev - 1 - step if comm_aware else step
    return (my + off) % plan.n_dev


def unit_bags(plan: BagPlan, unit: int, b_loc: int, t_loc: int, comm_aware: bool = True,
              my: int = 0) -> list[tuple[int, int, int]]:
    """The (destination, b, t) bags of unit ``unit``, warp 0 first, table
    major (the kernels' maps, ``PoolMap`` and ``A2AMap``)."""
    dest = unit_dest(plan, unit, comm_aware, my)
    out = []
    for w in range(WARPS):
        s = (unit % plan.units_per_frag) * WARPS + w
        if s >= b_loc * t_loc:
            break
        out.append((dest, s % b_loc, s // b_loc))
    return out


def cta_units(plan: BagPlan, cta: int) -> range:
    """The units CTA ``cta`` of a rank walks, in order."""
    return range(cta, plan.units, plan.ctas)
