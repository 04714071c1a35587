"""The partition of the streaming GEMV loop (``csrc/stream_gemv.cuh``),
computed in plain Python so that the CPU tests check the same split the
card runs.

A product x [rows, K] @ w [K, N] over ``n_dev`` ranks (rank d reduces
columns [d * N / n_dev, (d + 1) * N / n_dev)) is cut into units of
``rows_per_block`` rows x ``TILE_N`` columns of one rank's chunk; each unit
is one thread-block cluster of ``splits`` CTAs, CTA s streaming K rows
[s * ks, min(K, (s + 1) * ks)).  On an H100 a cluster that does not fit
in the first wave of resident clusters costs a second pass over its
share of the weights, so the split is sized to the clusters the card holds
at once (measured: chip_smoke.py's phase 18 row sweep, PERF.md).
"""
from __future__ import annotations

import math
from typing import NamedTuple

TILE_N = 128            # output columns per unit (kStreamN)
STAGE_ROWS = 32         # weight rows per ring stage (kStreamStageRows)
MAX_ROWS = 8            # rows per row block (kStreamMaxRows)
MAX_SPLITS = 8          # CTAs per cluster (kStreamMaxSplits, the portable cluster size)
RING_BYTES = 64 * 1024  # kStreamRingBytes
# stream_smem_bytes: alignment slack, the ring, 2 x 8 barriers, then x's
# [rows_per_block, ks] f32 slice
FIXED_SMEM = 128 + RING_BYTES + 2 * 8 * 8
SMEM_LIMIT = 232448     # 227 KB, the most a CTA may take on an H100
SM_SMEM = 233472        # 228 KB of shared memory per SM
H100_SMS = 132


class StreamPlan(NamedTuple):
    rows_per_block: int   # R: 1, 2, 4 or 8
    row_blocks: int
    tiles: int            # column tiles per rank's chunk
    splits: int           # CTAs per cluster along K
    ks: int               # K rows per CTA, a multiple of STAGE_ROWS
    smem: int             # dynamic shared memory per CTA, bytes

    @property
    def units(self) -> int:
        """Clusters per rank at n_dev = 1 (times n_dev in a larger world)."""
        return self.tiles * self.row_blocks


def smem_bytes(rows_per_block: int, ks: int) -> int:
    return FIXED_SMEM + 4 * rows_per_block * ks


def model_capacity(sms: int = H100_SMS):
    """Clusters resident at once, from shared memory alone: the CTAs per SM
    that its 228 KB hold (1 KB of each kept by the system) over the
    cluster's size.  The card packs clusters into its GPCs, so it may hold
    fewer; on a card the wrappers ask the runtime instead
    (cudaOccupancyMaxActiveClusters)."""
    def capacity(splits, rows_per_block, ks):
        return sms * (SM_SMEM // (smem_bytes(rows_per_block, ks) + 1024)) // splits
    return capacity


def stream_fits(dtype, rows, k, n, n_dev=1, aligned=True) -> bool:
    """Whether the stream path takes x [rows, k] @ w [k, n] over n_dev ranks
    (``dtype``: anything with an ``itemsize``, such as a torch dtype;
    ``aligned``: w at a 16-byte-aligned base): TMA can read w (rows of a
    multiple of 16 bytes at an aligned base), n splits over the ranks, and
    x's slice fits in shared memory (:func:`stream_plan`)."""
    return (aligned and (n * dtype.itemsize) % 16 == 0 and n % n_dev == 0
            and stream_plan(rows, k, n, n_dev, ranks_in_launch=n_dev) is not None)


def stream_plan(rows: int, k: int, n: int, n_dev: int = 1, sms: int = H100_SMS,
                ranks_in_launch: int = 1, capacity=None) -> StreamPlan | None:
    """The partition of x [rows, k] @ w [k, n] over n_dev ranks, or None when
    x's slice does not fit in shared memory even one row at a time.

    The row block is the largest power of two up to MAX_ROWS that covers the
    rows and fits.  K is split over the largest cluster (at most
    MAX_SPLITS, at most about two CTAs per SM, at least one ring stage per
    CTA) whose clusters the card holds all at once: ``capacity(splits,
    rows_per_block, ks)`` says how many it holds (default
    :func:`model_capacity`).  A cluster that waits for a second wave costs
    as much as the first, so where none fits in one wave the split with the
    fewest waves is taken."""
    if min(rows, k, n, n_dev) < 1 or n % n_dev:
        raise ValueError(f"stream_plan: rows={rows}, k={k}, n={n}, n_dev={n_dev}")
    capacity = capacity or model_capacity(sms)
    tiles = math.ceil(n // n_dev / TILE_N)
    r_pref = min(MAX_ROWS, 1 << (rows - 1).bit_length())
    clusters = lambda r: ranks_in_launch * n_dev * tiles * math.ceil(rows / r)
    upper = max(1, min(MAX_SPLITS, math.ceil(k / STAGE_ROWS),
                       math.ceil(2 * sms / clusters(r_pref))))
    best, best_waves = None, 0
    for s in range(upper, 0, -1):
        ks = math.ceil(math.ceil(k / s) / STAGE_ROWS) * STAGE_ROWS
        splits = math.ceil(k / ks)              # no CTA without rows
        r = r_pref
        while r > 1 and smem_bytes(r, ks) > SMEM_LIMIT:
            r //= 2
        if smem_bytes(r, ks) > SMEM_LIMIT:
            break                               # fewer splits only widen the slice
        waves = math.ceil(clusters(r) / max(1, capacity(splits, r, ks)))
        if best is None or waves < best_waves:
            best = StreamPlan(r, math.ceil(rows / r), tiles, splits, ks, smem_bytes(r, ks))
            best_waves = waves
        if waves == 1:
            break
    return best
