"""The embedding-bag gather's plan (``kernels/embedding_pool/plan.py``) and
its path choice, on the CPU.

The plan deals the bags of ``embedding_pool`` and ``fused_embedding_a2a``
to units, orders the units and sizes the ring path's ring and grid; the
CUDA kernels (``csrc/embedding_bag.cuh``) walk the same units, so these
tests check what the card runs.  The kernels themselves run only on a card,
in chip_smoke.py phases 11-14; here the wrappers' forced paths are checked
for what they accept.
"""
import collections
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import CSRC
from repro_torch.kernels.embedding_pool import plan as bag_plan_mod
from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables
from repro_torch.kernels.embedding_pool.plan import (RING_SWEEP, bag_path, bag_plan, call_plan,
                                                     cta_units, model_capacity, ring_fits,
                                                     unit_bags, unit_dest)
from repro_torch.kernels.embedding_pool.ref import embedding_pool_tables_ref
from repro_torch.kernels.fused_embedding_a2a.ops import (fused_embedding_a2a,
                                                         fused_embedding_a2a_ranks)
from repro_torch.kernels.fused_embedding_a2a.ref import fused_embedding_a2a_ref_ranks
from repro_torch.parallel.sharding import FusionConfig, ParallelContext

F32, BF16 = torch.float32, torch.bfloat16

# (n_dev, b_loc, t_loc): DLRM's 128 tables (one card, and its emulated
# 4-rank world) at a few batch rows, and ragged worlds whose fragments end
# in a part unit
SHAPES = [(1, 40, 128), (4, 12, 32), (3, 5, 2), (2, 3, 3), (1, 13, 3), (8, 1, 1)]
# the same calls at DLRM's batch of 8192, for what needs no bag lists
DLRM_SHAPES = [(1, 8192, 128), (4, 2048, 32)]


def _plan(n_dev, b_loc, t_loc, ctas=None):
    cap = None if ctas is None else (lambda smem: ctas)
    return bag_plan(n_dev, b_loc, t_loc, 92, 4, "ring", capacity=cap, ranks_in_launch=n_dev)


@pytest.mark.parametrize("ctas", [None, 1, 7])
@pytest.mark.parametrize("comm_aware", [True, False])
@pytest.mark.parametrize("n_dev,b_loc,t_loc", SHAPES)
def test_units_cover_every_bag_once(n_dev, b_loc, t_loc, comm_aware, ctas):
    """Every CTA's units together hold each (destination, b, t) bag of
    every rank's call exactly once, at the card's grid (None: the shared-
    memory model) and at 1 and 7 CTAs a rank."""
    plan = _plan(n_dev, b_loc, t_loc, ctas)
    for my in range(n_dev):
        seen = collections.Counter(
            bag for c in range(plan.ctas) for u in cta_units(plan, c)
            for bag in unit_bags(plan, u, b_loc, t_loc, comm_aware, my))
        want = {(d, b, t) for d in range(n_dev) for b in range(b_loc) for t in range(t_loc)}
        assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("n_dev,b_loc,t_loc", SHAPES)
def test_units_walk_a_fragment_table_major(n_dev, b_loc, t_loc):
    """A fragment's bags in unit order run through one table's batch rows
    before the next table's (the kernels' maps: s = t * b_loc + b)."""
    plan = _plan(n_dev, b_loc, t_loc)
    bags = [(t, b) for u in range(plan.units_per_frag)
            for _, b, t in unit_bags(plan, u, b_loc, t_loc, False)]
    assert bags == [(t, b) for t in range(t_loc) for b in range(b_loc)]


@pytest.mark.parametrize("comm_aware", [True, False])
@pytest.mark.parametrize("n_dev,b_loc,t_loc", SHAPES + DLRM_SHAPES)
def test_each_fragment_takes_one_ticket_a_unit(n_dev, b_loc, t_loc, comm_aware):
    """A fragment's flag goes up at its units_per_frag-th ticket (the
    kernels' unit_done): each fragment has exactly that many units."""
    plan = _plan(n_dev, b_loc, t_loc)
    assert plan.units_per_frag == -(-b_loc * t_loc // bag_plan_mod.WARPS)
    for my in range(n_dev):
        units = collections.Counter(unit_dest(plan, u, comm_aware, my) for u in range(plan.units))
        assert units == {d: plan.units_per_frag for d in range(n_dev)}
        if (n_dev, b_loc, t_loc) in DLRM_SHAPES:
            continue
        # a unit's bags all go to the destination it counts for
        for u in range(plan.units):
            assert {d for d, _, _ in unit_bags(plan, u, b_loc, t_loc, comm_aware, my)} == {
                unit_dest(plan, u, comm_aware, my)}


@pytest.mark.parametrize("n_dev,b_loc,t_loc", [s for s in SHAPES + DLRM_SHAPES if s[0] > 1])
def test_comm_aware_deals_every_remote_fragment_before_the_own(n_dev, b_loc, t_loc):
    plan = _plan(n_dev, b_loc, t_loc)
    for my in range(n_dev):
        dests = [unit_dest(plan, u, True, my) for u in range(plan.units)]
        own = dests.index(my)
        assert all(d == my for d in dests[own:]) and my not in dests[:own]
        # farthest first: the ring offsets n - 1, n - 2, ..., 0 in turn
        steps = [(d - my) % n_dev for d in dests[::plan.units_per_frag]]
        assert steps == list(range(n_dev - 1, -1, -1))
        # the plain schedule starts with the own fragment
        assert unit_dest(plan, 0, False, my) == my


@pytest.mark.parametrize("ring_bytes", RING_SWEEP)
@pytest.mark.parametrize("dtype,d", [(F32, 92), (BF16, 64), (F32, 256), (F32, 4), (BF16, 8)])
def test_the_ring_fits_shared_memory_at_every_sweep_depth(ring_bytes, dtype, d):
    plan = bag_plan(1, 8192, 128, d, dtype.itemsize, "ring", ring_bytes=ring_bytes)
    assert bag_plan_mod.GROUP <= plan.slots <= bag_plan_mod.MAX_SLOTS
    assert plan.slots % bag_plan_mod.GROUP == 0
    assert plan.smem <= bag_plan_mod.SMEM_LIMIT
    assert plan.smem == 128 + bag_plan_mod.WARPS * (plan.slots // bag_plan_mod.GROUP * 8
                                                    + plan.slots * d * dtype.itemsize)
    assert (plan.slots == bag_plan_mod.GROUP
            or plan.slots * bag_plan_mod.WARPS * d * dtype.itemsize <= ring_bytes)
    assert model_capacity(1)(plan.smem) >= 1                  # at least one CTA an SM
    assert plan.ctas == min(plan.units, model_capacity()(plan.smem))


def test_the_sweep_spans_one_cta_an_sm_and_more_at_dlrm_rows():
    """Each depth of the sweep holds a different number of CTAs an SM (in
    shared memory), down to one."""
    plans = [bag_plan(1, 8192, 128, 92, 4, ring_bytes=rb) for rb in RING_SWEEP]
    got = [model_capacity(1)(p.smem) for p in plans]
    assert got == sorted(set(got), reverse=True) and got[-1] == 1
    assert [p.slots for p in plans] == sorted({p.slots for p in plans})


@pytest.mark.parametrize("dtype,d,aligned,bags,fits", [
    (F32, 92, True, 8192 * 128, True),        # DLRM's main shape: 368-byte rows
    (BF16, 64, True, 10, True),               # 128-byte rows
    (F32, 256, True, 10, True),               # the widest a lane's registers take
    (F32, 4, True, 10, True),
    (BF16, 92, True, 10, False),              # 184-byte rows
    (F32, 93, True, 10, False),
    (F32, 1, True, 10, False),
    (F32, 92, False, 10, False),              # tables or output off 16 bytes
    (F32, 260, True, 10, False),              # past 32 x MAX_COLS elements
    (F32, 92, True, 2 ** 31, False),
])
def test_bag_path_choice(dtype, d, aligned, bags, fits):
    """The ring path where its rows fit and the call runs the peer
    protocol (n > 1); the warp path at one rank, and where the rows do not
    fit."""
    assert ring_fits(dtype, d, aligned, bags) == fits
    assert bag_path(dtype, d, aligned, bags, n_dev=4) == ("ring" if fits else "warp")
    assert bag_path(dtype, d, aligned, bags, n_dev=1) == "warp"


@pytest.mark.parametrize("n_dev,ctas,want", [(1, 5, 5), (4, 10**6, 4 * 1024), (4, 40, 10)])
def test_call_plan_sizes_the_grid_from_the_callers_capacity(n_dev, ctas, want):
    """A wrapper hands call_plan its own kernel's capacity; the ring
    path's grid is that, shared by the ranks of one launch, at most one CTA
    a unit."""
    tabs = torch.zeros((n_dev, 8, 92))
    plan = call_plan("k", tabs, n_dev, 1024, 8, capacity=lambda smem: ctas,
                     ranks_in_launch=n_dev)
    assert plan.path == ("ring" if n_dev > 1 else "warp")
    if plan.path == "warp":
        plan = call_plan("k", tabs, n_dev, 1024, 8, "ring", capacity=lambda smem: ctas)
    assert plan.ctas == min(plan.units, want)
    with pytest.raises(ValueError, match="^k: "):
        call_plan("k", tabs, n_dev, 1024, 8, "tile")


def test_warp_plan_is_one_cta_a_unit():
    plan = bag_plan(3, 5, 2, 93, 4, "warp")
    assert (plan.slots, plan.smem, plan.units_per_frag, plan.ctas) == (0, 0, 2, 6)
    assert [list(cta_units(plan, c)) for c in range(plan.ctas)] == [[c] for c in range(6)]
    with pytest.raises(ValueError):
        bag_plan(1, 4, 4, 93, 4, "ring")        # 372-byte rows
    with pytest.raises(ValueError):
        bag_plan(1, 4, 4, 92, 4, "random")


def test_plan_mirrors_the_kernel_constants():
    """plan.py sizes what embedding_bag.cuh runs: the same unit, ring,
    limits and shared-memory layout."""
    src = (CSRC / "embedding_bag.cuh").read_text()

    def const(name):
        return int(eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)))

    assert const("kBagWarps") == bag_plan_mod.WARPS
    assert const("kRingBytes") == bag_plan_mod.RING_BYTES
    assert const("kRingMaxSlots") == bag_plan_mod.MAX_SLOTS
    assert const("kRingGroup") == bag_plan_mod.GROUP
    assert const("kRingCols") == bag_plan_mod.MAX_COLS
    assert const("kRingSmemLimit") == bag_plan_mod.SMEM_LIMIT
    assert ("return 128 + (size_t)kBagWarps * (slots / kRingGroup * 8 + (size_t)slots * "
            "row_bytes);") in src
    assert bag_plan_mod.MAX_SLOTS % bag_plan_mod.GROUP == 0
    assert bag_plan_mod.RING_BYTES in bag_plan_mod.RING_SWEEP
    for cu in ("embedding_pool.cu", "fused_embedding_a2a.cu"):      # table-major units
        assert re.search(r"const (long long|int) t = s / (a\.)?B(_loc)?, b = s - t \* (a\.)?B",
                         (CSRC / cu).read_text()), cu


def test_bag_sources_are_in_the_build():
    names = {p.name for p in CSRC.glob("*.cu*")}
    assert {"embedding_bag.cuh", "embedding_pool.cu", "fused_embedding_a2a.cu",
            "hopper.cuh"} <= names
    assert '#include "hopper.cuh"' in (CSRC / "embedding_bag.cuh").read_text()
    assert "cp.async.bulk.shared::cluster.global" in (CSRC / "hopper.cuh").read_text()
    for cu in ("embedding_pool.cu", "fused_embedding_a2a.cu"):
        assert "ring_pool<T>(" in (CSRC / cu).read_text()


def _tables_idx(rng, n_tab, v, d, b, L, dtype=F32):
    tabs = torch.from_numpy(rng.standard_normal((n_tab, v, d)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, v, (b, n_tab, L)).astype(np.int32))
    return tabs, idx


@pytest.mark.parametrize("path", [None, "ring", "warp"])
@pytest.mark.parametrize("d,dtype", [(92, F32), (64, BF16)])
def test_forced_paths_on_the_cpu_take_the_plain_version(rng, path, d, dtype):
    tabs, idx = _tables_idx(rng, 3, 40, d, 5, 7, dtype)
    want = embedding_pool_tables_ref(tabs, idx)
    got = embedding_pool_tables(tabs, idx, _path=path)
    assert torch.equal(got, want)
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode="kernel"))
    assert torch.equal(fused_embedding_a2a(ctx, idx, tabs, _path=path), want)
    t4, i4 = _tables_idx(rng, 2, 40, d, 8, 3, dtype)
    world_t, world_i = t4[None].expand(2, -1, -1, -1).contiguous(), i4[None].repeat(2, 1, 1, 1)
    assert torch.equal(fused_embedding_a2a_ranks(world_t, world_i, _path=path),
                       fused_embedding_a2a_ref_ranks(world_t, world_i))


@pytest.mark.parametrize("d,dtype,path", [(92, BF16, "ring"), (93, F32, "ring"),
                                          (92, F32, "bogus")])
def test_a_forced_path_that_does_not_fit_raises(rng, d, dtype, path):
    tabs, idx = _tables_idx(rng, 2, 30, d, 4, 3, dtype)
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode="kernel"))
    with pytest.raises(ValueError):
        embedding_pool_tables(tabs, idx, _path=path)
    with pytest.raises(ValueError):
        fused_embedding_a2a(ctx, idx, tabs, _path=path)
    with pytest.raises(ValueError):
        fused_embedding_a2a_ranks(tabs[None], idx[None], _path=path)


def test_an_unaligned_table_takes_the_warp_path(rng):
    tabs, idx = _tables_idx(rng, 2, 30, 92, 4, 3)
    flat = torch.cat([torch.zeros(1), tabs.reshape(-1)])[1:].view(2, 30, 92)
    assert flat.data_ptr() % 16 != 0
    assert bag_path(flat.dtype, 92, flat.data_ptr() % 16 == 0) == "warp"
    with pytest.raises(ValueError):
        embedding_pool_tables(flat, idx, _path="ring")
    assert torch.equal(embedding_pool_tables(flat, idx), embedding_pool_tables_ref(tabs, idx))
