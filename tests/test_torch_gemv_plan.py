"""The streaming GEMV loop's partition and the launch-plan caches of the
port's wrappers, on the CPU.

The partition (``repro_torch.kernels.gemv.plan``) is the plain Python the
wrappers hand to ``csrc/stream_gemv.cuh``: here it must cover every
element of the product exactly once and fit the card.  The plan caches are
exercised through the public wrappers on a CPU tensor that reports itself
as a card's (``_OnCard``), with the plan classes replaced by recorders, so
that no kernel is built or launched.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import CSRC, PlanCache
from repro_torch.kernels.fused_dispatch_a2a import ops as dispatch_ops
from repro_torch.kernels.fused_gemv_allreduce import ops as fused_ops
from repro_torch.kernels.gemv import ops as gemv_ops
from repro_torch.kernels.gemv import plan as gemv_plan
from repro_torch.kernels.gemv.plan import stream_plan

BF16, F32 = torch.bfloat16, torch.float32
# (rows, K, N) at the main path: chatglm3-6b's decode w_down, rwkv6-7b's
# decode w_o and channel-mix w_v
MAIN = [(4, 13696, 4096), (4, 4096, 4096), (4, 14336, 4096)]


def _coverage(rows, k, n, n_dev, capacity=None):
    """How often each (row, K, N) element is computed by the plan's units."""
    p = stream_plan(rows, k, n, n_dev, ranks_in_launch=n_dev, capacity=capacity)
    bn = n // n_dev
    kn = np.zeros((k, n), np.int32)
    for d in range(n_dev):
        for t in range(p.tiles):
            c0, c1 = d * bn + t * gemv_plan.TILE_N, d * bn + min(bn, (t + 1) * gemv_plan.TILE_N)
            for s in range(p.splits):
                kn[s * p.ks:min(k, (s + 1) * p.ks), c0:c1] += 1
    row = np.zeros(rows, np.int32)
    for rb in range(p.row_blocks):
        row[rb * p.rows_per_block:(rb + 1) * p.rows_per_block] += 1
    return p, kn, row


@pytest.mark.parametrize("rows,k,n,n_dev", [
    *((r, k, n, 1) for r, k, n in MAIN),
    (4, 3424, 4096, 4),                     # the emulated 4-rank world of chatglm3's w_down
    (1, 1, 32, 1), (3, 1000, 1000, 1), (9, 4097, 1001, 1), (4, 1, 1001, 1),
    (2, 4097, 32, 1), (16, 1000, 32, 1), (11, 1000, 4 * 96, 4), (2048, 4096, 4096, 1),
])
def test_partition_covers_every_element_once(rows, k, n, n_dev):
    p, kn, row = _coverage(rows, k, n, n_dev)
    assert (kn == 1).all(), "a (K, N) element is computed twice or never"
    assert (row == 1).all(), "a row is computed twice or never"
    assert p.ks % gemv_plan.STAGE_ROWS == 0
    assert (p.splits - 1) * p.ks < k <= p.splits * p.ks, "a CTA of the cluster has no K rows"


def _holds_up_to(most):
    """A card that holds every cluster of at most ``most`` CTAs at once
    and none larger, so the planner takes ``most`` splits where K allows."""
    return lambda splits, rows_per_block, ks: 1 << 20 if splits <= most else 0


# cudaOccupancyMaxActiveClusters on an H100 (chip_smoke.py phase 6) at
# chatglm3-6b's w_down: 30 clusters of 8 CTAs, 32 of 7
def _h100(splits, rows_per_block, ks):
    return {8: 30, 7: 32}.get(splits, 1 << 20)


@pytest.mark.parametrize("most", range(1, 9))
@pytest.mark.parametrize("rows,k,n,n_dev", [*((r, k, n, 1) for r, k, n in MAIN),
                                            (4, 3424, 4096, 4), (9, 4097, 1001, 1)])
def test_partition_covers_every_element_once_at_each_split(rows, k, n, n_dev, most):
    p, kn, row = _coverage(rows, k, n, n_dev, _holds_up_to(most))
    # the world's 128 clusters take at most 3 CTAs each (about two per SM)
    assert p.splits == most if n_dev == 1 else p.splits == min(most, 3)
    assert (kn == 1).all() and (row == 1).all()
    assert (p.splits - 1) * p.ks < k <= p.splits * p.ks


def test_card_capacity_gives_the_split_the_card_runs():
    """At chatglm3-6b's w_down the H100 holds 30 clusters of 8 and 32 of 7:
    the planner takes 7 splits (224 CTAs), every cluster in one wave."""
    p, kn, row = _coverage(*MAIN[0], 1, _h100)
    assert (p.splits, p.ks, p.units, p.rows_per_block) == (7, 1984, 32, 4)
    assert (kn == 1).all() and (row == 1).all()
    assert p.units * p.splits == 224


@pytest.mark.parametrize("rows,k,n", MAIN)
def test_main_path_fills_the_card(rows, k, n):
    p = stream_plan(rows, k, n)
    assert p.units * p.splits >= gemv_plan.H100_SMS
    assert 1 <= p.splits <= 8
    assert p.smem <= 227 * 1024
    # two CTAs per SM (each with 1 KB the system keeps) fit its 228 KB
    assert 2 * (p.smem + 1024) <= 228 * 1024
    assert p.rows_per_block == rows


def test_plan_mirrors_the_kernel_constants():
    """plan.py sizes what stream_gemv.cuh runs: the same tile, stage,
    ring and limits."""
    src = (CSRC / "stream_gemv.cuh").read_text()

    def const(name):
        return int(eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)))

    assert const("kStreamN") == gemv_plan.TILE_N
    assert const("kStreamStageRows") == gemv_plan.STAGE_ROWS
    assert const("kStreamRingBytes") == gemv_plan.RING_BYTES
    assert const("kStreamMaxRows") == gemv_plan.MAX_ROWS
    assert const("kStreamMaxSplits") == gemv_plan.MAX_SPLITS
    assert const("kStreamSmemLimit") == gemv_plan.SMEM_LIMIT
    assert 128 + gemv_plan.RING_BYTES + 2 * const("kStreamMaxStages") * 8 == gemv_plan.FIXED_SMEM


def test_plan_shrinks_the_row_block_before_giving_up():
    p = stream_plan(8, 8 * 20000, 4096)          # 8 rows of a 20000-deep slice: 640 KB
    assert p is not None and p.rows_per_block < 8 and p.smem <= gemv_plan.SMEM_LIMIT
    assert stream_plan(8, 400000, 4096) is None  # one row of the slice is past 227 KB
    with pytest.raises(ValueError):
        stream_plan(0, 64, 64)
    with pytest.raises(ValueError):
        stream_plan(4, 64, 100, n_dev=3)


@pytest.mark.parametrize("dtype,rows,k,n,aligned,want", [
    (BF16, 4, 13696, 4096, True, "stream"),
    (F32, 3, 777, 200, True, "stream"),         # f32: 800-byte rows
    (BF16, 11, 1000, 1000, True, "stream"),     # ragged N, 2000-byte rows
    (BF16, 2048, 4096, 4096, True, "stream"),   # many rows: row blocks of 8
    (BF16, 11, 1000, 1001, True, "panel"),      # 2002-byte rows: not for TMA
    (F32, 4, 1000, 1001, True, "panel"),
    (BF16, 4, 13696, 4096, False, "panel"),     # an unaligned w
    (F32, 8, 400000, 4096, True, "panel"),      # x's slice past shared memory
])
def test_gemv_path_choice(dtype, rows, k, n, aligned, want):
    assert gemv_ops.gemv_path(dtype, rows, k, n, aligned) == want


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a card's: they look its plan
    up and launch it instead of running the plain version."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return t.as_subclass(_OnCard)


class _Recorder:
    """Stands in for a wrapper's plan class: records what it was built
    from and every launch."""

    built = []

    def __init__(self, *args):
        type(self).built.append(args)
        self.launched = 0
        self.path, self.device = "stream", torch.device("cpu")
        if len(args) == 3:                       # gemv: (x, w, path)
            self.out_shape = (args[0].shape[0], args[1].shape[1])
        elif len(args) == 6:                     # fused: (x, w, ndim, wire, comm_aware, path)
            x, w, ndim = args[:3]
            self.out_shape = ((x.shape[0], w.shape[1]) if ndim == 2
                              else (x.shape[0], x.shape[1], w.shape[2]))

    def launch(self, *ptrs):
        self.launched += 1
        return 0


@pytest.fixture
def recorder(monkeypatch):
    _Recorder.built = []
    for mod, cls in ((dispatch_ops, "_DispatchPlan"), (gemv_ops, "_GemvPlan"),
                     (fused_ops, "_FusedPlan")):
        monkeypatch.setattr(mod, cls, _Recorder)
        monkeypatch.setattr(mod, "_PLANS", PlanCache())
    return _Recorder


def test_dispatch_plan_is_built_once_per_signature(recorder):
    fn = dispatch_ops.fused_dispatch_a2a
    x = torch.zeros(1, 1, 2, 4, 8)
    launches = fn.launches
    for _ in range(3):
        assert fn(_on_card(x)).shape == x.shape
    assert len(recorder.built) == 1 and fn.launches == launches + 3
    # each key field builds a plan of its own, once
    for kw in ({"comm_aware": False}, {"skew": 1}, {"chunks_per_rank": 3}, {"wire": "bf16"}):
        fn(_on_card(x), **kw)
        fn(_on_card(x), **kw)
    fn(_on_card(x.to(BF16)))
    fn(_on_card(torch.zeros(1, 1, 2, 4, 16)))
    assert len(recorder.built) == 7 and fn.launches == launches + 3 + 10
    xr, q, wire, comm_aware, skew = recorder.built[3]
    assert q == 2 and xr.shape == (1,) + x.shape    # chunks_per_rank 3 clamps to C's divisor 2
    assert recorder.built[4][2] == "bf16"
    # a CPU tensor takes the plain version and builds nothing
    got = fn(x)
    assert torch.equal(got, x) and len(recorder.built) == 7 and fn.launches == launches + 13
    # a bad call still raises before any plan is built
    with pytest.raises(ValueError):
        fn(_on_card(x), chunks_per_rank=0)
    with pytest.raises(NotImplementedError):
        fn(_on_card(torch.zeros(2, 1, 2, 4, 8)))
    assert len(recorder.built) == 7


def test_dispatch_ranks_plan_is_built_once_per_signature(recorder):
    fn = dispatch_ops.fused_dispatch_a2a_ranks
    x = torch.zeros(2, 2, 1, 2, 4, 8)
    launches = fn.launches
    fn(_on_card(x))
    fn(_on_card(x))
    fn(_on_card(x), skew=1)
    assert len(recorder.built) == 2 and fn.launches == launches + 3
    assert recorder.built[0][0].shape == x.shape
    with pytest.raises(ValueError):
        fn(_on_card(torch.zeros(2, 3, 1, 2, 4, 8)))


def test_gemv_plan_is_built_once_per_signature(recorder):
    x, w = torch.zeros(4, 64), torch.zeros(64, 32)
    launches = gemv_ops.gemv.launches
    for _ in range(3):
        gemv_ops.gemv(_on_card(x), _on_card(w))
    assert len(recorder.built) == 1 and gemv_ops.gemv.launches == launches + 3
    gemv_ops.gemv(_on_card(x), _on_card(w.clone()))           # another weight tensor
    gemv_ops.gemv(_on_card(x), _on_card(w), _path="panel")
    gemv_ops.gemv(_on_card(x[:2]), _on_card(w))
    assert len(recorder.built) == 4
    gemv_ops.gemv(x, w)                                       # CPU: the plain version
    assert len(recorder.built) == 4 and gemv_ops.gemv.launches == launches + 6
    with pytest.raises(ValueError):
        gemv_ops.gemv(_on_card(x), _on_card(torch.zeros(32, 32)))


def test_fused_plan_is_built_once_per_signature(recorder):
    x, w = torch.zeros(4, 64), torch.zeros(64, 128)
    fn = fused_ops.fused_matmul_allreduce
    launches = fn.launches
    for _ in range(3):
        fn(_on_card(x), _on_card(w))
    fn(_on_card(x), _on_card(w), wire="bf16")
    fn(_on_card(x), _on_card(w), _path="panel")
    fn(_on_card(x.to(BF16)), _on_card(w.to(BF16)))
    assert len(recorder.built) == 4 and fn.launches == launches + 6
    assert fn(x, w).shape == (4, 128) and len(recorder.built) == 4
    with pytest.raises((TypeError, ValueError)):
        fn(_on_card(x), _on_card(w), wire="fp8")
    xr = torch.zeros(4, 4, 16)
    fused_ops.fused_matmul_allreduce_ranks(_on_card(xr), _on_card(w.reshape(4, 16, 128)))
    fused_ops.fused_matmul_allreduce_ranks(_on_card(xr), _on_card(w.reshape(4, 16, 128)),
                                           comm_aware=False)
    assert len(recorder.built) == 6


def test_plan_cache_evicts_the_oldest_and_frees_it():
    freed = []

    class Plan:
        def __init__(self, i):
            self.i = i

        def free(self):
            freed.append(self.i)

    cache = PlanCache(size=2)
    for i in range(3):
        cache.put(i, Plan(i))
    assert freed == [0] and cache.get(0) is None and cache.get(2).i == 2
    assert cache.put(3, Plan(3)).i == 3 and freed == [0, 1]


def test_plan_cache_keeps_the_recently_used():
    cache = PlanCache(size=2)
    cache.put(0, "a")
    cache.put(1, "b")
    assert cache.get(0) == "a"          # 0 is now the most recently used
    cache.put(2, "c")
    assert cache.get(1) is None and cache.get(0) == "a" and len(cache) == 2


def test_plan_cache_drops_a_plan_with_its_weight():
    freed = []

    class Plan:
        def free(self):
            freed.append(self)

    cache = PlanCache()
    w, other = torch.zeros(4, 4), torch.zeros(4, 4)
    cache.put("w", Plan(), owner=w)
    cache.put("view", Plan(), owner=other[1:])      # a view's plan lives with its base
    cache.put("free", Plan())
    assert len(cache) == 3 and not freed
    del w
    assert cache.get("w") is None and len(freed) == 1 and len(cache) == 2
    assert cache.get("view") is not None
    del other
    assert cache.get("view") is None and len(freed) == 2
    # a plan evicted first is not freed again when its weight goes
    small, w2 = PlanCache(size=1), torch.zeros(2)
    small.put("a", Plan(), owner=w2)
    small.put("b", Plan())
    assert len(freed) == 3
    del w2
    assert len(freed) == 3 and small.get("b") is not None
    small.drop("b")
    assert len(freed) == 4 and len(small) == 0


def test_gemv_plan_lives_with_its_weight(recorder):
    x, w = torch.zeros(4, 64), torch.zeros(64, 32)
    gemv_ops.gemv(_on_card(x), _on_card(w))
    assert len(gemv_ops._PLANS) == 1
    gemv_ops.gemv(_on_card(x), _on_card(w))
    assert len(recorder.built) == 1
    recorder.built.clear()                  # the recorder kept the call's tensors
    del w
    assert len(gemv_ops._PLANS) == 0


def test_stream_sources_are_in_the_build():
    names = {p.name for p in Path(CSRC).glob("*.cu*")}
    assert {"stream_gemv.cuh", "gemv.cu", "fused_gemv_allreduce.cu"} <= names


# ---------------------------------------------------------------------------
# the expert FFN's stream path (kernels/fused_gemm_a2a/plan.py)
# ---------------------------------------------------------------------------
from repro_torch.kernels.fused_gemm_a2a import ops as ffn_ops  # noqa: E402
from repro_torch.kernels.fused_gemm_a2a import plan as ffn_plan_mod  # noqa: E402
from repro_torch.kernels.fused_gemm_a2a.plan import ffn_plan, unit_order  # noqa: E402

# (n_dev, b, e, c, d, f): dbrx-132b's decode at n_dev = 1 (the main path),
# its emulated 4-rank world at capacities 2 and 8, ragged shapes
FFN_MAIN = (1, 1, 16, 2, 6144, 10752)
FFN_SHAPES = [FFN_MAIN, (4, 1, 4, 2, 6144, 10752), (4, 1, 4, 8, 6144, 10752),
              (1, 1, 3, 5, 1000, 776), (1, 2, 3, 1, 64, 32), (2, 1, 2, 3, 4096, 1000)]


def _ffn_plan(shape, capacity=None):
    n_dev = shape[0]
    return ffn_plan(*shape, ranks_in_launch=n_dev, capacity=capacity)


def _ffn_coverage(shape, p):
    """How often each element of u [groups, C, F] and y [groups, C, D], and
    each K row of each unit, is computed by the plan's units."""
    _, _, _, c, d, f = shape
    u = np.zeros((p.groups, f), np.int32)
    y = np.zeros((p.groups, d), np.int32)
    k_up, k_down = np.zeros(d, np.int32), np.zeros(f, np.int32)
    for up, g, t in unit_order(p.groups, p.f_tiles, p.d_tiles):
        (u if up else y)[g, t * ffn_plan_mod.TILE_N:(t + 1) * ffn_plan_mod.TILE_N] += 1
    for s in range(p.splits):
        k_up[s * p.ks_up:(s + 1) * p.ks_up] += 1
        k_down[s * p.ks_down:(s + 1) * p.ks_down] += 1
    return u, y, k_up, k_down


@pytest.mark.parametrize("shape", FFN_SHAPES)
def test_ffn_partition_covers_every_element_once(shape):
    p = _ffn_plan(shape)
    u, y, k_up, k_down = _ffn_coverage(shape, p)
    assert (u == 1).all() and (y == 1).all(), "a column of u or y is computed twice or never"
    assert (k_up == 1).all() and (k_down == 1).all(), "a K row is streamed twice or never"
    assert p.ks_up % gemv_plan.STAGE_ROWS == 0 and p.ks_down % gemv_plan.STAGE_ROWS == 0
    assert shape[3] <= p.rows_per_block <= 8, "one row block holds every row of a group"
    assert len(unit_order(p.groups, p.f_tiles, p.d_tiles)) == p.units


@pytest.mark.parametrize("shape", FFN_SHAPES)
def test_ffn_down_units_follow_their_groups_up_units(shape):
    """In the static order, and so in each cluster's share of it, every down
    unit of a group comes after all the up/gate units of that group."""
    p = _ffn_plan(shape)
    order = unit_order(p.groups, p.f_tiles, p.d_tiles)
    last_up = {}
    for pos, (up, g, _) in enumerate(order):
        if up:
            last_up[g] = pos
    for cid in range(p.clusters):
        mine = order[cid::p.clusters]
        for i, (up, g, _) in enumerate(mine):
            if not up:
                assert all(not (u and gg == g) for u, gg, _ in mine[i + 1:])
    for pos, (up, g, _) in enumerate(order):
        if not up:
            assert last_up[g] < pos


# cudaOccupancyMaxActiveClusters on an H100 at dbrx's main shape (R = 2,
# each split's x slice): clusters of 1..8 CTAs (chip_smoke.py phase 7
# prints them)
H100_FFN = {1: 132, 2: 66, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}


def _h100_ffn(splits, rows_per_block, ks):
    return H100_FFN[splits]


@pytest.mark.parametrize("capacity", [None, _h100_ffn])
def test_ffn_main_path_waits_only_on_earlier_rounds(capacity):
    """At the main shape the resident clusters fit in one group's up/gate
    units, so clusters walking the order in rounds find every up/gate unit
    a down unit needs in an earlier round."""
    p = _ffn_plan(FFN_MAIN, capacity)
    assert p.clusters <= p.f_tiles
    order = unit_order(p.groups, p.f_tiles, p.d_tiles)
    up_round = {}
    for pos, (up, g, _) in enumerate(order):
        if up:
            up_round[g] = pos // p.clusters
    for pos, (up, g, _) in enumerate(order):
        if not up:
            assert up_round[g] < pos // p.clusters


def test_ffn_card_capacity_gives_the_split_the_card_runs():
    """One CTA a cluster would make 132 clusters, above the 84 up/gate units
    of a group; of the others 4 keeps the most CTAs resident (62 clusters,
    248 CTAs, two an SM)."""
    p = _ffn_plan(FFN_MAIN, _h100_ffn)
    assert (p.splits, p.ks_up, p.ks_down, p.clusters) == (4, 1536, 2688, 62)
    assert p.clusters * p.splits == max(c * s for s, c in H100_FFN.items() if c <= p.f_tiles)


@pytest.mark.parametrize("most", range(1, 9))
@pytest.mark.parametrize("shape", FFN_SHAPES)
def test_ffn_clusters_fit_the_capacity_at_each_split(shape, most):
    """A card that holds clusters of at most ``most`` CTAs, more of them
    than there are units: the planner takes ``most`` splits (where the
    shorter K has that many stages), or none where x's slice at that split
    is past shared memory, and no more clusters than it holds."""
    held = 1 << 20
    cap = lambda splits, rows_per_block, ks: held if splits <= most else 0
    p = _ffn_plan(shape, cap)
    _, _, _, c, d, f = shape
    want = min(most, -(-min(d, f) // gemv_plan.STAGE_ROWS))
    r = 1 << (c - 1).bit_length()
    ks = max(-(-d // want), -(-f // want))
    if ffn_plan_mod.smem_bytes(r, -(-ks // 32) * 32) > gemv_plan.SMEM_LIMIT:
        assert p is None
        return
    assert p.splits == want
    assert p.clusters <= held // shape[0] and p.clusters <= p.units
    assert p.smem <= gemv_plan.SMEM_LIMIT
    u, y, k_up, k_down = _ffn_coverage(shape, p)
    assert (u == 1).all() and (y == 1).all() and (k_up == 1).all() and (k_down == 1).all()


def test_ffn_plan_mirrors_the_kernel_constants():
    src = (CSRC / "fused_gemm_a2a.cu").read_text() + (CSRC / "stream_gemv.cuh").read_text()

    def const(name):
        expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)
        for k in re.findall(r"k[A-Z]\w+", expr):
            expr = expr.replace(k, str(const(k)))
        return int(eval(expr))

    assert const("kFfnFixedSmem") == ffn_plan_mod.FIXED_SMEM
    assert const("kStreamConsumerWarps") == ffn_plan_mod.CONSUMER_WARPS
    assert "(kStreamConsumerWarps + 2) * kStreamN + ks" in src   # ffn_smem_bytes per row


def test_ffn_plan_refuses_what_the_stream_path_cannot_take():
    assert ffn_plan(1, 1, 4, 9, 6144, 10752) is None                  # C above 8 rows
    assert ffn_plan(1, 1, 4, 8, 8 * 60000, 64) is None                # x's slice past 227 KB
    with pytest.raises(ValueError):
        ffn_plan(1, 1, 0, 2, 64, 64)


@pytest.mark.parametrize("dtype,c,d,f,aligned,want", [
    (BF16, 2, 6144, 10752, True, "stream"),   # dbrx decode
    (F32, 5, 1000, 776, True, "stream"),      # 4000- and 3104-byte rows
    (BF16, 8, 4096, 1024, True, "stream"),
    (F32, 5, 1000, 777, True, "panel"),       # F rows of 3108 bytes: not for TMA
    (BF16, 2, 6143, 10752, True, "panel"),    # D rows of 12286 bytes
    (BF16, 9, 6144, 10752, True, "tile"),     # C above 8 in bf16: prefill rows
    (BF16, 2, 6144, 10752, False, "panel"),   # an unaligned weight
    (BF16, 2560, 6144, 10752, True, "tile"),  # dbrx prefill of 4 x 2048
    (F32, 9, 6144, 10752, True, "panel"),     # f32 above 8 rows
    (BF16, 9, 6143, 10752, True, "panel"),    # a ragged D
    (BF16, 9, 6144, 10752, False, "panel"),   # prefill rows, an unaligned weight
])
def test_gemm_a2a_path_choice(dtype, c, d, f, aligned, want):
    assert ffn_ops.gemm_a2a_path(dtype, 1, 1, 4, c, d, f, aligned) == want


@pytest.mark.parametrize("path,c,f,raises", [
    ("stream", 9, 8, True), ("stream", 3, 7, True), ("stream", 3, 8, False),
    ("panel", 9, 7, False), ("tile", 3, 8, True)])
def test_gemm_a2a_forced_path_that_does_not_fit_raises_on_cpu(path, c, f, raises):
    x = torch.randn(1, 1, 2, c, 16)
    wu, wg, wd = torch.randn(2, 16, f), torch.randn(2, 16, f), torch.randn(2, f, 16)
    for fn, args in ((ffn_ops.fused_gemm_a2a, (x, wu, wg, wd)),
                     (ffn_ops.fused_gemm_a2a_ranks, (x[None], wu[None], wg[None], wd[None]))):
        if raises:
            with pytest.raises(ValueError):
                fn(*args, _path=path)
        else:
            assert fn(*args, _path=path).shape == args[0].shape


class _FfnRecorder(_Recorder):
    """Stands in for the expert FFN's plan class."""

    def __init__(self, xr, wu, wg, wd, act, wire, comm_aware, skew, path):
        type(self).built.append((xr, act, wire, comm_aware, skew, path))
        self.launched, self.path = 0, path or "stream"


@pytest.fixture
def ffn_recorder(monkeypatch):
    _FfnRecorder.built = []
    monkeypatch.setattr(ffn_ops, "_GemmA2APlan", _FfnRecorder)
    monkeypatch.setattr(ffn_ops, "_PLANS", PlanCache())
    return _FfnRecorder


def test_gemm_a2a_plan_is_built_once_per_signature(ffn_recorder):
    fn = ffn_ops.fused_gemm_a2a
    x = torch.zeros(1, 1, 2, 3, 16)
    wu, wg, wd = torch.zeros(2, 16, 8), torch.zeros(2, 16, 8), torch.zeros(2, 8, 16)
    ops = [_on_card(a) for a in (wu, wg, wd)]
    launches, stream = fn.launches, fn.path_launches["stream"]
    for _ in range(3):
        assert fn(_on_card(x), *ops).shape == x.shape
    assert len(ffn_recorder.built) == 1
    assert fn.launches == launches + 3 and fn.path_launches["stream"] == stream + 3
    for kw in ({"act": "gelu"}, {"wire": "bf16"}, {"comm_aware": False}, {"skew": 1},
               {"_path": "panel"}):
        fn(_on_card(x), *ops, **kw)
        fn(_on_card(x), *ops, **kw)
    fn(_on_card(x), _on_card(wu.clone()), *ops[1:])           # another weight tensor
    assert len(ffn_recorder.built) == 7 and fn.path_launches["panel"] >= 2
    assert ffn_recorder.built[0][0].shape == (1,) + x.shape   # the rank axis added
    fn(x, wu, wg, wd)                                         # CPU: the plain version
    assert len(ffn_recorder.built) == 7
    with pytest.raises(ValueError):
        fn(_on_card(x), *ops, act="swish")
    ffn_ops.fused_gemm_a2a_ranks(_on_card(x[None]), *(_on_card(a[None]) for a in (wu, wg, wd)))
    assert len(ffn_recorder.built) == 8


@pytest.mark.parametrize("which", range(3))
def test_gemm_a2a_plan_goes_with_any_of_its_weights(ffn_recorder, which):
    x = torch.zeros(1, 1, 2, 3, 16)
    w = [torch.zeros(2, 16, 8), torch.zeros(2, 16, 8), torch.zeros(2, 8, 16)]
    ffn_ops.fused_gemm_a2a(_on_card(x), *(_on_card(a) for a in w))
    assert len(ffn_ops._PLANS) == 1
    ffn_recorder.built.clear()                  # the recorder kept the call's tensors
    del w[which]
    assert len(ffn_ops._PLANS) == 0


def test_plan_cache_drops_a_plan_with_any_owner():
    freed = []

    class Plan:
        def free(self):
            freed.append(self)

    cache, a, b = PlanCache(), torch.zeros(2), torch.zeros(2)
    cache.put("ab", Plan(), owner=(a, b))
    del b
    assert cache.get("ab") is None and len(freed) == 1
    del a                                       # the other owner's finalizer was detached
    assert len(freed) == 1


def test_stream_path_of_the_expert_ffn_is_in_the_build():
    src = (CSRC / "fused_gemm_a2a.cu").read_text()
    assert '#include "stream_gemv.cuh"' in src and "ffn_stream_kernel" in src
