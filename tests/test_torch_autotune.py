"""The port's hardware model, overlap autotuner and measured calibration
(``repro_torch.core.{perfmodel,autotune,calibrate}``) against the JAX
package's.

Both packages decide under the same constants: the port's
``HardwareModel`` is built from ``dataclasses.asdict`` of the reference's
``V5E`` / ``DCN`` (``tests/torch_tune.py``).  The model's terms and every
decision must then be equal (``==``, the same floats), on hypothesis grids
of shapes, worlds, divisors, wire requests, pinned granularities and the fp8
clamp; a cache written by either package loads in the other.  In a gloo
world of CPU processes (``tests/torch_world.py``, tp = 2 and 4) the fused
products with ``"auto"`` match the JAX package on a (1, tp) mesh under the
same decision, and a measured calibration pass leaves every rank with the
same decisions.  The serving launcher runs ``--granularity auto --wire auto
--calibrate --tune-cache`` on the reduced chatglm3-6b, alone and under
``torch.distributed.run``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.compat import make_mesh
from repro.core import allgather_matmul as jagmm
from repro.core import autotune as jtune
from repro.core import calibrate as jcal
from repro.core import perfmodel as jperf
from repro.core.matmul_allreduce import matmul_allreduce as jax_matmul_allreduce
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.configs.registry import get_arch
from repro_torch.core import autotune as ptune
from repro_torch.core import calibrate as pcal
from repro_torch.core import perfmodel as pperf
from repro_torch.launch import serve as launch_serve
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from torch_tune import P_DCN, P_V5E, as_json, clear_both, decisions, port_hw
from torch_world import World

TOL = dict(rtol=3e-4, atol=3e-4)                 # TOL["f32"] of test_parity_matrix.py
WIRE_TOL = {"f32": TOL, "bf16": dict(rtol=3e-2, atol=3e-2),
            "fp8": dict(rtol=2e-1, atol=2e-1)}   # its WIRE_TOL
ROOT = Path(__file__).resolve().parents[1]
J_FP8 = dataclasses.replace(jperf.V5E, fp8_wire=True)
# (reference, port) link classes under the same constants
HWS = {"v5e": (jperf.V5E, P_V5E), "dcn": (jperf.DCN, P_DCN), "fp8": (J_FP8, port_hw(J_FP8))}


@pytest.fixture(autouse=True)
def _clean_caches():
    clear_both()
    yield
    clear_both()


# ---------------------------------------------------------------------------
# the hardware model
# ---------------------------------------------------------------------------
_pos = st.floats(min_value=0.0, max_value=1e15, allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None)
@given(flops=_pos, hbm=_pos, wire=_pos, chunks=st.integers(1, 256),
       hw=st.sampled_from(sorted(HWS)), bw=st.one_of(st.none(), st.floats(1e6, 1e12)),
       saving=st.floats(0.0, 1e-3), factor=st.sampled_from([1.0, 0.5, 0.25]))
def test_model_terms_equal_the_reference(flops, hbm, wire, chunks, hw, bw, saving, factor):
    jh, ph = HWS[hw]
    assert ph.compute_time(flops, hbm) == jh.compute_time(flops, hbm)
    assert (pperf.model_bulk(flops, hbm, wire, bw=bw, hw=ph)
            == jperf.model_bulk(flops, hbm, wire, bw=bw, hw=jh))
    assert (pperf.model_fused(flops, hbm, wire, chunks, bw=bw, zero_copy_saving=saving, hw=ph)
            == jperf.model_fused(flops, hbm, wire, chunks, bw=bw, zero_copy_saving=saving,
                                 hw=jh))
    pair = pperf.model_pair(flops, hbm, wire, chunks, wire_factor=factor, hw=ph)
    assert pair == jperf.model_pair(flops, hbm, wire, chunks, wire_factor=factor, hw=jh)
    if pair[0] > 0:
        assert pperf.pct_reduction(*pair) == jperf.pct_reduction(*pair)


@pytest.mark.parametrize("axis", [None, "model", "pod", ("data", "model"), ("pod", "model"), ()])
def test_mesh_hardware_model_matches_the_reference(axis):
    asd = dataclasses.asdict
    pairs = [(jperf.MeshHardwareModel.uniform(jperf.DCN), pperf.MeshHardwareModel.uniform(P_DCN)),
             (jperf.MeshHardwareModel.from_mapping({"pod": jperf.DCN, "x": J_FP8}, jperf.V5E),
              pperf.MeshHardwareModel.from_mapping({"pod": P_DCN, "x": port_hw(J_FP8)}, P_V5E)),
             (jperf.MeshHardwareModel.for_mesh_axes(["data", "model", "pod"]),
              pperf.MeshHardwareModel.for_mesh_axes(["data", "model", "pod"], ici=P_V5E,
                                                    dcn=P_DCN))]
    for jm, pm in pairs:
        assert asd(pm.for_axes(axis)) == asd(jm.for_axes(axis))
        assert asd(pperf.resolve_hw(pm, axis)) == asd(jperf.resolve_hw(jm, axis))
    assert pperf.resolve_hw(P_DCN, axis) is P_DCN


def test_the_port_link_classes():
    """The H100 class (the default) and the gloo class fitted to the
    one-card all-reduce times; no TPU constant in the port."""
    h = pperf.HardwareModel()
    assert h == pperf.H100_NVLINK and not h.fp8_wire
    assert (h.peak_flops, h.hbm_bw, h.ici_bw) == (989e12, 3.35e12, 450e9)
    g = pperf.GLOO_HOST
    assert g.ici_lat == g.chunk_overhead == 3.586e-3 and not g.fp8_wire
    assert g.ici_lat + 4 * 4096 * 2 / g.ici_bw == pytest.approx(5.287e-3)
    assert not hasattr(pperf, "V5E") and not hasattr(pperf, "DCN")
    assert ParallelContext(device="cpu").hw == pperf.MeshHardwareModel.uniform(h)
    # the link class decides: at chatglm3-6b's FFN down over 4 ranks at
    # 2048 rows, the NVLink class picks finer sub-chunks than the gloo class
    kw = dict(dtype_bytes=2, n_dev=4, chunk_dim=2048)
    fine = ptune.tune_matmul_allreduce(2048, 3424, 4096, hw=h, **kw)
    coarse = ptune.tune_matmul_allreduce(2048, 3424, 4096, hw=g, **kw)
    assert fine.q > coarse.q == 1


# ---------------------------------------------------------------------------
# the decisions
# ---------------------------------------------------------------------------
_overlap = dict(
    shape=st.lists(st.integers(1, 4096), min_size=1, max_size=4).map(tuple),
    dtype_bytes=st.sampled_from([2, 4]), n_dev=st.sampled_from([1, 2, 4, 8]),
    flops=_pos, hbm_bytes=st.floats(0, 1e10), wire_bytes=st.floats(0, 1e10),
    divisor_of=st.one_of(st.none(), st.integers(1, 4096)),
    divisor_ring=st.sampled_from([None, 1, 2, 4]), max_q=st.sampled_from([1, 2, 4, 16]),
    skew=st.sampled_from([0, 1, 3]), wire=st.sampled_from(["f32", "bf16", "fp8", "auto"]),
    fixed_q=st.sampled_from([None, 1, 2, 4]), allow_fp8=st.booleans())


@settings(max_examples=400, deadline=None)
@given(hw=st.sampled_from(sorted(HWS)), **_overlap)
def test_choose_overlap_matches_the_reference(hw, **kw):
    clear_both()
    jh, ph = HWS[hw]
    want = jtune.choose_overlap("op", hw=jh, **kw)
    got = ptune.choose_overlap("op", hw=ph, **kw)
    assert got == want and isinstance(got, ptune.Decision)
    assert decisions(ptune) == decisions(jtune)
    assert ptune.choose_overlap("op", hw=ph, **kw) == want        # the memo's answer


def _tune_args(name):
    i = st.integers(1, 512)
    common = dict(dtype_bytes=st.sampled_from([2, 4]), n_dev=st.sampled_from([1, 2, 4, 8]),
                  skew=st.sampled_from([0, 2]),
                  wire=st.sampled_from(["f32", "bf16", "fp8", "auto"]),
                  fixed_q=st.sampled_from([None, 1, 2, 8]))
    per = {
        "tune_matmul_allreduce": dict(rows=i, k_local=i, n_out=i, chunk_dim=i,
                                      divisor_ring=st.sampled_from([None, 1]),
                                      allgather_phase=st.booleans()),
        "tune_allgather_matmul": dict(b=i, s_loc=i, k=i, n_out_local=i),
        "tune_all_to_all": dict(chunk_elems=i, flops_per_dest=st.floats(0, 1e12), sub_dim=i,
                                kernel=st.booleans()),
        "tune_ring_attention": dict(b=i, s_loc=i, n_heads=i, n_kv_heads=i, head_dim=i,
                                    hops=st.sampled_from([None, 0, 1, 3])),
        "tune_ce_ring": dict(b=i, s_loc=i, d_model=i, v_loc=i),
    }[name]
    return st.fixed_dictionaries({**common, **per})


@pytest.mark.parametrize("name", ["tune_matmul_allreduce", "tune_allgather_matmul",
                                  "tune_all_to_all", "tune_ring_attention", "tune_ce_ring"])
def test_tune_functions_match_the_reference(name):
    @settings(max_examples=150, deadline=None)
    @given(kw=_tune_args(name), hw=st.sampled_from(sorted(HWS)))
    def check(kw, hw):
        clear_both()
        jh, ph = HWS[hw]
        want = getattr(jtune, name)(hw=jh, **kw)
        assert getattr(ptune, name)(hw=ph, **kw) == want
        assert decisions(ptune) == decisions(jtune)
    check()


def test_candidates_match_the_reference():
    for (jh, ph) in HWS.values():
        for req in ("f32", "bf16", "fp8", "auto"):
            assert ptune.wire_candidates(req, ph) == jtune.wire_candidates(req, jh)
    with pytest.raises(ValueError, match="unknown wire"):
        ptune.wire_candidates("f16", P_V5E)
    for fixed_q in (None, 2):
        kw = dict(shape=(64, 64), dtype_bytes=4, n_dev=4, flops=1e9, hbm_bytes=1e6,
                  wire_bytes=1e6, divisor_of=64, wire="auto", fixed_q=fixed_q)
        jtune.choose_overlap("op", hw=J_FP8, **kw)
        ptune.choose_overlap("op", hw=port_hw(J_FP8), **kw)
    for (jk, pk) in zip(jtune.cache_info(), ptune.cache_info()):
        for max_q in (4, 16):
            assert ([tuple(d) for d in ptune.calibration_candidates(pk, max_q)]
                    == [tuple(d) for d in jtune.calibration_candidates(jk, max_q)])
    assert ptune.choose_chunks_per_rank("op2", shape=(8,), dtype_bytes=4, n_dev=2, flops=1e9,
                                        hbm_bytes=1e6, wire_bytes=1e8, divisor_of=8,
                                        hw=P_DCN) == jtune.choose_chunks_per_rank(
        "op2", shape=(8,), dtype_bytes=4, n_dev=2, flops=1e9, hbm_bytes=1e6, wire_bytes=1e8,
        divisor_of=8, hw=jperf.DCN)


def test_pinned_q_decisions_do_not_collide():
    kw = dict(shape=(512, 1024, 2048), dtype_bytes=4, n_dev=8, flops=2e11, hbm_bytes=1e7,
              wire_bytes=4e8, divisor_of=512, hw=P_DCN, wire="auto")
    d2 = ptune.choose_overlap("op_pin", **kw, fixed_q=2)
    d4 = ptune.choose_overlap("op_pin", **kw, fixed_q=4)
    free = ptune.choose_overlap("op_pin", **kw)
    assert d2.q == 2 and d4.q == 4 and len(ptune.cache_info()) == 3
    assert free == jtune.choose_overlap("op_pin", **dict(kw, hw=jperf.DCN))


def test_the_memo_follows_the_cache(tmp_path):
    kw = dict(shape=(64, 64), dtype_bytes=4, n_dev=4, flops=1e9, hbm_bytes=1e6,
              wire_bytes=1e6, divisor_of=64, hw=P_V5E, wire="auto")
    first = ptune.choose_overlap("op_m", **kw)
    (key,) = ptune.cache_info()
    ptune.set_decision(key, (8, "bf16"))
    assert ptune.choose_overlap("op_m", **kw) == (8, "bf16")
    path = str(tmp_path / "c.json")
    ptune.save_cache(path)
    ptune.set_decision(key, first)
    assert ptune.load_cache(path, merge=False) == 1
    assert ptune.choose_overlap("op_m", **kw) == (8, "bf16")
    ptune.clear_cache()
    assert ptune.choose_overlap("op_m", **kw) == first


# ---------------------------------------------------------------------------
# the cache file
# ---------------------------------------------------------------------------
def _populate(mod, v5e, dcn):
    big = dict(shape=(512, 1024, 2048), dtype_bytes=4, n_dev=8, flops=2e11, hbm_bytes=1e7,
               wire_bytes=4e8, divisor_of=512)
    return [mod.choose_overlap("op_w", **big, hw=dcn, wire="auto"),
            mod.choose_overlap("op_w", **big, hw=v5e, wire="auto", fixed_q=4),
            mod.tune_matmul_allreduce(8, 512, 1024, dtype_bytes=2, n_dev=4, chunk_dim=8,
                                      hw=v5e, skew=1, wire="auto"),
            mod.tune_all_to_all(4096, 1e9, dtype_bytes=4, n_dev=4, sub_dim=16, hw=dcn,
                                wire="fp8", kernel=True),
            mod.tune_ce_ring(2, 64, 128, 512, dtype_bytes=4, n_dev=2, hw=v5e)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_written_by_either_package_loads_in_the_other(tmp_path, writer):
    w, r = (jtune, ptune) if writer == "jax" else (ptune, jtune)
    hw = {jtune: (jperf.V5E, jperf.DCN), ptune: (P_V5E, P_DCN)}
    made = _populate(w, *hw[w])
    path = str(tmp_path / "tune.json")
    assert w.save_cache(path) == len(made) == 5
    assert r.load_cache(path) == 5
    assert decisions(r) == decisions(w)
    assert [tuple(d) for d in _populate(r, *hw[r])] == [tuple(d) for d in made]
    assert len(r.cache_info()) == 5                  # every call a hit
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_legacy_cache_without_the_wire_loads(tmp_path, writer):
    """tests/test_wire.py's legacy file (no wire in the key or the entry, no
    pinned q, no fp8 flag in the link model, a foreign link field), written
    by either package, loads in the port with the defaults."""
    mod, hw = (jtune, jperf.V5E) if writer == "jax" else (ptune, P_V5E)
    kw = dict(shape=(64, 64), dtype_bytes=4, n_dev=8, flops=1e9, hbm_bytes=1e6,
              wire_bytes=1e6, divisor_of=64)
    q = mod.choose_chunks_per_rank("op_legacy", hw=hw, **kw)
    path = str(tmp_path / "legacy.json")
    mod.save_cache(path)
    with open(path) as f:
        blob = json.load(f)
    for e in blob["entries"]:
        del e["key"]["wire"], e["key"]["fixed_q"], e["wire"], e["key"]["hw"]["fp8_wire"]
        e["key"]["hw"]["nvlink_bw"] = 1e12
    with open(path, "w") as f:
        json.dump(blob, f)
    clear_both()
    assert ptune.load_cache(path) == 1
    (key,) = ptune.cache_info()
    assert key.wire == "f32" and key.hw == P_V5E and key.fixed_q is None
    assert ptune.cache_info()[key] == ptune.Decision(q, "f32")
    assert ptune.choose_chunks_per_rank("op_legacy", hw=P_V5E, **kw) == q
    assert len(ptune.cache_info()) == 1


def test_load_cache_if_exists(tmp_path):
    assert ptune.load_cache_if_exists(None) == 0
    assert ptune.load_cache_if_exists(str(tmp_path / "missing.json")) == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"entries": [{"key": ')
    assert ptune.load_cache_if_exists(str(bad)) == 0


# ---------------------------------------------------------------------------
# tiles, resolution, CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,k,n,n_dev", [(1, 64, 128, 1), (4, 13696, 4096, 1), (4, 3424, 4096, 4),
                                         (8, 1000, 1024, 2), (32, 4096, 4096, 4), (4, 7, 12, 2)])
def test_tiles_match_the_reference(b, k, n, n_dev):
    for dtype_bytes in (2, 4):
        for budget in (1 << 16, 1 << 20, 8 << 20, 64 << 20):
            kw = dict(n_dev=n_dev, dtype_bytes=dtype_bytes, vmem_budget_bytes=budget)
            tn = ptune.choose_tile_n(b, k, n, **kw)
            assert tn == jtune.choose_tile_n(b, k, n, **kw)
            assert ptune.choose_tile_k(b, k, n, tn, **kw) == jtune.choose_tile_k(b, k, n, tn, **kw)
    for dim in (1, 7, 12, 128, 4096):
        for req in (1, 5, 64, 10000):
            assert ptune.feasible_tile(dim, req) == jtune.feasible_tile(dim, req)


def _outcome(fn):
    try:
        return tuple(fn())
    except ValueError as e:
        return ("ValueError", "granularity" in str(e), "wire" in str(e))


@pytest.mark.parametrize("override_q", [None, 1, 3, 0, "auto"])
@pytest.mark.parametrize("config_q", [1, 2, "auto"])
@pytest.mark.parametrize("override_wire", [None, "bf16", "auto", "f16"])
def test_resolve_overlap_matches_the_reference(override_q, config_q, override_wire):
    for config_wire in ("f32", "auto", "fp8"):
        for dim, ring in ((8, 1), (12, 2), (7, 2)):
            def call(mod, hw):
                pick = lambda fq, w: mod.tune_matmul_allreduce(
                    16, 64, 32, dtype_bytes=4, n_dev=ring, chunk_dim=dim, hw=hw, wire=w,
                    fixed_q=fq)
                return lambda: mod.resolve_overlap(override_q, config_q, override_wire,
                                                   config_wire, pick, dim=dim, ring=ring)
            clear_both()
            assert _outcome(call(ptune, P_DCN)) == _outcome(call(jtune, jperf.DCN))
            pick = lambda: 5
            for gran in (override_q, config_q):
                assert (_outcome(lambda: [ptune.resolve_chunks_per_rank(
                    gran, config_q, pick, dim=dim, ring=ring)])
                    == _outcome(lambda: [jtune.resolve_chunks_per_rank(
                        gran, config_q, pick, dim=dim, ring=ring)]))


def test_cli_flags_match_the_reference():
    import argparse

    def parse(mod, cal, argv):
        ap = argparse.ArgumentParser()
        mod.add_granularity_cli_args(ap)
        cal.add_calibration_cli_args(ap)
        return vars(ap.parse_args(argv))

    for argv in ([], ["--granularity", "auto", "--wire", "auto", "--tune-cache", "x",
                      "--calibrate", "--calibrate-iters", "5"], ["--granularity", "4"]):
        assert parse(ptune, pcal, argv) == parse(jtune, jcal, argv)
    for bad in ("0", "x", "-2"):
        with pytest.raises(ValueError, match="granularity"):
            ptune.parse_granularity(bad)
    assert ptune.parse_granularity("auto") == "auto" and ptune.parse_granularity("3") == 3


# ---------------------------------------------------------------------------
# the measured sweep
# ---------------------------------------------------------------------------
def test_measured_best_picks_the_fastest():
    def build(q):
        def fn():
            time.sleep(0.01 * q)
            return torch.zeros(())
        return fn

    best, times = ptune.measured_best(build, [1, 2, 4], iters=2, warmup=1)
    assert best == 1 and set(times) == {1, 2, 4} and times[4] > times[1] >= 0.01


def test_measured_best_excludes_a_raising_candidate_and_reports_it():
    def build_partial(q):
        if q == 1:
            raise RuntimeError("candidate cannot build")
        return lambda: torch.zeros(())

    errors = {}
    best, times = ptune.measured_best(build_partial, [1, 2], iters=1, warmup=0, fallback=7,
                                      errors=errors)
    assert best == 2 and set(times) == {2}
    assert errors == {1: "RuntimeError: candidate cannot build"}

    def build_none(q):
        raise torch.OutOfMemoryError("too fine")

    errors.clear()
    best, times = ptune.measured_best(build_none, [1, 2, 4], iters=1, warmup=0, fallback=7,
                                      errors=errors)
    assert best == 7 and times == {} and sorted(errors) == [1, 2, 4]
    with pytest.raises(torch.OutOfMemoryError):
        ptune.measured_best(build_none, [1, 2], iters=1, warmup=0)


def test_measured_best_never_swallows_a_cuda_error():
    class AcceleratorError(RuntimeError):
        pass

    for err in (AcceleratorError("an illegal memory access"),
                RuntimeError("CUDA error: an illegal memory access was encountered")):
        def build(q, err=err):
            if q == 2:
                raise err
            return lambda: torch.zeros(())
        with pytest.raises(type(err)):
            ptune.measured_best(build, [1, 2, 4], iters=1, warmup=0, fallback=1)


# ---------------------------------------------------------------------------
# the gloo world: tp = 2 and 4
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def _jctx(tp, **fusion):
    return JaxContext.from_mesh(make_mesh((1, tp), ("data", "model")),
                                fusion=JaxFusion(mode="fused", **fusion))


def _jdecisions():
    return sorted((json.dumps(as_json(k), sort_keys=True), d.q, d.wire)
                  for k, d in jtune.cache_info().items())


V5E_DICT = dataclasses.asdict(jperf.V5E)
DCN_DICT = dataclasses.asdict(jperf.DCN)


@pytest.mark.parametrize("case", ["ar_rows", "ar_cols", "ag"])
@pytest.mark.parametrize("knobs", [("auto", "f32"), (1, "auto"), ("auto", "auto")],
                         ids=["q_auto", "wire_auto", "both_auto"])
@pytest.mark.parametrize("tp", [2, 4])
def test_auto_products_match_jax_in_the_world(world, rng, tp, knobs, case):
    """matmul_allreduce (by rows, 8 of them, and by columns, 3 rows) and
    allgather_matmul with 'auto' knobs under the slow class (DCN, where a
    narrow wire can win): every rank takes the JAX package's decision, and
    the output matches at the chosen wire's tolerance."""
    q, wire = knobs
    jc = _jctx(tp, granularity=q, wire=wire)
    if case == "ag":
        x = rng.standard_normal((2, 16, 32)).astype(np.float32)
        w = rng.standard_normal((32, 32)).astype(np.float32)
        op = "allgather_matmul"
        fn = lambda x, w: jagmm.allgather_matmul(jc, x, w)
    else:
        x = rng.standard_normal((8 if case == "ar_rows" else 3, 1, 64)).astype(np.float32)
        w = rng.standard_normal((64, 32)).astype(np.float32)
        op = "matmul_allreduce"
        fn = lambda x, w: jax_matmul_allreduce(jc, x, w)
    jc = dataclasses.replace(jc, hw=jperf.MeshHardwareModel.uniform(jperf.DCN))
    want = np.asarray(jax.jit(fn)(x, w))
    jdec = _jdecisions()
    assert len(jdec) == 1
    outs = world.run("auto_task", tp, x=x, w=w, op=op, hw=DCN_DICT, q=q, wire=wire)[:tp]
    for got, dec in outs:
        assert dec == jdec
        if case == "ag":
            continue
        np.testing.assert_allclose(got, want, **WIRE_TOL[jdec[0][2]])
    if case == "ag":
        got = np.concatenate([o[0] for o in outs], axis=2)
        np.testing.assert_allclose(got, want, **WIRE_TOL[jdec[0][2]])


@pytest.mark.parametrize("tp", [2, 4])
def test_calibration_leaves_every_rank_with_the_same_decisions(world, rng, tp):
    x = rng.standard_normal((16, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    outs = world.run("calibrate_task", tp, x=x, w=w, hw=V5E_DICT)[:tp]
    decs, reports = zip(*outs)
    assert all(d == decs[0] for d in decs) and all(r == reports[0] for r in reports)
    ((model, measured, times, excluded),) = reports[0]
    assert measured in [d for d, _ in times] and not excluded
    assert [d for d, _ in times] == sorted(
        (q, w_) for w_ in ("f32", "bf16") for q in (1, 2, 4, 8, 16) if 16 % (tp * q) == 0)
    (key_json, q, w_), = decs[0]
    assert (q, w_) == measured and json.loads(key_json)["op"] == "matmul_allreduce"


def test_a_candidate_failing_on_one_rank_is_excluded_on_every_rank(world, rng):
    x = rng.standard_normal((8, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    outs = world.run("calibrate_task", 2, x=x, w=w, hw=V5E_DICT, fail="bf16")[:2]
    decs, reports = zip(*outs)
    assert decs[0] == decs[1]
    ((_, measured, times, excluded),) = reports[0]
    assert [tuple(e) for e in excluded] == [(1, "bf16"), (2, "bf16"), (4, "bf16")]
    assert reports[1][0][3] == excluded and measured[1] == "f32"
    assert all(d[1] == "f32" for d, _ in times)


@pytest.mark.parametrize("tp", [2, 4])
def test_a_gloo_world_takes_the_host_staged_class(world, tp):
    for hw in world.run("link_task", tp)[:tp]:
        assert hw == dataclasses.asdict(pperf.GLOO_HOST)


# ---------------------------------------------------------------------------
# the warm-up step and the serving launcher
# ---------------------------------------------------------------------------
def test_the_warm_up_step_leaves_the_serving_cache_bit_identical():
    bundle = get_arch("chatglm3-6b").reduced()
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode="kernel", granularity="auto",
                                                            wire="auto"))
    params = bundle.init_params(torch.Generator().manual_seed(0))
    serving = bundle.init_cache(4, "cpu")
    fresh = bundle.init_cache(4, "cpu")
    decode = bundle.decode_fn(ctx)
    tok, pos = torch.full((4, 1), 7, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    scratch = bundle.init_cache(4, "cpu")
    rep = pcal.warmup_and_calibrate(ctx, lambda c: decode(params, tok, c, pos), scratch,
                                    iters=1)
    for name in serving:
        assert torch.equal(serving[name], fresh[name]), name
    assert any(not torch.equal(scratch[n], fresh[n]) for n in scratch)   # the step wrote it
    (key,) = rep
    assert key.op == "matmul_allreduce" and key.shape == (4, 128, 64)
    assert rep[key]["measured_q"] == ptune.cache_info()[key]
    assert not rep[key]["fallback"]


SERVE_CPU = ["--reduced", "--device", "cpu", "--requests", "4", "--max-new", "6"]


def test_the_serving_launcher_with_auto_calibrate_and_a_tune_cache(tmp_path, capsys):
    """--granularity auto --wire auto --calibrate --tune-cache serve the
    pinned run's streams, print each decision, save the cache; a second
    launch from the cache sweeps no new key."""
    launch_serve.main(SERVE_CPU)
    want = [r.tokens for r in launch_serve.main(SERVE_CPU)]
    capsys.readouterr()
    path = str(tmp_path / "tune.json")
    auto = SERVE_CPU + ["--granularity", "auto", "--wire", "auto", "--calibrate",
                        "--calibrate-iters", "1", "--tune-cache", path]
    ptune.clear_cache()
    assert [r.tokens for r in launch_serve.main(auto)] == want
    out = capsys.readouterr().out
    assert "calibrate: 1/1 newly traced hot keys re-scored by measurement" in out
    assert re.search(r"decision: matmul_allreduce \(4, 128, 64\) -> \(\d+, (f32|bf16)\)", out)
    assert "tune cache: 1 decisions saved" in out
    ptune.clear_cache()
    assert [r.tokens for r in launch_serve.main(auto)] == want
    out = capsys.readouterr().out
    assert "tune cache: 1 decisions loaded" in out
    assert "calibrate: 0/0 newly traced hot keys" in out


def test_the_serving_launcher_in_a_gloo_world_calibrates_alike(tmp_path, capsys):
    """Under torch.distributed.run at tp = 2: every rank prints the same
    calibration, the launcher checks every rank's decisions, rank 0 alone
    writes the cache, and the streams are tp = 1's; a second launch from
    the cache sweeps nothing and serves the same streams."""
    want = {r.uid: r.tokens for r in launch_serve.main(SERVE_CPU + ["--fusion", "bulk"])}
    capsys.readouterr()
    path = str(tmp_path / "tune.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.serve", "--tp", "2", "--backend", "gloo", "--fusion",
           "fused", "--granularity", "auto", "--calibrate", "--calibrate-iters", "1",
           "--tune-cache", path, *SERVE_CPU]
    for run in range(2):
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = proc.stdout
        lines = {r: sorted(re.findall(rf"calibrate \[rank {r}\]: (.*)", out)) for r in (0, 1)}
        assert lines[0] == lines[1] and lines[0]
        assert "all 2 ranks' autotune decisions equal: True" in out
        assert out.count("decisions saved to") == 1
        streams = {int(u): eval(s) for u, s in re.findall(r"req (\d+): prompt .* -> (\[.*\])",
                                                           out)}
        assert streams == want
        swept = "1/1" if run == 0 else "0/0"
        assert f"calibrate [rank 1]: {swept} newly traced hot keys" in out
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    assert ptune.load_cache(path) == 1
    (key,) = ptune.cache_info()
    assert key.n_dev == 2 and key.hw == pperf.GLOO_HOST
