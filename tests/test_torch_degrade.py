"""The port's degradation policy (``repro_torch.core.degrade``) against the
JAX package's, and its hooks at every ported fused-op call site.

The policy is pure Python in both packages: the same sequence of
``record_failure`` / ``record_healthy`` / ``effective_mode`` events must
leave both in the same state.  At the call sites the keys the port
registers are the reference's keys on the same inputs (its op run with a
policy installed, on a one-device mesh), and a quarantined key runs the
bulk form, counted in ``demotions``.  CPU, f32.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.compat import make_mesh
from repro.core import allgather_matmul as jagmm
from repro.core import degrade as jdeg
from repro.core import moe_all_to_all as jmoe_a2a
from repro.core.embedding_all_to_all import embedding_all_to_all as jax_emb_a2a
from repro.core.matmul_allreduce import matmul_allreduce as jax_matmul_allreduce
from repro.models import moe as jmoe
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.core import allgather_matmul as pagmm
from repro_torch.core import degrade as pdeg
from repro_torch.core import embedding_all_to_all as emb_a2a
from repro_torch.core import matmul_allreduce as pmar
from repro_torch.core import moe_all_to_all as pmoe_a2a
from repro_torch.models import moe
from repro_torch.parallel.sharding import FusionConfig, ParallelContext

ROOT = Path(__file__).resolve().parents[1]
KEYS = [("matmul_allreduce", (4, 1, 64, 32)), ("allgather_matmul", (2, 8, 16, 16, 32)),
        ("embedding_a2a", (8, 4, 2, 4, 30, 16))]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def policies():
    """A fresh policy installed in each package; both removed after."""
    pj, pp = jdeg.DegradationPolicy(), pdeg.DegradationPolicy()
    prev = jdeg.set_degradation_policy(pj), pdeg.set_degradation_policy(pp)
    yield pj, pp
    jdeg.set_degradation_policy(prev[0])
    pdeg.set_degradation_policy(prev[1])


def _state(pol):
    return (pol.summary(), pol.quarantined_keys(), dict(pol._strikes),
            dict(pol._sentences), sorted(pol._active), pol.demotions)


# ---------------------------------------------------------------------------
# the policy's state machine
# ---------------------------------------------------------------------------
def test_quarantine_release_backoff():
    """tests/test_chaos.py's case, on the port's policy."""
    pol = pdeg.DegradationPolicy(pdeg.DegradeConfig(max_failures=2, cooldown=3,
                                                    cooldown_backoff=2.0))
    key = ("matmul_allreduce", (2, 8, 16, 16))
    assert pol.effective_mode(*key, "fused") == "fused"
    assert pol.record_failure(key) == []
    assert pol.record_failure(key) == [key]
    assert pol.consume_dirty() and not pol.consume_dirty()
    assert pol.effective_mode(*key, "fused") == "bulk"
    assert pol.effective_mode(*key, "bulk") == "bulk"
    for _ in range(2):
        assert pol.record_healthy() == []
    assert pol.record_healthy() == [key]
    assert pol.consume_dirty()
    assert pol.effective_mode(*key, "fused") == "fused"
    pol.record_failure(key)
    assert pol.record_failure(key) == [key]
    assert pol._quarantine[key] == 6
    assert pol.summary()["sentences"] == 2 and pol.summary()["demotions"] == 1


_event = st.one_of(
    st.tuples(st.just("mode"), st.sampled_from(range(len(KEYS))),
              st.sampled_from(["fused", "kernel", "bulk"])),
    st.tuples(st.just("fail"), st.sampled_from([None] + list(range(len(KEYS))))),
    st.tuples(st.just("healthy")),
    st.tuples(st.just("begin")),
    st.tuples(st.just("dirty")))


@settings(max_examples=150, deadline=None)
@given(events=st.lists(_event, max_size=60),
       cfg=st.tuples(st.integers(1, 3), st.integers(1, 5), st.sampled_from([1.0, 2.0, 3.0]),
                     st.integers(1, 20)))
def test_policy_state_machine_matches_reference(events, cfg):
    """A random sequence of events leaves both packages' policies in the
    same state, with the same answer to every event."""
    pj = jdeg.DegradationPolicy(jdeg.DegradeConfig(*cfg))
    pp = pdeg.DegradationPolicy(pdeg.DegradeConfig(*cfg))
    for ev in events:
        outs = []
        for pol in (pj, pp):
            if ev[0] == "mode":
                outs.append(pol.effective_mode(*KEYS[ev[1]], ev[2]))
            elif ev[0] == "fail":
                outs.append(pol.record_failure(None if ev[1] is None else KEYS[ev[1]]))
            elif ev[0] == "healthy":
                outs.append(pol.record_healthy())
            elif ev[0] == "begin":
                outs.append(pol.begin_trace())
            else:
                outs.append(pol.consume_dirty())
        assert outs[0] == outs[1], ev
        assert _state(pj) == _state(pp), ev


def test_installation_and_probe():
    assert pdeg.degrade_mode("matmul_allreduce", (4, 1, 64, 32), "fused") == "fused"
    assert not pdeg.is_quarantined("matmul_allreduce", (4, 1, 64, 32))
    pol = pdeg.DegradationPolicy(pdeg.DegradeConfig(max_failures=1))
    assert pdeg.set_degradation_policy(pol) is None
    try:
        assert pdeg.get_degradation_policy() is pol
        pol.record_failure(("matmul_allreduce", (4, 1, 64, 32)))
        assert pdeg.is_quarantined("matmul_allreduce", [4, 1, 64, 32])
        assert pol.summary()["active_keys"] == 0       # the probe registers nothing
        assert pdeg.degrade_mode("matmul_allreduce", (4, 1, 64, 32), "kernel") == "bulk"
    finally:
        assert pdeg.set_degradation_policy(None) is pol
    assert pdeg.degrade_mode("matmul_allreduce", (4, 1, 64, 32), "kernel") == "kernel"


def test_nothing_in_the_port_feeds_the_policy_from_an_except():
    """A kernel that fails raises: no ``record_failure`` call inside an
    ``except`` in the port's package or chip_smoke.py."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for handler in (n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)):
            for call in (n for n in ast.walk(handler) if isinstance(n, ast.Call)):
                name = getattr(call.func, "attr", getattr(call.func, "id", ""))
                assert name != "record_failure", f"{path}:{call.lineno}"


# ---------------------------------------------------------------------------
# the call sites: the reference's keys, and bulk mode for a quarantined key
# ---------------------------------------------------------------------------
def _jctx(mode="fused"):
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")), fusion=JaxFusion(mode=mode))


def _pctx(mode="kernel"):
    return ParallelContext(device="cpu", fusion=FusionConfig(mode=mode))


def _site(name, rng):
    """(the JAX call, the port call (mode -> output), the port function to
    spy on for its non-bulk path)."""
    if name == "matmul_allreduce":
        x = rng.standard_normal((4, 1, 64)).astype(np.float32)
        w = rng.standard_normal((64, 32)).astype(np.float32)
        return (lambda: jax_matmul_allreduce(_jctx(), x, w),
                lambda m: pmar.matmul_allreduce(_pctx(m), t(x), t(w)),
                (pmar, "fused_matmul_allreduce"))
    if name in ("allgather_matmul", "matmul_reducescatter"):
        x = rng.standard_normal((2, 8, 16)).astype(np.float32)
        w = rng.standard_normal((16, 16)).astype(np.float32)
        return (lambda: getattr(jagmm, name)(_jctx(), x, w),
                lambda m: getattr(pagmm, name)(_pctx(m), t(x), t(w)),
                (pagmm, "reduce_scatter" if name == "matmul_reducescatter" else "all_gather"))
    tabs = rng.standard_normal((4, 30, 16)).astype(np.float32)
    idx = rng.integers(0, 30, (8, 4, 2)).astype(np.int32)
    return (lambda: jax_emb_a2a(_jctx("kernel"), idx, tabs),
            lambda m: emb_a2a.embedding_all_to_all(_pctx(m), t(idx), t(tabs)),
            (emb_a2a, "embedding_pool_tables"))


SITES = ["matmul_allreduce", "allgather_matmul", "matmul_reducescatter", "embedding_a2a"]


@pytest.mark.parametrize("name", SITES)
def test_call_site_keys_match_reference(policies, rng, name):
    pj, pp = policies
    run_jax, run_port, _ = _site(name, rng)
    jax.eval_shape(run_jax)
    run_port("kernel")
    assert sorted(pp._active) == sorted(pj._active) and len(pp._active) == 1


@pytest.mark.parametrize("name", SITES)
def test_quarantined_key_runs_bulk_and_is_counted(policies, rng, monkeypatch, name):
    """A quarantined key takes the bulk path (the kernel-mode spy sees no
    call, or the bulk spy one) with the bulk output; each demotion counts;
    released, the key takes its mode again."""
    _, pol = policies
    pol.cfg = pdeg.DegradeConfig(max_failures=1, cooldown=2)
    _, run_port, (mod, fn_name) = _site(name, rng)
    calls = []
    real = getattr(mod, fn_name)
    monkeypatch.setattr(mod, fn_name, lambda *a, **k: calls.append(1) or real(*a, **k))
    bulk_spy = fn_name in ("all_reduce", "all_gather", "reduce_scatter")  # bulk mode's only
    want = run_port("bulk").clone()
    calls.clear()
    run_port("kernel")
    assert len(calls) == (0 if bulk_spy else 1)
    (key,) = pol._active
    assert pol.record_failure(key) == [key]
    calls.clear()
    for i in range(2):
        torch.testing.assert_close(run_port("kernel"), want, rtol=0, atol=0)
    assert pol.demotions == 2 and len(calls) == (2 if bulk_spy else 0)
    assert pol.record_healthy() == [] and pol.record_healthy() == [key]
    calls.clear()
    run_port("kernel")
    assert len(calls) == (0 if bulk_spy else 1) and pol.demotions == 2


def _moe_inputs(rng, cfg_kw):
    D, E, Fd = cfg_kw["d_model"], cfg_kw["n_experts"], cfg_kw["d_ff"]
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "w_gate": rng.standard_normal((E, D, Fd)).astype(np.float32) * D ** -0.5,
         "w_up": rng.standard_normal((E, D, Fd)).astype(np.float32) * D ** -0.5,
         "w_down": rng.standard_normal((E, Fd, D)).astype(np.float32) * Fd ** -0.5}
    return {k: t(v) for k, v in p.items()}, rng.standard_normal((4, 3, D)).astype(np.float32)


def test_moe_keys_match_reference(policies, rng):
    """The two MoE keys: the reference's standalone dispatch and combine
    entries on the dispatch buffer's global shape register the keys the
    port's layer registers."""
    pj, pp = policies
    cfg_kw = dict(n_experts=8, top_k=2, d_model=16, d_ff=8)
    params, x = _moe_inputs(rng, cfg_kw)
    moe.moe_apply(_pctx(), params, t(x), moe.MoEConfig(**cfg_kw))
    C = moe._route(moe.MoEConfig(**cfg_kw), t(x).reshape(-1, 16), params["router"])[-1]
    buf = np.zeros((1, 1, 8, C, 16), np.float32)
    w = {k: v.numpy() for k, v in params.items()}
    jc = _jctx("bulk")
    jax.eval_shape(lambda b: jmoe_a2a.moe_dispatch_all_to_all(jc, b), buf)
    jax.eval_shape(lambda b: jmoe_a2a.fused_expert_ffn_combine(
        jc, b, w["w_up"], w["w_gate"], w["w_down"], act=jax.nn.silu), buf)
    assert sorted(pp._active) == sorted(pj._active) and len(pp._active) == 2


@pytest.mark.parametrize("side", ["moe_dispatch_a2a", "moe_combine_a2a"])
def test_moe_quarantined_side_runs_bulk(policies, rng, monkeypatch, side):
    """A quarantined dispatch or combine runs its bulk form; the other side
    keeps its kernel; the layer's output is bulk mode's."""
    _, pol = policies
    pol.cfg = pdeg.DegradeConfig(max_failures=1)
    cfg_kw = dict(n_experts=8, top_k=2, d_model=16, d_ff=8)
    cfg = moe.MoEConfig(**cfg_kw)
    params, x = _moe_inputs(rng, cfg_kw)
    want = moe.moe_apply(_pctx("bulk"), params, t(x), cfg)
    seen = []
    for name in ("fused_dispatch_a2a", "fused_gemm_a2a"):
        real = getattr(pmoe_a2a, name)
        monkeypatch.setattr(pmoe_a2a, name, lambda *a, _n=name, _f=real, **k: seen.append(_n)
                            or _f(*a, **k))
    moe.moe_apply(_pctx(), params, t(x), cfg)
    assert seen == ["fused_dispatch_a2a", "fused_gemm_a2a"]
    (key,) = [k for k in pol._active if k[0] == side]
    pol.record_failure(key)
    seen.clear()
    got = moe.moe_apply(_pctx(), params, t(x), cfg)
    assert seen == (["fused_gemm_a2a"] if side == "moe_dispatch_a2a" else ["fused_dispatch_a2a"])
    assert pol.demotions == 1
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
