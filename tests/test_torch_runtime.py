"""The port's in-process runtime (``repro_torch.runtime``, ``repro_torch.
checkpoint``) against the JAX package's, with no world (one rank, CPU).

* Fault plans: the same spec and seed give the reference's events, one for
  one.
* The straggler loop: the same sequences give the reference's flags,
  rotations and rebuild counts.
* Checkpoints: the reference's format (f32, bf16 and int leaves in nested
  trees), its atomic ``.tmp``, ``keep`` and latest-step behaviour; a
  checkpoint the JAX package wrote restores bit for bit; an in-place update
  right after an async save does not reach the file.
* The supervisor: the scenarios of ``tests/test_fault_tolerance.py`` and
  ``tests/test_chaos.py`` on the same toy step in torch.  Restarts,
  backoffs, injected faults, rank losses and the final step equal the JAX
  supervisor's on the same plan; the final weights equal the port's own
  clean run bit for bit and are allclose to JAX's.
* The train launcher under ``--ckpt-dir`` and ``--chaos``: a clean run's
  losses bit for bit, and a second call resumes.

The world's half (gloo ranks: resharded checkpoints, a NaN wire in a real
ring, the elastic shrink, serving under chaos) is
``tests/test_torch_runtime_world.py``.
"""
import functools
import json
import os
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.compat import make_mesh
from repro.core import degrade as jdeg
from repro.core.matmul_allreduce import matmul_allreduce as jax_mar
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.runtime import chaos as jchaos
from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jstrag
from repro.runtime import watchdog as jwd
from repro_torch.checkpoint import checkpointer as pckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import degrade as pdeg
from repro_torch.core.collectives import set_wire_fault_hook
from repro_torch.core.matmul_allreduce import matmul_allreduce as port_mar
from repro_torch.launch import train as ptrain
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.runtime import chaos as pchaos
from repro_torch.runtime import elastic as pelastic
from repro_torch.runtime import fault_tolerance as pft
from repro_torch.runtime import straggler as pstrag
from repro_torch.runtime import watchdog as pwd

B, S, K = 2, 8, 16
LINKS = [1.0, 1.0, 1.0, 1.0, 4.0, 1.0, 1.0, 1.0]
CPU = ParallelContext(device="cpu", fusion=FusionConfig(mode="fused"))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def one_thread():
    """Bit-identity on the CPU needs one intra-op thread: a BLAS that adapts
    its threads to the machine's load splits its sums differently from one
    call to the next."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------
SPECS = ["rate=0.2,seed=5,kinds=timeout+nan_wire,delay=0.5", "rate=0.3",
         "rate=0.05,seed=3,kinds=timeout+slow_link+nan_wire+rank_fail",
         "rate=1.0,seed=2,kinds=rank_loss", "at=7:timeout+20:nan_wire+40:rank_loss",
         "at=1:slow_link+3:timeout+5:rank_fail,delay=0", "at=2:rank_loss,seed=9"]


def _events(plan):
    return [(e.step, e.kind, e.rank, e.delay_s, e.nth_send) for e in plan.events]


@pytest.mark.chaos
@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_spec_gives_the_references_events(spec):
    p = pchaos.parse_chaos_spec(spec, num_steps=100)
    j = jchaos.parse_chaos_spec(spec, num_steps=100)
    assert _events(p) == _events(j) and len(p) == len(j) > 0
    assert p.summary() == j.summary()
    assert all(_events(pchaos.FaultPlan(p.at(s))) == _events(jchaos.FaultPlan(j.at(s)))
               for s in range(100))
    assert pchaos.build_fault_plan(None, num_steps=3) is None


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 3, 4, 11])
def test_from_rate_gives_the_references_events(seed):
    kw = dict(kinds=("timeout", "slow_link", "nan_wire"), world=4, delay_s=0.25,
              nan_nth_send=2)
    p = pchaos.FaultPlan.from_rate(seed, 0.3, 200, **kw)
    j = jchaos.FaultPlan.from_rate(seed, 0.3, 200, **kw)
    assert _events(p) == _events(j) and len(p) > 0
    assert all(e.kind != "rank_loss" for e in p.events)
    assert _events(pchaos.FaultPlan.from_rate(seed, 0.3, 200)) == \
        _events(jchaos.FaultPlan.from_rate(seed, 0.3, 200))


@pytest.mark.chaos
def test_plan_errors_are_the_references():
    for mod in (pchaos, jchaos):
        with pytest.raises(ValueError):
            mod.parse_chaos_spec("delay=0.1", num_steps=10)
        with pytest.raises(ValueError):
            mod.parse_chaos_spec("rate", num_steps=10)
        with pytest.raises(ValueError):
            mod.FaultEvent(step=0, kind="meteor_strike")
        with pytest.raises(ValueError):
            mod.FaultPlan.from_rate(0, 1.5, 10)
        with pytest.raises(ValueError):
            mod.FaultPlan.from_rate(0, 0.5, 10, kinds=("meteor",))
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert pchaos.TRANSIENT_KINDS == jchaos.TRANSIENT_KINDS
    assert pchaos.RankLost(3).rank == jchaos.RankLost(3).rank == 3


@pytest.mark.chaos
def test_wire_fault_injector_counts_float_sends_and_restores_the_hook():
    ids = torch.arange(4)
    x = torch.ones(3)
    with pchaos.wire_faults(nth_send=1) as inj:
        hook = set_wire_fault_hook(None)
        set_wire_fault_hook(hook)
        assert hook is inj
        assert inj(ids) is ids              # integer payloads pass untouched
        assert inj(x) is x                  # send 0
        assert not inj.fired
        bad = inj(x)                        # send 1
        assert inj.fired and torch.isnan(bad).all() and bad.dtype == x.dtype
        assert inj(x) is x and inj.count == 3
    assert set_wire_fault_hook(None) is None


# ---------------------------------------------------------------------------
# the straggler loop
# ---------------------------------------------------------------------------
def _monitor_trace(mod, seq, **kw):
    m = mod.StragglerMonitor(**kw)
    return [(m.record(x), m.flags, m.flag_rate, m.skew, m.ewma) for x in seq], m.summary()


@pytest.mark.parametrize("seq,kw", [
    ([1, 1, 1, 1, 1, 3, 3, 3, 3, 3.0], dict(window=20, threshold=1.5, min_baseline=9)),
    ([1.0] * 6 + [10.0] * 3 + [1.0] * 10, dict(window=10, threshold=1.5, min_baseline=5)),
    (list(1.0 + np.random.default_rng(0).random(60)), {}),
])
def test_straggler_monitor_flags_as_the_reference(seq, kw):
    assert _monitor_trace(pstrag, seq, **kw) == _monitor_trace(jstrag, seq, **kw)


def _estimator_trace(mod, axes, seqs, **kw):
    est = mod.SkewEstimator(axes, **kw)
    out = []
    for times in seqs:
        est.observe(times)
        out.append((est.rotations(), {a: est.axis_skew(a) for a in axes}, est.ewma))
    return out


def test_skew_estimator_rotations_are_the_references():
    slow5, slow0 = [1.0] * 8, [1.0] * 8
    slow5[5] = slow0[0] = 1.5
    rng = np.random.default_rng(1)
    noisy = [list(1.0 + 0.2 * rng.random(8)) for _ in range(12)]
    for axes, kw, seqs in (
            ({"ring": 8}, dict(link_scales={"ring": LINKS}), [slow5] * 3 + [slow0] * 4),
            ({"ring": 8}, dict(link_scales={"ring": LINKS}, alpha=1.0, min_obs=1,
                               hysteresis=0.0), [slow5, slow5, slow0, slow5]),
            ({"data": 2, "model": 4}, {}, [[1.0, 1.0, 1.4, 1.0, 1.0, 1.0, 1.4, 1.0]] * 3),
            ({"data": 2, "model": 4}, dict(reduce_every=3), noisy)):
        assert _estimator_trace(pstrag, axes, seqs, **kw) == \
            _estimator_trace(jstrag, axes, seqs, **kw)
    for mod in (pstrag, jstrag):
        est = mod.SkewEstimator({"ring": 4})
        with pytest.raises(ValueError):
            est.observe([1.0, 1.0])
        with pytest.raises(ValueError):
            est.observe([1.0, 1.0, 0.0, 1.0])


def _scheduler_trace(mod):
    est = mod.SkewEstimator({"ring": 8}, link_scales={"ring": LINKS}, alpha=1.0,
                            min_obs=1, hysteresis=0.0)
    builds = []

    def build(skew):
        builds.append(skew)
        return lambda: skew

    sched = mod.SkewScheduler(build, est, axis="ring")
    trace = [sched.fn()()]
    slow, slow2 = [1.0] * 8, [1.0] * 8
    slow[5] = slow2[0] = 1.5
    for times in (slow, slow, slow2, slow, slow2):
        trace.append((sched.observe(times), sched.bucket, sched.fn()(), sched.rebuilds))
    sched.invalidate()
    trace.append((sched.fn()(), sched.rebuilds))
    return trace, builds


def test_skew_scheduler_rebuilds_as_the_reference():
    (trace, builds) = _scheduler_trace(pstrag)
    assert (trace, builds) == _scheduler_trace(jstrag)
    assert len(set(builds)) == 3 and len(builds) == 4   # one build a bucket, then invalidate


def test_process_telemetry_is_the_references():
    for local_world, gathered in ((8, [0.5, 0.7]), (4, [1.0, 2.0, 3.0, 4.0])):
        outs = []
        for mod in (pstrag, jstrag):
            mon = mod.StragglerMonitor()
            tel = mod.ProcessTelemetry(mon, local_world, allgather=lambda x, g=gathered: g)
            outs.append((tel(0.3), mon.record(0.3), tel(0.4)))
        assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        pstrag.ProcessTelemetry(pstrag.StragglerMonitor(), 3, allgather=lambda x: [1.0, 2.0])(1.0)
    # with no world the port's provider is the local time itself
    mon = pstrag.StragglerMonitor()
    assert pstrag.ProcessTelemetry(mon, 4)(0.25) == [0.25] * 4
    assert pstrag.world_allgather(CPU, 0.5) == [0.5]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _numpy_tree(rng):
    return {"params": {"w": rng.standard_normal((8, 16)).astype(np.float32),
                       "b": rng.standard_normal((16,)).astype(np.float32),
                       "h": (rng.standard_normal((4, 6)) * 3).astype(jnp.bfloat16)},
            "layers": [{"n": rng.standard_normal((5,)).astype(np.float32)},
                       {"n": rng.standard_normal((5,)).astype(np.float32)}],
            "opt": {"step": np.int32(7), "count": np.arange(6, dtype=np.int64)}}


def _torch_leaf(a):
    a = np.array(a)             # 0-d stays 0-d
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return _torch_leaf(tree)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _bits(x):
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes(), str(x.dtype), tuple(x.shape)


def _same_bits(a, b):
    la, lb = [x for _, x in pckpt._flatten(a)], [x for _, x in pckpt._flatten(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x) == _bits(y)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_roundtrip_f32_bf16_int_in_place(tmp_path, rng):
    tree = _to_torch(_numpy_tree(rng))
    path = pckpt.save_checkpoint(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007"
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    target = _zeros_like(tree)
    restored, step = pckpt.restore_checkpoint(path, target)
    assert step == 7
    _same_bits(restored, tree)
    # tensor leaves are overwritten in place
    assert restored["params"]["w"] is target["params"]["w"]
    assert restored["layers"][1]["n"] is target["layers"][1]["n"]


def test_manifest_is_the_references(tmp_path, rng):
    """The port's manifest lists each leaf as the JAX package's does (path,
    shape, dtype), bf16 included, and both write the same array bytes."""
    nt = _numpy_tree(rng)
    pj = jckpt.save_checkpoint(str(tmp_path / "jax"), 3, nt)
    pp = pckpt.save_checkpoint(str(tmp_path / "port"), 3, _to_torch(nt))
    mj, mp = (json.load(open(os.path.join(p, "manifest.json"))) for p in (pj, pp))
    entries = lambda m: {e["path"]: (e["shape"], e["dtype"]) for e in m["leaves"]}
    assert mp["step"] == mj["step"] == 3 and entries(mp) == entries(mj)
    files = lambda m, p: {e["path"]: np.load(os.path.join(p, e["file"])) for e in m["leaves"]}
    fj, fp = files(mj, pj), files(mp, pp)
    for k in fj:
        assert fj[k].tobytes() == fp[k].tobytes() and fj[k].itemsize == fp[k].itemsize, k


def test_jax_written_checkpoint_restores_bit_for_bit(tmp_path, rng):
    nt = _numpy_tree(rng)
    jtree = jax.tree.map(jnp.asarray, nt)       # int64 becomes int32 in JAX
    path = jckpt.save_checkpoint(str(tmp_path), 11, jtree)
    want = _to_torch(jax.tree.map(np.asarray, jtree))
    restored, step = pckpt.restore_checkpoint(path, _zeros_like(want))
    assert step == 11
    _same_bits(restored, want)
    assert restored["params"]["h"].dtype == torch.bfloat16


def test_shape_and_dtype_mismatch_rejected_before_any_write(tmp_path, rng):
    tree = _to_torch(_numpy_tree(rng))
    path = pckpt.save_checkpoint(str(tmp_path), 1, tree)
    bad = _zeros_like(tree)
    bad["params"]["b"] = torch.zeros(4)
    with pytest.raises(ValueError):
        pckpt.restore_checkpoint(path, bad)
    assert not bad["params"]["w"].any()         # nothing written before the check
    bad = _zeros_like(tree)
    bad["params"]["w"] = torch.zeros(8, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        pckpt.restore_checkpoint(path, bad)
    missing = _zeros_like(tree)
    missing["extra"] = torch.zeros(1)
    with pytest.raises(KeyError):
        pckpt.restore_checkpoint(path, missing)


def test_manager_keep_latest_and_fallback_as_the_reference(tmp_path, rng):
    nt = _numpy_tree(rng)
    tree = _to_torch(nt)
    steps = {}
    for name, mgr, tr in (("port", CheckpointManager(str(tmp_path / "p"), keep=2,
                                                     async_save=False), tree),
                          ("jax", JaxManager(str(tmp_path / "j"), keep=2, async_save=False), nt)):
        for s in [10, 20, 30, 40]:
            mgr.save(s, tr)
        steps[name] = (mgr.all_steps(), os.path.basename(mgr.latest_path()))
    assert steps["port"] == steps["jax"] == ([30, 40], "step_00000040")
    # the newest torn, then a missing array file: walk back past both
    mgr = CheckpointManager(str(tmp_path / "c"), keep=3, async_save=False)
    good = _to_torch(_numpy_tree(np.random.default_rng(5)))
    mgr.save(10, good)
    mgr.save(20, tree)
    manifest = tmp_path / "c" / "step_00000020" / "manifest.json"
    manifest.write_text(manifest.read_text()[:15])
    restored, step = mgr.restore_latest(_zeros_like(tree))
    assert step == 10
    _same_bits(restored, good)
    mgr.save(30, tree)
    arrs = [p for p in os.listdir(tmp_path / "c" / "step_00000030") if p.endswith(".npy")]
    os.remove(tmp_path / "c" / "step_00000030" / arrs[0])
    assert mgr.restore_latest(_zeros_like(tree))[1] == 10
    (tmp_path / "c" / "step_00000010" / "manifest.json").write_text("{")
    assert mgr.restore_latest(_zeros_like(tree)) is None
    assert [s["step"] for s in mgr.stats] == [10, 10]


def test_async_save_is_not_reached_by_an_in_place_update(tmp_path, rng):
    """The port's optimizer updates the state in place: a step right after
    an async save must not reach the file."""
    tree = _to_torch(_numpy_tree(rng))
    want = {k: v.clone() for k, v in tree["params"].items()}
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, tree)
    with torch.no_grad():           # the next step, in place, at once
        for v in tree["params"].values():
            v.add_(1)
    mgr.wait()
    restored, step = mgr.restore_latest(_zeros_like(tree))
    assert step == 5
    for k, v in want.items():
        assert _bits(restored["params"][k]) == _bits(v)
    entry = mgr.history[0]
    assert entry["step"] == 5 and entry["bytes"] == pckpt.tree_bytes(tree)
    assert entry["total_s"] >= entry["block_s"] >= 0


# ---------------------------------------------------------------------------
# the supervisor: tests/test_fault_tolerance.py's scenarios
# ---------------------------------------------------------------------------
def _cfg(mod, path, **kw):
    base = dict(checkpoint_dir=str(path), async_save=False)
    base.update(kw)
    return mod.SupervisorConfig(**base)


def _plus_one(mod, fail_at=(), nan_at=(), seen=None):
    """The reference tests' toy: w += 1, the loss its new value; call
    numbers in ``fail_at`` raise, in ``nan_at`` report NaN."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if seen is not None:
            seen.append(batch["id"])
        if fail_at(calls["n"]) if callable(fail_at) else calls["n"] in fail_at:
            raise RuntimeError("injected failure")
        if mod is pft:
            state["w"].add_(1.0)                 # in place, as the port's optimizer
            new, val = state, float(state["w"][0])
        else:
            new = {"w": state["w"] + 1.0}
            val = float(new["w"][0])
        loss = float("nan") if calls["n"] in nan_at else val
        return new, {"loss": torch.tensor(loss) if mod is pft else jnp.asarray(loss)}
    return step_fn


def _w0(mod):
    return {"w": torch.zeros(1)} if mod is pft else {"w": np.zeros((1,), np.float32)}


def _run_both(tmp_path, cfg_kw, step_kw, num_steps, batches=lambda: iter(lambda: {"id": 0}, None),
              **sup_kw):
    out = {}
    for name, mod in (("port", pft), ("jax", jft)):
        sleeps = []
        sup = mod.TrainSupervisor(_cfg(mod, tmp_path / name, **cfg_kw), _plus_one(mod, **step_kw),
                                  sleep_fn=sleeps.append, **sup_kw)
        try:
            final, step = sup.run(_w0(mod), batches(), num_steps=num_steps)
            w = float(np.asarray(final["w"])[0])
        except RuntimeError as e:
            step, w = type(e).__name__, None
        out[name] = dict(step=step, w=w, restarts=sup.restarts, backoffs=sup.backoffs,
                         sleeps=sleeps, saved=sup.manager.all_steps())
    assert out["port"] == out["jax"], out
    return out["port"]


def test_supervisor_restarts_from_checkpoint(tmp_path):
    got = _run_both(tmp_path, dict(checkpoint_every=3, keep=2, max_restarts=2),
                    dict(fail_at=(7,)), 10)
    assert got["step"] == 10 and got["restarts"] == 1 and got["w"] == 10.0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    got = _run_both(tmp_path, dict(checkpoint_every=100, max_restarts=2),
                    dict(fail_at=lambda n: True), 5)
    assert got["step"] == "RuntimeError" and got["restarts"] == 3


def test_backoff_exponential_with_seeded_jitter(tmp_path):
    kw = dict(checkpoint_every=50, max_restarts=8, backoff_base_s=0.1, backoff_max_s=0.25,
              backoff_jitter=0.5, seed=42)
    got = _run_both(tmp_path, kw, dict(fail_at=(1, 2, 3, 4)), 3)
    assert got["step"] == 3 and len(got["backoffs"]) == 4
    assert got["backoffs"] == got["sleeps"]
    for k, d in enumerate(got["backoffs"], start=1):
        lo = min(0.25, 0.1 * 2 ** (k - 1))
        assert lo <= d <= lo * 1.5


def test_restart_budget_heals_after_sustained_health(tmp_path):
    got = _run_both(tmp_path, dict(checkpoint_every=5, max_restarts=2, heal_after=8,
                                   backoff_base_s=1e-4),
                    dict(fail_at=lambda n: n % 10 == 0 and n <= 40), 50)
    assert got["step"] == 50 and got["restarts"] <= 2


def test_nan_loss_restores_and_never_checkpoints_poison(tmp_path):
    got = _run_both(tmp_path, dict(checkpoint_every=2, keep=10, max_restarts=3,
                                   backoff_base_s=1e-4), dict(nan_at=(5,)), 8)
    assert got["step"] == 8 and got["restarts"] == 1 and got["w"] == 8.0
    for s in got["saved"]:
        restored, _ = pckpt.restore_checkpoint(
            os.path.join(str(tmp_path / "port"), f"step_{s:08d}"), {"w": torch.zeros(1)})
        assert torch.isfinite(restored["w"]).all(), f"poisoned checkpoint at {s}"


def test_finite_iterator_drains_with_partial_checkpoint(tmp_path):
    got = _run_both(tmp_path, dict(checkpoint_every=3), {}, 20,
                    batches=lambda: iter([{"id": 0}] * 7))
    assert got["step"] == 7 and got["w"] == 7.0 and got["saved"][-1] == 7


def test_replay_ledger_reserves_same_batches(tmp_path):
    seen = {"port": [], "jax": []}
    for name, mod in (("port", pft), ("jax", jft)):
        sup = mod.TrainSupervisor(_cfg(mod, tmp_path / name, checkpoint_every=3,
                                       backoff_base_s=1e-4),
                                  _plus_one(mod, fail_at=(6,), seen=seen[name]),
                                  sleep_fn=lambda s: None)
        _, step = sup.run(_w0(mod), ({"id": i} for i in range(100)), num_steps=8)
        assert step == 8
    assert seen["port"] == seen["jax"] == [0, 1, 2, 3, 4, 5, 3, 4, 5, 6, 7]


def test_resume_skips_the_restored_steps_batches(tmp_path):
    """A port difference: a second run on the same directory resumes at the
    saved step and draws that step's batch, not the iterator's first."""
    seen = []
    for n in (4, 6):
        sup = pft.TrainSupervisor(_cfg(pft, tmp_path, checkpoint_every=2),
                                  _plus_one(pft, seen=seen), sleep_fn=lambda s: None)
        final, step = sup.run(_w0(pft), ({"id": i} for i in range(100)), n)
    assert step == 6 and float(final["w"][0]) == 6.0
    assert seen == [0, 1, 2, 3, 4, 5]


def test_process_telemetry_needs_a_skew_scheduler(tmp_path):
    for mod in (pft, jft):
        with pytest.raises(ValueError):
            mod.TrainSupervisor(_cfg(mod, tmp_path / mod.__name__), lambda s, b: (s, {}),
                                per_rank_times="process")


def _peer_monitor(wd, path, *, alive, pid_alive=True, armed=True):
    """The watchdog module ``wd``'s monitor of rank 0 in a world of 2 whose
    peer's heartbeat is fresh for ever (``alive``) or 100 s stale."""
    os.makedirs(path, exist_ok=True)
    t = time.time()
    wd.write_heartbeat(str(path), wd.Heartbeat(rank=1, pid=99, time=t + 1e6 if alive else t - 100))
    mon = wd.LivenessMonitor(str(path), 0, 2, stall_after_s=0.05, pid_alive=lambda p: pid_alive)
    mon.enabled = armed
    return mon


def test_supervisor_under_liveness_with_healthy_peers_is_the_references(tmp_path):
    """With every peer heartbeating, a step's own failure and an injected
    timeout take the in-process restart path under liveness, as the JAX
    supervisor's do: the same restarts, checkpoints and final weights (the
    port first waits one staleness deadline for a verdict that never comes)."""
    out = {}
    for name, mod, wd in (("port", pft, pwd), ("jax", jft, jwd)):
        chaos = pchaos if mod is pft else jchaos
        sup = mod.TrainSupervisor(
            _cfg(mod, tmp_path / name, checkpoint_every=3, keep=2, max_restarts=3),
            _plus_one(mod, fail_at=(7,)), sleep_fn=lambda s: None,
            fault_plan=chaos.FaultPlan([chaos.FaultEvent(step=4, kind="timeout")]),
            liveness=_peer_monitor(wd, tmp_path / f"hb_{name}", alive=True))
        final, step = sup.run(_w0(mod), iter(lambda: {"id": 0}, None), num_steps=10)
        out[name] = (step, float(np.asarray(final["w"])[0]), sup.restarts, sup.faults_injected,
                     sup.manager.all_steps())
    assert out["port"] == out["jax"] and out["port"][:4] == (10, 10.0, 2, 1), out


@pytest.mark.parametrize("pid_alive,kind", [(False, pchaos.RankLost),
                                             (True, pchaos.CollectiveTimeout)])
def test_supervisor_leaves_at_once_on_the_watchdogs_verdict(tmp_path, pid_alive, kind):
    """A peer found dead (RankLost) or stopped (CollectiveTimeout) by the
    watchdog makes ``run`` raise at once: no restart, no restore, and no
    ``on_rank_loss``, whose in-process shrink needs the lost rank's memory.
    A deliberate difference: the reference restarts on a liveness
    CollectiveTimeout (its restore has no barrier over the world)."""
    mon = _peer_monitor(pwd, tmp_path / "hb", alive=False, pid_alive=pid_alive, armed=False)
    base = _plus_one(pft)
    calls = []

    def step_fn(state, batch):
        calls.append(1)
        if len(calls) == 3:
            mon.enabled = True        # the next check finds the peer gone
        return base(state, batch)

    sup = pft.TrainSupervisor(_cfg(pft, tmp_path / "ck", checkpoint_every=2), step_fn,
                              sleep_fn=lambda s: None, liveness=mon,
                              on_rank_loss=lambda st, e: pytest.fail("shrunk in process"))
    with pytest.raises(kind) as ei:
        sup.run(_w0(pft), iter(lambda: {"id": 0}, None), num_steps=8)
    assert pwd.from_liveness(ei.value) and "liveness" in str(ei.value)
    assert (len(calls), sup.restarts, sup.manager.all_steps()) == (3, 0, [0, 2])
    if kind is pchaos.CollectiveTimeout:
        jmon = _peer_monitor(jwd, tmp_path / "jhb", alive=False, pid_alive=True, armed=False)
        jbase, jcalls = _plus_one(jft), []

        def jstep(state, batch):
            jcalls.append(1)
            if len(jcalls) == 3:
                jmon.enabled = True
            return jbase(state, batch)
        jsup = jft.TrainSupervisor(_cfg(jft, tmp_path / "jck", checkpoint_every=2,
                                        max_restarts=1), jstep, sleep_fn=lambda s: None,
                                   liveness=jmon)
        with pytest.raises(jchaos.CollectiveTimeout):
            jsup.run(_w0(jft), iter(lambda: {"id": 0}, None), num_steps=8)
        assert jsup.restarts == 2          # the reference's restart path ran


def test_step_error_under_liveness_becomes_the_verdict(tmp_path):
    """A step's own error (gloo's, as a dead peer's socket closes) is handed
    to the watchdog: the peer's verdict leaves ``run``, chained to it."""
    mon = _peer_monitor(pwd, tmp_path / "hb", alive=False, pid_alive=False, armed=False)
    sup = pft.TrainSupervisor(_cfg(pft, tmp_path / "ck", checkpoint_every=2),
                              _plus_one(pft, fail_at=(3,)), sleep_fn=lambda s: None,
                              liveness=mon)
    with pytest.raises(pchaos.RankLost) as ei:
        sup.run(_w0(pft), iter(lambda: {"id": 0}, None), num_steps=8)
    assert isinstance(ei.value.__cause__, RuntimeError) and "injected failure" in str(
        ei.value.__cause__)
    assert sup.restarts == 0 and mon.enabled is False


# ---------------------------------------------------------------------------
# the supervisor: tests/test_chaos.py's scenarios, the same toy in torch
# ---------------------------------------------------------------------------
def _batches_np(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, S, K)) * 0.1).astype(np.float32) for _ in range(n)]


def _w0_np():
    return (np.random.default_rng(1).standard_normal((K, K)) * 0.1).astype(np.float32)


def _jax_step_factory(ctx):
    def build():
        def raw(state, batch):
            y = jax_mar(ctx, batch, state["w"])
            g = jnp.einsum("bsk,bsn->kn", batch, jnp.tanh(y))
            return {"w": state["w"] - 0.01 * g}, {"loss": jnp.mean(y * y)}
        return jax.jit(raw)
    return build


def toy_step(ctx, state, batch):
    """The reference scenarios' step on this rank: y = x w summed over the
    tp ranks (``matmul_allreduce``), w -= 0.01 x^T tanh(y), in place."""
    y = port_mar(ctx, batch, state["w"])
    g = torch.einsum("bsk,bsn->kn", batch, torch.tanh(y))
    with torch.no_grad():
        state["w"].sub_(0.01 * g)
    return state, {"loss": torch.mean(y * y)}


CHAOS_CFG = dict(checkpoint_every=3, keep=3, max_restarts=8, backoff_base_s=1e-4,
                 backoff_max_s=1e-3)


def _port_chaos(path, plan=None, num_steps=8, **kw):
    sup = pft.TrainSupervisor(_cfg(pft, path, **CHAOS_CFG),
                              functools.partial(toy_step, CPU), sleep_fn=lambda s: None,
                              fault_plan=plan, **kw)
    state, step = sup.run({"w": t(_w0_np())}, [t(b) for b in _batches_np(num_steps)], num_steps)
    return state["w"].numpy().copy(), step, sup


@functools.lru_cache(maxsize=None)
def _jax_ctx():
    return JaxContext.from_mesh(make_mesh((2, 4), ("data", "model")))


def _jax_chaos(path, plan=None, num_steps=8, **kw):
    build = _jax_step_factory(_jax_ctx())
    sup = jft.TrainSupervisor(_cfg(jft, path, **CHAOS_CFG), build(), rebuild_step=build,
                              sleep_fn=lambda s: None, fault_plan=plan, **kw)
    state, step = sup.run({"w": _w0_np()}, iter(_batches_np(num_steps)), num_steps)
    return np.asarray(state["w"]), step, sup


def _counts(sup):
    return (sup.restarts, sup.backoffs, sup.faults_injected, sup.rank_losses)


PLANS = {
    "transient": lambda m: m.FaultPlan([m.FaultEvent(step=4, kind="timeout"),
                                        m.FaultEvent(step=6, kind="slow_link", delay_s=0.0),
                                        m.FaultEvent(step=6, kind="rank_fail")]),
    "nan_wire": lambda m: m.FaultPlan([m.FaultEvent(step=5, kind="nan_wire", nth_send=0)]),
    "seeded": lambda m: m.FaultPlan.from_rate(7, 0.3, 8, kinds=("timeout", "slow_link",
                                                                "nan_wire"), delay_s=0.0),
}


@pytest.mark.chaos
@pytest.mark.parametrize("name", sorted(PLANS))
def test_chaos_recovers_to_the_clean_bits(tmp_path, name):
    w_clean, step, _ = _port_chaos(tmp_path / "clean")
    assert step == 8
    w_p, step_p, sup_p = _port_chaos(tmp_path / "port", PLANS[name](pchaos))
    w_j, step_j, sup_j = _jax_chaos(tmp_path / "jax", PLANS[name](jchaos))
    assert step_p == step_j == 8
    assert _counts(sup_p) == _counts(sup_j) and sup_p.faults_injected > 0
    assert sup_p.restarts >= 1
    np.testing.assert_array_equal(w_p, w_clean)
    assert np.isfinite(w_p).all()
    np.testing.assert_allclose(w_p, w_j, rtol=1e-5, atol=1e-6)
    if name == "nan_wire":
        assert sup_p.failures == [(5, "NonFiniteLoss")]


@pytest.mark.chaos
def test_rank_loss_handler_and_counts(tmp_path):
    """One rank cannot shrink (the world's test does); the handler's path
    and counts are the reference's, and the port's bits the clean run's."""
    w_clean, _, _ = _port_chaos(tmp_path / "clean")
    seen = []

    def on_loss_port(state, exc):
        seen.append(exc.rank)
        with pytest.raises(ValueError, match="no mesh axis"):
            pelastic.shrink_context(CPU)
        return state, None

    cur = {"ctx": _jax_ctx()}

    def on_loss_jax(state, exc):
        cur["ctx"] = jelastic.shrink_context(cur["ctx"])
        state, _ = jelastic.reshard_tree(state, {"w": (None, None)}, cur["ctx"])
        return state, _jax_step_factory(cur["ctx"])()

    w_p, step_p, sup_p = _port_chaos(tmp_path / "p", pchaos.FaultPlan(
        [pchaos.FaultEvent(step=5, kind="rank_loss", rank=3)]), on_rank_loss=on_loss_port)
    w_j, step_j, sup_j = _jax_chaos(tmp_path / "j", jchaos.FaultPlan(
        [jchaos.FaultEvent(step=5, kind="rank_loss", rank=3)]), on_rank_loss=on_loss_jax)
    assert step_p == step_j == 8 and seen == [3]
    assert _counts(sup_p) == _counts(sup_j) and sup_p.rank_losses == 1
    np.testing.assert_array_equal(w_p, w_clean)
    np.testing.assert_allclose(w_p, w_j, rtol=1e-5, atol=1e-6)


@pytest.mark.chaos
def test_rank_loss_without_handler_is_fatal(tmp_path):
    with pytest.raises(pchaos.RankLost):
        _port_chaos(tmp_path, pchaos.FaultPlan([pchaos.FaultEvent(step=2, kind="rank_loss",
                                                                  rank=1)]))


@pytest.mark.chaos
def test_supervisor_degrades_after_repeated_faults(tmp_path):
    """Two transient faults strike the step's fused decisions; the policy
    quarantines the same key as the reference's and the next calls run
    bulk (counted in ``demotions``)."""
    got = {}
    for name, mod, dmod, run in (("port", pchaos, pdeg, _port_chaos),
                                 ("jax", jchaos, jdeg, _jax_chaos)):
        pol = dmod.DegradationPolicy(dmod.DegradeConfig(max_failures=2, cooldown=100))
        prev = dmod.set_degradation_policy(pol)
        try:
            plan = mod.FaultPlan([mod.FaultEvent(step=2, kind="timeout"),
                                  mod.FaultEvent(step=4, kind="timeout")])
            _, step, sup = run(tmp_path / name, plan, num_steps=10, degradation=pol)
        finally:
            dmod.set_degradation_policy(prev)
        assert step == 10 and pol.demotions >= 1
        got[name] = (pol.quarantined_keys() if hasattr(pol, "quarantined_keys")
                     else tuple(sorted(pol._quarantine)), _counts(sup))
    assert got["port"] == got["jax"]
    assert got["port"][0] == (("matmul_allreduce", (B, S, K, K)),)


def test_failure_strikes_only_the_failed_steps_keys(tmp_path):
    """The policy's ledger is reset before every step (the port's
    "before every trace"), so a blanket strike blames only the keys the
    failed step ran, not a stale one."""
    pol = pdeg.DegradationPolicy(pdeg.DegradeConfig(max_failures=1))
    pol.effective_mode("stale_op", (1, 2), "fused")

    def step(state, batch):
        pol.effective_mode("live_op", (3, 4), "fused")
        return state, {"loss": torch.tensor(0.0)}

    sup = pft.TrainSupervisor(_cfg(pft, tmp_path), step, degradation=pol,
                              fault_plan=pchaos.FaultPlan([pchaos.FaultEvent(step=1,
                                                                             kind="timeout")]),
                              sleep_fn=lambda s: None)
    sup.run({"w": torch.zeros(1)}, iter(lambda: {}, None), 3)
    assert pol.quarantined_keys() == (("live_op", (3, 4)),)


def test_supervisor_swaps_step_on_bucket_change(tmp_path):
    """tests/test_skew.py's case: telemetry swaps in the rebuilt step."""
    got = {}
    for name, mod, smod in (("port", pft, pstrag), ("jax", jft, jstrag)):
        est = smod.SkewEstimator({"ring": 8}, link_scales={"ring": LINKS}, alpha=1.0, min_obs=1)
        ran_with = []

        def build(skew, ran_with=ran_with, name=name):
            def step(state, batch):
                ran_with.append(skew)
                return state, {"loss": torch.tensor(0.0) if name == "port" else jnp.float32(0)}
            return step

        sched = smod.SkewScheduler(build, est, axis="ring")
        slow = [1.0] * 8
        slow[5] = 1.5
        sup = mod.TrainSupervisor(_cfg(mod, tmp_path / name, checkpoint_every=100), step_fn=None,
                                  skew_scheduler=sched, per_rank_times=lambda dt: slow)
        _, step = sup.run({"x": torch.zeros(()) if name == "port" else jnp.zeros(())},
                          iter([{}] * 4), 4)
        got[name] = (step, sched.bucket, sched.rebuilds, ran_with)
    assert got["port"] == got["jax"]
    assert got["port"][1] != 0 and got["port"][2] == 2


# ---------------------------------------------------------------------------
# elastic helpers at one rank
# ---------------------------------------------------------------------------
def test_rescale_batch_and_divisibility_are_the_references():
    for args in ((256, 16, 8), (128, 8, 16), (4, 8, 4), (100, 16, 8), (16, 4, 2, 2), (8, 4, 1, 4),
                 (12, 4, 3, 2), (8, 4, 1, 1)):
        outs = []
        for mod in (pelastic, jelastic):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                outs.append((mod.rescale_batch(*args), [str(x.message) for x in w]))
        assert outs[0][0] == outs[1][0] and len(outs[0][1]) == len(outs[1][1]), args
    assert pelastic.check_divisibility(CPU, 6, 10, 7) == []


def test_shrink_at_one_rank_raises_as_the_reference():
    with pytest.raises(ValueError, match="no mesh axis divisible"):
        pelastic.shrink_context(CPU)
    with pytest.raises(ValueError, match="no mesh axis divisible"):
        jelastic.shrink_context(JaxContext.from_mesh(make_mesh((1, 1), ("data", "model"))))
    with pytest.raises(ValueError):
        pelastic.shrink_context(CPU, factor=1)
    with pytest.raises(ValueError):
        pelastic.shrink_context(CPU, axis="data")


def test_reshard_tree_places_whole_leaves_at_one_rank(rng):
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "s": torch.tensor(3, dtype=torch.int32)}
    placed, placement = pelastic.reshard_tree(tree, {"w": ("tp", None), "s": ()}, CPU)
    np.testing.assert_array_equal(placed["w"].numpy(), tree["w"])
    assert placed["s"].device.type == "cpu" and int(placed["s"]) == 3
    assert placement.ctx is CPU and placement.writer


# ---------------------------------------------------------------------------
# the train launcher under the supervisor
# ---------------------------------------------------------------------------
LAUNCH = ["--reduced", "--device", "cpu", "--steps", "6", "--log-every", "100"]


@functools.lru_cache(maxsize=None)
def _clean_losses():
    return tuple(ptrain.main(LAUNCH))


@pytest.mark.chaos
def test_launcher_chaos_gives_the_clean_losses_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    got = ptrain.main(LAUNCH + ["--ckpt-dir", d, "--ckpt-every", "2",
                                "--chaos", "at=3:timeout+5:rank_fail"])
    assert tuple(got) == _clean_losses() and len(got) == 6
    out = capsys.readouterr().out
    assert "injected 2, restarts 2, rank losses 0" in out and "done at step 6" in out
    # a second call resumes at the last checkpoint (step 6) and runs on
    more = ptrain.main(LAUNCH[:3] + ["--steps", "8", "--log-every", "100", "--ckpt-dir", d,
                                     "--ckpt-every", "2"])
    assert len(more) == 2 and all(np.isfinite(more))
    assert "done at step 8" in capsys.readouterr().out
    assert ptrain.main(LAUNCH + ["--ckpt-dir", d]) == []     # nothing left to run


def test_launcher_runtime_flags_and_refusals(tmp_path, capsys):
    got = ptrain.main(LAUNCH[:3] + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a"),
                                    "--degrade", "--skew-schedule"])
    assert tuple(got) == _clean_losses()[:2] or len(got) == 2
    out = capsys.readouterr().out
    assert "degradation: {" in out and "straggler stats" in out
    for flag in ("--chaos", "--degrade", "--skew-schedule"):
        argv = LAUNCH + ([flag, "rate=0.1"] if flag == "--chaos" else [flag])
        with pytest.raises(ValueError, match="--ckpt-dir"):
            ptrain.main(argv)
    refused = {"--auto-fuse": "analyzer", "--explain-comm": "analyzer",
               "--production-mesh": "item 1"}
    for flag, item in refused.items():
        with pytest.raises(NotImplementedError, match=item):
            ptrain.main(LAUNCH + [flag])
