"""The port's DLRM over the flattened (dp, tp) world against the JAX package.

``embedding_all_to_all`` at (dp, tp) = (1, 4), (2, 2) and (4, 1) in bulk,
fused and kernel mode (sub-chunks, bf16 wire, the world's skew), reduced
DLRM's loss with every gradient and three AdamW steps at (2, 2), the
``"auto"`` decisions over the world, kernel mode's refused gradient, and the
train launcher with ``--arch dlrm`` at tp = 1 and ``--dp 2 --tp 2``.  The
same numpy inputs, made from a seed, go through the JAX package on a (dp,
tp) ("data", "model") mesh of conftest's CPU devices (its kernel mode in
interpret mode; compiles memoised) and through the port on a gloo world of
CPU processes (``tests/torch_world.py``), world rank r = tp rank r % tp of
replica r // tp holding tables [r T / n, (r + 1) T / n) and rows [r B / n,
(r + 1) B / n); each rank's result is held to its slice of the JAX
package's.  On the CPU kernel mode runs the pooling kernel's plain version.
Tolerances: ``TOL["f32"]`` and ``WIRE_TOL`` of tests/test_parity_matrix.py
for the pooled embeddings, gradients at ``GRAD`` (rtol 2e-3, atol 1e-5,
tests/test_loss.py's), losses at rtol 1e-5, AdamW steps at rtol 1e-4
(tests/test_torch_train.py's).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
from test_parity_matrix import TOL, WIRE_TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.core import autotune as jtune
from repro.core.embedding_all_to_all import embedding_all_to_all as jax_emb_a2a
from repro.core.perfmodel import DCN, MeshHardwareModel
from repro.models import dlrm as jdlrm
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import grad_compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import get_arch
from repro_torch.data.synthetic import DLRMBatches
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import dlrm_params_from_numpy
from repro_torch.train.optimizer import tree_leaves, tree_paths
from torch_tune import as_json
from torch_world import World

ROOT = Path(__file__).resolve().parents[1]
F32 = TOL["f32"]
GRAD = dict(rtol=2e-3, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=0)
STEPS = dict(rtol=1e-4, atol=0)
B = 16
LAYOUTS = [(1, 4), (2, 2), (4, 1)]
# (q, wire) of each mode: bulk sends once at f32 whatever it is given
CASES = {"bulk": [(1, "f32")],
         "fused": [(1, "f32"), (2, "f32"), (1, "bf16"), (2, "bf16")],
         "kernel": [(1, "f32"), (2, "f32"), (2, "bf16")]}
DCN_DICT = dataclasses.asdict(DCN)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def reduced():
    jb = jax_get_arch("dlrm").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    cfg = get_arch("dlrm").reduced().config
    batches = list(zip(range(4), DLRMBatches(cfg.n_tables, cfg.table_vocab, cfg.pooling,
                                             cfg.n_dense, B, seed=0)))
    return jb, jparams, jax.tree.map(np.asarray, jparams), [b for _, b in batches]


def run(world, name, layout, **inputs):
    dp, tp = layout
    return world.run(name, tp, dp=dp, **inputs)


def jctx(layout, mode="bulk", **fusion):
    return JaxContext.from_mesh(make_mesh(layout, ("data", "model")),
                                fusion=JaxFusion(mode=mode, **fusion))


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def rows(a, n, r):
    """Block r of n of a's leading dim: world rank r's rows of a batch, or
    its tables of a whole [T, ...] leaf."""
    size = a.shape[0] // n
    return a[r * size:(r + 1) * size]


# ---------------------------------------------------------------------------
# the embedding all-to-all over the world
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["bulk", "fused", "kernel"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_embedding_all_to_all_over_the_world_matches_jax(world, rng, layout, mode):
    """Every (q, wire) of ``CASES[mode]``: each rank's [B / n, T, D] against
    its rows of the JAX package's (same mode, q and wire), skew_world 1
    bit-identical to skew 0, and in kernel mode n * q pooling calls a rank,
    each over the rank's tables."""
    n = layout[0] * layout[1]
    tabs = rng.standard_normal((8, 40, 16)).astype(np.float32)
    idx = rng.integers(0, 40, (B, 8, 5)).astype(np.int32)
    per_rank, _ = zip(*run(world, "dlrm_a2a_task", layout, tables=tabs, indices=idx, mode=mode,
                           cases=CASES[mode]))
    for i, (q, wire) in enumerate(CASES[mode]):
        want = np.asarray(jax.jit(lambda ix, tb: jax_emb_a2a(
            jctx(layout, mode), ix, tb, chunks_per_rank=q, wire=wire))(idx, tabs))
        tol = F32 if wire == "f32" else WIRE_TOL[wire]
        for r, cases in enumerate(per_rank):
            (skew0, skew1), calls = cases[i]
            assert skew0.shape == (B // n, 8, 16)
            np.testing.assert_allclose(skew0, rows(want, n, r), **tol,
                                       err_msg=f"rank {r} q={q} wire={wire}")
            np.testing.assert_array_equal(skew1, skew0)
            assert calls == ([(B // (n * q), 8 // n)] * (n * q) if mode == "kernel" else [])


def test_auto_decisions_over_the_world_match_jax(world, rng):
    """'auto' granularity and wire at (2, 2) under the slow link class (DCN,
    where a narrow wire can win): every rank takes the JAX package's
    decision (the reference resolves the link model for the world's axes),
    and the pooled rows match at its wire's tolerance."""
    layout = (2, 2)
    tabs = rng.standard_normal((8, 40, 16)).astype(np.float32)
    idx = rng.integers(0, 40, (B, 8, 5)).astype(np.int32)
    jtune.clear_cache()
    jc = dataclasses.replace(jctx(layout, "fused", granularity="auto", wire="auto"),
                             hw=MeshHardwareModel.uniform(DCN))
    want = np.asarray(jax.jit(lambda ix, tb: jax_emb_a2a(jc, ix, tb))(idx, tabs))
    jdec = sorted((json.dumps(as_json(k), sort_keys=True), d.q, d.wire)
                  for k, d in jtune.cache_info().items())
    assert len(jdec) == 1
    out = run(world, "dlrm_a2a_task", layout, tables=tabs, indices=idx, mode="fused",
              cases=[("auto", "auto")], hw=DCN_DICT, skews=(0,))
    wire = jdec[0][2]
    for r, (cases, dec) in enumerate(out):
        assert dec == jdec
        (got,), _ = cases[0]
        np.testing.assert_allclose(got, rows(want, 4, r), **(F32 if wire == "f32" else
                                                              WIRE_TOL[wire]))


# ---------------------------------------------------------------------------
# training at (2, 2)
# ---------------------------------------------------------------------------
def _names(tree):
    return [".".join(map(str, p)) for p, _ in tree_paths(dlrm_params_from_numpy(tree))]


def port_leaves(jtree):
    """A JAX-layout DLRM tree's leaves in the port's leaf order."""
    return [a.numpy() for a in tree_leaves(dlrm_params_from_numpy(jax.tree.map(np.asarray,
                                                                               jtree)))]


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_dlrm_loss_and_every_gradient_at_2x2_match_jax(world, reduced, mode):
    """``loss_fn`` of a batch of 16: the loss (the global mean, the same on
    every rank) and every gradient, a table shard against its world slice of
    the JAX package's ``jax.grad`` on the (2, 2) mesh, the MLP leaves
    (summed over the world) whole; fused mode's gradients bulk mode's bits."""
    jb, jparams, tree, batches = reduced
    batch = batches[0]

    def make():
        loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn(jctx((2, 2), mode))))(jparams, batch)
        return float(loss), port_leaves(grads)
    want_loss, want = memo(("grads", mode), make)
    names = _names(tree)
    per_rank = run(world, "dlrm_loss_grads_task", (2, 2), tree=tree, batch=batch, mode=mode)
    for r, (loss, grads) in enumerate(per_rank):
        np.testing.assert_allclose(loss, want_loss, **LOSS)
        assert loss == per_rank[0][0]
        for name, g, w in zip(names, grads, want, strict=True):
            w = rows(w, 4, r) if name == "tables" else w
            np.testing.assert_allclose(g, w, **GRAD, err_msg=f"rank {r} {name}")
    if mode == "fused":
        bulk = run(world, "dlrm_loss_grads_task", (2, 2), tree=tree, batch=batch, mode="bulk")
        for (_, g_f), (_, g_b) in zip(per_rank, bulk):
            for a, b in zip(g_f, g_b):
                np.testing.assert_array_equal(a, b)


def test_fused_gradients_do_not_move_with_skew_or_subchunks(world, reduced):
    """Fused mode at 2 sub-chunks and skew_world 1, and with a bf16 wire:
    the tables' gradient is one pooling backward over the whole batch, so
    skew and sub-chunks change no bit of any gradient; a bf16 wire stays
    within its tolerance of the f32 wire's."""
    _, _, tree, batches = reduced
    base = run(world, "dlrm_loss_grads_task", (2, 2), tree=tree, batch=batches[0], mode="fused")
    moved = run(world, "dlrm_loss_grads_task", (2, 2), tree=tree, batch=batches[0], mode="fused",
                q=2, skew=1)
    bf16 = run(world, "dlrm_loss_grads_task", (2, 2), tree=tree, batch=batches[0], mode="fused",
               q=2, wire="bf16")
    for (l0, g0), (l1, g1), (l2, g2) in zip(base, moved, bf16):
        assert l0 == l1
        for a, b, c in zip(g0, g1, g2):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(c, a, **WIRE_TOL["bf16"])


def test_kernel_mode_gradient_raises_in_both_packages(world, reduced):
    """The pooling kernel has no backward: ``jax.grad`` through the
    reference's kernel mode raises, and so does the port's, on every rank
    of the (2, 2) world (before any rank exchanges a cotangent)."""
    jb, jparams, tree, batches = reduced
    with pytest.raises(NotImplementedError):
        jax.grad(jb.loss_fn(jctx((2, 2), "kernel")))(jparams, batches[0])
    for msg in run(world, "dlrm_loss_grads_task", (2, 2), tree=tree, batch=batches[0],
                   mode="kernel"):
        assert msg is not None and re.search("no backward.*bulk or fused mode", msg)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_dlrm_adamw_steps_at_2x2_match_the_jax_step(world, reduced, mode):
    """Three AdamW steps through ``build_train_step`` (the tables' shards not
    summed, the MLP's gradients summed over the world, the clip's norm
    counting each table once) against the JAX package's jitted step on the
    (2, 2) mesh: each step's loss and grad norm, then every parameter."""
    jb, jparams, tree, batches = reduced
    steps = 3

    def make():
        tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                              total_steps=steps))
        jfn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx((2, 2), mode)), tc))
        state, out = jstep.init_train_state(tc, jparams), []
        for b in batches[:steps]:
            state, m = jfn(state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, port_leaves(state["params"])
    want, final = memo(("steps", mode), make)
    names = _names(tree)
    per_rank = run(world, "dlrm_train_steps_task", (2, 2), tree=tree, batches=batches[:steps],
                   mode=mode)
    for r, (metrics, params, _) in enumerate(per_rank):
        np.testing.assert_allclose(np.array(metrics), np.array(want), **STEPS)
        assert metrics == per_rank[0][0]
        for name, got, w in zip(names, params, final, strict=True):
            w = rows(w, 4, r) if name == "tables" else w
            np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-5, err_msg=f"rank {r} {name}")
    # the MLP's leaves leave the step with the same bits on every rank
    for r in range(1, 4):
        for name, a, b in zip(names, per_rank[r][1], per_rank[0][1]):
            if name != "tables":
                np.testing.assert_array_equal(a, b)


def test_dlrm_train_state_and_params_shard_by_world_rank(world, reduced):
    """``dlrm_params_from_numpy`` and ``train_state_from_numpy`` with a (2,
    2) context: rank r's tables and their moments are rows [r T / 4, ...) of
    the whole, the MLP whole."""
    jb, jparams, tree, _ = reduced
    state = jax.tree.map(np.asarray, jstep.init_train_state(jstep.TrainConfig(), jparams))
    state["opt"]["mu"]["tables"] = np.arange(state["opt"]["mu"]["tables"].size, dtype=np.float32
                                             ).reshape(state["opt"]["mu"]["tables"].shape)
    per_rank = run(world, "train_state_task", (2, 2), state=state)
    names = _names(tree)
    whole, mu = port_leaves(state["params"]), port_leaves(state["opt"]["mu"])
    for r, (params, got_mu, _) in enumerate(per_rank):
        for name, got, w, g_mu, w_mu in zip(names, params, whole, got_mu, mu, strict=True):
            cut = (lambda a: rows(a, 4, r)) if name == "tables" else (lambda a: a)
            np.testing.assert_array_equal(got, cut(w))
            np.testing.assert_array_equal(g_mu, cut(w_mu))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
@pytest.mark.parametrize("layout", [(2, 2), (4, 1)])
def test_compression_over_the_world_split_tables_matches_jax(world, rng, reduced, layout,
                                                             scheme):
    """``compress_decompress`` of each rank's leaves, two steps on the same
    gradients (the residuals fed back), against the JAX package's over the
    whole leaves: the tables' int8 scale the MAX over the world, their top-k
    the whole leaf's k over every rank's shard; each rank's slices."""
    from repro_torch.models.dlrm import param_specs
    from repro_torch.train.optimizer import tree_map

    _, _, tree, _ = reduced
    jg = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    jr = jax.tree.map(lambda a: 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)
    cfg = jcomp.CompressionConfig(scheme=scheme, topk_ratio=0.05)
    g, r = jg, jr
    for _ in range(2):
        g, r = jax.jit(lambda a, b: jcomp.compress_decompress(cfg, a, b))(jg, r)
    port = lambda t: tree_map(lambda x: x.numpy(), dlrm_params_from_numpy(t))
    dp, tp = layout
    shards = lambda t, k: [a.numpy() for a in tree_leaves(dlrm_params_from_numpy(
        jax.tree.map(np.asarray, t), "cpu", types.SimpleNamespace(tp=tp, tp_rank=k % tp, dp=dp,
                                                                  dp_rank=k // tp)))]
    per_rank = run(world, "compress_task", layout, grads=port(jg), residuals=port(jr),
                   specs=param_specs(dlrm_params_from_numpy(jg)), scheme=scheme, ratio=0.05,
                   steps=2)
    for k, (gs, rs) in enumerate(per_rank):
        for got, w in zip(gs, shards(g, k), strict=True):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7)
        for got, w in zip(rs, shards(r, k), strict=True):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
LAUNCH = ["--arch", "dlrm", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "256",
          "--log-every", "1"]


def test_launcher_trains_dlrm_at_tp1_and_over_a_2x2_world(capsys):
    """``--arch dlrm`` at tp = 1: fused mode's losses fall and equal bulk
    mode's; under ``torch.distributed.run`` at ``--dp 2 --tp 2`` (gloo) the
    printed losses are tp = 1's and every rank's are equal."""
    fused = launch_train.main(LAUNCH + ["--fusion", "fused"])
    bulk = launch_train.main(LAUNCH + ["--fusion", "bulk"])
    capsys.readouterr()
    assert fused[-1] < fused[0] and fused[1] < fused[0]
    np.testing.assert_allclose(fused, bulk, rtol=1e-5)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--dp", "2", "--tp", "2", "--backend", "gloo",
         "--fusion", "fused", *LAUNCH],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", proc.stdout)]
    np.testing.assert_allclose(got, fused, atol=1e-4)      # the printed digits
    assert "all 4 ranks' losses equal: True" in proc.stdout


def test_world_axis_places_a_leaf_in_world_order():
    """A ``"world"`` dim splits over all dp * tp ranks, rank r = dp_rank *
    tp + tp_rank taking block r, in serving and training alike; it counts as
    split over both axes (its gradient is summed over neither)."""
    from repro_torch.parallel.sharding import (shard_leaf, split_dims, splits_over_data,
                                               splits_over_tp)
    import torch

    x = torch.arange(8 * 3).reshape(8, 3)
    for dp, tp in LAYOUTS + [(1, 1), (2, 1), (1, 2)]:
        for r in range(dp * tp):
            place = types.SimpleNamespace(tp=tp, tp_rank=r % tp, dp=dp, dp_rank=r // tp)
            n = dp * tp
            for training in (False, True):
                got = shard_leaf(x, ("world", None), place, training)
                assert torch.equal(got, x[r * 8 // n:(r + 1) * 8 // n])
    assert split_dims(("world", None), types.SimpleNamespace(tp=1, tp_rank=0)) == []
    assert splits_over_tp(("world", None, None)) and splits_over_data(("world", None, None))
    with pytest.raises(ValueError, match="'world' axis alone"):
        split_dims(("world", "tp"), types.SimpleNamespace(tp=2, tp_rank=0))


@pytest.mark.parametrize("layout,q,wire,schedule,skew", [
    ((2, 2), 1, "f32", "comm_aware", 0), ((2, 2), 2, "bf16", "comm_aware", 1),
    ((4, 1), 2, "f32", "oblivious", 0), ((1, 4), 1, "f32", "comm_aware", 1)])
def test_all_to_alls_over_the_world_group(world, rng, layout, q, wire, schedule, skew):
    """``group="world"``: world rank r's result is every source's fine
    chunks for r, stacked by source; the direct sends' backward (and
    ``direct_all_to_all_transpose``, its stand-alone form) returns each
    chunk's cotangent from the rank it was sent to, rounded to the wire as
    the payload was; ``bulk_all_to_all`` swaps blocks over the same world."""
    n = layout[0] * layout[1]
    sub, cols = 2, 3
    x = rng.standard_normal((n, n * q, sub, cols)).astype(np.float32)
    g = rng.standard_normal((n, n, q * sub, cols)).astype(np.float32)
    xb = rng.standard_normal((n, n, 5)).astype(np.float32)
    rnd = (lambda a: a) if wire == "f32" else (
        lambda a: np.asarray(jax.numpy.asarray(a).astype(jax.numpy.bfloat16).astype(np.float32)))
    out = run(world, "world_a2a_task", layout, x=x, xb=xb, g=g, q=q, wire=wire,
              schedule=schedule, skew=skew)
    for r, (got, grad, back, bulk) in enumerate(out):
        for src in range(n):
            want = x[src, r * q:(r + 1) * q].reshape(q * sub, cols)
            np.testing.assert_array_equal(got[src], want if src == r else rnd(want))
            np.testing.assert_array_equal(bulk[src], xb[src, r])
        for dest in range(n):
            want = g[dest, r].reshape(q, sub, cols)
            np.testing.assert_array_equal(grad[dest * q:(dest + 1) * q],
                                          want if dest == r else rnd(want))
            np.testing.assert_array_equal(back[dest], g[dest, r] if dest == r else rnd(g[dest, r]))
