"""The port's data axis against the JAX package: (dp, tp) = (2, 2) and (2, 1).

Reduced chatglm3-6b's decode (B divisible by dp: a replica's rows; B not
divisible: the whole batch on every replica), prefill, ``loss_fn`` with every
gradient and three AdamW steps through ``build_train_step`` (the train
state's fsdp dims split over the data ranks); ``global_norm``; int8 and
top-k gradient compression over tp- and fsdp-sharded stacks, residuals
included; ``params_from_numpy`` and ``train_state_from_numpy`` at dp > 1; both
launchers at ``--dp 2 --tp 2``.  The same numpy inputs, made from a seed, go
through the JAX package on a (dp, tp) data x model mesh of conftest's CPU
devices (compiles memoised per layout) and through the port on a gloo world
of CPU processes (``tests/torch_world.py``), each rank on its shard; each
rank's result is held to its slice of the JAX package's.  Tolerances:
``TOL["f32"]`` of tests/test_parity_matrix.py for logits and caches, the
gradients at ``GRAD`` (rtol 2e-3, atol 1e-5, tests/test_loss.py's), losses
at rtol 1e-5, AdamW steps at rtol 1e-4 (tests/test_torch_ring_train.py's),
compression exact up to the f32 rounding of the sums (rtol 1e-6).
"""
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
from test_parity_matrix import TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import grad_compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import param_specs
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves, tree_map, tree_paths
from repro_torch.train.step import TrainConfig, build_train_step
from torch_world import World

ROOT = Path(__file__).resolve().parents[1]
F32 = TOL["f32"]
GRAD = dict(rtol=2e-3, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=0)
STEPS = dict(rtol=1e-4, atol=0)
LAYOUTS = [(2, 2), (2, 1)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, layout, **inputs):
    """The task's per-rank results at (dp, tp) = ``layout``, rank r being tp
    rank r % tp of replica r // tp ((2, 1) runs two worlds on the pairs,
    which must agree)."""
    dp, tp = layout
    out = world.run(name, tp, dp=dp, **inputs)
    if dp * tp == 2:
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(u, v)
    return out[:dp * tp]


def place(layout, r):
    """The placement of rank r of a layout, as ``shard_leaf`` reads it."""
    dp, tp = layout
    return types.SimpleNamespace(tp=tp, tp_rank=r % tp, dp=dp, dp_rank=r // tp)


def block(a, n, d, axis):
    size = a.shape[axis] // n
    return np.take(a, np.arange(d * size, (d + 1) * size), axis=axis)


def jctx(layout, mode="fused"):
    return JaxContext.from_mesh(make_mesh(layout, ("data", "model")),
                                fusion=JaxFusion(mode=mode))


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


@pytest.fixture(scope="module")
def glm():
    jb = jax_get_arch("chatglm3-6b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, jax.tree.map(np.asarray, jparams)


def shards(tree, layout, r, training=True):
    """Rank r's shards of a JAX-layout tree, in the port's leaf order."""
    return [a.numpy() for a in tree_leaves(params_from_numpy(tree, "cpu", place(layout, r),
                                                             training=training))]


def lm_batch(seed, b=4, s=32, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


# ---------------------------------------------------------------------------
# decode and prefill: the batch's rows over the replicas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_at_dp_matches_jax(world, glm, layout, mode, B):
    """3 decode steps (per-slot positions): every rank's logits are the JAX
    package's, all B rows; each rank's cache is its replica's rows (all B
    where dp does not divide B) of its tp rank's sequence rows."""
    jb, jparams, tree = glm
    dp, tp = layout
    rng = np.random.default_rng(B)
    steps = 3
    tokens = rng.integers(0, jb.config.vocab, (steps, B, 1)).astype(np.int32)
    positions = np.stack([s * 5 + np.arange(B) for s in range(steps)]).astype(np.int32)

    def make():
        jdec = jax.jit(lambda tk, cache, p: jb.decode_fn(jctx(layout))(jparams, tk, cache, p))
        jcache, want = jb.init_cache(B), []
        for tok, pos in zip(tokens, positions):
            lg, jcache = jdec(tok, jcache, pos)
            want.append(np.asarray(lg))
        return np.stack(want), {k: np.asarray(v) for k, v in jcache["scan"].items()}
    want, jcache = memo(("decode", layout, B), make)
    per_rank = run(world, "decode_steps_task", layout, tree=tree, mode=mode, tokens=tokens,
                   positions=positions)
    for r, (logits, k, v) in enumerate(per_rank):
        np.testing.assert_allclose(logits, want, **F32)
        np.testing.assert_array_equal(logits, per_rank[0][0])
        for got, name in ((k, "k"), (v, "v")):
            rows = block(jcache[name], dp, r // tp, 1) if B % dp == 0 else jcache[name]
            np.testing.assert_allclose(got, block(rows, tp, r % tp, 2), **F32, err_msg=name)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_at_dp_matches_jax(world, glm, layout, mode):
    """``prefill_fn`` of 4 x 32 tokens: every rank's logits are JAX's, its
    cache its replica's 2 rows of its tp rank's sequence chunk."""
    jb, jparams, tree = glm
    dp, tp = layout
    tokens = np.random.default_rng(3).integers(0, jb.config.vocab, (4, 32)).astype(np.int32)

    def make():
        lg, cache = jax.jit(lambda p, tk: jb.prefill_fn(jctx(layout))(p, {"tokens": tk}))(
            jparams, tokens)
        return np.asarray(lg), {k: np.asarray(v) for k, v in cache["scan"].items()}
    want, cache = memo(("prefill", layout), make)
    per_rank = run(world, "prefill_task", layout, tree=tree, tokens=tokens, mode=mode)
    for r, (logits, k, v) in enumerate(per_rank):
        np.testing.assert_allclose(logits, want, **F32)
        for got, name in ((k, "k"), (v, "v")):
            rows = block(cache[name], dp, r // tp, 1)
            np.testing.assert_allclose(got, block(rows, tp, r % tp, 2), **F32, err_msg=name)


# ---------------------------------------------------------------------------
# training: fsdp-sharded state, the global mean loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["bulk", "fused", "kernel"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_loss_fn_and_every_gradient_at_dp_match_jax(world, glm, layout, mode):
    """``loss_fn`` of 4 x 32 tokens on the training shards: the loss (the
    global mean, every rank the same) and every gradient, each rank's shard
    (the leaves whole over a group summed over it, as the train step does)
    against its slice of the JAX package's ``jax.value_and_grad`` on the
    same (dp, tp) mesh."""
    jb, jparams, tree = glm
    tokens, labels = lm_batch(1)

    def make():
        loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn(jctx(layout))))(
            jparams, {"tokens": tokens, "labels": labels})
        return float(loss), jax.tree.map(np.asarray, grads)
    want_loss, want = memo(("loss", layout), make)
    names = [".".join(map(str, p)) for p, _ in tree_paths(params_from_numpy(tree))]
    per_rank = run(world, "loss_grads_task", layout, tree=tree, tokens=tokens, labels=labels,
                   mode=mode)
    for r, (loss, grads) in enumerate(per_rank):
        np.testing.assert_allclose(loss, want_loss, **LOSS)
        assert loss == per_rank[0][0]
        for name, g, w in zip(names, grads, shards(want, layout, r), strict=True):
            np.testing.assert_allclose(g, w, **GRAD, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("layout,mode", [((2, 2), "fused"), ((2, 1), "bulk")])
def test_adamw_steps_at_dp_match_the_jax_step(world, glm, layout, mode):
    """Three AdamW steps through ``build_train_step`` (the fsdp shards'
    moments on their shards, the clip's norm over the world) against the
    JAX package's jitted step on the same mesh: each step's loss and grad
    norm, then every parameter shard."""
    jb, jparams, tree = glm
    steps = 3
    batches = [lm_batch(10 + i) for i in range(steps)]

    def make():
        tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                              total_steps=steps))
        jfn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx(layout)), tc))
        state, out = jstep.init_train_state(tc, jparams), []
        for tok, lab in batches:
            state, m = jfn(state, {"tokens": tok, "labels": lab})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, jax.tree.map(np.asarray, state["params"])
    want, final = memo(("steps", layout), make)
    per_rank = run(world, "train_steps_task", layout, tree=tree, batches=batches, mode=mode,
                   steps=steps)
    for r, (metrics, params) in enumerate(per_rank):
        np.testing.assert_allclose(np.array(metrics), np.array(want), **STEPS)
        assert metrics == per_rank[0][0]
        for got, w in zip(params, shards(final, layout, r), strict=True):
            np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_data_collectives(world, layout):
    """Over the data group (the ranks with this rank's tp rank): the gather
    of the replicas' rows in data-rank order, this replica's slice of their
    sum, and the mean whose gradient hands each replica 1 / dp."""
    dp, tp = layout
    x = np.random.default_rng(8).standard_normal((dp, tp, 4, 3)).astype(np.float32)
    for r, (gathered, scattered, mean, grad) in enumerate(run(world, "data_collectives_task",
                                                               layout, x=x)):
        d, m = r // tp, r % tp
        np.testing.assert_array_equal(gathered, np.concatenate(list(x[:, m])))
        np.testing.assert_allclose(scattered, block(x[:, m].sum(0), dp, d, 0), rtol=1e-6)
        np.testing.assert_allclose(mean, x[:, m].sum((1, 2)).mean(), rtol=1e-5)
        np.testing.assert_allclose(grad, np.full((4, 3), 1 / dp), rtol=1e-6)


def test_context_reads_groups_made_beforehand(world):
    """A (dp, tp) context reads the groups ``make_world_groups`` made on
    every rank; it makes none itself (``dist.new_group`` is collective, and
    ranks may build their contexts in different orders), so where none were
    made it raises, naming how to make them."""
    for msg in world.run("unmade_groups_task", 4):
        assert msg is not None and "make_world_groups" in msg


SPECS = [("fsdp", "tp"), ("tp", "fsdp"), ("fsdp", None), (None,), (None, None)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_global_norm_over_tp_and_data_shards(world, layout):
    """``global_norm`` of leaves split over tp, over data, over both and over
    neither: the whole leaves' norm on every rank, the same bits."""
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((8, 12), (12, 8), (8, 6), (10,), (4, 4))]
    want = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    per_rank = run(world, "global_norm_task", layout, grads=grads, specs=SPECS)
    assert all(n == per_rank[0] for n in per_rank)
    np.testing.assert_allclose(per_rank[0], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression over shards
# ---------------------------------------------------------------------------
def comp_trees(tree, tie: bool):
    """A JAX-layout gradient tree of ``tree``'s shapes (reduced chatglm3-6b,
    2 layers stacked) and its residuals; ``tie``: values on a coarse grid
    and zero residuals, so that equal magnitudes straddle the top-k's cut
    across the ranks' shards."""
    rng = np.random.default_rng(11)

    def draw(x):
        a = rng.standard_normal(x.shape).astype(np.float32)
        return np.round(a * 2) / 2 if tie else a
    res = (lambda x: np.zeros(x.shape, np.float32)) if tie else (
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32))
    return jax.tree.map(draw, tree), jax.tree.map(res, tree)


@pytest.mark.parametrize("scheme,tie", [("int8", False), ("topk", False), ("topk", True)])
@pytest.mark.parametrize("layout", LAYOUTS + [(1, 4)])
def test_compression_over_shards_matches_jax(world, glm, layout, scheme, tie):
    """``compress_decompress`` of each rank's training shards, two steps on
    the same gradients (the residuals fed back), against the JAX package's
    over the whole stacked leaves: the int8 scale the MAX over the leaf's
    ranks, the top-k the whole stack's k (a tie across two ranks' shards
    lost by the larger global index, as ``lax.top_k`` loses it).  Gradients
    and residuals, each rank's slices."""
    jg, jr = comp_trees(glm[2], tie)
    cfg = jcomp.CompressionConfig(scheme=scheme, topk_ratio=0.05)
    g, r = jg, jr
    for _ in range(2):
        g, r = jax.jit(lambda a, b: jcomp.compress_decompress(cfg, a, b))(jg, r)
    want_g, want_r = jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, r)
    port = lambda tree: tree_map(lambda x: x.numpy(), params_from_numpy(tree))
    specs = param_specs(params_from_numpy(jg))
    per_rank = run(world, "compress_task", layout, grads=port(jg), residuals=port(jr),
                   specs=specs, scheme=scheme, ratio=0.05, steps=2)
    for rk, (gs, rs) in enumerate(per_rank):
        for got, w in zip(gs, shards(want_g, layout, rk), strict=True):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7)
        for got, w in zip(rs, shards(want_r, layout, rk), strict=True):
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


def test_calibration_agrees_over_the_whole_world(world):
    """At (2, 2) the measured pass all-reduces its times with MAX over the
    tp group and then the data group: all four ranks, both replicas, keep
    the same times and decisions."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    per_rank = run(world, "calibrate_task", (2, 2), x=x, w=w)
    assert all(r == per_rank[0] for r in per_rank)
    decisions, report = per_rank[0]
    assert len(decisions) == 1 and len(report) == 1 and len(report[0][2]) > 1


# ---------------------------------------------------------------------------
# placement, refusals and the launchers
# ---------------------------------------------------------------------------
def test_params_and_train_state_from_numpy_at_dp(world, glm):
    """At (2, 2) serving shards split only the tp dims (fsdp whole, as the
    reference's serve launcher keeps them); training shards split the fsdp
    dims over the data ranks too; ``train_state_from_numpy`` gives the
    parameters' and AdamW moments' training shards."""
    jb, jparams, tree = glm
    layout = (2, 2)
    for r, (serving, training) in enumerate(run(world, "place_task", layout, tree=tree)):
        for got, w in zip(serving, shards(tree, layout, r, training=False), strict=True):
            np.testing.assert_array_equal(got, w)
        for got, w in zip(training, shards(tree, layout, r), strict=True):
            np.testing.assert_array_equal(got, w)
    table = tree["embed"]["table"]                     # ("tp", "fsdp"): [V / tp, D / dp]
    assert shards(tree, layout, 3)[0].shape == (table.shape[0] // 2, table.shape[1] // 2)
    state = jax.tree.map(np.asarray, jstep.init_train_state(jstep.TrainConfig(), jparams))
    state["opt"]["mu"] = jax.tree.map(lambda a: a + 1.0, state["opt"]["mu"])
    for r, (params, mu, nu) in enumerate(run(world, "train_state_task", layout, state=state)):
        for got, w in zip(params, shards(state["params"], layout, r), strict=True):
            np.testing.assert_array_equal(got, w)
        for got, w in zip(mu, shards(state["opt"]["mu"], layout, r), strict=True):
            np.testing.assert_array_equal(got, w)
        assert len(nu) == len(mu)


def test_what_stays_out_refuses_at_dp():
    """rwkv6 over data replicas raises naming its ROADMAP item; DLRM over
    data replicas (its tables over the flattened world), MoE over data
    replicas and Adafactor at dp > 1 (ROADMAP item 5's) build their
    functions."""
    two = types.SimpleNamespace(tp=1, dp=2)
    assert callable(get_arch("dbrx-132b").reduced().decode_fn(two))
    assert callable(get_arch("dlrm").reduced().loss_fn(two))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        get_arch("rwkv6-7b").reduced().loss_fn(two)
    tc = TrainConfig(optimizer=OptimizerConfig(name="adafactor"))
    assert callable(build_train_step(lambda p, b: None, tc, ctx=two, param_specs={}))


def _torchrun(module, argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", module, "--dp", "2", "--tp", "2", "--backend", "gloo", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_launchers_at_dp2_tp2_match_one_rank(capsys):
    """``torch.distributed.run`` of both launchers at --dp 2 --tp 2 (gloo,
    CPU): the train launcher prints --tp 1's losses (to their printed
    digits), the paged serve launcher --tp 1's streams, and each says every
    rank's are equal."""
    train = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32",
             "--log-every", "1", "--fusion", "fused"]
    launch_train.main(train)
    want = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", capsys.readouterr().out)]
    out = _torchrun("repro_torch.launch.train", train)
    assert "all 4 ranks' losses equal: True" in out
    got = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", out)]
    assert len(want) == 2 and len(got) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1.01e-4)
    serve = ["--reduced", "--device", "cpu", "--requests", "4", "--max-new", "6", "--paged",
             "--block-size", "8", "--fusion", "fused"]
    launch_serve.main(serve)
    streams = lambda s: dict(re.findall(r"req (\d+): prompt .* -> (\[.*\])", s))
    want_streams = streams(capsys.readouterr().out)
    out = _torchrun("repro_torch.launch.serve", serve)
    assert "all 4 ranks' token streams equal: True" in out
    assert streams(out) == want_streams and len(want_streams) == 4


def test_kernel_mode_over_four_replicas_matches_jax(world, glm):
    """(dp, tp) = (4, 1) in kernel mode, as the card runs it: decode at B = 4
    (a replica's one row through the fused op at one rank) and ``loss_fn``
    with every gradient (a replica's row through the flash op), on the CPU
    the kernels' plain versions, against the JAX package on a (4, 1) mesh."""
    jb, jparams, tree = glm
    layout, B = (4, 1), 4
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jb.config.vocab, (2, B, 1)).astype(np.int32)
    positions = np.stack([s * 3 + np.arange(B) for s in range(2)]).astype(np.int32)
    jdec = jax.jit(lambda tk, cache, p: jb.decode_fn(jctx(layout))(jparams, tk, cache, p))
    jcache, want = jb.init_cache(B), []
    for tok, pos in zip(tokens, positions):
        lg, jcache = jdec(tok, jcache, pos)
        want.append(np.asarray(lg))
    for r, (logits, k, _) in enumerate(run(world, "decode_steps_task", layout, tree=tree,
                                           mode="kernel", tokens=tokens,
                                           positions=positions)):
        np.testing.assert_allclose(logits, np.stack(want), **F32)
        np.testing.assert_allclose(k, np.asarray(jcache["scan"]["k"])[:, r:r + 1], **F32)
    tok, lab = lm_batch(2)
    loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn(jctx(layout))))(
        jparams, {"tokens": tok, "labels": lab})
    grads = jax.tree.map(np.asarray, grads)
    for r, (got_loss, got) in enumerate(run(world, "loss_grads_task", layout, tree=tree,
                                            tokens=tok, labels=lab, mode="kernel")):
        np.testing.assert_allclose(got_loss, float(loss), **LOSS)
        for g, w in zip(got, shards(grads, layout, r), strict=True):
            np.testing.assert_allclose(g, w, **GRAD)
