"""zamba2 over (dp, tp) worlds against the JAX package on one device.

The reduced zamba2-7b has one Mamba head (d_model 32), so both sides run it
at d_model 128: 4 Mamba heads of 64, which tp = 2 and 4 split.  The port
lays its Mamba shards out by heads (``models/mamba2.param_specs``): rank r
holds heads ``[r H / tp, (r + 1) H / tp)`` of every block, B and C whole;
its shared block is context-parallel; over data each replica takes its
batch rows.  On a gloo world of CPU processes (``tests/torch_world.py``'s
``zamba2_task``) at tp = 2, tp = 4 and (dp, tp) = (2, 2), in bulk and fused
mode, every rank's prefill logits, its part of every cache leaf, 4 greedy
decode steps from the prefill's state, the loss and its gradients (the
rank's shards, the whole leaves summed as the train step sums them) are
held to the reference's numbers on a (1, 1) mesh, sliced by the port's
layout.  The training shards go through a checkpoint and back at every
layout, and the checkpoint restores whole on one rank; ``reshard_tree``
places whole leaves as ``zamba2_params_from_numpy`` does.  Both launchers
run zamba2 under ``torch.distributed.run``.  The reference's ``A_log``,
``D`` and ``dt_bias`` init to constants, so they are drawn at random here
(tests/test_torch_zamba2.py's reason).  f32 throughout; tolerances:
``TOL["f32"]`` of tests/test_parity_matrix.py for logits and caches, the
loss at rtol 1e-5 and the gradients at rtol 2e-3, atol 1e-5
(tests/test_loss.py's); checkpoints and placements bit for bit.
"""
import dataclasses
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.checkpoint.checkpointer import restore_checkpoint
from repro_torch.configs.registry import ArchBundle
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import zamba2
from repro_torch.models.convert import zamba2_params_from_numpy
from repro_torch.parallel.sharding import shard_leaf
from repro_torch.train.optimizer import tree_leaves, tree_map
from torch_world import World, zamba2_bundle

ROOT = Path(__file__).resolve().parents[1]
F32 = TOL["f32"]
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=2e-3, atol=1e-5)
D_MODEL = 128
B, S, STEPS = 2, 32, 4
LAYOUTS = [(1, 2), (1, 4), (2, 2)]          # (dp, tp)
IDS = ["tp2", "tp4", "dp2tp2"]
MODES = ("bulk", "fused")

_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def jctx():
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                fusion=JaxFusion(mode="bulk"))


def leaves_of(cache):
    return {(g, k): np.asarray(v) for g, sub in cache.items() if sub is not None
            for k, v in sub.items()}


def models():
    """(JAX bundle, JAX params, numpy tree) of the reduced zamba2-7b at
    D_MODEL, the Mamba blocks' per-head constants drawn at random."""
    def make():
        jb = jax_get_arch("zamba2-7b").reduced()
        jb = dataclasses.replace(jb, config=dataclasses.replace(jb.config, d_model=D_MODEL))
        tree = jax.tree.map(np.asarray, split_params(jb.init_params(jax.random.PRNGKey(0)))[0])
        rng = np.random.default_rng(9)
        blocks = [gm["m"] for gm in tree["groups"]["mamba"]] + [b["m"] for b in tree["tail"]]
        for m in blocks:
            for k, scale, base in (("A_log", 0.5, 0.0), ("D", 0.3, 1.0), ("dt_bias", 0.5, 0.0)):
                m[k] = (base + scale * rng.standard_normal(m[k].shape)).astype(np.float32)
        return jb, jax.tree.map(jnp.asarray, tree), tree
    return memo("models", make)


def inputs():
    rng = np.random.default_rng(3)
    vocab = zamba2_bundle(D_MODEL).config.vocab
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def reference():
    """The reference on one device: the prefill's logits and cache, STEPS
    greedy decode steps from its state (k and v in rows [0, S) of
    init_cache's buffers) and the final cache, the loss and every
    gradient."""
    def make():
        jb, jparams, _ = models()
        tokens, labels = inputs()
        ctx = jctx()
        jl, jcache = jax.jit(jb.prefill_fn(ctx))(jparams, {"tokens": tokens})
        dc = jb.init_cache(B)
        dc["mamba"], dc["tail"] = jcache["mamba"], jcache["tail"]
        dc["attn"] = jax.tree.map(lambda full, got: full.at[:, :, :S].set(got), dc["attn"],
                                  jcache["attn"])
        jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
        tok, logits = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), []
        for s in range(STEPS):
            lg, dc = jdec(tok, dc, np.full((B,), S + s, np.int32))
            logits.append(np.asarray(lg))
            tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn(ctx)))(
            jparams, {"tokens": tokens, "labels": labels})
        return (np.asarray(jl), leaves_of(jcache), np.stack(logits), leaves_of(dc),
                float(loss), jax.tree.map(np.asarray, grads))
    return memo("reference", make)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


def run(world, ckpt_dir, layout, mode):
    """``zamba2_task``'s per-rank results at (dp, tp) = ``layout`` (at tp = 2
    both pairs run it and must agree), one run a layout and mode."""
    def make():
        dp, tp = layout
        tokens, labels = inputs()
        out = world.run("zamba2_task", tp, dp=dp, tree=models()[2], d_model=D_MODEL,
                        tokens=tokens, labels=labels, mode=mode, steps=STEPS,
                        path=str(ckpt_dir / f"{dp}x{tp}{mode}"))
        if tp == 2 and dp == 1:
            for a, b in zip(out[:2], out[2:]):
                for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                    np.testing.assert_array_equal(u, v)
        return out[:dp * tp]
    return memo(("run", layout, mode), make)


def place(layout, r):
    dp, tp = layout
    return types.SimpleNamespace(tp=tp, tp_rank=r % tp, dp=dp, dp_rank=r // tp)


def cache_part(whole, pl, rows):
    """This rank's part of a whole cache's leaves by the port's
    ``cache_logical_specs`` (the SSM states by heads, the conv state by its
    heads' x channels with B and C whole, the KV rows by sequence), and its
    replica's batch rows where the replicas split them."""
    specs = zamba2.cache_logical_specs(zamba2_bundle(D_MODEL).config, None)
    out = {}
    for (g, k), a in whole.items():
        spec = specs[g][k]
        x = shard_leaf(torch.from_numpy(np.ascontiguousarray(a)), spec, pl).numpy()
        if rows is not None:
            x = np.take(x, np.arange(rows[0], rows[0] + rows[1]), axis=spec.index("batch"))
        out[(g, k)] = x
    return out


def shards(tree, pl):
    """This rank's training shards of a whole parameter-shaped numpy tree."""
    cfg = zamba2_bundle(D_MODEL).config
    return [a.numpy() for a in tree_leaves(zamba2_params_from_numpy(tree, "cpu", cfg, pl,
                                                                    training=True))]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_prefill_over_a_world_matches_jax(world, ckpt_dir, layout, mode):
    """Every rank's last logits are the reference's; its cache is its part of
    the reference's: its heads' SSM states, its conv channels, its chunk of
    each group's k and v, its replica's rows."""
    want_logits, want_cache = reference()[:2]
    for r, out in enumerate(run(world, ckpt_dir, layout, mode)):
        logits, cache, rows = out[0], out[1], out[-1]
        np.testing.assert_allclose(logits, want_logits, **F32)
        want = cache_part(want_cache, place(layout, r), rows)
        assert set(cache) == set(want)
        for key, w in want.items():
            assert cache[key].shape == w.shape, (r, key)
            np.testing.assert_allclose(cache[key], w, **F32, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_decode_steps_over_a_world_match_jax(world, ckpt_dir, layout, mode):
    """STEPS greedy steps from the prefill's state (positions past the
    prompt, in another rank's rows of the KV cache at tp = 2 and 4): every
    step's logits, and the final cache's part of every leaf."""
    *_, want_logits, want_final, _, _ = reference()
    for r, out in enumerate(run(world, ckpt_dir, layout, mode)):
        logits, final, rows = out[3], out[4], out[-1]
        np.testing.assert_allclose(logits, want_logits, **F32)
        for key, w in cache_part(want_final, place(layout, r), rows).items():
            np.testing.assert_allclose(final[key], w, **F32, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_loss_and_every_gradient_over_a_world_match_jax(world, ckpt_dir, layout, mode):
    """``loss_fn`` on the training shards (the fsdp dims over data at dp = 2):
    the loss on every rank, and every gradient, each rank's shard against
    its part of the reference's ``jax.value_and_grad``."""
    want_loss, want_grads = reference()[4:]
    for r, out in enumerate(run(world, ckpt_dir, layout, mode)):
        loss, grads = out[5], out[6]
        np.testing.assert_allclose(loss, want_loss, **LOSS)
        for i, (g, w) in enumerate(zip(grads, shards(want_grads, place(layout, r)),
                                       strict=True)):
            np.testing.assert_allclose(g, w, **GRAD, err_msg=f"rank {r} leaf {i}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_clip_norm_over_a_world_is_the_whole_gradients(world, ckpt_dir, layout):
    """``global_norm`` over the world's gradient shards (B and C's columns,
    whole on every rank, counted once) is the norm of the reference's whole
    gradients, on every rank."""
    want = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in jax.tree.leaves(reference()[5])))
    for out in run(world, ckpt_dir, layout, "fused"):
        np.testing.assert_allclose(out[8], want, rtol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_checkpoint_round_trips_the_heads_layout(world, ckpt_dir, layout):
    """The training shards saved over the world (every split leaf gathered
    by its segments, world rank 0 writing) restore onto the world bit for
    bit, and whole on one rank as the one-rank weights."""
    dp, tp = layout
    tree = models()[2]
    for r, out in enumerate(run(world, ckpt_dir, layout, "fused")):
        for got, want in zip(out[7], shards(tree, place(layout, r)), strict=True):
            np.testing.assert_array_equal(got, want)
    whole = zamba2_params_from_numpy(tree)
    back, step = restore_checkpoint(str(ckpt_dir / f"{dp}x{tp}fused" / "w0" / "step_00000001"),
                                    tree_map(torch.zeros_like, whole))
    assert step == 1
    for got, want in zip(tree_leaves(back), tree_leaves(whole), strict=True):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_fused_mode_runs_w_out_through_the_ring(world, ckpt_dir, layout):
    """Fused mode's prefill runs every Mamba block's ``w_out`` through the
    ring of ``matmul_allreduce`` (the shared MLP's prefill takes the
    sequence-parallel products); bulk mode runs no ring."""
    n = zamba2_bundle(D_MODEL).config.n_layers
    assert [out[2] for out in run(world, ckpt_dir, layout, "fused")] == [n] * (layout[0] *
                                                                           layout[1])
    assert [out[2] for out in run(world, ckpt_dir, layout, "bulk")] == [0] * (layout[0] *
                                                                            layout[1])


@pytest.mark.parametrize("tp", [2, 4])
def test_reshard_tree_places_whole_leaves_by_heads(tp):
    """``reshard_tree`` of whole leaves onto a world (the host-to-device
    restore path) gives each rank ``zamba2_params_from_numpy``'s shards, B
    and C's columns whole on every rank and the heads' own split."""
    from repro_torch.runtime.elastic import reshard_tree

    tree = models()[2]
    bundle = zamba2_bundle(D_MODEL)
    whole = zamba2_params_from_numpy(tree)
    specs = bundle.param_specs(whole)
    mc = bundle.config.mamba
    for r in range(tp):
        pl = types.SimpleNamespace(tp=tp, tp_rank=r, dp=1, dp_rank=0, member=True,
                                   device=torch.device("cpu"))
        got, _ = reshard_tree(whole, specs, pl)
        for a, b in zip(tree_leaves(got), shards(tree, place((1, tp), r)), strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
        w_in = got["groups"][0]["mamba"][0]["m"]["w_in"].numpy()
        full = whole["groups"][0]["mamba"][0]["m"]["w_in"].numpy()
        di = mc.d_inner // tp
        np.testing.assert_array_equal(w_in[:, 2 * di:2 * di + 2 * mc.d_state],
                                      full[:, 2 * mc.d_inner:2 * mc.d_inner + 2 * mc.d_state])
        np.testing.assert_array_equal(w_in[:, :di], full[:, r * di:(r + 1) * di])


@pytest.mark.parametrize("what", ["zamba2_prefill", "zamba2_train"])
def test_kernel_mode_over_ranks_raises(world, what):
    """Kernel mode at tp = 2 raises where a Mamba block's ``w_out`` reaches
    the fused GEMV/GEMM (its real peers are ROADMAP Queue 1 item 1's), in
    the prefill and in the training forward, on every rank."""
    for msg in world.run("refusal_task", 2, what=what):
        assert msg is not None and "Queue 1 item 1" in msg and "tp=2" in msg, msg


def test_reset_slot_over_data_replicas_zeroes_the_replicas_row():
    """At dp = 2 the engine's slot is a global one: a replica whose rows hold
    it zeroes its own row of the states (slot 3 is row 1 of replica 1's 2),
    the other replica leaves its cache as it was."""
    bundle = zamba2_bundle(D_MODEL)
    for dp_rank in (0, 1):
        ctx = types.SimpleNamespace(tp=2, tp_rank=0, dp=2, dp_rank=dp_rank)
        cache = bundle.init_cache(4, "cpu", tp=2, dp=2)
        for sub in cache.values():
            for v in sub.values():
                v.fill_(1.0)
        bundle.reset_slot_fn(ctx, 4)(cache, 3)
        for grp, k, axis in (("mamba", "ssm", 2), ("mamba", "conv", 2), ("tail", "ssm", 1)):
            assert cache[grp][k].shape[axis] == 2
            zeroed = [not cache[grp][k].select(axis, r).any() for r in range(2)]
            assert zeroed == ([False, True] if dp_rank == 1 else [False, False]), (grp, k)
        assert cache["attn"]["k"].all()


def test_check_tp_refuses_a_tp_that_does_not_divide_the_heads():
    """tp = 8 does not divide the 4 Mamba heads: ``check_tp`` raises before
    any weight is drawn, naming the heads."""
    ctx = types.SimpleNamespace(tp=8, dp=1)
    with pytest.raises(ValueError, match="does not divide the 4 Mamba heads"):
        zamba2_bundle(D_MODEL).check_tp(ctx)


# ---------------------------------------------------------------------------
# the launchers under torch.distributed.run
# ---------------------------------------------------------------------------
_WIDE = """import dataclasses, sys
from repro_torch.configs import registry
real = registry.ArchBundle.reduced
registry.ArchBundle.reduced = lambda self: dataclasses.replace(
    real(self), config=dataclasses.replace(real(self).config, d_model={d}))
from repro_torch.launch import {module}
{module}.main(sys.argv[1:])
"""


def _wide(monkeypatch):
    real = ArchBundle.reduced
    monkeypatch.setattr(ArchBundle, "reduced", lambda self: dataclasses.replace(
        real(self), config=dataclasses.replace(real(self).config, d_model=D_MODEL)))


def _torchrun(tmp_path, module, nproc, argv):
    script = tmp_path / f"wide_{module}.py"
    script.write_text(_WIDE.format(d=D_MODEL, module=module))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), str(script), *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _streams(out: str) -> dict:
    return {int(u): eval(toks) for u, toks in re.findall(r"req (\d+): prompt .* -> (\[.*\])", out)}


def test_serve_launcher_at_tp2_drains_the_one_rank_streams(monkeypatch, tmp_path, capsys):
    """``--arch zamba2-7b --tp 2`` (gloo, fused mode) drains the greedy streams
    of one rank, reused slots included, every rank the same."""
    argv = ["--arch", "zamba2-7b", "--reduced", "--device", "cpu", "--requests", "4",
            "--batch", "2", "--max-new", "5", "--fusion", "fused"]
    _wide(monkeypatch)
    launch_serve.main(argv)
    want = _streams(capsys.readouterr().out)
    out = _torchrun(tmp_path, "serve", 2, argv + ["--tp", "2", "--backend", "gloo"])
    assert "all 2 ranks' token streams equal: True" in out
    assert len(want) == 4 and _streams(out) == want


def test_train_launcher_at_dp2_tp2_gives_the_one_rank_losses(monkeypatch, tmp_path, capsys):
    """``--arch zamba2-7b --dp 2 --tp 2`` (gloo, fused mode) prints the losses
    of one rank (to their printed digits), every rank's equal."""
    argv = ["--arch", "zamba2-7b", "--reduced", "--device", "cpu", "--steps", "2", "--batch",
            "4", "--seq", "32", "--log-every", "1", "--fusion", "fused"]
    _wide(monkeypatch)
    launch_train.main(argv)
    want = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", capsys.readouterr().out)]
    out = _torchrun(tmp_path, "train", 4, argv + ["--dp", "2", "--tp", "2", "--backend",
                                                   "gloo"])
    assert "all 4 ranks' losses equal: True" in out
    got = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", out)]
    assert len(want) == 2 and len(got) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1.01e-4)
