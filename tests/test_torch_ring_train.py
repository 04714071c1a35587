"""The port's training at tp = 2 and 4 against the JAX package: the
gradients of the AG/RS products and of matmul_allreduce, of the KV ring
(``context_attention``) in bulk, fused and kernel mode, of the embedding
ring and of the CE ring; the reduced chatglm3-6b's and gemma2-27b's
``loss_fn`` and every gradient; AdamW steps through ``build_train_step``;
the CE ring's calibration builder; the launcher at ``--tp 2``.

The same numpy inputs, made from a seed, go through each JAX function on a
(1, tp) data x model mesh of conftest's CPU devices and through its port on
a gloo world of CPU processes (``tests/torch_world.py``), each rank on its
shard; each rank's gradient is held to its slice of the JAX package's (the
JAX package's gradients at tp > 1 are the dense ones, so no scale factor
enters).  Every port mode is held to the JAX package's fused mode (its
bulk mode gives the same gradients, to 1e-6 relative, at every tp); the
port's kernel mode runs the flash op's plain version a hop (a CPU tensor)
and the ring's plain backward.  Every span is a multiple of the JAX package's blocks
(its ``_span_flash`` drops tail blocks, ROADMAP Queue 3).  f32 gradients at
``GRAD`` (rtol 2e-3, atol 1e-5, tests/test_loss.py's), losses at rtol 1e-5;
a compressed wire at ``WIRE_TOL`` of tests/test_parity_matrix.py; AdamW
steps' losses at rtol 1e-4.
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

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.core.fused import allgather_matmul, matmul_allreduce, matmul_reducescatter
from repro.core.loss import sharded_cross_entropy as jax_ce
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.optimizer import tree_leaves, tree_paths
from torch_world import World

ROOT = Path(__file__).resolve().parents[1]
GRAD = dict(rtol=2e-3, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=0)
STEPS = dict(rtol=1e-4, atol=0)
WIRE_TOL = {"bf16": dict(rtol=3e-2, atol=3e-2), "fp8": dict(rtol=2e-1, atol=2e-1)}
TPS = [2, 4]
B, S, HQ, HKV, HD = 2, 64, 4, 2, 16
CASES = {"causal": (True, None, None), "window 24": (True, 24, None),
         "cap 30": (True, None, 30.0), "non-causal": (False, None, None)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, tp, **inputs):
    """The task's per-rank results at tp (the tp = 2 pairs must agree)."""
    out = world.run(name, tp, **inputs)
    if tp == 2:
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(u, v)
    return out[:tp]


def jctx(tp, mode="fused", **fusion):
    return JaxContext.from_mesh(make_mesh((1, tp), ("data", "model")),
                                fusion=JaxFusion(mode=mode, **fusion))


def block(a, tp, d, axis):
    n = a.shape[axis] // tp
    return np.take(a, np.arange(d * n, (d + 1) * n), axis=axis)


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


# ---------------------------------------------------------------------------
# the AG/RS products and matmul_allreduce (tests/test_fused_ops.py:26-38)
# ---------------------------------------------------------------------------
# op -> (the JAX op, dx's sharded axis, dw's sharded axis)
PRODUCTS = {"allgather_matmul": (allgather_matmul, 1, 1),
            "matmul_reducescatter": (matmul_reducescatter, 2, 0),
            "matmul_allreduce": (matmul_allreduce, 2, 0)}


@pytest.fixture(scope="module")
def products():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((4, 16, 32)).astype(np.float32),
            rng.standard_normal((32, 64)).astype(np.float32),
            rng.standard_normal((4, 16, 64)).astype(np.float32))


@pytest.mark.parametrize("op", list(PRODUCTS))
@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("tp", TPS)
def test_product_grads_match_jax_and_the_dense_gradient(world, products, tp, mode, op):
    """Each rank's (dx, dw) of sum(op(x, w) * co) against its slices of the
    JAX package's gradient on a (1, tp) mesh and of the dense one (x @ w on
    one process): allgather_matmul's dx through the dual reduce-scatter
    ring, matmul_reducescatter's through the all-gather ring of dy,
    matmul_allreduce's local; bulk mode through the bulk collectives'
    backward."""
    x, w, co = products
    fn, ax_x, ax_w = PRODUCTS[op]
    c = jctx(tp)
    want = memo(("product", tp, op), lambda: [np.asarray(a) for a in jax.jit(jax.grad(
        lambda x, w: (fn(c, x, w, mode="fused") * co).sum(), argnums=(0, 1)))(x, w)])
    dense = (np.einsum("bsn,kn->bsk", co, w), np.einsum("bsk,bsn->kn", x, co))
    for a, b in zip(want, dense):
        np.testing.assert_allclose(a, b, **GRAD)
    for d, (gx, gw) in enumerate(run(world, "product_grads_task", tp, x=x, w=w, co=co, op=op,
                                     mode=mode)):
        np.testing.assert_allclose(gx, block(want[0], tp, d, ax_x), **GRAD, err_msg="dx")
        np.testing.assert_allclose(gw, block(want[1], tp, d, ax_w), **GRAD, err_msg="dw")


def test_product_grads_with_sub_chunks(world, products):
    """The AG/RS rings at chunks_per_rank 2 (the dual rings take the
    forward's sub-chunks) against the dense gradient at tp = 4."""
    x, w, co = products
    dense = (np.einsum("bsn,kn->bsk", co, w), np.einsum("bsk,bsn->kn", x, co))
    for op in ("allgather_matmul", "matmul_reducescatter"):
        _, ax_x, ax_w = PRODUCTS[op]
        for d, (gx, gw) in enumerate(run(world, "product_grads_task", 4, x=x, w=w, co=co,
                                         op=op, mode="fused", q=2)):
            np.testing.assert_allclose(gx, block(dense[0], 4, d, ax_x), **GRAD, err_msg=op)
            np.testing.assert_allclose(gw, block(dense[1], 4, d, ax_w), **GRAD, err_msg=op)


# ---------------------------------------------------------------------------
# the KV ring's backward
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, S, h, HD)).astype(np.float32) for h in (HQ, HKV, HKV))
    return q, k, v, rng.standard_normal((B, S, HQ, HD)).astype(np.float32)


def jax_attention_grads(qkv, tp, mode, case, **fusion):
    """The JAX package's (dq, dk, dv) of context_attention on a (1, tp)
    mesh under the cotangent do, memoised."""
    def make():
        causal, window, cap = CASES[case]
        c = jctx(tp, mode, **fusion)
        q, k, v, do = qkv
        f = lambda q, k, v: jattn.context_attention(c, q, k, v, causal=causal, window=window,
                                                    softcap_val=cap, q_block=16, kv_block=16)
        return [np.asarray(a) for a in jax.jit(lambda q, k, v: jax.vjp(f, q, k, v)[1](do))(
            q, k, v)]
    return memo(("attn", tp, mode, case, tuple(sorted(fusion.items()))), make)


def check_attention(per_rank, want, tp, tol=GRAD, skew=0):
    for name, i in (("dq", 0), ("dk", 1), ("dv", 2)):
        got = np.concatenate([r[0][skew][i] for r in per_rank], axis=1)
        np.testing.assert_allclose(got, want[i], **tol, err_msg=f"{name} skew {skew}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["bulk", "fused", "kernel"])
@pytest.mark.parametrize("tp", TPS)
def test_context_attention_grads_match_jax(world, qkv, tp, mode, case):
    """Each rank's chunk of (dq, dk, dv) against the JAX package's: bulk mode
    by autograd through the all-gather, fused and kernel mode by the ring's
    backward (the travelling (dk, dv) accumulators); kernel mode's forward
    calls the flash op once a hop a rank sees, its backward never."""
    causal, window, cap = CASES[case]
    q, k, v, do = qkv
    want = jax_attention_grads(qkv, tp, "fused", case)
    per_rank = run(world, "ring_attention_grads_task", tp, q=q, k=k, v=v, do=do, mode=mode,
                   causal=causal, window=window, cap=cap)
    check_attention(per_rank, want, tp)
    calls = [r[2][0] for r in per_rank]
    if mode != "kernel":
        assert calls == [0] * tp
    elif causal and window is None:
        assert calls == [1 + d for d in range(tp)]


@pytest.mark.parametrize("mode", ["fused", "kernel"])
@pytest.mark.parametrize("tp", TPS)
def test_ring_grads_sub_chunks_and_skew(world, qkv, tp, mode):
    """chunks_per_rank 2 against the JAX package's ring at granularity 2
    (windowed, so the backward stops at the forward's hop bound), and skew
    1's gradients bit-identical to skew 0's."""
    q, k, v, do = qkv
    want = jax_attention_grads(qkv, tp, "fused", "window 24", granularity=2)
    per_rank = run(world, "ring_attention_grads_task", tp, q=q, k=k, v=v, do=do, mode=mode,
                   window=24, qs=2, skews=(0, 1))
    for skew in (0, 1):
        check_attention(per_rank, want, tp, skew=skew)
    for grads, _, _ in per_rank:
        for a, b in zip(grads[0], grads[1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["fused", "kernel"])
@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_ring_grads_compressed_wire(world, qkv, wire, mode):
    """A bf16 and an fp8 wire (the replayed KV rounds once at its source,
    the travelling accumulators on every send) against the JAX package's
    ring on the same wire, at tp = 4."""
    q, k, v, do = qkv
    want = jax_attention_grads(qkv, 4, "fused", "causal", wire=wire)
    per_rank = run(world, "ring_attention_grads_task", 4, q=q, k=k, v=v, do=do, mode=mode,
                   wire=wire)
    check_attention(per_rank, want, 4, tol=WIRE_TOL[wire])


@pytest.mark.parametrize("window,hops", [(None, 3), (24, 2), (16, 1)])
def test_windowed_backward_keeps_the_forward_hops(world, qkv, window, hops):
    """The backward replays the forward's hops, counted through the ring's
    sends: a hop sends k and v (as the forward) and the dk and dv
    accumulators a sub-chunk, and one home permute sends each accumulator;
    at 2 sub-chunks and s_loc = 16 the forward sends 2 * 2 * hops."""
    q, k, v, do = qkv
    for mode in ("fused", "kernel"):
        for _, sends, _ in run(world, "ring_attention_grads_task", 4, q=q, k=k, v=v, do=do,
                               mode=mode, window=window, qs=2):
            fwd, bwd = sends[0]
            assert fwd == 2 * 2 * hops, mode
            assert bwd == 2 * fwd + 2 * 2, mode


# ---------------------------------------------------------------------------
# the embedding ring's backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["comm_aware", "oblivious"])
@pytest.mark.parametrize("tp", TPS)
def test_embedding_table_grad_matches_jax(world, rng, tp, schedule):
    """Each rank's vocabulary rows of the table's gradient (ids outside the
    vocabulary included) through the ring's all-gather backward, and
    through the all-reduce where S does not split over the ranks."""
    table = rng.standard_normal((64, 16)).astype(np.float32)
    c = jctx(tp, schedule=schedule)
    for tokens in (rng.integers(-2, 66, (2, 8)).astype(np.int32),
                   rng.integers(0, 64, (1, 6 if tp == 4 else 5)).astype(np.int32)):
        dy = rng.standard_normal(tokens.shape + (16,)).astype(np.float32)
        want = np.asarray(jax.jit(jax.grad(lambda tb: (jlayers.embedding_lookup(
            c, {"table": tb}, tokens, seq_shard=True, scale=2.0) * dy).sum()))(table))
        for d, got in enumerate(run(world, "embedding_grad_task", tp, table=table, tokens=tokens,
                                    dy=dy, schedule=schedule)):
            np.testing.assert_allclose(got, block(want, tp, d, 0), **GRAD)


# ---------------------------------------------------------------------------
# the CE ring (tests/test_loss.py's shapes)
# ---------------------------------------------------------------------------
CE_B, CE_D, CE_V = 4, 32, 64


def ce_inputs(rng, s):
    return (rng.standard_normal((CE_B, s, CE_D)).astype(np.float32),
            rng.standard_normal((CE_V, CE_D)).astype(np.float32),
            rng.integers(0, CE_V, (CE_B, s)).astype(np.int32))


def check_ce(per_rank, want, tp, seq, tol=GRAD):
    for d, (loss, (dx, de)) in enumerate(per_rank):
        np.testing.assert_allclose(loss, want[0], **LOSS)
        assert loss == per_rank[0][0]
        np.testing.assert_allclose(dx, block(want[1], tp, d, 1) if seq else want[1], **tol,
                                   err_msg="dx")
        np.testing.assert_allclose(de, block(want[2], tp, d, 0), **tol, err_msg="dE")


def jax_ce_grads(tp, x, e, y, **kw):
    loss, (dx, de) = jax.jit(jax.value_and_grad(
        lambda x, e: jax_ce(jctx(tp), x, e, y, **kw), argnums=(0, 1)))(x, e)
    return float(loss), np.asarray(dx), np.asarray(de)


@pytest.mark.parametrize("path", ["ring", "replicated"])
@pytest.mark.parametrize("cap", [None, 20.0])
@pytest.mark.parametrize("tp", TPS)
def test_ce_at_tp_matches_jax(world, rng, tp, cap, path):
    """sharded_cross_entropy at tp = 2 and 4: the loss (every rank the
    same) and each rank's (dx, dE) against its slices of the JAX package's.
    S 16 rings over the ranks; S 2 at tp = 4 and S 3 at tp = 2 do not split
    and take the replicated path (x whole on every rank, dx all-reduced).
    Before the CE ring the port scored a rank's first labels against its
    vocabulary rows as if they were the whole table, and returned that
    local CE without raising."""
    s = 16 if path == "ring" else (2 if tp == 4 else 3)
    x, e, y = ce_inputs(rng, s)
    want = jax_ce_grads(tp, x, e, y, logit_softcap=cap)
    check_ce(run(world, "ce_grads_task", tp, x=x, e=e, y=y, cap=cap), want, tp, path == "ring")


@pytest.mark.parametrize("q,skew,wire", [(2, 1, "f32"), (2, 0, "bf16"), (2, 0, "fp8")])
@pytest.mark.parametrize("tp", TPS)
def test_ce_ring_sub_chunks_skew_and_wire(world, rng, tp, q, skew, wire):
    """The CE ring at chunks_per_rank 2, under skew 1 and with a bf16 and an
    fp8 wire (x rounds once at its source, the travelling dx accumulators on
    every send), against the JAX package's same settings; labels outside
    the vocabulary included."""
    x, e, y = ce_inputs(rng, 16)
    y[0, :3] = [-1, CE_V, CE_V + 7]
    want = jax_ce_grads(tp, x, e, y, chunks_per_rank=q, skew=skew, wire=wire)
    got = run(world, "ce_grads_task", tp, x=x, e=e, y=y, q=q, skew=skew, wire=wire)
    check_ce(got, want, tp, True, GRAD if wire == "f32" else WIRE_TOL[wire])


def test_ce_calibration_agrees_on_every_rank(world, rng):
    """The CE's 'auto' key is re-scored by measurement through
    ``_build_ce_ring``: every rank measures every candidate and takes the
    same decision."""
    x, e, y = ce_inputs(rng, 16)
    per_rank = run(world, "calibrate_ce_task", 4, x=x, e=e, y=y)
    assert all(r == per_rank[0] for r in per_rank)
    decisions, report = per_rank[0]
    (op, _, measured_q, cands, fallback), = report
    assert op == "ce_ring" and not fallback and measured_q in cands and len(cands) > 1
    assert len(decisions) == 1


# ---------------------------------------------------------------------------
# the slice: reduced chatglm3-6b and gemma2-27b training at tp > 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name in ("chatglm3-6b", "gemma2-27b"):
        jb = jax_get_arch(name).reduced()
        jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
        out[name] = jb, jparams, jax.tree.map(np.asarray, jparams)
    return out


def lm_batch(seed, b=4, s=32, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def shards(tree, tp, d):
    """Rank d's shards of a JAX-layout tree, in the port's leaf order."""
    return [a.numpy() for a in tree_leaves(
        params_from_numpy(tree, "cpu", types.SimpleNamespace(tp=tp, tp_rank=d)))]


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ("chatglm3-6b", "gemma2-27b")
                                       for m in ("bulk", "fused", "kernel")])
@pytest.mark.parametrize("tp", TPS)
def test_loss_fn_and_every_gradient_match_jax(world, jax_models, tp, arch, mode):
    """``loss_fn`` of 4 x 32 tokens at tp: the loss (every rank the same)
    and every gradient, each rank's shard (the whole leaves summed over the
    ranks, as the train step does) against its slice of the JAX package's
    ``jax.value_and_grad`` on a (1, tp) mesh.  gemma2 (window 16, both
    caps, layer period 2) at tp = 4 has chunks of 8: its windowed layers'
    rings and their backward stop at 2 of 3 hops."""
    jb, jparams, tree = jax_models[arch]
    tokens, labels = lm_batch(1)

    def make():
        loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn(jctx(tp))))(
            jparams, {"tokens": tokens, "labels": labels})
        return float(loss), jax.tree.map(np.asarray, grads)
    want_loss, want = memo(("loss", arch, tp), make)
    per_rank = run(world, "loss_grads_task", tp, tree=tree, tokens=tokens, labels=labels,
                   mode=mode, arch=arch)
    names = [".".join(map(str, p)) for p, _ in tree_paths(params_from_numpy(tree))]
    for d, (loss, grads) in enumerate(per_rank):
        np.testing.assert_allclose(loss, want_loss, **LOSS)
        assert loss == per_rank[0][0]
        for name, g, w in zip(names, grads, shards(want, tp, d), strict=True):
            np.testing.assert_allclose(g, w, **GRAD, err_msg=f"rank {d} {name}")


def test_adamw_steps_match_the_jax_step(world, jax_models):
    """Six AdamW steps of reduced chatglm3-6b through ``build_train_step`` at
    tp = 2 in fused mode, 2 microbatches a step (the whole leaves'
    gradients all-reduced after the microbatch sum, the clip's norm the
    world's), against the JAX package's jitted step on a (1, 2) mesh: each
    step's loss and grad norm at rtol 1e-4.  Every leaf whole on every rank
    has the same bits on both ranks after the last step."""
    arch, steps, micro = "chatglm3-6b", 6, 2
    jb, jparams, tree = jax_models[arch]
    batches = [lm_batch(10 + i) for i in range(steps)]
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
        lr=3e-3, warmup_steps=max(steps // 20, 5), total_steps=steps), microbatches=micro)
    jfn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx(2)), tc))
    state, want = jstep.init_train_state(tc, jparams), []
    for tok, lab in batches:
        state, m = jfn(state, {"tokens": tok, "labels": lab})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    per_rank = run(world, "train_steps_task", 2, tree=tree, batches=batches, mode="fused",
                   arch=arch, steps=steps, microbatches=micro)
    specs = [p for p, _ in tree_paths(params_from_numpy(tree))]
    whole = [i for i, p in enumerate(specs) if p[-1] not in ("table", "w_gate", "w_up", "w_down")]
    for metrics, _ in per_rank:
        np.testing.assert_allclose(np.array(metrics), np.array(want), **STEPS)
    assert per_rank[0][0] == per_rank[1][0]
    for i in whole:
        np.testing.assert_array_equal(per_rank[0][1][i], per_rank[1][1][i])


def test_moe_training_still_raises_at_tp2(world):
    """MoE training at tp > 1 runs in bulk and fused mode
    (tests/test_torch_moe_tp.py); in kernel mode it raises, naming the
    real-peer half of ROADMAP Queue 1 item 1 (the MoE kernels over ranks)."""
    for msg in run(world, "refusal_task", 2, what="moe_train"):
        assert msg is not None and re.search("ROADMAP Queue 1 item 1 .*real-peer", msg), msg


def _printed_losses(out):
    return [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", out)]


def test_launcher_at_tp2_trains_as_tp1(capsys):
    """``torch.distributed.run`` of the train launcher at --tp 2 (gloo, CPU,
    kernel mode) prints the losses of --tp 1 (to their printed digits) and
    that every rank's losses are equal."""
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32",
            "--log-every", "1", "--fusion", "kernel"]
    launch_train.main(argv)
    want = _printed_losses(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", "--tp", "2", "--backend", "gloo", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "all 2 ranks' losses equal: True" in proc.stdout
    got = _printed_losses(proc.stdout)
    assert len(want) == 3 and len(got) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1.01e-4)
