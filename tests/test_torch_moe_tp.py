"""The port's MoE over the (dp, tp) world against the JAX package.

The MoE layer sequence-sharded at tp = 2 and 4 (bulk and fused mode) and as
decode EP at (dp, tp) = (1, 2), (1, 4) and (2, 2); the two entries of
``core/moe_all_to_all.py`` (bulk and fused, sub-chunks, a bf16 wire, skew);
the layer's gradients; the dispatch and expert-FFN ops' autograd at tp = 1
(their plain versions here); Adafactor over shards; reduced dbrx-132b's
prefill logits and six Adafactor training steps (2 microbatches) at tp = 1,
2 and (2, 2); ``moe_aux_loss``.  The same numpy inputs, made from a seed, go
through the JAX package on a (dp, tp) data x model mesh of conftest's CPU
devices (compiles memoised) and through the port on a gloo world of CPU
processes (``tests/torch_world.py``), each rank on its part.  Tolerances:
``TOL["f32"]`` and ``WIRE_TOL["bf16"]`` of tests/test_parity_matrix.py; the
gradients at ``GRAD`` (tests/test_loss.py's), training steps as
tests/test_torch_dp.py holds AdamW's.  Skew 0 and 1 give the same bits in
the port.
"""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL, WIRE_TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.core import moe_all_to_all as jmoe_a2a
from repro.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a as jax_dispatch
from repro.kernels.fused_gemm_a2a.ops import fused_gemm_a2a as jax_gemm_a2a
from repro.models import moe as jmoe
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
from repro_torch.kernels.fused_gemm_a2a.ops import fused_gemm_a2a
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.step import TrainConfig, build_train_step, init_train_state
from torch_world import World

torch.backends.cuda.matmul.allow_tf32 = False

F32, BF16 = TOL["f32"], WIRE_TOL["bf16"]
GRAD = dict(rtol=2e-3, atol=1e-5)
STEPS = dict(rtol=1e-4, atol=0)
CFG = dict(n_experts=8, top_k=2, d_model=64, d_ff=32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, layout, **inputs):
    """The task's per-rank results at (dp, tp) = ``layout`` (rank r: tp rank
    r % tp of replica r // tp; a tp = 2 world runs on both pairs, which must
    agree)."""
    dp, tp = layout
    out = world.run(name, tp, dp=dp, **inputs)
    if dp * tp == 2:
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(u, v)
    return out[:dp * tp]


def jctx(layout, mode="bulk", **fusion):
    return JaxContext.from_mesh(make_mesh(layout, ("data", "model")),
                                fusion=JaxFusion(mode=mode, **fusion))


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def block(a, n, d, axis):
    size = a.shape[axis] // n
    return np.take(a, np.arange(d * size, (d + 1) * size), axis=axis)


def place(layout, r):
    dp, tp = layout
    return types.SimpleNamespace(tp=tp, tp_rank=r % tp, dp=dp, dp_rank=r // tp)


def layer_params(seed=0):
    rng = np.random.default_rng(seed)
    E, D, F = CFG["n_experts"], CFG["d_model"], CFG["d_ff"]
    return {"router": (0.3 * rng.standard_normal((D, E))).astype(np.float32),
            "w_gate": (0.2 * rng.standard_normal((E, D, F))).astype(np.float32),
            "w_up": (0.2 * rng.standard_normal((E, D, F))).astype(np.float32),
            "w_down": (0.2 * rng.standard_normal((E, F, D))).astype(np.float32)}


def jax_layer(layout, params, x, mode="bulk"):
    return np.asarray(jax.jit(lambda p, v: jmoe.moe_apply(
        jctx(layout, mode), p, v, jmoe.MoEConfig(**CFG)))(params, x))


def rank_part(want, layout, r, seq_sharded):
    """Rank r's part of the layer's whole output: its replica's rows (where
    dp divides them), its tp block of S when sequence-sharded."""
    dp, tp = layout
    rows = block(want, dp, r // tp, 0) if want.shape[0] % dp == 0 else want
    return block(rows, tp, r % tp, 1) if seq_sharded else rows


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,q,wire", [("bulk", 1, "f32"), ("fused", 1, "f32"),
                                         ("fused", 2, "bf16")])
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_layer_sequence_sharded_matches_jax(world, tp, mode, q, wire):
    """``moe_apply`` on each rank's S / tp positions (2 x 16 tokens), its
    experts a tp block: each rank's output is its block of the JAX layer's
    (the reference's layer runs its MoE exchanges at q = 1 and the f32 wire
    whatever the fusion config says, and so does the port's); skew 1 gives
    skew 0's bits."""
    params = layer_params()
    x = np.random.default_rng(tp).standard_normal((2, 16, CFG["d_model"])).astype(np.float32)
    want = memo(("layer", tp), lambda: jax_layer((1, tp), params, x))
    for r, (outs, _) in enumerate(run(world, "moe_layer_task", (1, tp), params=params, x=x,
                                      cfg=CFG, mode=mode, q=q, wire=wire, skews=(0, 1))):
        np.testing.assert_allclose(outs[0], rank_part(want, (1, tp), r, True), **F32)
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("B", [4, 3])
@pytest.mark.parametrize("layout", [(1, 2), (1, 4), (2, 2)])
def test_decode_ep_matches_jax(world, layout, B):
    """S = 1, rows replicated over the tp ranks: decode EP over the whole
    world (the port's experts numbered model-major, the reference's
    data-major: the same sum up to its f32 order); at dp = 2 with B = 4 the
    replicas split the rows and gather them, with B = 3 each runs them all.
    Bulk and fused mode alike."""
    params = layer_params(1)
    x = np.random.default_rng(B).standard_normal((B, 1, CFG["d_model"])).astype(np.float32)
    want = memo(("decode", layout, B), lambda: jax_layer(layout, params, x))
    for mode in ("bulk", "fused"):
        for r, (outs, _) in enumerate(run(world, "moe_layer_task", layout, params=params, x=x,
                                          cfg=CFG, mode=mode, seq_sharded=False)):
            np.testing.assert_allclose(outs[0], rank_part(want, layout, r, False), **F32)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_moe_layer_gradients_match_jax_grad(world, mode):
    """The gradients of sum(moe_apply(x) * co) at tp = 2 (x sequence-
    sharded): x's block, the router's (summed over the ranks), each rank's
    experts' against ``jax.grad`` of the reference's bulk layer."""
    params = layer_params(2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, CFG["d_model"])).astype(np.float32)
    co = rng.standard_normal(x.shape).astype(np.float32)

    def make():
        f = lambda p, v: jnp.sum(jmoe.moe_apply(jctx((1, 2)), p, v, jmoe.MoEConfig(**CFG)) * co)
        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
        return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}
    gx, gp = memo("grads", make)
    for r, (_, (grads,)) in enumerate(run(world, "moe_layer_task", (1, 2), params=params, x=x,
                                          cfg=CFG, mode=mode, co=co)):
        want = [block(gx, 2, r, 1), gp["router"]] + [block(gp[k], 2, r, 0)
                                                     for k in ("w_gate", "w_up", "w_down")]
        for name, g, w in zip(("x", "router", "w_gate", "w_up", "w_down"), grads, want):
            np.testing.assert_allclose(g, w, **GRAD, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_layer_gradients_keep_their_bits_across_skews(world, tp):
    """Fused mode computes the combine's FFN one destination at a time in
    the schedule's order, which the skew rotates; every gradient (x's, the
    router's, the experts' summed over the destination blocks) is the same
    bits at skew 0 and 1."""
    params = layer_params(2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, CFG["d_model"])).astype(np.float32)
    co = rng.standard_normal(x.shape).astype(np.float32)
    for outs, (g0, g1) in run(world, "moe_layer_task", (1, tp), params=params, x=x, cfg=CFG,
                              mode="fused", co=co, skews=(0, 1)):
        np.testing.assert_array_equal(outs[0], outs[1])
        for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), g0, g1):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_moe_kernel_mode_over_ranks_raises(world):
    """Kernel mode of reduced dbrx's prefill at tp = 2 (the sequence-sharded
    MoE layer) raises, naming the real-peer half of ROADMAP item 1;
    nothing falls back."""
    for msg in world.run("refusal_task", 2, what="moe_prefill"):
        assert msg is not None and re.search("ROADMAP Queue 1 item 1 .*real-peer", msg), msg


# ---------------------------------------------------------------------------
# the two entries of core/moe_all_to_all.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp,mode,q,wire", [(2, "bulk", 1, "f32"), (2, "fused", 2, "bf16"),
                                            (4, "fused", 1, "f32")])
def test_moe_entries_match_jax(world, tp, mode, q, wire):
    """``moe_dispatch_all_to_all`` then ``fused_expert_ffn_combine`` on each
    rank's part of a global dispatch buffer [B, n_ep, E, C, D] (its tp block
    of the experts) against the JAX package's exchange: at the f32 wire the
    dispatch bit-exact and the combine at ``TOL["f32"]``, with the bf16 wire
    both at ``WIRE_TOL["bf16"]`` (one rounding per value that crosses
    ranks); skew 1 gives skew 0's bits.  The JAX side runs its bulk mode
    (its fused mode is the same exchange at q = 1 and the f32 wire, and a
    multiple of the compile time)."""
    rng = np.random.default_rng(tp)
    E, D, F, C = 8, 16, 24, 4
    x = rng.standard_normal((2, tp, E, C, D)).astype(np.float32)
    ws = [(0.3 * rng.standard_normal(s)).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]

    def make():
        c = jctx((1, tp), "bulk")
        d = jmoe_a2a.moe_dispatch_all_to_all(c, x)
        y = jmoe_a2a.fused_expert_ffn_combine(c, d, *ws, act=jax.nn.silu)
        return np.asarray(d), np.asarray(y)
    want_d, want_y = memo(("entries", tp), make)
    tol = F32 if wire == "f32" else BF16
    for r, outs in enumerate(run(world, "moe_entries_task", (1, tp), x=x, w_up=ws[0],
                                 w_gate=ws[1], w_down=ws[2], mode=mode, q=q, wire=wire,
                                 skews=(0, 1))):
        (d0, y0), (d1, y1) = outs
        np.testing.assert_allclose(d0, block(want_d, tp, r, 2), **tol)
        if wire == "f32":
            np.testing.assert_array_equal(d0, block(want_d, tp, r, 2))
        np.testing.assert_allclose(y0, block(want_y, tp, r, 2), **tol)
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(y0, y1)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_moe_entries_over_data_replicas(world, mode):
    """At (2, 2) the entries run over each replica's tp group (its rows of
    the buffer), against the JAX package's bulk exchange on the (2, 2)
    mesh."""
    rng = np.random.default_rng(12)
    E, D, F, C = 4, 8, 16, 3
    x = rng.standard_normal((2, 2, E, C, D)).astype(np.float32)
    ws = [(0.3 * rng.standard_normal(s)).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]

    def make():
        c = jctx((2, 2), "bulk")
        d = jmoe_a2a.moe_dispatch_all_to_all(c, x)
        return np.asarray(d), np.asarray(jmoe_a2a.fused_expert_ffn_combine(
            c, d, *ws, act=jax.nn.silu))
    want_d, want_y = memo("entries_dp", make)
    for r, outs in enumerate(run(world, "moe_entries_task", (2, 2), x=x, w_up=ws[0],
                                 w_gate=ws[1], w_down=ws[2], mode=mode)):
        (d0, y0), = outs
        rows = lambda a: block(block(a, 2, r // 2, 0), 2, r % 2, 2)
        np.testing.assert_array_equal(d0, rows(want_d))
        np.testing.assert_allclose(y0, rows(want_y), **F32)


# ---------------------------------------------------------------------------
# the kernels' autograd at tp = 1 (their plain versions on the CPU)
# ---------------------------------------------------------------------------
def test_dispatch_and_ffn_ops_autograd_match_jax():
    """The dispatch op's VJP is the exchange of the cotangent; the FFN op's
    differentiates the plain version from the saved operands: both against
    ``jax.vjp`` of the JAX kernels (interpret mode) on a one-device mesh."""
    rng = np.random.default_rng(4)
    B, E, C, D, F = 2, 3, 10, 16, 24
    x = rng.standard_normal((B, 1, E, C, D)).astype(np.float32)
    ws = [(0.3 * rng.standard_normal(s)).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    co = rng.standard_normal(x.shape).astype(np.float32)
    c1 = JaxContext.from_mesh(make_mesh((1,), ("model",)))
    _, vjp_d = jax.vjp(lambda v: jax_dispatch(c1, v), x)
    _, vjp_f = jax.vjp(lambda *a: jax_gemm_a2a(c1, *a, act=jax.nn.silu), x, *ws)
    want_d, = vjp_d(co)
    want_f = vjp_f(co)

    xt = torch.from_numpy(x).movedim(1, 0).contiguous().requires_grad_(True)
    cot = torch.from_numpy(co).movedim(1, 0)
    got_d, = torch.autograd.grad(fused_dispatch_a2a(xt, chunks_per_rank=2), xt, cot)
    np.testing.assert_array_equal(got_d.movedim(0, 1).numpy(), np.asarray(want_d))
    pw = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    got_f = torch.autograd.grad(fused_gemm_a2a(xt, *pw), [xt] + pw, cot)
    np.testing.assert_allclose(got_f[0].movedim(0, 1).numpy(), np.asarray(want_f[0]), **F32)
    for g, w, name in zip(got_f[1:], want_f[1:], ("w_up", "w_gate", "w_down")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32, err_msg=name)


@pytest.mark.parametrize("mode", ["kernel", "fused", "bulk"])
def test_layer_gradients_at_tp1_every_mode(mode):
    """At tp = 1 the layer's gradients in kernel mode (the chained ops'
    VJPs), fused and bulk mode are ``jax.grad``'s of the reference's bulk
    layer."""
    params = layer_params(3)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, CFG["d_model"])).astype(np.float32)
    co = rng.standard_normal(x.shape).astype(np.float32)

    def make():
        f = lambda p, v: jnp.sum(jmoe.moe_apply(jctx((1, 1)), p, v, jmoe.MoEConfig(**CFG)) * co)
        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
        return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}
    gx, gp = memo("grads1", make)
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode=mode))
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xl = torch.from_numpy(x).requires_grad_(True)
    y = moe.moe_apply(ctx, p, xl, moe.MoEConfig(**CFG))
    leaves = [xl] + [p[k] for k in ("router", "w_gate", "w_up", "w_down")]
    got = torch.autograd.grad((y * torch.from_numpy(co)).sum(), leaves)
    for g, w in zip(got, [gx] + [gp[k] for k in ("router", "w_gate", "w_up", "w_down")]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD)


# ---------------------------------------------------------------------------
# Adafactor over shards
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dbrx():
    jb = jax_get_arch("dbrx-132b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("layout", [(1, 2), (1, 4), (2, 2)])
def test_adafactor_over_shards_matches_whole_leaf_update(world, dbrx, layout):
    """Two Adafactor updates of reduced dbrx's train state on each rank's
    training shards (experts over tp, fsdp dims over data): the factored
    means over split dims and the clip's mean over the whole stacked leaf
    reduced over the ranks, so every shard of the parameters and of the
    factors is its slice of the reference's whole-leaf update."""
    jb, jparams, tree = dbrx
    rng = np.random.default_rng(13)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    cfg = jopt.OptimizerConfig(name="adafactor", lr=1e-2, warmup_steps=1)
    state = {"params": jparams, "opt": jopt.adafactor_init(cfg, jparams)}

    def make():
        st = state
        upd = jax.jit(lambda g, o, p: jopt.adafactor_update(cfg, g, o, p))
        for _ in range(2):
            p, o, _ = upd(grads, st["opt"], st["params"])
            st = {"params": p, "opt": o}
        return jax.tree.map(np.asarray, st)
    want = memo("adafactor", make)
    per_rank = run(world, "adafactor_task", layout, state=jax.tree.map(np.asarray, state),
                   grads=grads)
    for r, (params, v) in enumerate(per_rank):
        exp = train_state_from_numpy(want, "cpu", place(layout, r))
        for got, w in zip(params, tree_leaves(exp["params"]), strict=True):
            np.testing.assert_allclose(got, w.detach().numpy(), rtol=1e-5, atol=1e-6)
        for got, w in zip(v, tree_leaves(exp["opt"]["v"]), strict=True):
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# reduced dbrx-132b: prefill and training
# ---------------------------------------------------------------------------
def lm_batch(seed, b=4, s=16, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


@pytest.mark.parametrize("layout,mode", [((1, 1), "kernel"), ((1, 2), "fused"),
                                         ((1, 2), "bulk"), ((2, 2), "fused")])
def test_dbrx_prefill_logits_match_jax(world, dbrx, layout, mode):
    """``prefill_fn`` of 4 x 16 tokens through the sequence-sharded MoE
    layers: the logits (every rank's) and each rank's cache chunk against
    the JAX package's on the same mesh."""
    jb, jparams, tree = dbrx
    dp, tp = layout
    tokens = lm_batch(3)[0]

    def make():
        lg, cache = jax.jit(lambda p, tk: jb.prefill_fn(jctx(layout, "fused"))(
            p, {"tokens": tk}))(jparams, tokens)
        return np.asarray(lg), {k: np.asarray(v) for k, v in cache["scan"].items()}
    want, cache = memo(("prefill", layout), make)
    if layout == (1, 1):
        ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode=mode))
        lg, pc = get_arch("dbrx-132b").reduced().prefill_fn(ctx)(
            params_from_numpy(tree), {"tokens": torch.from_numpy(tokens)})
        per_rank = [(lg.numpy(), pc["k"].numpy(), pc["v"].numpy())]
    else:
        per_rank = run(world, "prefill_task", layout, tree=tree, tokens=tokens, mode=mode,
                       arch="dbrx-132b")
    for r, (logits, k, v) in enumerate(per_rank):
        np.testing.assert_allclose(logits, want, **F32)
        for got, name in ((k, "k"), (v, "v")):
            rows = block(cache[name], dp, r // tp, 1)
            np.testing.assert_allclose(got, block(rows, tp, r % tp, 2), **F32, err_msg=name)


@pytest.mark.parametrize("layout,mode", [((1, 1), "kernel"), ((1, 2), "fused"),
                                         ((2, 2), "bulk")])
def test_dbrx_adafactor_steps_match_the_jax_step(world, dbrx, layout, mode):
    """Six steps of reduced dbrx through ``build_train_step`` with the
    registry's Adafactor and 2 microbatches (experts over tp, fsdp dims over
    data, Adafactor over the shards) against the JAX package's jitted step on
    the same mesh: each step's loss and grad norm, then every parameter
    shard; on one batch seen six times the loss falls."""
    jb, jparams, tree = dbrx
    steps = 6
    batches = [lm_batch(20)] * steps
    pb = get_arch("dbrx-132b")
    assert (pb.optimizer, pb.microbatches) == ("adafactor", 2)

    def make():
        tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
            name="adafactor", lr=3e-3, warmup_steps=5, total_steps=steps), microbatches=2)
        jfn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx(layout, "fused")), tc))
        state, out = jstep.init_train_state(tc, jparams), []
        for tok, lab in batches:
            state, m = jfn(state, {"tokens": tok, "labels": lab})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, jax.tree.map(np.asarray, state["params"])
    want, final = memo(("steps", layout), make)
    if layout == (1, 1):
        ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode=mode))
        bundle = pb.reduced()
        params = params_from_numpy(tree)
        tc = TrainConfig(optimizer=OptimizerConfig(name="adafactor", lr=3e-3, warmup_steps=5,
                                                   total_steps=steps), microbatches=2)
        step = build_train_step(bundle.loss_fn(ctx), tc)
        state, metrics = init_train_state(tc, params), []
        for tok, lab in batches:
            state, m = step(state, {"tokens": torch.from_numpy(tok),
                                    "labels": torch.from_numpy(lab)})
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        per_rank = [(metrics, [p.detach().numpy() for p in tree_leaves(state["params"])])]
    else:
        per_rank = run(world, "train_steps_task", layout, tree=tree, batches=batches,
                       mode=mode, arch="dbrx-132b", steps=steps, microbatches=2,
                       optimizer="adafactor")
    for r, (metrics, params) in enumerate(per_rank):
        np.testing.assert_allclose(np.array(metrics), np.array(want), **STEPS)
        assert metrics == per_rank[0][0]
        assert metrics[-1][0] < metrics[0][0]
        exp = tree_leaves(params_from_numpy(final, "cpu", place(layout, r), training=True))
        for got, w in zip(params, exp, strict=True):
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# the load-balance loss
# ---------------------------------------------------------------------------
def test_moe_aux_loss_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((12, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gate_i = np.argsort(-probs, axis=-1)[:, :2].astype(np.int32)
    want = float(jmoe.moe_aux_loss(probs, gate_i, 8))
    got = moe.moe_aux_loss(torch.from_numpy(probs), torch.from_numpy(gate_i), 8)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
