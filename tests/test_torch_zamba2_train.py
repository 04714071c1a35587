"""zamba2 training on one rank against the JAX package.

The reduced zamba2-7b (2 groups of 2 Mamba blocks, a tail of 1) from the
reference's ``PRNGKey(0)`` draw, carried over by
``zamba2_params_from_numpy``, with the Mamba blocks' ``A_log``, ``D`` and
``dt_bias`` drawn at random (the reference inits them to constants, which
would hide the decay's and the skip's per-head values and the stacked
decay below).  The same ``LMBatches(seed=0)`` batches go through the
reference's ``loss_fn`` / jitted ``build_train_step`` on a (1, 1) mesh and
through the port's on the CPU: kernel mode (the flash op's plain version
and the fused GEMM's, the analytic attention backward) against the
reference's fused mode, bulk and fused mode against their namesakes.  The
SSD scan's gradient is autograd's through ``ssd_chunked`` against
autodiff through the reference's ``lax.scan`` of checkpointed chunks.  The
optimizer sees the groups stacked as the reference's ``stacked_init``
builds them, so AdamW decays the groups' ``[G, H]`` and ``[G, D]`` leaves
and not the tail's ``[H]`` and ``[D]`` ones.  f32 throughout.  Tolerances:
the loss at rtol 1e-5 and the gradients at rtol 2e-3, atol 1e-5
(tests/test_loss.py's); the SSD scan's gradients at ``TOL["f32"]`` of
tests/test_parity_matrix.py; six steps' losses at rtol 1e-4
(tests/test_torch_train.py's) and their parameters at rtol 1e-4, atol 1e-4
(Adam's normalised step moves an element whose gradient is near zero by
up to lr either way: the atol is a thirtieth of one step at lr 3e-3);
remat bit for bit, and the decay-only update at rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.models import mamba2 as jm2
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2 as m2
from repro_torch.models.convert import train_state_from_numpy, zamba2_params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep

LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=2e-3, atol=1e-5)
STEPS = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=1e-4, atol=1e-4)
F32 = TOL["f32"]
ARCH = "zamba2-7b"
MODES = {"kernel": "fused", "bulk": "bulk", "fused": "fused"}   # port mode -> the reference's
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in MODES}
B, S = 4, 32
# the launcher's defaults: 16 x 64 tokens, lr 3e-3, warmup 5 over 6 steps
LB, LS, LR, N_STEPS = 16, 64, 3e-3, 6

_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def jctx(mode):
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                fusion=JaxFusion(mode=mode))


@pytest.fixture(scope="module")
def models():
    """(JAX bundle, JAX params, port bundle, numpy tree)."""
    jb = jax_get_arch(ARCH).reduced()
    tree = jax.tree.map(np.asarray, split_params(jb.init_params(jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(9)
    blocks = [gm["m"] for gm in tree["groups"]["mamba"]] + [b["m"] for b in tree["tail"]]
    for m in blocks:
        for k, scale, base in (("A_log", 0.5, 0.0), ("D", 0.3, 1.0), ("dt_bias", 0.5, 0.0)):
            m[k] = (base + scale * rng.standard_normal(m[k].shape)).astype(np.float32)
    return jb, jax.tree.map(jnp.asarray, tree), get_arch(ARCH).reduced(), tree


def _pparams(tree):
    params = zamba2_params_from_numpy(tree)
    for p in popt.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(n=B, s=S, seed=0):
    return next(JaxLMBatches(256, n, s, seed))


def _grads(loss, params):
    grads = iter(torch.autograd.grad(loss, popt.tree_leaves(params)))
    return popt.tree_map(lambda _: next(grads), params)


# ---------------------------------------------------------------------------
# the SSD scan's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [8, 64])
def test_ssd_scan_gradient_matches_jax(chunk):
    """Autograd through ``ssd_chunked`` (every chunk's intra-chunk term at
    once, the state carried chunk after chunk) against autodiff through the
    reference's scan, from a random state over 64 positions: the gradients
    of <y, gy> + <S, gS> in x, dt, A_log, B, C and the initial state."""
    rng = np.random.default_rng(chunk)
    b, T, H, P, N = 2, 64, 3, 8, 4
    a = [rng.standard_normal((b, T, H, P)), np.abs(rng.standard_normal((b, T, H))) * 0.5,
         rng.standard_normal(H) * 0.3, rng.standard_normal((b, T, N)),
         rng.standard_normal((b, T, N)), rng.standard_normal((b, H, N, P))]
    a = [v.astype(np.float32) for v in a]
    gy = rng.standard_normal((b, T, H, P)).astype(np.float32)
    gs = rng.standard_normal((b, H, N, P)).astype(np.float32)

    def jloss(*v):
        y, s = jm2.ssd_chunked(*v, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*a)
    xs = [torch.from_numpy(v).requires_grad_(True) for v in a]
    y, s = m2.ssd_chunked(*xs, chunk)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum(),
                              xs)
    for name, g, w in zip(("x", "dt", "A_log", "B", "C", "state"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32, err_msg=name)


# ---------------------------------------------------------------------------
# the model: loss and every parameter's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_train_forward_loss_and_grads_match_jax(models, mode):
    """The loss and every gradient at tp = 1 in each mode."""
    jb, jparams, pb, tree = models
    batch = _batch()
    jfn = memo(("vg", MODES[mode]),
               lambda: jax.jit(jax.value_and_grad(jb.loss_fn(jctx(MODES[mode])))))
    jloss, jgrads = jfn(jparams, batch)
    params = _pparams(tree)
    loss = pb.loss_fn(CPU[mode])(params, to_device(batch, "cpu"))
    grads = _grads(loss, params)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS)
    want = zamba2_params_from_numpy(jax.tree.map(np.asarray, jgrads))
    cfg = pb.config
    assert len(popt.tree_leaves(want)) == 2 + 8 + 2 * cfg.n_groups + 8 * cfg.n_layers
    popt.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD,
                                                          err_msg=mode), grads, want)


def test_remat_changes_no_gradient(models):
    """Each group under torch.utils.checkpoint (the config's remat) gives the
    loss and gradients of the plain group loop, bit for bit."""
    _, _, pb, tree = models
    batch = to_device(_batch(), "cpu")
    out = {}
    for remat in (True, False):
        bundle = dataclasses.replace(pb, config=dataclasses.replace(pb.config, remat=remat))
        params = _pparams(tree)
        loss = bundle.loss_fn(CPU["kernel"])(params, batch)
        out[remat] = (loss,) + torch.autograd.grad(loss, popt.tree_leaves(params))
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_mode_backward_uses_the_analytic_attention(monkeypatch, models):
    """Kernel mode's shared attention differentiates through flash_backward
    (the reference's ring-attention VJP), once a group; bulk mode's through
    autograd; and every Mamba block's ``w_out`` runs the fused GEMM +
    AllReduce in the forward and again in its group's recompute."""
    import repro_torch.core.matmul_allreduce as mar
    from repro_torch.models import attention

    _, _, pb, tree = models
    cfg = pb.config
    calls, fused = [], []
    real_bwd, real_fused = attention.flash_backward, mar.fused_matmul_allreduce
    monkeypatch.setattr(attention, "flash_backward",
                        lambda *a, **kw: calls.append(1) or real_bwd(*a, **kw))
    monkeypatch.setattr(mar, "fused_matmul_allreduce",
                        lambda *a, **kw: fused.append(1) or real_fused(*a, **kw))
    batch = to_device(_batch(), "cpu")
    for mode, bwd, fwd in (("kernel", cfg.n_groups, cfg.n_layers + cfg.n_groups * cfg.attn_every),
                           ("bulk", 0, 0)):
        calls.clear()
        fused.clear()
        params = _pparams(tree)
        pb.loss_fn(CPU[mode])(params, batch).backward()
        assert (len(calls), len(fused)) == (bwd, fwd), mode


# ---------------------------------------------------------------------------
# the optimizer: the groups stacked, as the reference's stacked_init builds them
# ---------------------------------------------------------------------------
def test_leaf_groups_stack_the_groups_and_not_the_tail(models):
    """Each group leaf forms one stacked group of n_groups tensors under
    ``("groups", ...)``; the tail's blocks and the other leaves are groups
    of one."""
    _, _, pb, tree = models
    params = zamba2_params_from_numpy(tree)
    groups = {path: (len(ts), stacked) for path, ts, stacked in popt.leaf_groups(params)}
    G = pb.config.n_groups
    assert groups[("groups", "mamba", 0, "m", "A_log")] == (G, True)
    assert groups[("groups", "lora_a")] == (G, True)
    assert groups[("tail", 0, "m", "A_log")] == (1, False)
    assert groups[("final_norm",)] == (1, False)
    n_group_leaves = len(popt.tree_leaves(params["groups"][0]))
    assert sum(stacked for _, stacked in groups.values()) == n_group_leaves
    assert sum(n for n, _ in groups.values()) == len(popt.tree_leaves(params))


def test_adamw_decays_the_stacked_groups_as_the_reference(models):
    """One AdamW update with zero gradients moves a leaf by its weight decay
    alone: the groups' ``[G, H]`` and ``[G, D]`` leaves (A_log, D, dt_bias,
    the norms) decay as the reference's stacked leaves do, the tail's
    ``[H]`` and ``[D]`` leaves and the final norm do not; the port's update
    is the reference's, leaf for leaf."""
    jb, jparams, _, tree = models
    cfg = jopt.OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    jzero = jax.tree.map(jnp.zeros_like, jparams)
    jnew = jax.jit(lambda g, st, p: jopt.adamw_update(cfg, g, st, p)[0])(
        jzero, jopt.adamw_init(cfg, jparams), jparams)
    pcfg = popt.OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    params = zamba2_params_from_numpy(tree)
    before = zamba2_params_from_numpy(tree)
    zeros = popt.tree_map(torch.zeros_like, params)
    popt.adamw_update(pcfg, zeros, popt.adamw_init(pcfg, params), params)
    want = zamba2_params_from_numpy(jax.tree.map(np.asarray, jnew))
    popt.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                                          atol=0), params, want)
    moved = lambda a, b: not torch.equal(a, b)
    for g in range(2):
        mb = params["groups"][g]["mamba"][0]
        was = before["groups"][g]["mamba"][0]
        for k in ("A_log", "D", "dt_bias", "norm"):
            assert moved(mb["m"][k], was["m"][k]), k
        assert moved(mb["ln"], was["ln"])
    tail, was = params["tail"][0], before["tail"][0]
    for k in ("A_log", "D", "dt_bias", "norm"):
        torch.testing.assert_close(tail["m"][k], was["m"][k], rtol=0, atol=0)
    torch.testing.assert_close(tail["ln"], was["ln"], rtol=0, atol=0)
    torch.testing.assert_close(params["final_norm"], before["final_norm"], rtol=0, atol=0)


def _jax_loop(models):
    """The reference's jitted AdamW step on the launcher's batches: each
    step's loss, its state after step 3 and after the last."""
    jb, jparams, _, _ = models

    def make():
        tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(lr=LR, warmup_steps=5,
                                                              total_steps=N_STEPS))
        fn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx("fused")), tc))
        state, losses, mid = jstep.init_train_state(tc, jparams), [], None
        it = JaxLMBatches(256, LB, LS, 0)
        batches = [next(it) for _ in range(N_STEPS)]
        for i, batch in enumerate(batches):
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
            if i == 2:
                mid = jax.tree.map(np.asarray, state)
        return losses, mid, jax.tree.map(np.asarray, state), batches
    return memo("jax_loop", make)


def test_six_adamw_steps_match_the_jax_step(models):
    """Six steps from the same state on the same batches (kernel mode against
    the reference's fused mode): the losses, then every parameter; and the
    reference's state after step 3, carried over by
    ``train_state_from_numpy``, continues in the port to its losses."""
    jb, jparams, pb, tree = models
    want, mid, final, batches = _jax_loop(models)
    ptc = pstep.TrainConfig(optimizer=popt.OptimizerConfig(lr=LR, warmup_steps=5,
                                                           total_steps=N_STEPS))
    pfn = pstep.build_train_step(pb.loss_fn(CPU["kernel"]), ptc)
    state = pstep.init_train_state(ptc, _pparams(tree))
    got = []
    for batch in batches:
        state, m = pfn(state, to_device(batch, "cpu"))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, **STEPS)
    assert want[-1] < want[0]
    popt.tree_map(lambda p, w: np.testing.assert_allclose(p.detach().numpy(), w.numpy(),
                                                          **PARAMS),
                  state["params"], zamba2_params_from_numpy(final["params"]))
    resumed = train_state_from_numpy(mid)
    assert int(resumed["opt"]["step"]) == 3
    tail = [pfn(resumed, to_device(b, "cpu"))[1]["loss"].item() for b in batches[3:]]
    np.testing.assert_allclose(tail, want[3:], **STEPS)


def test_launcher_matches_the_jax_loop(monkeypatch, models, capsys):
    """``python -m repro_torch.launch.train --arch zamba2-7b --reduced
    --device cpu --steps 6`` (16 x 64 tokens, lr 3e-3, kernel mode, the
    registry's AdamW and one microbatch) on the same weights: the
    reference loop's losses, lower at the end than at the start."""
    _, _, pb, tree = models
    assert (pb.optimizer, pb.microbatches) == ("adamw", 1)
    monkeypatch.setattr(registry.ArchBundle, "init_params",
                        lambda self, gen, ctx=None, training=False:
                        zamba2_params_from_numpy(tree))
    got = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                             str(N_STEPS), "--log-every", "2"])
    want = _jax_loop(models)[0]
    np.testing.assert_allclose(got, want, **STEPS)
    assert got[-1] < got[0]
    out = capsys.readouterr().out
    assert out.count("gnorm") == 3 and "done at step 6" in out
