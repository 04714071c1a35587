"""The port's dense training of reduced chatglm3-6b against the JAX package.

The same parameters (the JAX init, carried over by ``params_from_numpy``)
and the same ``LMBatches(seed=0)`` batches go through the JAX package's
``loss_fn`` / jitted ``build_train_step`` on a one-device mesh (its rings
have no hops, as on one card) and the port's on the CPU, f32 throughout:
kernel mode against the reference's fused mode (the ring attention's
custom VJP), bulk mode against its bulk mode (autodiff).  The loss at
rtol 1e-5 and every parameter's gradient at rtol 2e-3, atol 1e-5 (the
bounds of ``tests/test_loss.py``); six steps' losses at rtol 1e-4.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import grad_compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import ReplayBuffer, prefetch, to_device
from repro_torch.data.synthetic import LMBatches
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.train import grad_compression as pcomp
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep
from repro_torch.core import autotune as ptune
from torch_tune import jax_decision

LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=2e-3, atol=1e-5)
STEPS = dict(rtol=1e-4, atol=0)
MODES = {"kernel": "fused", "bulk": "bulk", "fused": "fused"}   # port mode -> the reference's
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in MODES}
B, S = 8, 32


@pytest.fixture(scope="module")
def jctx():
    mesh = make_mesh((1, 1), ("data", "model"))
    return {m: JaxContext.from_mesh(mesh, fusion=JaxFusion(mode=m)) for m in MODES.values()}


@pytest.fixture(scope="module")
def models():
    jb = jax_get_arch("chatglm3-6b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, get_arch("chatglm3-6b").reduced(), jax.tree.map(np.asarray, jparams)


def _pparams(np_params):
    params = params_from_numpy(np_params)
    for p in popt.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(n=B, s=S, seed=0):
    return next(LMBatches(512, n, s, seed))


# ---------------------------------------------------------------------------
# the model: loss and every parameter's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["kernel", "bulk", "fused"])
def test_train_forward_loss_and_grads_match_jax(jctx, models, mode):
    """The loss and every gradient at tp = 1; fused mode's rings have no
    hops there (the KV ring's gradient is the analytic one, as kernel
    mode's on the CPU)."""
    jb, jparams, pb, np_params = models
    batch = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(jb.loss_fn(jctx[MODES[mode]])))(jparams, batch)
    params = _pparams(np_params)
    loss = pb.loss_fn(CPU[mode])(params, to_device(batch, "cpu"))
    grads = iter(torch.autograd.grad(loss, popt.tree_leaves(params)))
    grads = popt.tree_map(lambda _: next(grads), params)
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS)
    want = params_from_numpy(jax.tree.map(np.asarray, jgrads))
    assert len(popt.tree_leaves(want)) == 2 + 7 * pb.config.n_layers
    popt.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD,
                                                          err_msg=mode), grads, want)


def test_remat_changes_no_gradient(models):
    """Each layer under torch.utils.checkpoint (the config's remat) gives the
    gradients of the plain layer loop, bit for bit."""
    _, _, pb, np_params = models
    batch = to_device(_batch(), "cpu")
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(pb.config, remat=remat)
        bundle = dataclasses.replace(pb, config=cfg)
        params = _pparams(np_params)
        loss = bundle.loss_fn(CPU["kernel"])(params, batch)
        out[remat] = (loss,) + torch.autograd.grad(loss, popt.tree_leaves(params))
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_mode_backward_uses_the_analytic_attention(monkeypatch, models):
    """Kernel mode's attention gradient is flash_backward (the reference's
    ring-attention VJP), once per layer; bulk mode's is autograd."""
    from repro_torch.models import attention

    _, _, pb, np_params = models
    calls = []
    real = attention.flash_backward
    monkeypatch.setattr(attention, "flash_backward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = to_device(_batch(), "cpu")
    for mode, want in (("kernel", pb.config.n_layers), ("bulk", 0)):
        calls.clear()
        params = _pparams(np_params)
        pb.loss_fn(CPU[mode])(params, batch).backward()
        assert len(calls) == want, mode


# ---------------------------------------------------------------------------
# the step: six steps against the reference's jitted step
# ---------------------------------------------------------------------------
VARIANTS = {
    "adamw": (dict(name="adamw"), "none", 1),
    "adafactor": (dict(name="adafactor"), "none", 1),
    "int8": (dict(name="adamw"), "int8", 1),
    "topk": (dict(name="adamw"), "topk", 1),
    "microbatches2": (dict(name="adamw"), "none", 2),
}


def _configs(variant):
    opt, scheme, micro = VARIANTS[variant]
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=6, **opt)
    return (jstep.TrainConfig(optimizer=jopt.OptimizerConfig(**kw),
                              compression=jcomp.CompressionConfig(scheme=scheme),
                              microbatches=micro),
            pstep.TrainConfig(optimizer=popt.OptimizerConfig(**kw),
                              compression=pcomp.CompressionConfig(scheme=scheme),
                              microbatches=micro))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_six_steps_match_the_jax_step(jctx, models, variant):
    """Six steps from the same state on the same batches; then the JAX state
    after step 3, carried over by ``train_state_from_numpy``, continues in
    the port and matches the JAX steps 4-6."""
    jb, jparams, pb, _ = models
    jtc, ptc = _configs(variant)
    jfn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx["fused"]), jtc))
    pfn = pstep.build_train_step(pb.loss_fn(CPU["kernel"]), ptc)
    jstate = jstep.init_train_state(jtc, jparams)
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    batches = [next(it) for it in [JaxLMBatches(512, B, S, 0)] for _ in range(6)]
    jl, pl, mid = [], [], None
    for i, batch in enumerate(batches):
        jstate, jm = jfn(jstate, batch)
        pstate, pm = pfn(pstate, to_device(batch, "cpu"))
        jl.append(float(jm["loss"]))
        pl.append(pm["loss"].item())
        np.testing.assert_allclose(pm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        assert int(pm["step"]) == int(jm["step"]) == i + 1
        if i == 2:
            mid = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    np.testing.assert_allclose(pl, jl, **STEPS)
    resumed = [pfn(mid, to_device(b, "cpu"))[1]["loss"].item() for b in batches[3:]]
    np.testing.assert_allclose(resumed, jl[3:], **STEPS)
    assert jl[-1] < jl[0]


def test_train_state_from_numpy_keeps_the_layout(models):
    jb, jparams, pb, _ = models
    for name in ("adamw", "adafactor"):
        jtc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(name=name),
                                compression=jcomp.CompressionConfig(scheme="int8"))
        ptc = pstep.TrainConfig(optimizer=popt.OptimizerConfig(name=name),
                                compression=pcomp.CompressionConfig(scheme="int8"))
        got = train_state_from_numpy(jax.tree.map(np.asarray, jstep.init_train_state(jtc,
                                                                                    jparams)))
        own = pstep.init_train_state(ptc, pb.init_params(torch.Generator().manual_seed(0)))
        shapes = lambda tr: popt.tree_map(lambda t: (tuple(t.shape), t.dtype), tr)
        assert shapes(got) == shapes(own)
        assert all(p.requires_grad for p in popt.tree_leaves(got["params"]))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_matches_the_jax_loop(monkeypatch, jctx, models, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu --steps 6``
    (its defaults: 16 x 64 tokens, lr 3e-3, warmup 5, kernel mode) on the
    JAX init's weights: falling losses equal to the JAX loop's."""
    jb, jparams, _, np_params = models
    monkeypatch.setattr(registry.ArchBundle, "init_params",
                        lambda self, gen: params_from_numpy(np_params))
    got = launch_train.main(["--reduced", "--device", "cpu", "--steps", "6", "--log-every", "2"])
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                          total_steps=6))
    fn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx["fused"]), tc))
    state, want = jstep.init_train_state(tc, jparams), []
    it = JaxLMBatches(512, 16, 64, 0)
    for _ in range(6):
        state, m = fn(state, next(it))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, **STEPS)
    assert all(b < a for a, b in zip(got, got[1:]))
    out = capsys.readouterr().out
    assert out.count("gnorm") == 3 and "done at step 6" in out


TRAIN_CPU = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32"]


def _auto_run(argv, measured=()):
    """The launcher's losses with ``argv`` on a cleared tuner cache, and its
    decisions, each checked against the JAX package's on the same key
    (except the ops in ``measured``, whose decisions calibration took)."""
    ptune.clear_cache()
    losses = launch_train.main(TRAIN_CPU + argv)
    taken = ptune.cache_info()
    assert {k.op for k in taken} >= {"ce_ring"}
    for key, dec in taken.items():
        if key.op not in measured:
            assert tuple(dec) == jax_decision(key), key
    return losses, taken


@pytest.mark.parametrize("flag", ["granularity_auto", "calibrate", "tune_cache"])
def test_launcher_autotune_flags(tmp_path, capsys, flag):
    """--granularity auto, --calibrate and --tune-cache run: the CE takes
    the sub-chunks the tuner chose (the JAX package's decision), and the
    losses equal a run pinned to that q."""
    losses, taken = _auto_run(["--granularity", "auto"])
    (ce,) = [d for k, d in taken.items() if k.op == "ce_ring"]
    if flag == "granularity_auto":
        ptune.clear_cache()
        assert launch_train.main(TRAIN_CPU + ["--granularity", str(ce.q)]) == losses
    elif flag == "calibrate":
        got, measured = _auto_run(["--granularity", "auto", "--wire", "auto", "--calibrate",
                                   "--calibrate-iters", "1"],
                                  measured=("allgather_matmul", "matmul_reducescatter",
                                            "ce_ring"))
        out = capsys.readouterr().out
        assert re.search(r"calibrate: 3/3 newly traced hot keys", out), out
        assert re.search(r"calibrate: ce_ring .* model .* -> measured", out), out
        # the run on the CE's measured decision, pinned (the products' take
        # no sub-chunks or wire at tp = 1)
        (ce,) = [d for k, d in measured.items() if k.op == "ce_ring"]
        ptune.clear_cache()
        pinned = launch_train.main(TRAIN_CPU + ["--granularity", str(ce.q), "--wire", ce.wire])
        np.testing.assert_allclose(got, pinned, rtol=1e-6)
    else:
        path = str(tmp_path / "tune.json")
        _auto_run(["--granularity", "auto", "--tune-cache", path])
        ptune.clear_cache()
        assert ptune.load_cache(path) == len(taken)
        assert ptune.cache_info() == taken
        ptune.clear_cache()
        assert launch_train.main(TRAIN_CPU + ["--granularity", "auto",
                                              "--tune-cache", path]) == losses


# the runtime's flags run since the runtime was ported: the in-process ones
# (--skew-schedule, --chaos, --degrade, --ckpt-dir, --ckpt-every) in
# tests/test_torch_runtime.py, the multi-process ones (--coordinator,
# --num-processes, --process-id, --heartbeat-dir, --step-deadline, ...) in
# tests/test_torch_multiprocess_unit.py and tests/test_torch_respawn_*.py;
# their places hold refusals still standing
@pytest.mark.parametrize("argv,match", [
    (["--auto-fuse"], "item 7"), (["--explain-comm"], "item 7"),
    (["--arch", "deepseek-v3-671b", "--fusion", "bulk"], "item 7"),
    (["--production-mesh"], "item 1"),
    (["--arch", "rwkv6-7b"], "item 7"),
    (["--arch", "deepseek-v3-671b"], "item 7"),
])
def test_launcher_refuses_later_slices(argv, match):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {match}"):
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1"] + argv)


def test_launcher_refuses_dlrm_in_kernel_mode():
    """DLRM trains in bulk and fused mode; kernel mode (the launcher's
    default) raises before any step, naming the pooling kernel's missing
    backward, as the reference's kernel mode has none."""
    with pytest.raises(NotImplementedError, match="embedding_pool kernel has no backward"):
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1", "--arch", "dlrm",
                           "--fusion", "kernel"])


def test_launcher_trains_reduced_dbrx():
    """dbrx-132b (MoE, Adafactor, 2 microbatches) trains through the
    launcher: kernel mode (the MoE kernels' plain versions and their VJPs on
    the CPU) gives bulk mode's losses, and they fall."""
    argv = ["--arch", "dbrx-132b", "--reduced", "--device", "cpu", "--steps", "3",
            "--lr", "1e-2"]
    kernel = launch_train.main(argv + ["--fusion", "kernel"])
    assert len(kernel) == 3 and kernel[-1] < kernel[0]
    np.testing.assert_allclose(kernel, launch_train.main(argv + ["--fusion", "bulk"]),
                               rtol=1e-5)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# the registry, the data and the pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["chatglm3-6b", "dbrx-132b", "dlrm", "rwkv6-7b"])
def test_registry_training_fields_match_jax(name):
    jb, pb = jax_get_arch(name), get_arch(name)
    assert (pb.optimizer, pb.microbatches) == (jb.optimizer, jb.microbatches)
    if name == "rwkv6-7b":
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            pb.loss_fn(CPU["bulk"])
    else:
        assert callable(pb.loss_fn(CPU["bulk"]))


def test_lm_batches_match_jax():
    for seed in (0, 3):
        want, got = JaxLMBatches(512, 4, 16, seed), LMBatches(512, 4, 16, seed)
        for _ in range(3):
            w, g = next(want), next(got)
            assert set(w) == set(g) == {"tokens", "labels"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == np.int32


def test_prefetch_on_the_cpu_yields_every_batch_in_order():
    src = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = list(prefetch(iter(src), "cpu", depth=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor) and int(b["tokens"][0, 0]) == i


def test_replay_buffer_rewind_and_commit():
    rb = ReplayBuffer(iter(range(10)), base_step=2)
    assert [rb.next_batch() for _ in range(4)] == [0, 1, 2, 3]
    assert rb.step == 6
    rb.rewind(3)
    assert rb.next_batch() == 1          # step 3 re-serves the second batch
    rb.commit(5)
    with pytest.raises(ValueError, match="replay window"):
        rb.rewind(4)                     # pre-commit batches are gone
    rb.rewind(5)
    assert rb.next_batch() == 3
    short = ReplayBuffer(iter(range(2)))
    short.next_batch(), short.next_batch()
    with pytest.raises(StopIteration):
        short.next_batch()
