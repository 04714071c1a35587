"""The port's optimizers and gradient compression against the JAX package.

The same numpy parameters, gradients and states, made from a seed, go
through each JAX update and its counterpart in ``repro_torch.train`` (in
place, leaf by leaf) on the CPU.  The trees have the JAX package's layout
(its layers stacked, as its scan keeps them) and reach the port through
``params_from_numpy`` (one dict per layer).  f32 updates agree to f32
rounding (rtol 1e-5); bf16 state and parameters to one bf16 step
(TOL["bf16"]).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.train import grad_compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import grad_compression as pcomp
from repro_torch.train import optimizer as popt
from repro_torch.train.step import TrainConfig, train_state_specs

F32 = dict(rtol=1e-5, atol=1e-7)
BF16 = TOL["bf16"]


def _tree(rng):
    """A small parameter tree in the JAX layout: a table and a norm, and two
    layers (a matrix and a norm each) stacked as the reference's scan keeps
    them."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": {"table": f(12, 8)}, "final_norm": f(8),
            "layers": {"l0": {"w": f(2, 8, 6), "ln": f(2, 8)}}}


def _torch(tree, dtype=torch.float32):
    """The port's layout of a JAX-layout tree (one dict per layer)."""
    return popt.tree_map(lambda t: t.to(dtype),
                         params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), tree)))


def _close(got, want, tol):
    """Leaf by leaf, matched by the trees' keys (JAX orders leaves by key)."""
    popt.tree_map(lambda g, w: np.testing.assert_allclose(g.float().numpy(), w.numpy(), **tol),
                  got, _torch(want))


@pytest.mark.parametrize("cfg", [
    popt.OptimizerConfig(),
    popt.OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=6),
    popt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10, min_lr_ratio=0.0),
])
def test_lr_schedule_matches_jax(cfg):
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 2, 5, 6, 7, 50, 100, 101, 5000, 10_000, 20_000):
        got = popt.lr_schedule(cfg, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(jopt.lr_schedule(jcfg, jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(rng, max_norm):
    grads = _tree(rng)
    want, wnorm = jopt.clip_by_global_norm(grads, max_norm)
    got, norm = popt.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    _close(got, want, F32)


def test_clip_by_global_norm_bf16_rounds_once(rng):
    grads = _tree(rng)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)
    want, wnorm = jopt.clip_by_global_norm(jg, 0.5)
    got, norm = popt.clip_by_global_norm(_torch(grads, torch.bfloat16), 0.5)
    assert all(g.dtype == torch.bfloat16 for g in popt.tree_leaves(got))
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    _close(got, want, dict(rtol=2 ** -7, atol=0))


@pytest.mark.parametrize("name,state_dtype", [("adamw", "float32"), ("adamw", "bfloat16"),
                                              ("adafactor", "float32")])
def test_optimizer_updates_match_jax(rng, name, state_dtype):
    """Three updates from zero state on the same gradients."""
    cfg = popt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2, total_steps=10,
                               state_dtype=state_dtype)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    params = _tree(rng)
    jinit, jupd = jopt.make_optimizer(jcfg)
    pinit, pupd = popt.make_optimizer(cfg)
    jp, jstate = params, jinit(jcfg, params)
    pp = _torch(params)
    pstate = pinit(cfg, pp)
    tol = F32 if state_dtype == "float32" else BF16
    for step in range(3):
        grads = _tree(np.random.default_rng(step))
        jp, jstate, jlr = jupd(jcfg, grads, jstate, jp)
        out, pstate, plr = pupd(cfg, _torch(grads), pstate, pp)
        assert out is pp                               # updated in place
        np.testing.assert_allclose(plr.item(), float(jlr), rtol=1e-6)
        assert int(pstate["step"]) == int(jstate["step"]) == step + 1
        _close(pp, jp, tol)
        if name == "adamw":
            for key in ("mu", "nu"):
                assert all(t.dtype == popt.DTYPES[state_dtype]
                           for t in popt.tree_leaves(pstate[key]))
                _close(pstate[key], jstate[key], tol)
        else:
            # the reference's stacked factored state, kept stacked by the port
            want = {**jstate["v"], "layers": jstate["v"]["layers"]["l0"]}
            popt.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                                                  **F32), pstate["v"], want)


def test_adamw_bf16_params_and_state_match_jax(rng):
    """bf16 parameters and bf16 moments: each value rounds once per update."""
    cfg = popt.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4, state_dtype="bfloat16")
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    params = _tree(rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jstate = jopt.adamw_init(jcfg, jp)
    pp = _torch(params, torch.bfloat16)
    pstate = popt.adamw_init(cfg, pp)
    for step in range(2):
        grads = _tree(np.random.default_rng(10 + step))
        jp, jstate, _ = jopt.adamw_update(jcfg, jax.tree.map(
            lambda a: jnp.asarray(a, jnp.bfloat16), grads), jstate, jp)
        popt.adamw_update(cfg, _torch(grads, torch.bfloat16), pstate, pp)
        assert all(t.dtype == torch.bfloat16 for t in popt.tree_leaves(pp))
        _close(pp, jp, BF16)
        _close(pstate["mu"], jstate["mu"], BF16)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_with_error_feedback_matches_jax(rng, scheme):
    cfg = pcomp.CompressionConfig(scheme=scheme, topk_ratio=0.2)
    jcfg = jcomp.CompressionConfig(scheme=scheme, topk_ratio=0.2)
    params = _tree(rng)
    jres = jcomp.init_residuals(jcfg, params)
    pres = pcomp.init_residuals(cfg, _torch(params))
    for step in range(3):
        grads = _tree(np.random.default_rng(20 + step))
        jg, jres = jcomp.compress_decompress(jcfg, grads, jres)
        pg, out_res = pcomp.compress_decompress(cfg, _torch(grads), pres)
        assert out_res is pres                         # residuals updated in place
        _close(pg, jg, F32)
        _close(pres, jres, F32)


def test_compression_none_is_the_identity(rng):
    cfg = pcomp.CompressionConfig()
    grads = _torch(_tree(rng))
    assert pcomp.init_residuals(cfg, grads) == {}
    out, res = pcomp.compress_decompress(cfg, grads, {})
    assert out is grads and res == {}


def test_tree_helpers_keep_the_layout(rng):
    tree = _torch(_tree(rng))
    leaves = popt.tree_leaves(tree)
    assert len(leaves) == 2 + 2 * 2
    groups = popt.leaf_groups(tree)
    assert [(path, len(ts), stacked) for path, ts, stacked in groups] == [
        (("embed", "table"), 1, False), (("final_norm",), 1, False),
        (("layers", "ln"), 2, True), (("layers", "w"), 2, True)]
    assert groups[3][1][1] is tree["layers"][1]["w"]
    doubled = popt.tree_map(lambda a, b: a + b, tree, tree)
    assert set(doubled) == set(tree) and len(doubled["layers"]) == 2
    torch.testing.assert_close(doubled["layers"][1]["w"], 2 * tree["layers"][1]["w"])


def _jax_specs(arch):
    """The JAX package's parameter specs of the reduced ``arch`` (its layers
    stacked under ``"l0"``, ``"l1"``, ...) and the port's of the same model
    (one dict per layer)."""
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.models.common import split_params
    from repro_torch.configs.registry import get_arch

    _, jspecs = split_params(jax.eval_shape(jax_get_arch(arch).reduced().init_params,
                                            jax.random.PRNGKey(0)))
    bundle = get_arch(arch).reduced()
    pspecs = bundle.param_specs(bundle.init_params(torch.Generator().manual_seed(0)))
    return jspecs, pspecs, bundle.config.local_global_period or 1


def _stacked(layers, period):
    """The port's per-layer specs as the reference stacks them: position j
    of the pattern under "l<j>", with a leading (unsharded) layer axis."""
    return {f"l{j}": jax.tree.map(lambda sp: (None,) + sp, layers[j],
                                  is_leaf=lambda x: isinstance(x, tuple))
            for j in range(period)}


@pytest.mark.parametrize("what", ["optimizer", "train_state", "name"])
def test_specs_and_unknown_optimizer_raise(what):
    """AdamW's and Adafactor's state specs and the train state's against the
    JAX package's, on reduced chatglm3-6b and gemma2-27b (layer period 2);
    an unknown optimizer raises."""
    if what == "name":
        with pytest.raises(ValueError, match="sgd"):
            popt.make_optimizer(popt.OptimizerConfig(name="sgd"))
        return
    is_spec = lambda x: isinstance(x, tuple)
    for arch in ("chatglm3-6b", "gemma2-27b"):
        jspecs, pspecs, period = _jax_specs(arch)
        assert all(lp == pspecs["layers"][i % period] for i, lp in enumerate(pspecs["layers"]))
        as_jax = {**{k: v for k, v in pspecs.items() if k != "layers"},
                  "layers": _stacked(pspecs["layers"], period)}
        assert as_jax == jspecs
        for name in ("adamw", "adafactor"):
            cfg = popt.OptimizerConfig(name=name)
            want = jopt.optimizer_state_specs(jopt.OptimizerConfig(name=name), jspecs)
            if what == "optimizer":
                got = popt.optimizer_state_specs(cfg, pspecs, period)
            else:
                tc = TrainConfig(optimizer=cfg, layer_period=period)
                got = train_state_specs(tc, pspecs)
                assert got["params"] is pspecs and "residuals" not in got
                got = got["opt"]
            if name == "adamw":
                for key in ("mu", "nu"):
                    assert got[key] is pspecs
                    got = {**got, key: as_jax}
            else:
                v = got["v"]
                layers = v["layers"] if period > 1 else {"l0": v["layers"]}
                got = {**got, "v": {**v, "layers": layers}}
            assert jax.tree.map(tuple, got, is_leaf=is_spec) == jax.tree.map(
                tuple, want, is_leaf=is_spec), (arch, name)
