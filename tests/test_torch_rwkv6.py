"""The port's rwkv6 slice against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``repro_torch`` on the CPU.  The JAX WKV6 kernel runs in
interpret mode, as the JAX package's own tests run it; the model functions
run under the conftest ``ctx`` (a (2, 4) data x model mesh of CPU devices),
the port on one rank in kernel and bulk mode.  On the CPU the port's WKV6
wrapper runs its plain chunked version (the CUDA kernel runs only on a
card, in chip_smoke.py).  f32 throughout; matrix products in full f32.
The reference initialises ``mu``, ``w0`` and ``u`` to zeros, which would
hide the token shift, the decay's offset and the bonus, so every model row
here draws them at random.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.configs.registry import get_arch as jax_get_arch
from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import rwkv6 as jrwkv6
from repro.models.common import split_params
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_factored, wkv6_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import rwkv6
from repro_torch.models.convert import rwkv6_params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}
F32 = TOL["f32"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rkvwu(rng, b, T, h, n):
    """r, k, v, w [b, T, h, n] and u [h, n]: decays exp(-exp(N(0, 1))) with
    some at 0 and below the 1e-8 clip, and some within 1e-6 of 1."""
    r = rng.standard_normal((b, T, h, n)).astype(np.float32)
    k = rng.standard_normal((b, T, h, n)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, T, h, n)).astype(np.float32)
    w = np.exp(-np.exp(rng.standard_normal((b, T, h, n)))).astype(np.float32)
    pick = rng.random((b, T, h, n))
    w[pick < 0.05] = 1e-12
    w[(pick >= 0.05) & (pick < 0.07)] = 0.0
    w[pick > 0.95] = 1.0 - 1e-6
    u = rng.standard_normal((h, n)).astype(np.float32) * 0.5
    return r, k, v, w, u


def _fold(a):
    b, T, h, n = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, T, n)


# ---------------------------------------------------------------------------
# the WKV6 kernel's plain versions and wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,n", [(16, 8), (24, 16)])
def test_wkv6_ref_matches_jax_ref(rng, T, n):
    r, k, v, w, u = _rkvwu(rng, 2, T, 3, n)
    lw = np.log(np.clip(w, 1e-8, 1.0))
    uu = np.broadcast_to(u[None], (2, 3, n)).reshape(6, 1, n)
    want = np.asarray(jax_wkv6_ref(_fold(r), _fold(k), _fold(v), _fold(lw), uu))
    got = wkv6_ref(*(t(_fold(a)) for a in (r, k, v, lw)), t(uu))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("T,n,chunk", [(32, 8, 8), (64, 16, 16), (16, 8, 4),   # test_kernels' sweep
                                       (8, 16, 32), (48, 32, 16)])
def test_wkv6_op_matches_jax_kernel_and_chunked(rng, T, n, chunk):
    r, k, v, w, u = _rkvwu(rng, 2, T, 2, n)
    want_o = np.asarray(jax_wkv6(r, k, v, w, u, chunk=chunk))
    want_oc, want_s = jrwkv6.wkv6_chunked(r, k, v, w, u, jnp.zeros((2, 2, n, n)), chunk)
    wkv_ops.wkv6.launches = 0
    o, s = wkv_ops.wkv6(t(r), t(k), t(v), t(w), t(u), chunk=chunk)
    assert wkv_ops.wkv6.launches == 0                  # the CPU takes the plain version
    assert o.shape == r.shape and s.shape == (2, 2, n, n)
    np.testing.assert_allclose(o.numpy(), want_o, **F32)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_oc), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32)


def _clipped(rng, b, T, h, n, at_clip):
    """_rkvwu's operands with a share ``at_clip`` of the decays below the
    1e-8 clip (log decay -18.4 a step, so the -60 clip binds four steps
    apart) and the rest within 1e-6 of 1 or drawn as there."""
    r, k, v, w, u = _rkvwu(rng, b, T, h, n)
    pick = rng.random(w.shape)
    w[pick < at_clip] = 1e-12
    w[pick > 1 - (1 - at_clip) / 2] = 1.0 - 1e-6
    return r, k, v, w, u


@pytest.mark.parametrize("T,n,chunk", [(64, 8, 64), (96, 16, 32), (48, 8, 16), (40, 8, 20),
                                       (32, 4, 8), (24, 8, 24)])
@pytest.mark.parametrize("at_clip", [0.05, 0.5])
def test_wkv6_factored_matches_jax_kernel_and_chunked(rng, T, n, chunk, at_clip):
    """The CUDA kernel's factored pairwise decay, in its plain mirror,
    against the JAX kernel in interpret mode and the chunked form, with
    decays at the clip (where the factored form may differ, by at most
    e^-60 |r k| a term) and close to 1."""
    r, k, v, w, u = _clipped(rng, 2, T, 2, n, at_clip)
    want_o = np.asarray(jax_wkv6(r, k, v, w, u, chunk=chunk))
    want_oc, want_s = jrwkv6.wkv6_chunked(r, k, v, w, u, jnp.zeros((2, 2, n, n)), chunk)
    o, s = wkv6_factored(t(r), t(k), t(v), t(w), t(u), torch.zeros(2, 2, n, n), chunk)
    np.testing.assert_allclose(o.numpy(), want_o, **F32)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_oc), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_wkv6_factored_matches_chunked_from_a_state(rng, chunk):
    """From a non-zero state, over several chunks, against the port's own
    chunked form (the CPU path of the op)."""
    r, k, v, w, u = (t(a) for a in _clipped(rng, 2, 128, 3, 16, 0.2))
    S0 = t(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    o_f, s_f = wkv6_factored(r, k, v, w, u, S0, chunk)
    o_c, s_c = wkv6_chunked(r, k, v, w, u, S0, chunk)
    torch.testing.assert_close(o_f, o_c, **F32)
    torch.testing.assert_close(s_f, s_c, **F32)


def test_wkv6_factored_is_the_chunked_form_where_no_clip_binds(rng):
    """Decays in [0.5, 1): a chunk of 64 steps decays by at most e^-44.4,
    so no factor is clipped and the two forms differ by rounding only."""
    r, k, v, _, u = _rkvwu(rng, 2, 128, 2, 16)
    w = (0.5 + 0.5 * rng.random(r.shape)).astype(np.float32)
    got = wkv6_factored(*(t(a) for a in (r, k, v, w, u)), torch.zeros(2, 2, 16, 16), 64)
    want = wkv6_chunked(*(t(a) for a in (r, k, v, w, u)), torch.zeros(2, 2, 16, 16), 64)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


def test_wkv6_launch_operands_are_16_byte_aligned():
    """The kernel reads 16-byte vectors: an operand off that boundary is
    copied first, an aligned one is passed as it is."""
    base = torch.zeros(65)
    assert wkv_ops._aligned(base[:64]) is not None
    assert wkv_ops._aligned(base[:64]).data_ptr() == base.data_ptr()
    off = base[1:]
    assert off.data_ptr() % 16 != 0 and wkv_ops._aligned(off).data_ptr() % 16 == 0
    assert torch.equal(wkv_ops._aligned(off), off)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_wkv6_chunked_matches_step(rng, chunk):
    """As tests/test_recurrent.py holds the JAX pair, from a non-zero state."""
    B, T, H, N = 2, 32, 3, 8
    r, k, v, w, u = (t(a) for a in _rkvwu(rng, B, T, H, N))
    S0 = t(rng.standard_normal((B, H, N, N)).astype(np.float32))
    o_c, S_c = wkv6_chunked(r, k, v, w, u, S0, chunk)
    S, outs = S0, []
    for i in range(T):
        o, S = rwkv6.wkv6_step(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], w[:, i:i + 1], u, S)
        outs.append(o[:, 0])
    torch.testing.assert_close(o_c, torch.stack(outs, 1), **F32)
    torch.testing.assert_close(S_c, S, **F32)


def test_wkv6_step_matches_jax(rng):
    r, k, v, w, u = _rkvwu(rng, 3, 1, 2, 8)
    S = rng.standard_normal((3, 2, 8, 8)).astype(np.float32)
    want_o, want_s = jrwkv6.wkv6_step(r, k, v, w, u, S)
    o, s = rwkv6.wkv6_step(t(r), t(k), t(v), t(w), t(u), t(S))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32)


@pytest.mark.parametrize("bad", ["ragged_chunk", "u_shape", "operand_shape"])
def test_wkv6_wrapper_rejects_bad_input(rng, bad):
    r, k, v, w, u = (t(a) for a in _rkvwu(rng, 1, 12, 2, 8))
    args = {"ragged_chunk": ((r, k, v, w, u), 8), "u_shape": ((r, k, v, w, u[:1]), 4),
            "operand_shape": ((r, k[:, :8], v, w, u), 4)}[bad]
    with pytest.raises(ValueError):
        wkv_ops.wkv6(*args[0], chunk=args[1])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv6_chunked(r, k, v, w, u, torch.zeros(1, 2, 8, 8), 5)


def test_backward_through_the_wkv6_op_raises(rng):
    r, k, v, w, u = (t(a) for a in _rkvwu(rng, 1, 8, 2, 8))
    r.requires_grad_(True)
    o, _ = wkv_ops.wkv6(r, k, v, w, u, chunk=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        o.sum().backward()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """The reduced rwkv6 in both packages from one numpy tree: the JAX
    package's init, with mu, w0 and u drawn at random."""
    jb = jax_get_arch("rwkv6-7b").reduced()
    cfg = jb.config
    L, D = cfg.n_layers, cfg.d_model
    tree = jax.tree.map(np.asarray, split_params(jb.init_params(jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(7)
    tm, cm = tree["layers"]["tm"], tree["layers"]["cm"]
    tm["mu"] = rng.uniform(0, 1, (L, 5, D)).astype(np.float32)
    tm["w0"] = rng.normal(0, 1, (L, D)).astype(np.float32)
    tm["u"] = rng.normal(0, 0.5, (L, D)).astype(np.float32)
    cm["mu"] = rng.uniform(0, 1, (L, 2, D)).astype(np.float32)
    return jb, tree, get_arch("rwkv6-7b").reduced(), rwkv6_params_from_numpy(tree)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree["layers"])


def test_ddlerp_matches_jax(rng, models):
    _, tree, _, _ = models
    p = _layer(tree, 1)["tm"]
    x, xp = (rng.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jrwkv6._ddlerp(x, xp, p["mu"], p["lora_a"], p["lora_b"]))
    got = rwkv6._ddlerp(t(x), t(xp), t(p["mu"]), t(p["lora_a"]), t(p["lora_b"]))
    assert got.shape == (5, 2, 5, 64)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
@pytest.mark.parametrize("form", ["chunked", "step"])
def test_time_mix_matches_jax(ctx, rng, models, mode, form):
    jb, tree, pb, pparams = models
    cfg = jb.config
    H, N = cfg.n_heads, cfg.head_size
    p = _layer(tree, 1)["tm"]
    if form == "chunked":
        x = rng.standard_normal((4, 16, 64)).astype(np.float32)
        xp, S = None, None
    else:
        x, xp = (rng.standard_normal((4, 1, 64)).astype(np.float32) for _ in range(2))
        S = rng.standard_normal((4, H, N, N)).astype(np.float32) * 0.3
    want_y, want_s = jax.jit(lambda x, xp, S: jrwkv6.time_mix(ctx, p, cfg, x, xp, S))(x, xp, S)
    wrap = lambda a: None if a is None else t(a)
    y, s = rwkv6.time_mix(CPU[mode], pparams["layers"][1]["tm"], pb.config, t(x), wrap(xp),
                          wrap(S))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32)


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
@pytest.mark.parametrize("shifted", [False, True])
def test_channel_mix_matches_jax(ctx, rng, models, mode, shifted):
    _, tree, _, pparams = models
    p = _layer(tree, 0)["cm"]
    x = rng.standard_normal((4, 8 if not shifted else 1, 64)).astype(np.float32)
    xp = rng.standard_normal((4, 1, 64)).astype(np.float32) if shifted else None
    want = jax.jit(lambda x, xp: jrwkv6.channel_mix(ctx, p, x, xp))(x, xp)
    got = rwkv6.channel_mix(CPU[mode], pparams["layers"][0]["cm"], t(x),
                            None if xp is None else t(xp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# the slice: reduced rwkv6 prefill and decode against the JAX functions
# ---------------------------------------------------------------------------
def _assert_state_close(got, want):
    assert set(got) == set(want) == {"tm_x", "cm_x", "wkv"}
    for key in got:
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **F32, err_msg=key)


@pytest.fixture(scope="module")
def prefilled(ctx, models):
    """Both packages' prefill of one seeded batch [4, 32] (4 chunks of 8)."""
    jb, tree, pb, pparams = models
    tokens = np.random.default_rng(3).integers(0, jb.config.vocab, (4, 32)).astype(np.int32)
    jl, js = jax.jit(jb.prefill_fn(ctx))(tree, {"tokens": tokens})
    port = {m: pb.prefill_fn(CPU[m])(pparams, {"tokens": t(tokens)}) for m in CPU}
    return tokens, (jl, js), port


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_prefill_matches_jax(prefilled, mode):
    _, (jl, js), port = prefilled
    logits, state = port[mode]
    assert logits.shape == (4, 1, 512) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **F32)
    _assert_state_close(state, js)


@pytest.mark.parametrize("start", ["init_state", "prefill"])
def test_decode_steps_match_jax(ctx, models, prefilled, start):
    jb, tree, pb, pparams = models
    _, (_, js), port = prefilled
    B = 4
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(tree, tk, c, p))
    if start == "init_state":
        jstate, pstate = jb.init_cache(B), pb.init_cache(B, "cpu")
        _assert_state_close(pstate, jstate)
    else:
        jstate, pstate = js, port["kernel"][1]
    rng = np.random.default_rng(5)
    pdec = pb.decode_fn(CPU["kernel"])
    for s in range(8):
        tok = rng.integers(0, jb.config.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), s, np.int32)
        jl, jstate = jdec(tok, jstate, pos)
        before = {k: v.clone() for k, v in pstate.items()}
        pl, new = pdec(pparams, t(tok), pstate, t(pos))
        for k in pstate:                               # the state passed in is left as it was
            assert torch.equal(pstate[k], before[k]), k
        pstate = new
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **F32, err_msg=f"step {s}")
    _assert_state_close(pstate, jstate)


def test_prefill_hands_off_to_decode(models, prefilled):
    """Prefill of a prompt = decode steps over it from the zeroed state."""
    _, _, pb, pparams = models
    tokens, _, port = prefilled
    logits_p, state_p = port["bulk"]
    state = pb.init_cache(4, "cpu")
    dec = pb.decode_fn(CPU["bulk"])
    for i in range(tokens.shape[1]):
        logits, state = dec(pparams, t(tokens[:, i:i + 1]), state, None)
    torch.testing.assert_close(logits, logits_p, **F32)
    for k in state:
        torch.testing.assert_close(state[k], state_p[k], **F32)


# ---------------------------------------------------------------------------
# parameters, registry, launcher
# ---------------------------------------------------------------------------
def test_rwkv6_params_from_numpy(models):
    jb, tree, _, pparams = models
    L = jb.config.n_layers
    assert len(pparams["layers"]) == L
    np.testing.assert_array_equal(pparams["embed"]["table"].numpy(), tree["embed"]["table"])
    for i in range(L):
        want = _layer(tree, i)
        got = jax.tree.map(lambda a: a.numpy(), pparams["layers"][i])
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(np.testing.assert_array_equal, got, want)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), {"layers": tree["layers"],
                                                              "embed": tree["embed"],
                                                              "final_norm": tree["final_norm"]})
    conv = rwkv6_params_from_numpy(jax.tree.map(np.asarray, bf))
    assert conv["layers"][1]["tm"]["w_r"].dtype == torch.bfloat16
    np.testing.assert_array_equal(conv["layers"][1]["tm"]["w_r"].float().numpy(),
                                  np.asarray(bf["layers"]["tm"]["w_r"][1], np.float32))


def test_port_init_follows_the_reference_tree(models):
    jb, tree, pb, _ = models
    p = pb.init_params(torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)), tree["layers"])
    for layer in p["layers"]:
        assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), layer) == want
    for key in ("mu", "w0", "u"):                   # zeros, as the reference's init
        assert not p["layers"][0]["tm"][key].any()
    assert p["layers"][0]["tm"]["lora_a"].std().item() < 0.02


def test_full_width_param_shapes_match_reference(monkeypatch):
    """rwkv6-7b's full-width tree, shapes and dtypes, without allocating
    its 14.7 GB: jax.eval_shape against the port's init with its large
    initialisers drawing on the meta device."""
    jb, pb = jax_get_arch("rwkv6-7b"), get_arch("rwkv6-7b")
    want = jax.eval_shape(lambda k: split_params(jb.init_params(k))[0], jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    meta = lambda gen, shape, dtype, *a, **kw: torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(rwkv6, "dense_init", meta)
    monkeypatch.setattr("repro_torch.models.layers.embed_init", meta)
    p = pb.init_params(torch.Generator().manual_seed(0))
    assert p["embed"]["table"].device.type == "meta"
    got = {"embed": {"table": (tuple(p["embed"]["table"].shape), "bfloat16")},
           "final_norm": (tuple(p["final_norm"].shape), "float32"),
           "layers": jax.tree.map(lambda *a: ((len(a),) + tuple(a[0].shape), str(a[0].dtype)[6:]),
                                  *p["layers"])}
    assert got == want
    n_params = sum(int(np.prod(s)) for s, _ in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[1], str)))
    assert 7.3e9 < n_params < 7.4e9


def test_registry_rwkv6_entry_points(models):
    jb, _, pb, _ = models
    for full in (False, True):
        jcfg = jax_get_arch("rwkv6-7b").config if full else jb.config
        pcfg = get_arch("rwkv6-7b").config if full else pb.config
        for f in dataclasses.fields(jcfg):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
        assert (pcfg.n_heads, pcfg.sub_quadratic) == (jcfg.n_heads, True)
    assert pb.family == jb.family == "rwkv6"
    assert pb.shapes() == jb.shapes()
    assert "long_500k" in pb.shapes() and "long_500k" not in get_arch("chatglm3-6b").shapes()
    assert callable(get_arch("dbrx-132b").prefill_fn(CPU["bulk"]))   # MoE prefills too
    with pytest.raises(ValueError, match="does not prefill"):
        get_arch("dlrm").prefill_fn(CPU["bulk"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        pb.loss_fn(CPU["bulk"])


def test_launcher_refuses_rwkv6():
    with pytest.raises(NotImplementedError, match="serve.py:146.*Queue 3"):
        launch_serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu"])
