"""The port's decode modules and dense decode step against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function
(under the conftest ``ctx``: a (2, 4) data x model mesh of CPU devices)
and its counterpart in ``repro_torch`` on the CPU (one rank).  f32
throughout; matrix products in full f32 (TF32 off for cuBLAS and cuDNN).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.configs.registry import get_arch
from repro_torch.core.matmul_allreduce import matmul_allreduce
from repro_torch.models import attention, layers, rope
from repro_torch.models.common import dense_init, embed_init
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from torch_tune import clear_both, same_decisions, v5e_ctx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# TOL["f32"] of tests/test_parity_matrix.py: f32 sums in another order
TOL = dict(rtol=3e-4, atol=3e-4)
CPU_KERNEL = ParallelContext(device="cpu", fusion=FusionConfig(mode="kernel"))
CPU_BULK = ParallelContext(device="cpu", fusion=FusionConfig(mode="bulk"))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# module rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(rng, plus_one):
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jlayers.rms_norm(x, w, 1e-5, plus_one=plus_one))
    got = layers.rms_norm(t(x), t(w), 1e-5, plus_one=plus_one)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("style", ["2d", "full"])
def test_rope_matches_jax(rng, style):
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    if style == "2d":
        want, got = jrope.apply_rope_2d(x, pos), rope.apply_rope_2d(t(x), t(pos))
    else:
        want, got = jrope.apply_rope(x, pos), rope.apply_rope(t(x), t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cache_update_matches_jax_and_drops_past_end(ctx, rng):
    B, S = 4, 16
    cache = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    new = rng.standard_normal((B, 1, 2, 8)).astype(np.float32)
    pos = np.array([0, 5, 15, 16], np.int32)       # slot 3 is at S_max
    want = np.asarray(jax.jit(lambda c, n, p: jattn.cache_update(ctx, c, n, p))(
        cache, new, pos))
    got_t = t(cache.copy())
    out = attention.cache_update(CPU_KERNEL, got_t, t(new), t(pos))
    assert out is got_t                           # in place
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy()[3], cache[3])   # write dropped
    np.testing.assert_array_equal(got_t.numpy()[2, 15], new[2, 0])


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 2.0)])
def test_decode_attention_matches_jax(ctx, rng, window, softcap):
    B, S, Hq, Hkv, hd = 4, 16, 4, 2, 8
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    pos = np.array([0, 3, 15, 9], np.int32)
    want = np.asarray(jax.jit(lambda q, k, v, p: jattn.decode_attention(
        ctx, q, k, v, p, window=window, softcap_val=softcap))(q, k, v, pos))
    got = attention.decode_attention(CPU_KERNEL, t(q), t(k), t(v), t(pos),
                                     window=window, softcap_val=softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the slice: reduced chatglm3-6b decode against the JAX decode step
# ---------------------------------------------------------------------------
def _jax_and_port(cfg_over=None):
    jb = jax_get_arch("chatglm3-6b").reduced()
    if cfg_over:
        jb = dataclasses.replace(jb, config=dataclasses.replace(jb.config, **cfg_over))
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch("chatglm3-6b").reduced()
    pb = dataclasses.replace(pb, config=dataclasses.replace(pb.config, **(cfg_over or {})))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jb, jparams, pb, pparams


def _decode_parity(ctx, rng, cfg_over, steps, pos_stride=1):
    jb, jparams, pb, pparams = _jax_and_port(cfg_over)
    B = 4
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
    pdec = pb.decode_fn(CPU_KERNEL)
    jcache, pcache = jb.init_cache(B), pb.init_cache(B, "cpu")
    for s in range(steps):
        tok = rng.integers(0, pb.config.vocab, (B, 1)).astype(np.int32)
        pos = (s * pos_stride + np.arange(B)).astype(np.int32)   # per-slot positions
        jl, jcache = jdec(tok, jcache, pos)
        pl, pcache = pdec(pparams, t(tok), pcache, t(pos))
        assert pl.shape == (B, 1, pb.config.vocab) and pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {s}")
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(),
                                   np.asarray(jcache["scan"][name]), **TOL)


def test_decode_steps_match_jax(ctx, rng):
    """6 decode steps of reduced chatglm3-6b (f32): logits at TOL["f32"]."""
    _decode_parity(ctx, rng, None, steps=6)


@pytest.mark.parametrize("over", [
    {"window": 4}, {"window": 4, "local_global_period": 2},
    {"attn_softcap": 2.0}, {"logit_softcap": 3.0}, {"post_norms": True},
    {"embed_scale": True}, {"norm_plus_one": True}, {"query_scale": 0.1},
    {"act": "gelu"}, {"rope_style": "full"},
    # decode is the text phase: M-RoPE on three equal streams (its sections
    # fit head_dim 16), and a front end adds nothing to a decode step
    {"rope_style": "mrope", "mrope_sections": (2, 3, 3)}, {"frontend": "audio"},
], ids=lambda o: ",".join(o))
def test_decode_options_match_jax(ctx, rng, over):
    """Each option chatglm3 leaves off, ported and held to the reference."""
    _decode_parity(ctx, rng, over, steps=3, pos_stride=3)


def test_params_from_numpy_round_trips_bf16():
    jb = jax_get_arch("chatglm3-6b").reduced()
    jb = dataclasses.replace(jb, config=dataclasses.replace(jb.config,
                                                            param_dtype="bfloat16"))
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(1)))
    tree = jax.tree.map(np.asarray, jparams)
    assert tree["embed"]["table"].dtype.name == "bfloat16"
    p = params_from_numpy(tree)
    assert p["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"]["table"].float().numpy(),
                                  tree["embed"]["table"].astype(np.float32))
    assert len(p["layers"]) == jb.config.n_layers
    for i, lp in enumerate(p["layers"]):
        w = tree["layers"]["l0"]["ffn"]["w_down"][i]
        assert lp["ffn"]["w_down"].dtype == torch.bfloat16
        np.testing.assert_array_equal(lp["ffn"]["w_down"].float().numpy(),
                                      w.astype(np.float32))


# ---------------------------------------------------------------------------
# matmul_allreduce, the parallel context, init, registry
# ---------------------------------------------------------------------------
def test_matmul_allreduce_kernel_equals_bulk_and_jax(ctx, rng):
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, w: jlayers.matmul_allreduce(
        ctx, x, w, mode="bulk"))(x, w))
    for pctx in (CPU_KERNEL, CPU_BULK):
        got = matmul_allreduce(pctx, t(x), t(w))
        assert got.shape == (4, 1, 32)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kwargs", [{"mode": "fused", "chunks_per_rank": "auto"},
                                    {"wire": "auto"}, {"chunks_per_rank": "auto"}])
def test_matmul_allreduce_auto_choices_match_jax(rng, kwargs):
    """The 'auto' choices resolve through the autotuner, in kernel and fused
    mode: the JAX package's decision on the same inputs under the same link
    constants (its one-device mesh), and its product."""
    x = rng.standard_normal((8, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    jc = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")), fusion=JaxFusion())
    clear_both()
    want = np.asarray(jax.jit(lambda x, w: jlayers.matmul_allreduce(
        jc, x, w, **dict(kwargs, mode="fused")))(x, w))
    got = matmul_allreduce(v5e_ctx(mode="kernel"), t(x), t(w), **kwargs)
    assert len(same_decisions()) == 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matmul_allreduce_fp8_wire_clamps_to_bf16():
    x, w = torch.ones(2, 8), torch.ones(8, 4)
    with pytest.warns(UserWarning, match="bf16"):
        y = matmul_allreduce(CPU_KERNEL, x, w, wire="fp8")
    assert torch.equal(y, x @ w)


@pytest.mark.parametrize("kwargs", [{"tp": 2}, {"dp": 2}])
def test_parallel_context_world_above_one_raises(kwargs):
    """tp > 1 and dp > 1 need a started world (none here)."""
    with pytest.raises(RuntimeError, match="init_world"):
        ParallelContext(device="cpu", **kwargs)


def test_parallel_context_defaults_to_cuda():
    if torch.cuda.is_available():
        assert ParallelContext().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParallelContext()


def test_layers_training_paths_raise():
    """The sequence-sharded paths run at tp = 1 in every mode (the prefill's
    and the training's); their gradients at tp > 1 are held to the JAX
    package's in tests/test_torch_ring_train.py."""
    p = {"w_gate": torch.ones(4, 8), "w_up": torch.ones(4, 8), "w_down": torch.ones(8, 4)}
    x = torch.ones(1, 2, 4)
    for c in (CPU_KERNEL, ParallelContext(device="cpu")):
        torch.testing.assert_close(layers.mlp_apply(c, p, x, seq_sharded=True),
                                   layers.mlp_apply(CPU_BULK, p, x, seq_sharded=False))
    table, tokens = torch.randn(8, 4), torch.tensor([[0, 7, 8, -1]])
    torch.testing.assert_close(
        layers.embedding_lookup(CPU_KERNEL, {"table": table}, tokens, seq_shard=True),
        layers.embedding_lookup(CPU_KERNEL, {"table": table}, tokens, seq_shard=False))


def test_embedding_out_of_vocab_is_zero(ctx):
    table = np.arange(32, dtype=np.float32).reshape(8, 4) + 1
    tokens = np.array([[0, 7, 8, -1]], np.int32)
    want = np.asarray(jax.jit(lambda tk, tb: jlayers.embedding_lookup(
        ctx, {"table": tb}, tk, seq_shard=False))(np.repeat(tokens, 2, 0), table))[:1]
    got = layers.embedding_lookup(CPU_KERNEL, {"table": t(table)}, t(tokens),
                                  seq_shard=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0, 2:].any()


def test_initialisers_follow_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = dense_init(gen, (256, 512), torch.float32)
    bound = 2 * 256 ** -0.5                       # the cut at +-2 std
    assert w.abs().max() <= bound + 1e-6
    # a unit normal cut at +-2 has std 0.8796
    assert abs(w.std().item() / 256 ** -0.5 - 0.8796) < 0.02
    e = embed_init(gen, (512, 64), torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(e.float().std().item() - 0.02) < 1e-3
    p = get_arch("chatglm3-6b").reduced().init_params(gen)
    cfg = get_arch("chatglm3-6b").reduced().config
    assert p["layers"][0]["ffn"]["w_down"].shape == (cfg.d_ff, cfg.d_model)
    assert len(p["layers"]) == cfg.n_layers


def test_registry_matches_reference_reduced_config():
    jcfg = jax_get_arch("chatglm3-6b").reduced().config
    pcfg = get_arch("chatglm3-6b").reduced().config
    for f in dataclasses.fields(pcfg):
        if f.name not in ("mla", "moe"):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    full = get_arch("chatglm3-6b").config
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab) == (28, 4096, 13696, 65024)
    assert get_arch("qwen2-vl-2b").config.rope_style == "mrope"
    with pytest.raises(KeyError):
        get_arch("no-such-model")
