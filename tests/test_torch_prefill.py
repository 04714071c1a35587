"""The port's dense transformer prefill against the JAX package.

The same numpy inputs and parameters, made from a seed, go through each JAX
function (under the conftest ``ctx``: a (2, 4) data x model mesh of CPU
devices, default fusion) and its counterpart in ``repro_torch`` on the CPU
(one rank, kernel and bulk mode; on the CPU the attention runs the plain
``_span_flash``).  f32 throughout (the reduced config); matrix products in
full f32.  The prompt length 32 splits evenly over the 4 model ranks and
into the reference's attention blocks, so the JAX functions are sound here
(see ``test_span_flash_ragged_computes_every_row``).
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
from repro.core import allgather_matmul as jagmm
from repro.models import layers as jlayers
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.configs.registry import get_arch
from repro_torch.core.allgather_matmul import allgather_matmul, matmul_reducescatter
from repro_torch.models import attention, layers, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from torch_tune import clear_both, same_decisions, v5e_ctx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}
F32 = TOL["f32"]
B, S = 4, 32


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# module rows: the sequence-parallel products, the MLP and the embedding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jax_mode", ["bulk", "fused"])
def test_allgather_matmul_and_reducescatter_match_jax(ctx, rng, jax_mode):
    x = rng.standard_normal((4, 16, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 32)) / 5).astype(np.float32)
    want_ag = np.asarray(jax.jit(lambda x, w: jagmm.allgather_matmul(
        ctx, x, w, mode=jax_mode))(x, w))
    want_rs = np.asarray(jax.jit(lambda x, w: jagmm.matmul_reducescatter(
        ctx, x, w, mode=jax_mode))(x, w))
    for mode, c in CPU.items():
        np.testing.assert_allclose(allgather_matmul(c, t(x), t(w)).numpy(), want_ag, **F32,
                                   err_msg=mode)
        np.testing.assert_allclose(matmul_reducescatter(c, t(x), t(w)).numpy(), want_rs, **F32,
                                   err_msg=mode)


@pytest.mark.parametrize("op", [allgather_matmul, matmul_reducescatter])
def test_sequence_parallel_products_refuse_fused_mode(op):
    """Fused mode runs at op level (at tp = 1 the ring has no hops and gives
    the product), its 'auto' granularity resolving to the JAX package's
    decision under the same link constants; the sequence-sharded MLP in
    fused mode at tp = 1 is kernel mode's (its rings have no hops)."""
    x, w = torch.randn(1, 4, 8), torch.randn(8, 8)
    torch.testing.assert_close(op(ParallelContext(device="cpu"), x, w), x @ w)
    jc = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                              fusion=JaxFusion(granularity="auto"))
    clear_both()
    jax.eval_shape(lambda x, w: getattr(jagmm, op.__name__)(jc, x, w), x.numpy(), w.numpy())
    torch.testing.assert_close(op(v5e_ctx(granularity="auto"), x, w), x @ w)
    assert len(same_decisions()) == 1
    p = {"w_gate": w, "w_up": w, "w_down": w}
    fused = layers.mlp_apply(ParallelContext(device="cpu"), p, x, seq_sharded=True)
    torch.testing.assert_close(fused, layers.mlp_apply(CPU["kernel"], p, x, seq_sharded=True))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply_seq_sharded_matches_jax(ctx, rng, act):
    d, f = 32, 48
    x = rng.standard_normal((4, 16, d)).astype(np.float32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    want = np.asarray(jax.jit(lambda p, x: jlayers.mlp_apply(ctx, p, x, act=act,
                                                           seq_sharded=True))(p, x))
    tp = {k: t(v) for k, v in p.items()}
    for mode, c in CPU.items():
        got = layers.mlp_apply(c, tp, t(x), act=act, seq_sharded=True)
        np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=mode)


def test_embedding_lookup_seq_shard_matches_jax(ctx, rng):
    table = rng.standard_normal((64, 16)).astype(np.float32)
    tokens = rng.integers(0, 64, (4, 16)).astype(np.int32)
    tokens[0, :3] = [-1, 64, 1000]                       # outside the vocabulary: zeros
    want = np.asarray(jax.jit(lambda p, tk: jlayers.embedding_lookup(
        ctx, p, tk, seq_shard=True))({"table": table}, tokens))
    got = layers.embedding_lookup(CPU["kernel"], {"table": t(table)}, t(tokens), seq_shard=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0, :3].any()


# ---------------------------------------------------------------------------
# the slice: reduced chatglm3-6b prefill against the JAX prefill
# ---------------------------------------------------------------------------
def _models(cfg_over=None):
    jb = jax_get_arch("chatglm3-6b").reduced()
    pb = get_arch("chatglm3-6b").reduced()
    if cfg_over:
        jb = dataclasses.replace(jb, config=dataclasses.replace(jb.config, **cfg_over))
        pb = dataclasses.replace(pb, config=dataclasses.replace(pb.config, **cfg_over))
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, pb, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _prefill_both(ctx, models, tokens):
    jb, jparams, pb, pparams = models
    jout = jax.jit(jb.prefill_fn(ctx))(jparams, {"tokens": tokens})
    port = {m: pb.prefill_fn(CPU[m])(pparams, {"tokens": t(tokens)}) for m in CPU}
    return jout, port


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(3).integers(0, 512, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(ctx, models, prompt):
    return _prefill_both(ctx, models, prompt)


def _assert_prefill_close(jout, port, vocab, n_layers):
    jl, jcache = jout
    for mode, (logits, cache) in port.items():
        assert logits.shape == (B, 1, vocab) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **F32, err_msg=mode)
        assert set(cache) == {"k", "v"}
        for key in cache:
            want = np.asarray(jcache["scan"][key])             # [L, B, S, Hkv, hd]
            assert tuple(cache[key].shape) == want.shape and want.shape[0] == n_layers
            for i in range(n_layers):
                np.testing.assert_allclose(cache[key][i].numpy(), want[i], **F32,
                                           err_msg=f"{mode} layer {i} {key}")


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_prefill_matches_jax(prefilled, models, mode):
    jout, port = prefilled
    cfg = models[2].config
    _assert_prefill_close(jout, {mode: port[mode]}, cfg.vocab, cfg.n_layers)


@pytest.mark.parametrize("over", [{"window": 12}, {"attn_softcap": 5.0, "logit_softcap": 30.0}])
def test_prefill_window_and_softcap_match_jax(ctx, prompt, over):
    """The plain attention's window and softcap through the whole model (on
    a card kernel mode computes both in the flash kernel)."""
    models = _models(over)
    cfg = models[2].config
    _assert_prefill_close(*_prefill_both(ctx, models, prompt), cfg.vocab, cfg.n_layers)


def test_prefill_reads_the_decode_parameters(models):
    """The prefill needs no converter of its own: ``params_from_numpy`` (the
    decode slice's) gives the tree the port's own init makes, and both
    entry points take it."""
    _, _, pb, pparams = models
    own = pb.init_params(torch.Generator().manual_seed(0))
    shapes = lambda p: jax.tree.map(lambda a: (tuple(a.shape), a.dtype), p)
    assert shapes(own) == shapes(pparams)
    tokens = torch.zeros((2, 5), dtype=torch.long)
    logits, cache = pb.prefill_fn(CPU["kernel"])(pparams, {"tokens": tokens})
    dec, _ = pb.decode_fn(CPU["kernel"])(pparams, tokens[:, :1], pb.init_cache(2, "cpu"),
                                         torch.zeros(2, dtype=torch.int32))
    assert logits.shape == dec.shape == (2, 1, pb.config.vocab)
    assert cache["k"].shape == (pb.config.n_layers, 2, 5, pb.config.n_kv_heads, pb.config.hd)


def test_moe_prefill_raises():
    """MoE prefill, which raised before the sequence-sharded MoE layer, runs:
    reduced dbrx's ``prefill_fn`` in kernel mode (the MoE kernels' plain
    versions here) gives bulk mode's logits and caches (held to the JAX
    package in tests/test_torch_moe_tp.py)."""
    pb = get_arch("dbrx-132b").reduced()
    params = pb.init_params(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.randint(0, pb.config.vocab, (2, 12),
                                      generator=torch.Generator().manual_seed(1))}
    lk, ck = pb.prefill_fn(CPU["kernel"])(params, tokens)
    lb, cb = transformer.prefill_forward(CPU["bulk"], params, pb.config, tokens)
    assert lk.shape == (2, 1, pb.config.vocab) and torch.isfinite(lk).all()
    torch.testing.assert_close(lk, lb, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        assert ck[name].shape == (pb.config.n_layers, 2, 12, pb.config.n_kv_heads, pb.config.hd)
        torch.testing.assert_close(ck[name], cb[name], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the hand-off: decode from the prefill cache
# ---------------------------------------------------------------------------
def _decode_cache(pb, cache):
    """The prefill cache copied into a zeroed decode cache of max_seq rows."""
    dc = pb.init_cache(cache["k"].shape[1], "cpu")
    for key in dc:
        dc[key][:, :, :cache[key].shape[2]] = cache[key]
    return dc


def test_decode_from_prefill_matches_jax(ctx, models, prefilled):
    jb, jparams, pb, pparams = models
    (jl, jcache), port = prefilled
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
    jc = jb.init_cache(B)
    jc = {"scan": {key: jc["scan"][key].at[:, :, :S].set(jcache["scan"][key])
                   for key in jc["scan"]}}
    pc = _decode_cache(pb, port["kernel"][1])
    pdec = pb.decode_fn(CPU["kernel"])
    jtok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    ptok = port["kernel"][0].argmax(-1)
    for step in range(8):
        np.testing.assert_array_equal(ptok.numpy(), jtok, err_msg=f"step {step}")
        pos = np.full((B,), S + step, np.int32)
        jl, jc = jdec(jtok, jc, pos)
        pl, pc = pdec(pparams, ptok, pc, t(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **F32, err_msg=f"step {step}")
        jtok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        ptok = pl.argmax(-1)
    for key in pc:
        np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc["scan"][key]), **F32)


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_prefill_matches_token_by_token_decode(models, prompt, prefilled, mode):
    """Prefill of a prompt = decode steps over it from the zeroed cache: the
    last logits, and the cache rows the prompt fills."""
    _, _, pb, pparams = models
    _, port = prefilled
    logits_p, cache_p = port[mode]
    cache = pb.init_cache(B, "cpu")
    dec = pb.decode_fn(CPU[mode])
    for i in range(S):
        logits, cache = dec(pparams, t(prompt[:, i:i + 1]), cache,
                            torch.full((B,), i, dtype=torch.int32))
    torch.testing.assert_close(logits, logits_p, **F32)
    for key in cache:
        torch.testing.assert_close(cache[key][:, :, :S], cache_p[key], **F32)
        assert not cache[key][:, :, S:].any()


@pytest.mark.parametrize("mode,device,want", [("kernel", "cuda", "flash"), ("bulk", "cuda", "span"),
                                              ("kernel", "cpu", "span"), ("bulk", "cpu", "span")])
def test_attention_path_choice(mode, device, want):
    """Kernel mode on a card runs the flash kernel; bulk mode runs the
    reference's bulk computation on any device; the CPU runs it too."""
    assert attention.attention_path(mode, torch.device(device)) == want


@pytest.mark.parametrize("mode,want", [("kernel", "flash"), ("bulk", "span")])
def test_context_attention_routes_by_mode(monkeypatch, mode, want):
    """context_attention on tensors off the CPU (meta tensors stand in for a
    card) calls the op that attention_path names, with the same arguments."""
    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, **kw: calls.append(("flash", kw["causal"])) or q)
    monkeypatch.setattr(attention, "span_attention",
                        lambda q, k, v, **kw: calls.append(("span", kw["causal"])) or q)
    q = torch.empty((1, 8, 4, 16), device="meta")
    kv = torch.empty((1, 8, 2, 16), device="meta")
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode=mode))
    attention.context_attention(ctx, q, kv, kv, causal=False)
    assert calls == [(want, False)]
