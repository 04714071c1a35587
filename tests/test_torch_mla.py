"""deepseek-v3 on one rank: the port's MLA, shared expert and dense prefix
against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function on a
(1, 1) data x model mesh of CPU devices (its bulk mode: the reference's
kernel path for MoE does not run on this host) and through its counterpart
in ``repro_torch`` on the CPU (one rank; kernel mode runs the MoE kernels'
and the fused GEMV's plain versions, and MLA's ``_span_flash`` as every
mode does).  MLA's modules, the shared-expert MoE layer, the whole reduced
deepseek-v3-671b (prefill logits and latent caches, then decode steps from
the prefill's cache, every mode), ``params_from_numpy`` on a tree with
``"prefix"``, the registry's configs field for field, the serve launcher's
streams against the reference's engine, and what still raises.  f32
throughout; tolerance ``TOL["f32"]`` of tests/test_parity_matrix.py (f32
sums in another order).  The per-rank S of the prefills stays below
``_span_flash``'s blocks, where the port and the reference visit the same
rows.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.registry import ArchBundle, get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mla, moe, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext

torch.backends.cuda.matmul.allow_tf32 = False

F32 = TOL["f32"]
ARCH = "deepseek-v3-671b"
MODES = ("bulk", "fused", "kernel")
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in MODES}
# reduced deepseek-v3's MLA widths (registry.reduced)
MCFG = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16)
SHARED_MOE = dict(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared_experts=1,
                  router_scale=2.5)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jctx(mode="bulk"):
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                fusion=JaxFusion(mode=mode))


def mla_params(seed=0):
    """MLA leaves at the reduced widths, fan-in scaled, the norms' weights
    nonzero (so ``1 + w`` is exercised)."""
    rng = np.random.default_rng(seed)
    c = jmla.MLAConfig(**MCFG)
    D, H = c.d_model, c.n_heads
    shapes = {"w_dq": (D, c.q_lora_rank), "q_norm": (c.q_lora_rank,),
              "w_uq": (c.q_lora_rank, H * c.qk_dim), "w_dkv": (D, c.kv_lora_rank),
              "kv_norm": (c.kv_lora_rank,), "w_kr": (D, c.qk_rope_dim),
              "w_uk": (c.kv_lora_rank, H, c.qk_nope_dim),
              "w_uv": (c.kv_lora_rank, H, c.v_head_dim), "w_o": (H * c.v_head_dim, D)}
    return {k: (rng.standard_normal(s) * (0.1 if len(s) == 1 else s[0] ** -0.5))
            .astype(np.float32) for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# MLA's modules
# ---------------------------------------------------------------------------
def test_qkv_latent_and_cache_latents_match_jax():
    p = mla_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 5)).astype(np.int32)
    jc, pc = jmla.MLAConfig(**MCFG), mla.MLAConfig(**MCFG)
    pt = {k: t(v) for k, v in p.items()}
    want = jmla._mla_qkv_latent(p, jc, x, pos)
    got = mla._mla_qkv_latent(pt, pc, t(x), t(pos))
    for name, g, w in zip(("q_nope", "q_rope", "c", "k_rope"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32, err_msg=name)
    for g, w in zip(mla.mla_latents_for_cache(pt, pc, t(x), t(pos)),
                    jmla.mla_latents_for_cache(p, jc, x, pos)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("mode", MODES)
def test_context_attention_matches_jax(mode):
    """tp = 1: the local span, every mode (bulk's all-gather has no peer;
    fused and kernel mode's ring no hop): the output and the latents."""
    p = mla_params(2)
    x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(np.float32)
    want_o, (want_c, want_kr) = jax.jit(lambda pp, v: jmla.mla_context_attention(
        jctx(), pp, jmla.MLAConfig(**MCFG), v))(p, x)
    got_o, (got_c, got_kr) = mla.mla_context_attention(
        CPU[mode], {k: t(v) for k, v in p.items()}, mla.MLAConfig(**MCFG), t(x))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **F32)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **F32)
    np.testing.assert_allclose(got_kr.numpy(), np.asarray(want_kr), **F32)


@pytest.mark.parametrize("pos", [[0, 7, 31, 12], [5, 5, 5, 5]], ids=["ragged", "shared"])
def test_decode_attention_matches_jax(pos):
    """The absorbed form over a cache of 32 rows, each slot masked at its
    own position."""
    p = mla_params(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    cc = rng.standard_normal((4, 32, MCFG["kv_lora_rank"])).astype(np.float32)
    kr = rng.standard_normal((4, 32, MCFG["qk_rope_dim"])).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want = jax.jit(lambda pp, *a: jmla.mla_decode_attention(
        jctx(), pp, jmla.MLAConfig(**MCFG), *a))(p, x, cc, kr, pos)
    got = mla.mla_decode_attention(CPU["kernel"], {k: t(v) for k, v in p.items()},
                                   mla.MLAConfig(**MCFG), t(x), t(cc), t(kr), t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mla_init_draws_the_reference_leaves():
    """The leaves, shapes and dtypes of the reference's ``mla_init`` (the
    norms' weights zero)."""
    pc = mla.MLAConfig(**MCFG)
    want = jax.tree.map(np.asarray, split_params(jmla.mla_init(
        jax.random.PRNGKey(0), jmla.MLAConfig(**MCFG), jnp.float32))[0])
    got = mla.mla_init(torch.Generator().manual_seed(0), pc, torch.float32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
    assert not got["q_norm"].any() and not got["kv_norm"].any()


# ---------------------------------------------------------------------------
# the shared expert
# ---------------------------------------------------------------------------
def shared_moe_params(seed=6):
    rng = np.random.default_rng(seed)
    E, D, F = SHARED_MOE["n_experts"], SHARED_MOE["d_model"], SHARED_MOE["d_ff"]
    w = lambda *s: (0.2 * rng.standard_normal(s)).astype(np.float32)
    return {"router": w(D, E), "w_gate": w(E, D, F), "w_up": w(E, D, F), "w_down": w(E, F, D),
            "shared": {"w_gate": w(D, F), "w_up": w(D, F), "w_down": w(F, D)}}


def _as_t(tree):
    return {k: _as_t(v) if isinstance(v, dict) else t(v) for k, v in tree.items()}


@pytest.mark.parametrize("path", ["bulk", "fused", "kernel", "decode_ep"])
def test_shared_expert_layer_matches_jax(path):
    """The MoE layer with its shared expert in every mode of ``_moe_local``
    and in decode EP at one rank, against the JAX package's bulk layer."""
    p = shared_moe_params()
    x = np.random.default_rng(7).standard_normal((2, 6, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda pp, v: jmoe.moe_apply(
        jctx(), pp, v, jmoe.MoEConfig(**SHARED_MOE)))(p, x))
    cfg = moe.MoEConfig(**SHARED_MOE)
    if path == "decode_ep":
        got = moe._moe_decode_ep(CPU["bulk"], _as_t(p), t(x), cfg)
    else:
        got = moe.moe_apply(CPU[path], _as_t(p), t(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # the shared expert's share is there: without it the output differs
    no_shared = moe.moe_apply(CPU["bulk"], {k: v for k, v in _as_t(p).items()
                                            if k != "shared"}, t(x), cfg)
    assert not np.allclose(no_shared.numpy(), want, **F32)


def test_shared_expert_init_and_specs():
    """``moe_init`` draws the shared expert after the routed ones at the
    reference's shapes; its leaves are whole over tp (not the dense MLP's
    column and row splits), the routed experts split by expert."""
    cfg = moe.MoEConfig(**SHARED_MOE)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    want = jax.tree.map(np.asarray, split_params(jmoe.moe_init(
        jax.random.PRNGKey(0), jmoe.MoEConfig(**SHARED_MOE), jnp.float32))[0])
    assert set(p) == set(want) and set(p["shared"]) == set(want["shared"])
    assert {k: tuple(v.shape) for k, v in p["shared"].items()} == {
        k: v.shape for k, v in want["shared"].items()}
    specs = transformer.param_specs({"ffn": p})["ffn"]
    assert specs["shared"] == {"w_gate": ("fsdp", None), "w_up": ("fsdp", None),
                               "w_down": (None, "fsdp")}
    assert specs["w_gate"] == ("tp", "fsdp", None)
    ctx = types.SimpleNamespace(tp=2, tp_rank=1, dp=1, dp_rank=0)
    sh = transformer.shard_params({"ffn": p}, ctx)["ffn"]
    for k in ("w_gate", "w_up", "w_down"):
        torch.testing.assert_close(sh["shared"][k], p["shared"][k], rtol=0, atol=0)
    torch.testing.assert_close(sh["w_gate"], p["w_gate"][4:], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the whole reduced deepseek-v3
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jb = jax_get_arch(ARCH).reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch(ARCH).reduced()
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jb, jparams, pb, pparams


def whole_cache(jcache):
    """The reference's {"prefix", "scan"} cache as the port's: every layer on
    the leading axis, the prefix first."""
    return {k: np.concatenate([np.asarray(jcache["prefix"][k]), np.asarray(jcache["scan"][k])])
            for k in ("c", "kr")}


B, S, STEPS = 2, 16, 4


@pytest.fixture(scope="module")
def jax_run(models):
    """The reference's prefill of a seeded prompt, then STEPS greedy decode
    steps from its cache: the logits of each and the final cache."""
    jb, jparams, _, _ = models
    ctx = jctx()
    tokens = np.random.default_rng(8).integers(0, jb.config.vocab, (B, S)).astype(np.int32)
    jl, jcache = jax.jit(jb.prefill_fn(ctx))(jparams, {"tokens": tokens})
    pre = (np.asarray(jl), whole_cache(jcache))
    dc = jb.init_cache(B)
    dc = jax.tree.map(lambda full, got: full.at[:, :, :S].set(got), dc, jcache)
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
    tok, logits = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), []
    for s in range(STEPS):
        lg, dc = jdec(tok, dc, np.full((B,), S + s, np.int32))
        logits.append(np.asarray(lg))
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
    return tokens, pre, logits, whole_cache(dc)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_jax(models, jax_run, mode):
    """Reduced deepseek-v3 (1 dense-prefix layer, 2 MoE layers with a shared
    expert, MLA): the prefill's last logits and its latent caches {"c",
    "kr"} [L, B, S, ...], then STEPS greedy decode steps from them."""
    _, _, pb, pparams = models
    tokens, (jl, jcache), jlogits, jfinal = jax_run
    logits, cache = pb.prefill_fn(CPU[mode])(pparams, {"tokens": t(tokens)})
    assert logits.shape == (B, 1, pb.config.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jl, **F32)
    assert set(cache) == {"c", "kr"}
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), jcache[k], **F32, err_msg=k)
    dc = pb.init_cache(B, "cpu")
    for k in dc:
        dc[k][:, :, :S] = cache[k]
    dec = pb.decode_fn(CPU[mode])
    tok = logits.argmax(-1).to(torch.int32)
    for s, want in enumerate(jlogits):
        lg, dc = dec(pparams, tok, dc, torch.full((B,), S + s, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), want, **F32, err_msg=f"step {s}")
        tok = lg.argmax(-1).to(torch.int32)
    for k in dc:
        np.testing.assert_allclose(dc[k].numpy(), jfinal[k], **F32, err_msg=k)


class OneAtATime:
    """Layer dicts handed out one at a time, each emptied when the next is
    asked for: what a caller that upcasts one layer at a time passes."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        prev = {}
        for lp in self.layers:
            prev.clear()
            prev = dict(lp)
            yield prev


@pytest.mark.parametrize("arch", [ARCH, "chatglm3-6b"])
def test_layers_run_one_at_a_time(models, arch):
    """Prefill and decode take ``params["layers"]`` as any iterable and ask
    for a layer only when they run it (``transformer.decoder_layers``), so a
    caller may hand out one layer at a time: the same logits as the list."""
    pb = get_arch(arch).reduced()
    params = models[3] if arch == ARCH else pb.init_params(torch.Generator().manual_seed(0))
    tokens = {"tokens": torch.randint(0, pb.config.vocab, (2, 8),
                                      generator=torch.Generator().manual_seed(2))}
    lazy = {**params, "layers": OneAtATime(params["layers"])}
    want, _ = pb.prefill_fn(CPU["bulk"])(params, tokens)
    got, _ = pb.prefill_fn(CPU["bulk"])(lazy, tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    step = [pb.decode_fn(CPU["bulk"])(p, tokens["tokens"][:, :1], pb.init_cache(2, "cpu"),
                                      torch.zeros(2, dtype=torch.int32))[0]
            for p in (params, {**params, "layers": OneAtATime(params["layers"])})]
    torch.testing.assert_close(step[1], step[0], rtol=0, atol=0)


def test_decode_launches_the_path_kernels_wrappers(models):
    """A kernel-mode decode step goes through the wrappers phase 57 counts on
    the card: the fused GEMV once a dense-prefix layer, the dispatch and the
    expert FFN once a MoE layer (their plain versions here), flash never."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
    from repro_torch.kernels.fused_gemm_a2a.ops import fused_gemm_a2a
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce

    _, _, pb, pparams = models
    wrappers = (fused_matmul_allreduce, fused_dispatch_a2a, fused_gemm_a2a, flash_attention)
    seen = []
    kept = {w.__name__: w for w in wrappers}
    import repro_torch.core.matmul_allreduce as mar
    import repro_torch.core.moe_all_to_all as ma2a

    def spy(name, fn):
        def call(*a, **kw):
            seen.append(name)
            return fn(*a, **kw)
        return call
    with pytest.MonkeyPatch.context() as mp:
        for mod in (mar, ma2a):
            for name, fn in kept.items():
                if hasattr(mod, name):
                    mp.setattr(mod, name, spy(name, fn))
        pb.decode_fn(CPU["kernel"])(pparams, torch.zeros((B, 1), dtype=torch.int32),
                                    pb.init_cache(B, "cpu"), torch.zeros(B, dtype=torch.int32))
    n_moe = pb.config.n_layers - pb.config.dense_prefix
    assert sorted(seen) == sorted(["fused_matmul_allreduce"] * pb.config.dense_prefix
                                  + ["fused_dispatch_a2a", "fused_gemm_a2a"] * n_moe)


def test_params_from_numpy_carries_the_prefix_mla_and_shared(models):
    """``params["prefix"]`` holds the dense layers, each leaf the reference's
    bits; MLA's 3-D ``w_uk`` / ``w_uv`` and the shared expert as they are;
    the tree has the port's own init's structure, shapes and dtypes."""
    jb, jparams, pb, pparams = models
    tree = jax.tree.map(np.asarray, jparams)
    assert len(pparams["prefix"]) == pb.config.dense_prefix == len(tree["prefix"])
    assert len(pparams["layers"]) == pb.config.n_layers - pb.config.dense_prefix
    pre = pparams["prefix"][0]
    assert "router" not in pre["ffn"] and "router" in pparams["layers"][0]["ffn"]
    np.testing.assert_array_equal(pre["ffn"]["w_down"].numpy(),
                                  tree["prefix"][0]["l0"]["ffn"]["w_down"])
    np.testing.assert_array_equal(pre["attn"]["w_uk"].numpy(),
                                  tree["prefix"][0]["l0"]["attn"]["w_uk"])
    assert pre["attn"]["w_uk"].dim() == 3
    for i, lp in enumerate(pparams["layers"]):
        np.testing.assert_array_equal(lp["ffn"]["shared"]["w_up"].numpy(),
                                      tree["layers"]["l0"]["ffn"]["shared"]["w_up"][i])
        np.testing.assert_array_equal(lp["attn"]["w_uv"].numpy(),
                                      tree["layers"]["l0"]["attn"]["w_uv"][i])
    own = pb.init_params(torch.Generator().manual_seed(0))
    shapes = lambda p: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[-7:]), p)
    assert shapes(own) == shapes(pparams)


def test_params_from_numpy_shards_by_the_specs(models):
    """At tp = 2 the converter keeps every MLA leaf, the shared expert and
    the prefix's attention whole, splits the prefix's dense FFN by columns
    and rows and the routed experts by expert."""
    jb, jparams, pb, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    ctx = types.SimpleNamespace(tp=2, tp_rank=1, dp=1, dp_rank=0)
    p = params_from_numpy(tree, "cpu", ctx)
    pre, lay = p["prefix"][0], p["layers"][1]
    wpre = tree["prefix"][0]["l0"]
    np.testing.assert_array_equal(pre["ffn"]["w_gate"].numpy(),
                                  wpre["ffn"]["w_gate"][:, pb.config.d_ff // 2:])
    np.testing.assert_array_equal(pre["ffn"]["w_down"].numpy(),
                                  wpre["ffn"]["w_down"][pb.config.d_ff // 2:])
    np.testing.assert_array_equal(pre["attn"]["w_o"].numpy(), wpre["attn"]["w_o"])
    np.testing.assert_array_equal(lay["attn"]["w_uq"].numpy(),
                                  tree["layers"]["l0"]["attn"]["w_uq"][1])
    np.testing.assert_array_equal(lay["ffn"]["shared"]["w_down"].numpy(),
                                  tree["layers"]["l0"]["ffn"]["shared"]["w_down"][1])
    np.testing.assert_array_equal(lay["ffn"]["w_up"].numpy(),
                                  tree["layers"]["l0"]["ffn"]["w_up"][1][4:])


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_registry_config_matches_the_reference_field_for_field(reduced):
    """``get_arch("deepseek-v3-671b")`` returns a bundle whose config (and
    ``reduced()``'s: 3 layers, 1 of them dense prefix, kv_lora 16, rope 8,
    8 experts top-2) equals the reference's field for field, the ``mla``
    and ``moe`` sub-configs included; optimizer and microbatches kept."""
    jb, pb = jax_get_arch(ARCH), get_arch(ARCH)
    if reduced:
        jb, pb = jb.reduced(), pb.reduced()
    jc, pc = jb.config, pb.config
    assert [f.name for f in dataclasses.fields(pc)] == [f.name for f in dataclasses.fields(jc)]
    for f in dataclasses.fields(jc):
        if f.name in ("mla", "moe"):
            assert dataclasses.asdict(getattr(pc, f.name)) == \
                dataclasses.asdict(getattr(jc, f.name)), f.name
        else:
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert (pb.family, pb.optimizer, pb.microbatches) == (jb.family, jb.optimizer,
                                                          jb.microbatches)
    if reduced:
        assert (pc.n_layers, pc.dense_prefix, pc.mla.kv_lora_rank, pc.mla.qk_rope_dim,
                pc.moe.n_experts, pc.moe.top_k) == (3, 1, 16, 8, 8, 2)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------
def test_launcher_streams_match_the_reference_engine(models, capsys):
    """The serve launcher (``--arch deepseek-v3-671b --reduced``, kernel
    mode, in this process) on the reference launcher's weights (its
    ``PRNGKey(0)`` draw, converted) and prompts gives the greedy streams of
    the reference's ``DecodeEngine`` on the same weights."""
    jb, jparams, pb, pparams = models
    n_req, batch, max_new = 4, 2, 6
    decode = jb.decode_fn(jctx())
    jeng = JaxDecodeEngine(jax.jit(lambda tk, c, p: decode(jparams, tk, c, p)),
                           jb.init_cache, batch, max_seq=jb.config.max_seq)
    for r in launch_serve.make_requests(n_req, pb.config.vocab, max_new):
        jeng.submit(JaxRequest(uid=r.uid, prompt=r.prompt, max_new=max_new))
    want = {r.uid: r.tokens for r in jeng.run_until_drained(max_steps=200)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ArchBundle, "init_params", lambda self, gen, ctx=None, training=False:
                   pparams)
        fin = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
                                 str(n_req), "--batch", str(batch), "--max-new", str(max_new)])
    assert {r.uid: r.tokens for r in fin} == want
    assert f"served {n_req} requests, {n_req * max_new} tokens" in capsys.readouterr().out


def test_launcher_layers_keep_the_dense_prefix():
    """``--layers N`` keeps the 3 dense-prefix layers whole: N = 3 is
    refused; ``--paged`` is refused as the reference refuses it."""
    with pytest.raises(SystemExit, match="dense-prefix"):
        launch_serve.main(["--arch", ARCH, "--layers", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="GQA"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--paged"])


@pytest.mark.parametrize("what", ["paged_pool", "serve_step", "train"])
def test_what_still_raises(models, what):
    """Paged MLA (the reference's refusal) and MLA training (ROADMAP item 7)
    raise, each naming its reason."""
    _, _, pb, pparams = models
    cfg = pb.config
    if what == "paged_pool":
        assert not pb.supports_paged
        with pytest.raises(NotImplementedError, match="dense latent cache"):
            pb.init_paged_pool(8, 4, "cpu")
    elif what == "serve_step":
        with pytest.raises(NotImplementedError, match="dense latent cache"):
            transformer.serve_step(CPU["bulk"], pparams, cfg, torch.zeros((1, 1), dtype=torch.long),
                                   {}, None, 0, 1)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
            pb.loss_fn(CPU["bulk"])
