"""gemma2-27b and the other dense configs (phi3-medium-14b, deepseek-67b) in
the port against the JAX package, at each one's reduced config.

gemma2's reduced config (both registries' ``reduced()``: 4 layers, a
local/global pattern of 2, window 16, attention softcap 50, logit softcap
30, post-norms, (1 + w) norms, the embedding scale and ``query_scale``)
runs its prefill at S = 32 > window 16, teacher-forced decode steps past the
window, and paged ``serve_step`` at C = 1 and C = 8, each against the JAX
function on the same numpy inputs and the JAX init's weights (carried over
by ``params_from_numpy``), f32 at ``TOL["f32"]``.  The JAX package runs
under the conftest ``ctx`` (a (2, 4) data x model mesh of CPU devices) or,
for training, on a one-device mesh; the port on the CPU, where kernel mode's
attention is the flash kernel's plain version.  Training: six steps of the
reduced gemma2 through ``train/step.py`` against the jitted JAX step, with
the optimizer and the int8 compression stacking the pattern's two positions
apart, as the reference's scan does.
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
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import grad_compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import to_device
from repro_torch.kernels.fused_gemv_allreduce.ops import fused_path
from repro_torch.kernels.gemv.plan import SMEM_LIMIT, stream_plan
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.train import grad_compression as pcomp
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}
F32 = TOL["f32"]
STEPS = dict(rtol=1e-4, atol=0)
DENSE = ("gemma2-27b", "phi3-medium-14b", "deepseek-67b")
B, S = 4, 32
BS = 8                      # tokens per pool block (max_seq 64: 8 blocks a slot)


def t(a):
    return torch.from_numpy(np.array(a))


def _models(name):
    jb = jax_get_arch(name).reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch(name).reduced()
    return jb, jparams, pb, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def gemma():
    return _models("gemma2-27b")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(5).integers(0, 512, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(name, reduced):
    """Every field the two configs share, at full width and reduced, and the
    registry's training fields."""
    jb, pb = jax_get_arch(name), get_arch(name)
    assert (pb.family, pb.optimizer, pb.microbatches) == (jb.family, jb.optimizer,
                                                          jb.microbatches)
    if reduced:
        jb, pb = jb.reduced(), pb.reduced()
    jc, pc = dataclasses.asdict(jb.config), dataclasses.asdict(pb.config)
    shared = set(jc) & set(pc)
    assert {"window", "attn_softcap", "logit_softcap", "query_scale", "post_norms",
            "norm_plus_one", "embed_scale", "local_global_period", "act"} <= shared
    assert {k: pc[k] for k in shared} == {k: jc[k] for k in shared}


def test_gemma2_reduced_engages_the_window(gemma):
    cfg = gemma[2].config
    assert (cfg.n_layers, cfg.local_global_period, cfg.window) == (4, 2, 16)
    assert [cfg.layer_window(i) for i in range(4)] == [16, None, 16, None]
    assert S > cfg.window and (cfg.attn_softcap, cfg.logit_softcap) == (50.0, 30.0)


# ---------------------------------------------------------------------------
# parameters across the period-2 stack
# ---------------------------------------------------------------------------
def test_params_from_numpy_unstacks_the_pattern(gemma):
    """The reference stacks pattern position j of every group under "l<j>";
    port layer 2 g + j is group g's entry j (local layers even, global odd),
    and the tree is the one the port's own init makes."""
    _, jparams, pb, pparams = gemma
    stacked = jax.tree.map(np.asarray, jparams)["layers"]
    assert set(stacked) == {"l0", "l1"} and len(pparams["layers"]) == 4
    for i, layer in enumerate(pparams["layers"]):
        want = jax.tree.map(lambda a: a[i // 2], stacked[f"l{i % 2}"])
        popt.tree_map(lambda g, w: np.testing.assert_array_equal(g.numpy(), w), layer, want)
    own = pb.init_params(torch.Generator().manual_seed(0))
    shapes = lambda p: popt.tree_map(lambda a: (tuple(a.shape), a.dtype), p)
    assert shapes(own) == shapes(pparams)
    assert {"post_ln1", "post_ln2"} <= set(pparams["layers"][0])


# ---------------------------------------------------------------------------
# prefill, decode past the window, paged serving
# ---------------------------------------------------------------------------
def _jax_cache_rows(jcache, n_layers):
    """The reference's cache or pool, ``{"scan": {"k", "v"}}`` with every
    layer's rows in layer order (its scan groups reshaped to [L, ...])."""
    rows = {k: np.asarray(v) for k, v in jcache["scan"].items()}
    assert all(a.shape[0] == n_layers for a in rows.values())
    return rows


@pytest.fixture(scope="module")
def prefilled(ctx, gemma, prompt):
    jb, jparams, pb, pparams = gemma
    jout = jax.jit(jb.prefill_fn(ctx))(jparams, {"tokens": prompt})
    port = {m: pb.prefill_fn(CPU[m])(pparams, {"tokens": t(prompt)}) for m in CPU}
    return jout, port


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_gemma2_prefill_matches_jax(gemma, prefilled, mode):
    """S = 32 > window 16: the local layers' window and every layer's cap,
    the logits and every layer's k and v."""
    cfg = gemma[2].config
    (jl, jcache), port = prefilled
    logits, cache = port[mode]
    assert logits.shape == (B, 1, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **F32)
    want = _jax_cache_rows(jcache, cfg.n_layers)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == want[key].shape == (cfg.n_layers, B, S,
                                                              cfg.n_kv_heads, cfg.hd)
        np.testing.assert_allclose(cache[key].numpy(), want[key], **F32, err_msg=key)


def _decode_cache(pb, cache):
    dc = pb.init_cache(cache["k"].shape[1], "cpu")
    for key in dc:
        dc[key][:, :, :cache[key].shape[2]] = cache[key]
    return dc


def _jax_decode_cache(jb, jcache):
    """The reference's zeroed decode cache with the prefill's rows copied in."""
    jc = jb.init_cache(B)
    return jax.tree.map(lambda full, pre: full.at[:, :, :S].set(pre), jc, jcache)


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_gemma2_decode_past_the_window_matches_jax(ctx, gemma, prefilled, mode):
    """Eight teacher-forced decode steps from position 32 (each local layer
    sees only the last 16 positions) on the prefill's cache: the logits and
    the cache against the reference's decode."""
    jb, jparams, pb, pparams = gemma
    (_, jcache), port = prefilled
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
    jc, pc = _jax_decode_cache(jb, jcache), _decode_cache(pb, port[mode][1])
    pdec = pb.decode_fn(CPU[mode])
    toks = np.random.default_rng(7).integers(0, 512, (8, B, 1)).astype(np.int32)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        jl, jc = jdec(toks[step], jc, pos)
        pl, pc = pdec(pparams, t(toks[step]), pc, t(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **F32, err_msg=f"step {step}")
    want = _jax_cache_rows(jc, pb.config.n_layers)
    for key in pc:
        np.testing.assert_allclose(pc[key].numpy(), want[key], **F32, err_msg=key)


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_gemma2_serve_step_matches_jax(ctx, gemma, mode, C):
    """Paged ``serve_step``: prompts of 24, 17, 9 and 30 tokens fed C a step
    (C = 8: chunks ending mid-prompt; C = 1: token by token), then decode
    steps to position 40 and past it, every step's logits and the pool's
    blocks against the reference's serve step (window 16: each local layer
    reads only the blocks of its last 16 positions)."""
    jb, jparams, pb, pparams = gemma
    cfg = pb.config
    MB = cfg.max_seq // BS
    tables = np.array([[i * MB + m for m in range(MB)] for i in range(B)], np.int32)
    nb = B * MB
    jfn = jb.serve_step_fn(ctx)
    jserve = jax.jit(lambda tk, pl, tb, p, n: jfn(jparams, tk, pl, tb, p, n))
    serve = pb.serve_step_fn(CPU[mode])
    jpool, pool = jb.init_paged_pool(nb, BS), pb.init_paged_pool(nb, BS, "cpu")
    rng = np.random.default_rng(11)
    lens = np.array([24, 17, 9, 30])
    seqs = rng.integers(0, 512, (B, 40)).astype(np.int32)   # prompt, then forced tokens
    pos = np.zeros(B, np.int32)
    step = 0
    while (pos < 40).any():
        tk = np.zeros((B, C), np.int32)
        nn = np.zeros(B, np.int32)
        for i in range(B):
            # a prompt C tokens a step, then one decode token a step
            n = min(C, lens[i] - pos[i]) if pos[i] < lens[i] else min(1, 40 - pos[i])
            nn[i] = n
            tk[i, :n] = seqs[i, pos[i]:pos[i] + n]
        jl, jpool = jserve(tk, jpool, tables, pos, nn)
        lg, pool = serve(pparams, t(tk), pool, t(tables), t(pos), t(nn))
        live = nn > 0
        np.testing.assert_allclose(lg.numpy()[live], np.asarray(jl)[live], **F32,
                                   err_msg=f"step {step}")
        pos += nn
        step += 1
    jp = _jax_cache_rows(jpool, cfg.n_layers)
    for key in ("k", "v"):
        np.testing.assert_allclose(pool[key][:, :nb].numpy(), jp[key], **F32, err_msg=key)


# ---------------------------------------------------------------------------
# the three dense configs: prefill and decode at the reduced config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE)
def test_dense_config_prefill_and_decode_match_jax(ctx, name, prompt):
    """Each dense config's reduced model in kernel mode: the prefill's logits
    and caches, then four greedy decode steps from its cache, against the
    JAX package."""
    jb, jparams, pb, pparams = _models(name)
    cfg = pb.config
    jl, jcache = jax.jit(jb.prefill_fn(ctx))(jparams, {"tokens": prompt})
    pl, pcache = pb.prefill_fn(CPU["kernel"])(pparams, {"tokens": t(prompt)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **F32)
    want = _jax_cache_rows(jcache, cfg.n_layers)
    for key in ("k", "v"):
        np.testing.assert_allclose(pcache[key].numpy(), want[key], **F32, err_msg=key)
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
    jc, pc = _jax_decode_cache(jb, jcache), _decode_cache(pb, pcache)
    pdec = pb.decode_fn(CPU["kernel"])
    tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        jl, jc = jdec(tok, jc, pos)
        pl, pc = pdec(pparams, t(tok), pc, t(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **F32, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("name,rows,path", [(n, r, p) for n in DENSE
                                            for r, p in ((4, "stream"), (32, "tile"))])
def test_ffn_down_plan_fits(name, rows, path):
    """The FFN down at full width, [rows, d_ff] @ [d_ff, d_model] bf16: decode's
    4 rows on the stream path, whose plan (pure Python, the split the card
    runs) keeps x's f32 slice beside the 64 KB ring within a CTA's shared
    memory; the paged chunk's 32 rows on the tile path."""
    cfg = get_arch(name).config
    assert fused_path(torch.bfloat16, rows, cfg.d_ff, cfg.d_model) == path
    plan = stream_plan(rows, cfg.d_ff, cfg.d_model)
    assert plan is not None and plan.smem <= SMEM_LIMIT
    assert plan.splits * plan.ks >= cfg.d_ff and plan.rows_per_block * plan.row_blocks >= rows


# ---------------------------------------------------------------------------
# training: the pattern's positions stacked apart
# ---------------------------------------------------------------------------
def test_leaf_groups_stack_each_pattern_position_apart(gemma):
    pparams = gemma[3]
    groups = popt.leaf_groups(pparams, 2)
    stacks = {path[:2] for path, _, stacked in groups if stacked}
    assert stacks == {("layers", "l0"), ("layers", "l1")}
    for path, leaves, stacked in groups:
        if stacked:
            j = int(path[1][1])
            want = [popt.get_path(pparams["layers"][i], path[2:]) for i in (j, j + 2)]
            assert all(a is b for a, b in zip(leaves, want))
    with pytest.raises(ValueError, match="patterns of 3"):
        popt.leaf_groups(pparams, 3)


def _pattern_tree(seed):
    """A tree in the JAX layout with a layer pattern of 2: stacks "l0" and
    "l1" of 2 groups each, whose gradients differ in scale by 100 (so one
    int8 scale or Adafactor RMS over all four layers would differ)."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    return {"embed": {"table": f(12, 8)}, "final_norm": f(8),
            "layers": {"l0": {"w": f(2, 8, 6), "ln": f(2, 8)},
                       "l1": {"w": 100 * f(2, 8, 6), "ln": 100 * f(2, 8)}}}


def _port_tree(tree):
    return params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), tree))


def _close_tree(got, want):
    popt.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                                          atol=1e-6), got, _port_tree(want))


@pytest.mark.parametrize("what", ["int8", "topk", "adafactor", "adamw"])
def test_pattern_updates_match_jax(what):
    """One stack per pattern position: the compression and both optimizers'
    updates on a period-2 tree against the JAX package's, three steps."""
    params, res = _pattern_tree(0), None
    pp = _port_tree(params)
    if what in ("int8", "topk"):
        jcfg = jcomp.CompressionConfig(scheme=what, topk_ratio=0.2)
        cfg = pcomp.CompressionConfig(scheme=what, topk_ratio=0.2)
        jres, res = jcomp.init_residuals(jcfg, params), pcomp.init_residuals(cfg, pp)
    else:
        cfg = popt.OptimizerConfig(name=what, lr=1e-2, warmup_steps=2, total_steps=10)
        jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
        jinit, jupd = jopt.make_optimizer(jcfg)
        pinit, pupd = popt.make_optimizer(cfg)
        jstate, pstate = jinit(jcfg, params), pinit(cfg, pp, 2)
    for step in range(3):
        grads = _pattern_tree(10 + step)
        if res is not None:
            jg, jres = jcomp.compress_decompress(jcfg, grads, jres)
            pg, _ = pcomp.compress_decompress(cfg, _port_tree(grads), res, 2)
            _close_tree(pg, jg)
            _close_tree(res, jres)
        else:
            params, jstate, _ = jupd(jcfg, grads, jstate, params)
            pupd(cfg, _port_tree(grads), pstate, pp, 2)
            _close_tree(pp, params)
    if what == "adafactor":
        # the reference's factored state, one stack a position, kept as it is
        popt.tree_map(lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                                              rtol=1e-5, atol=1e-6),
                      pstate["v"], jstate["v"])


@pytest.mark.parametrize("variant", ["int8", "adafactor"])
def test_gemma2_six_steps_match_the_jax_step(gemma, variant):
    """Six steps from the JAX init's state on the same batches, kernel mode
    against the reference's fused mode on a one-device mesh: the int8
    compression's scale and Adafactor's factored state per pattern
    position."""
    jb, jparams, pb, _ = gemma
    opt = dict(name="adafactor" if variant == "adafactor" else "adamw", lr=3e-3,
               warmup_steps=5, total_steps=6)
    scheme = "int8" if variant == "int8" else "none"
    jtc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(**opt),
                            compression=jcomp.CompressionConfig(scheme=scheme))
    ptc = pstep.TrainConfig(optimizer=popt.OptimizerConfig(**opt),
                            compression=pcomp.CompressionConfig(scheme=scheme), layer_period=2)
    jctx = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                fusion=JaxFusion(mode="fused"))
    jfn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx), jtc))
    pfn = pstep.build_train_step(pb.loss_fn(CPU["kernel"]), ptc)
    jstate = jstep.init_train_state(jtc, jparams)
    pstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    own = pstep.init_train_state(ptc, pb.init_params(torch.Generator().manual_seed(0)))
    shapes = lambda tr: popt.tree_map(lambda a: (tuple(a.shape), a.dtype), tr)
    assert shapes(own) == shapes(pstate)
    it = JaxLMBatches(512, 8, S, 0)
    jl, pl = [], []
    for i in range(6):
        batch = next(it)
        jstate, jm = jfn(jstate, batch)
        pstate, pm = pfn(pstate, to_device(batch, "cpu"))
        jl.append(float(jm["loss"]))
        pl.append(pm["loss"].item())
    np.testing.assert_allclose(pl, jl, **STEPS)
    assert jl[-1] < jl[0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_serves_gemma2_dense_and_paged(capsys):
    """``--arch gemma2-27b --reduced --device cpu``: kernel and bulk mode,
    dense and paged, serve the same streams."""
    base = ["--arch", "gemma2-27b", "--reduced", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--max-new", "6"]
    runs = {(mode, tuple(paged)): launch_serve.main(base + ["--fusion", mode] + paged)
            for mode in ("kernel", "bulk") for paged in ([], ["--paged"])}
    streams = {key: sorted((r.uid, r.tokens) for r in fin) for key, fin in runs.items()}
    first = next(iter(streams.values()))
    assert all(s == first for s in streams.values()) and len(first) == 3
    assert all(len(tokens) == 6 for _, tokens in first)
    out = capsys.readouterr().out
    assert out.count("served 3 requests, 18 tokens") == 4 and "paged pool" in out
