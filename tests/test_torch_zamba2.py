"""zamba2 on one rank: the port's Mamba-2 block, shared attention block and
whole reduced model against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function on a
(1, 1) data x model mesh of CPU devices in bulk mode and through its
counterpart in ``repro_torch`` on the CPU (kernel mode runs the fused
GEMV's plain version, and the shared attention's prefill ``_SpanFlash``, as
the CPU does at tp = 1).  The SSD scan and the causal conv (at the shapes
of tests/test_recurrent.py and the block's), ``mamba2_apply`` in prefill
and decode form, ``_shared_attn``, the reduced zamba2-7b (prefill logits
and every cache leaf, then decode steps from the prefill's state in every
mode), ``zamba2_params_from_numpy``, the registry's configs field for
field, the refusals, and the serve launcher: its first wave against the
reference's engine, its reused slots against a fresh engine, and the
reference's reused slots pinned as stale.  The reference's ``A_log``,
``D`` and ``dt_bias`` init to constants, which would hide the decay's and
the skip's per-head values, so the module rows draw them at random.  f32
throughout; tolerance ``TOL["f32"]`` of tests/test_parity_matrix.py.
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
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.models import mamba2 as jm2
from repro.models import zamba2 as jz
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.registry import ArchBundle, get_arch
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba2 as m2
from repro_torch.models import zamba2
from repro_torch.models.convert import zamba2_params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.serve.engine import DecodeEngine, Request

torch.backends.cuda.matmul.allow_tf32 = False

F32 = TOL["f32"]
ARCH = "zamba2-7b"
MODES = ("bulk", "fused", "kernel")
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in MODES}
# a Mamba-2 block of 4 heads of 16 over chunks of 8 (the reduced model's
# block has one head of 64)
MCFG = dict(d_model=32, d_state=8, head_dim=16, chunk=8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def as_t(tree):
    if isinstance(tree, dict):
        return {k: as_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_t(v) for v in tree]
    return t(np.asarray(tree))


def jctx(mode="bulk"):
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                fusion=JaxFusion(mode=mode))


def ssd_inputs(rng, b, T, H, P, N, state=False):
    """test_recurrent.py's SSD inputs, and a zero or random initial state."""
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, T, H))).astype(np.float32) * 0.5
    A_log = rng.standard_normal(H).astype(np.float32) * 0.3
    B_ = rng.standard_normal((b, T, N)).astype(np.float32)
    C_ = rng.standard_normal((b, T, N)).astype(np.float32)
    S = (rng.standard_normal((b, H, N, P)).astype(np.float32) if state
         else np.zeros((b, H, N, P), np.float32))
    return x, dt, A_log, B_, C_, S


# ---------------------------------------------------------------------------
# the SSD scan and the causal conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk,state", [(4, False), (16, False), (32, False), (8, True),
                                         (64, True)])
def test_ssd_chunked_matches_jax(rng, chunk, state):
    """test_recurrent.py's shapes (T = 32 over chunks of 4, 16, 32, and one
    chunk of T when the chunk is longer), from a zero and a random state."""
    a = ssd_inputs(rng, 2, 32, 3, 8, 4, state)
    want_y, want_s = jax.jit(lambda *v: jm2.ssd_chunked(*v, chunk))(*a)
    got_y, got_s = m2.ssd_chunked(*(t(v) for v in a), chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32)


def test_ssd_chunked_keeps_the_decay_clip(rng):
    """Decays past exp(-60) within a chunk: the clip at -60 binds, as in the
    reference (dt of 40 and A_log of 1 give log a = -108.7 a step)."""
    x, dt, A_log, B_, C_, S = ssd_inputs(rng, 1, 16, 2, 4, 4, True)
    dt[:, 5] = 40.0
    A_log[:] = 1.0
    want_y, want_s = jax.jit(lambda *v: jm2.ssd_chunked(*v, 8))(x, dt, A_log, B_, C_, S)
    got_y, got_s = m2.ssd_chunked(*(t(v) for v in (x, dt, A_log, B_, C_, S)), 8)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32)


@pytest.mark.parametrize("T,chunk", [(33, 32), (20, 8)])
def test_ssd_chunked_refuses_a_ragged_tail(rng, T, chunk):
    """A T longer than the chunk and not a multiple of it: the reference
    reshapes T into whole chunks, so there is no tail to compute."""
    a = ssd_inputs(rng, 1, T, 2, 4, 4)
    with pytest.raises(ValueError, match="not a multiple"):
        m2.ssd_chunked(*(t(v) for v in a), chunk)


def test_ssd_step_matches_jax(rng):
    x, dt, A_log, B_, C_, S = ssd_inputs(rng, 2, 1, 3, 8, 4, True)
    want = jm2.ssd_step(x, dt, A_log, B_, C_, S)
    got = m2.ssd_step(*(t(v) for v in (x, dt, A_log, B_, C_, S)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(rng, with_state):
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    kern = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    want = jm2._causal_conv(x, kern, st)
    got = m2._causal_conv(t(x), t(kern), None if st is None else t(st))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


# ---------------------------------------------------------------------------
# the Mamba-2 block and the shared attention block
# ---------------------------------------------------------------------------
def mamba_params(seed=0, **over):
    """The reference's Mamba-2 leaves (its init) with A_log, D and dt_bias
    drawn at random."""
    cfg = jm2.Mamba2Config(**{**MCFG, **over})
    p = jax.tree.map(np.asarray, split_params(jm2.mamba2_init(
        jax.random.PRNGKey(seed), cfg, jnp.float32))[0])
    rng = np.random.default_rng(seed)
    H = cfg.n_heads
    p["A_log"] = (rng.standard_normal(H) * 0.5).astype(np.float32)
    p["D"] = (1.0 + rng.standard_normal(H) * 0.3).astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(H) * 0.5).astype(np.float32)
    p["norm"] = (1.0 + rng.standard_normal(cfg.d_inner) * 0.1).astype(np.float32)
    return p


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_mamba2_apply_matches_jax(rng, mode, form):
    """The block over 16 positions (2 chunks) from a zero state, and one
    decode step from a random SSM and conv state: its output and both
    states."""
    p = mamba_params(1)
    jc, pc = jm2.Mamba2Config(**MCFG), m2.Mamba2Config(**MCFG)
    if form == "prefill":
        x = rng.standard_normal((2, 16, 32)).astype(np.float32)
        kw = {}
    else:
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        kw = dict(state=rng.standard_normal((2, jc.n_heads, jc.d_state, jc.head_dim))
                  .astype(np.float32),
                  conv_state=rng.standard_normal((2, jc.conv_width - 1,
                                                  jc.d_inner + 2 * jc.d_state))
                  .astype(np.float32))
    want, (ws, wc) = jax.jit(lambda pp, v, **k: jm2.mamba2_apply(jctx(), pp, jc, v, **k))(
        p, x, **kw)
    got, (gs, gc) = m2.mamba2_apply(CPU[mode], as_t(p), pc, t(x),
                                    **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **F32)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **F32)


def test_mamba2_init_draws_the_reference_leaves():
    cfg = jm2.Mamba2Config(**MCFG)
    want = jax.tree.map(np.asarray, split_params(jm2.mamba2_init(
        jax.random.PRNGKey(0), cfg, jnp.float32))[0])
    got = m2.mamba2_init(torch.Generator().manual_seed(0), m2.Mamba2Config(**MCFG),
                         torch.float32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
    for k in ("A_log", "D", "dt_bias", "norm"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.fixture(scope="module")
def models():
    jb = jax_get_arch(ARCH).reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(np.asarray, jparams)
    # the Mamba blocks' per-head constants at random (see the docstring)
    rng = np.random.default_rng(9)
    blocks = [gm["m"] for gm in jparams["groups"]["mamba"]] + [b["m"] for b in jparams["tail"]]
    for m in blocks:
        for k, scale, base in (("A_log", 0.5, 0.0), ("D", 0.3, 1.0), ("dt_bias", 0.5, 0.0)):
            m[k] = (base + scale * rng.standard_normal(m[k].shape)).astype(np.float32)
    pb = get_arch(ARCH).reduced()
    return jb, jparams, pb, zamba2_params_from_numpy(jparams)


@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_shared_attn_matches_jax(rng, models, form):
    """The shared block with group 1's LoRA on [B, T, 2D]: causal over 12
    positions, and one decode step over a cache of 64 rows at per-slot
    positions (the updated cache rows too)."""
    jb, jparams, pb, pparams = models
    jcfg, pcfg = jb.config, pb.config
    gp = jax.tree.map(lambda a: a[1], {k: jparams["groups"][k] for k in ("lora_a", "lora_b")})
    sp = jparams["shared"]
    if form == "prefill":
        x = rng.standard_normal((2, 12, jcfg.d_attn)).astype(np.float32)
        want, _ = jax.jit(lambda s, g, v: jz._shared_attn(jctx(), jcfg, s, g, v))(sp, gp, x)
        for mode in MODES:
            got, kv = zamba2._shared_attn(CPU[mode], pcfg, pparams["shared"],
                                          pparams["groups"][1], t(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32, err_msg=mode)
            assert tuple(kv["k"].shape) == (2, 12, jcfg.n_kv_heads, jcfg.hd)
        return
    x = rng.standard_normal((2, 1, jcfg.d_attn)).astype(np.float32)
    shape = (2, jcfg.max_seq, jcfg.n_kv_heads, jcfg.hd)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    pos = np.array([5, 40], np.int32)
    want, wc = jax.jit(lambda s, g, v, c, p: jz._shared_attn(jctx(), jcfg, s, g, v, cache=c,
                                                             pos=p))(sp, gp, x, cache, pos)
    for mode in MODES:
        pc = {k: t(v.copy()) for k, v in cache.items()}
        got, gc = zamba2._shared_attn(CPU[mode], pcfg, pparams["shared"], pparams["groups"][1],
                                      t(x), cache=pc, pos=t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32, err_msg=mode)
        for k in ("k", "v"):
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **F32, err_msg=k)
            assert gc[k] is pc[k]            # updated in place


def test_flash_plain_at_head_size_224_matches_jax_ref(rng):
    """The flash op's plain version (what its CPU calls run; the kernel at d
    = 224 is held to it on the card) against the JAX oracle at zamba2-7b's
    head size, causal, and a CPU call asking for the CUDA-core path at 224
    runs it (the path takes 224) with no launch counted."""
    q, k, v = (rng.standard_normal((2, 40, 4, 224)).astype(np.float32) for _ in "qkv")
    want = jax_flash_ref(*(a.transpose(0, 2, 1, 3).reshape(8, 40, 224) for a in (q, k, v)),
                         causal=True, scale=224 ** -0.5)
    want = np.asarray(want).reshape(2, 4, 40, 224).transpose(0, 2, 1, 3)
    got = flash_attention_plain(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    before = flash_attention.launches
    forced = flash_attention(t(q), t(k), t(v), _path="cuda_core")
    torch.testing.assert_close(forced, got, rtol=0, atol=0)
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# the whole reduced zamba2-7b
# ---------------------------------------------------------------------------
B, S, STEPS = 2, 16, 4


def leaves_of(cache):
    """(group, leaf) -> array of a cache, the tail's None kept out."""
    return {(g, k): np.asarray(v) for g, sub in cache.items() if sub is not None
            for k, v in sub.items()}


@pytest.fixture(scope="module")
def jax_run(models):
    """The reference's prefill of a seeded prompt, then STEPS greedy decode
    steps from its state (k and v in rows [0, S) of init_cache's buffers):
    the logits of each and the final cache."""
    jb, jparams, _, _ = models
    ctx = jctx()
    tokens = np.random.default_rng(8).integers(0, jb.config.vocab, (B, S)).astype(np.int32)
    jl, jcache = jax.jit(jb.prefill_fn(ctx))(jparams, {"tokens": tokens})
    pre = (np.asarray(jl), leaves_of(jcache))
    dc = jb.init_cache(B)
    dc["mamba"] = jcache["mamba"]
    dc["tail"] = jcache["tail"]
    dc["attn"] = jax.tree.map(lambda full, got: full.at[:, :, :S].set(got), dc["attn"],
                              jcache["attn"])
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx)(jparams, tk, c, p))
    tok, logits = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), []
    for s in range(STEPS):
        lg, dc = jdec(tok, dc, np.full((B,), S + s, np.int32))
        logits.append(np.asarray(lg))
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
    return tokens, pre, logits, leaves_of(dc)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_jax(models, jax_run, mode):
    """Reduced zamba2-7b (2 groups of 2 Mamba blocks and a tail of 1, heads
    of 16 on 2 d_model): the prefill's last logits and every cache leaf
    (the SSM and conv states of every block, each group's k and v), then
    STEPS greedy decode steps from them and the final cache."""
    _, _, pb, pparams = models
    tokens, (jl, jcache), jlogits, jfinal = jax_run
    logits, cache = pb.prefill_fn(CPU[mode])(pparams, {"tokens": t(tokens)})
    assert logits.shape == (B, 1, pb.config.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jl, **F32)
    got = leaves_of(cache)
    assert set(got) == set(jcache)
    for key, want in jcache.items():
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key], want, **F32, err_msg=str(key))
    dc = pb.init_cache(B, "cpu")
    for g in ("mamba", "tail"):
        for k in dc[g]:
            dc[g][k].copy_(cache[g][k])
    for k in ("k", "v"):
        dc["attn"][k][:, :, :S] = cache["attn"][k]
    dec = pb.decode_fn(CPU[mode])
    tok = logits.argmax(-1).to(torch.int32)
    for s, want in enumerate(jlogits):
        lg, dc = dec(pparams, tok, dc, torch.full((B,), S + s, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), want, **F32, err_msg=f"step {s}")
        tok = lg.argmax(-1).to(torch.int32)
    for key, want in jfinal.items():
        np.testing.assert_allclose(leaves_of(dc)[key], want, **F32, err_msg=str(key))


def test_init_cache_has_the_reference_leaves(models):
    jb, _, pb, _ = models
    want = {k: (v.shape, str(v.dtype)) for k, v in leaves_of(jb.init_cache(3)).items()}
    got = {k: (v.shape, str(v.dtype)) for k, v in leaves_of(pb.init_cache(3, "cpu")).items()}
    assert got == want


def test_reset_slot_zeroes_only_that_slots_state(models):
    """``reset_slot`` zeroes every block's SSM and conv state of one slot and
    leaves the other slots and every KV row as they were."""
    _, _, pb, _ = models
    cache = pb.init_cache(3, "cpu")
    g = torch.Generator().manual_seed(3)
    for sub in cache.values():
        for v in sub.values():
            v.copy_(torch.randn(v.shape, generator=g))
    before = {(grp, k): v.clone() for grp, sub in cache.items() for k, v in sub.items()}
    out = pb.reset_slot_fn()(cache, 1)
    assert out is cache
    for (grp, k), was in before.items():
        slot_axis = {"mamba": 2, "tail": 1, "attn": 1}[grp]
        for s in range(3):
            got = cache[grp][k].select(slot_axis, s)
            if grp != "attn" and s == 1:
                assert not got.any(), (grp, k)
            else:
                torch.testing.assert_close(got, was.select(slot_axis, s), rtol=0, atol=0)
    assert get_arch("chatglm3-6b").reset_slot_fn() is None


def test_decode_launches_the_fused_gemv_per_block(models):
    """A kernel-mode step runs the fused GEMV + AllReduce once per Mamba
    block's w_out and once per group's shared MLP down (their plain
    versions here), a prefill once per block (the shared MLP's prefill
    runs the sequence-parallel products); phase 59 counts them on the card."""
    import repro_torch.core.matmul_allreduce as mar

    _, _, pb, pparams = models
    cfg = pb.config
    seen = []
    real = mar.fused_matmul_allreduce

    def spy(x, w, **kw):
        seen.append(tuple(x.shape))
        return real(x, w, **kw)
    tokens = torch.zeros((B, 4), dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mar, "fused_matmul_allreduce", spy)
        pb.prefill_fn(CPU["kernel"])(pparams, {"tokens": tokens})
        n_pre = len(seen)
        pb.decode_fn(CPU["kernel"])(pparams, tokens[:, :1], pb.init_cache(B, "cpu"),
                                    torch.zeros(B, dtype=torch.int32))
    assert n_pre == cfg.n_layers
    assert len(seen) - n_pre == cfg.n_layers + cfg.n_groups
    assert all(s == (B * 4, cfg.mamba.d_inner) for s in seen[:n_pre])


def test_params_from_numpy_unstacks_the_groups(models):
    """Group g's leaves are the reference's entry g of each stacked leaf, the
    per-group Mamba list and the LoRA among them; the shared block and the
    tail as they are; the tree has the port's own init's structure, shapes
    and dtypes."""
    jb, jparams, pb, pparams = models
    cfg = pb.config
    assert len(pparams["groups"]) == cfg.n_groups == 2
    assert len(pparams["tail"]) == cfg.n_tail == 1
    for g, gp in enumerate(pparams["groups"]):
        assert len(gp["mamba"]) == cfg.attn_every
        for i, mb in enumerate(gp["mamba"]):
            np.testing.assert_array_equal(mb["m"]["w_in"].numpy(),
                                          jparams["groups"]["mamba"][i]["m"]["w_in"][g])
            np.testing.assert_array_equal(mb["ln"].numpy(),
                                          jparams["groups"]["mamba"][i]["ln"][g])
        np.testing.assert_array_equal(gp["lora_b"].numpy(), jparams["groups"]["lora_b"][g])
    np.testing.assert_array_equal(pparams["shared"]["mlp"]["w_down"].numpy(),
                                  jparams["shared"]["mlp"]["w_down"])
    np.testing.assert_array_equal(pparams["tail"][0]["m"]["conv"].numpy(),
                                  jparams["tail"][0]["m"]["conv"])
    own = pb.init_params(torch.Generator().manual_seed(0))
    shapes = lambda p: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[-7:]), p)
    assert shapes(own) == shapes(pparams)


# ---------------------------------------------------------------------------
# the configs and the refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_registry_config_matches_the_reference_field_for_field(reduced):
    """``get_arch("zamba2-7b")`` and its ``reduced()`` (5 blocks, d 32, 4
    heads, attn_every 2, f32) equal the reference's field for field, the
    derived widths and the Mamba sub-config too."""
    jb, pb = jax_get_arch(ARCH), get_arch(ARCH)
    if reduced:
        jb, pb = jb.reduced(), pb.reduced()
    jc, pc = jb.config, pb.config
    assert [f.name for f in dataclasses.fields(pc)] == [f.name for f in dataclasses.fields(jc)]
    for f in dataclasses.fields(jc):
        assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    for prop in ("d_attn", "hd", "n_groups", "n_tail"):
        assert getattr(pc, prop) == getattr(jc, prop), prop
    assert dataclasses.asdict(pc.mamba) == dataclasses.asdict(jc.mamba)
    assert (pb.family, pb.optimizer, pb.microbatches) == (jb.family, jb.optimizer,
                                                          jb.microbatches)
    assert pb.shapes() == jb.shapes()
    if reduced:
        assert (pc.n_layers, pc.d_model, pc.n_heads, pc.attn_every, pc.param_dtype) == (
            5, 32, 4, 2, "float32")
    else:
        assert (pc.n_groups, pc.n_tail, pc.hd) == (13, 3, 224)


@pytest.mark.parametrize("what", ["tp", "init_tp", "cache_tp", "paged", "kernel_tp", "topk",
                                  "adafactor"])
def test_what_still_raises(models, what):
    """What zamba2 still refuses, each naming its reason: a tp that does not
    divide the Mamba heads (the reduced model has one) in ``check_tp``,
    ``init_params`` and ``init_cache``; the paged engine (the reference's
    refusal); kernel mode over more than one tp rank where a Mamba block's
    ``w_out`` reaches the fused GEMV/GEMM (ROADMAP Queue 1 item 1; the
    whole model's refusal runs on a world in
    tests/test_torch_zamba2_world.py); top-k compression and Adafactor over
    the heads' segmented dims."""
    import types

    from repro_torch.core.matmul_allreduce import matmul_allreduce
    from repro_torch.train import grad_compression, optimizer

    pb = models[2]
    heads = "does not divide the 1 Mamba heads"
    two = types.SimpleNamespace(tp=2, dp=1, tp_rank=0, dp_rank=0)
    if what == "tp":
        with pytest.raises(ValueError, match=heads):
            pb.decode_fn(two)
    elif what == "init_tp":
        with pytest.raises(ValueError, match=heads):
            pb.init_params(torch.Generator().manual_seed(0), two)
    elif what == "cache_tp":
        with pytest.raises(ValueError, match=heads):
            pb.init_cache(2, "cpu", tp=2)
    elif what == "paged":
        assert not pb.supports_paged
        with pytest.raises(SystemExit, match="GQA transformer"):
            launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--paged"])
    elif what == "kernel_tp":
        ctx = types.SimpleNamespace(tp=2, fusion=FusionConfig(mode="kernel"))
        w_out = torch.zeros(pb.config.mamba.d_inner // 2, pb.config.d_model)
        with pytest.raises(NotImplementedError, match="tp=2: ROADMAP Queue 1 item 1"):
            matmul_allreduce(ctx, torch.zeros(2, 4, w_out.shape[0]), w_out)
    else:
        spec = m2.param_specs(pb.config.mamba)["w_in"]
        with pytest.raises(NotImplementedError, match="segmented tp dim"):
            if what == "topk":
                grad_compression._global_index((4, 4), spec, two)
            else:
                optimizer._Shards(spec, two)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------
N_REQ, BATCH, MAX_NEW = 6, 2, 5


@pytest.fixture(scope="module")
def engine_runs(models):
    """The reference's engine (what its launcher builds) on the reduced
    model: its streams over the launcher's seeded requests, and a fresh
    engine's on each of those that took a reused slot (the requests after
    the first BATCH), each alone."""
    jb, jparams, pb, _ = models
    decode = jb.decode_fn(jctx())
    step = jax.jit(lambda tk, c, p: decode(jparams, tk, c, p))

    def drain(reqs):
        eng = JaxDecodeEngine(step, jb.init_cache, BATCH, max_seq=jb.config.max_seq)
        for r in reqs:
            eng.submit(JaxRequest(uid=r.uid, prompt=r.prompt, max_new=MAX_NEW))
        return {r.uid: r.tokens for r in eng.run_until_drained(max_steps=500)}
    reqs = launch_serve.make_requests(N_REQ, pb.config.vocab, MAX_NEW)
    fresh = {}
    for r in reqs[BATCH:]:
        fresh.update(drain([r]))
    return reqs, drain(reqs), fresh


@pytest.fixture(scope="module")
def launcher_streams(models):
    """The port's serve launcher (``--arch zamba2-7b --reduced``, kernel
    mode, in this process) on the reference's weights (its ``PRNGKey(0)``
    draw converted, with the per-head constants drawn in ``models``)."""
    pparams = models[3]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ArchBundle, "init_params", lambda self, gen, ctx=None, training=False:
                   pparams)
        fin = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
                                 str(N_REQ), "--batch", str(BATCH), "--max-new", str(MAX_NEW)])
    return {r.uid: r.tokens for r in fin}


def test_launcher_first_wave_matches_the_reference_engine(engine_runs, launcher_streams):
    """The first BATCH requests start on fresh slots in both engines: the
    same greedy streams."""
    reqs, ref, _ = engine_runs
    first = [r.uid for r in reqs[:BATCH]]
    assert {u: launcher_streams[u] for u in first} == {u: ref[u] for u in first}
    assert set(launcher_streams) == set(ref)


def test_launcher_reused_slots_match_a_fresh_engine(models, engine_runs, launcher_streams):
    """Every later request takes a reused slot, whose state the port's engine
    zeroes: its stream is a fresh engine's on that request alone (the
    reference's fresh streams, and the port's own fresh engine's)."""
    _, _, pb, pparams = models
    reqs, _, ref_fresh = engine_runs
    decode = pb.decode_fn(CPU["kernel"])
    for r in reqs[BATCH:]:
        eng = DecodeEngine(lambda tk, c, p: decode(pparams, tk, c, p),
                           lambda b: pb.init_cache(b, "cpu"), BATCH, device="cpu",
                           max_seq=pb.config.max_seq, reset_slot_fn=pb.reset_slot_fn())
        eng.submit(Request(uid=r.uid, prompt=list(r.prompt), max_new=MAX_NEW))
        (done,) = eng.run_until_drained()
        assert launcher_streams[r.uid] == done.tokens == ref_fresh[r.uid], r.uid


def test_reference_engine_reuses_a_slots_stale_state(engine_runs):
    """The reference's engine resets only a reused slot's position: its
    requests after the first wave start from the state of the request that
    held their slot, and their streams part from a fresh engine's (the
    difference the port's reset removes; ROADMAP Queue 3)."""
    reqs, ref, ref_fresh = engine_runs
    stale = [r.uid for r in reqs[BATCH:] if ref[r.uid] != ref_fresh[r.uid]]
    assert stale, "the reference's reused slots gave a fresh engine's streams"


def test_engine_resets_on_every_admission():
    """``reset_slot_fn`` runs for each request that takes a slot, in slot
    order, first admissions and a reshard's re-admissions alike."""
    calls = []
    eng = DecodeEngine(lambda tk, c, p: (torch.zeros((tk.shape[0], 1, 4)), c),
                       lambda b: {}, 2, device="cpu", max_seq=32,
                       reset_slot_fn=lambda c, i: calls.append(i) or c)
    for u in range(3):
        eng.submit(Request(uid=u, prompt=[1, 2], max_new=2))
    eng.step()
    assert calls == [0, 1]
    eng.reshard(eng.decode_fn, eng.init_cache_fn)
    eng.step()
    assert calls == [0, 1, 0, 1]
    eng.run_until_drained()
    assert calls == [0, 1, 0, 1, 0]
