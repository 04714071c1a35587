"""The front ends and M-RoPE: qwen2-vl-2b and musicgen-medium against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function on a
(1, 1) data x model mesh of CPU devices (its numbers do not depend on the
mesh) and through its counterpart in ``repro_torch`` on the CPU: one rank in
every mode (kernel mode runs the kernels' plain versions here), and tp = 2
and (dp, tp) = (2, 1) in bulk and fused mode on a gloo world of CPU
processes (``tests/torch_world.py``).  The JAX weights are carried over by
``params_from_numpy``.  A vision batch puts ``N_PATCHES`` patch embeddings
on a grid of 3 (``mrope_positions``) ahead of the text, so at tp = 2 the
patches cross the ranks' sequence chunks; an audio batch adds its frame
embeddings everywhere.  f32 throughout.  Tolerances: ``TOL["f32"]`` of
tests/test_parity_matrix.py (f32 sums in another order) for logits, caches
and M-RoPE; losses at rtol 1e-5 and gradients at rtol 2e-3, atol 1e-5
(tests/test_loss.py's); six AdamW steps' losses at rtol 1e-4
(tests/test_torch_train.py's).  Positions, the launcher's batches and
``shard_batch`` are held bit for bit.  The JAX compiles are memoised.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.launch import train as jax_launch_train
from repro.models import frontends as jfront
from repro.models import rope as jrope
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.registry import ArchBundle, get_arch
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import frontends, rope, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves, tree_paths
from repro_torch.train.step import TrainConfig, build_train_step, init_train_state
from torch_world import World

torch.backends.cuda.matmul.allow_tf32 = False

F32 = TOL["f32"]
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=2e-3, atol=1e-5)
STEPS = dict(rtol=1e-4, atol=0)
ARCHS = ("qwen2-vl-2b", "musicgen-medium")
MODES = ("kernel", "bulk", "fused")
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in MODES}
B, S, N_PATCHES = 4, 16, 9
LAYOUTS = [(1, 2), (2, 1)]                  # (dp, tp)


def t(a):
    return torch.from_numpy(np.array(a))


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def jctx(mode="fused"):
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                fusion=JaxFusion(mode=mode))


def models(arch):
    """(JAX bundle, JAX params, port bundle, port params, numpy tree) of the
    reduced ``arch`` from the reference's ``PRNGKey(0)`` draw."""
    def make():
        jb = jax_get_arch(arch).reduced()
        jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
        tree = jax.tree.map(np.asarray, jparams)
        return jb, jparams, get_arch(arch).reduced(), params_from_numpy(tree), tree
    return memo(("models", arch), make)


def extras(arch, seed=0, b=B, s=S):
    """A front end's inputs as numpy: vision embeddings on the first
    ``N_PATCHES`` positions with their M-RoPE streams, or audio frames."""
    cfg = get_arch(arch).reduced().config
    rng = np.random.default_rng(100 + seed)
    emb = (rng.standard_normal((b, s, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        return {"frame_embeds": emb}
    return {"vision_embeds": emb, "vision_mask": np.arange(s) < N_PATCHES,
            "positions_thw": np.asarray(jfront.mrope_positions(b, s, N_PATCHES))}


def prompt(arch, seed=3, b=B, s=S):
    vocab = get_arch(arch).reduced().config.vocab
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def jax_decode(arch):
    """The reference's jitted decode step (one compile a model: every caller
    decodes B rows of a max_seq cache)."""
    jb, jparams = models(arch)[:2]
    decode = jb.decode_fn(jctx())
    return memo(("jdecode", arch), lambda: jax.jit(lambda tk, c, p: decode(jparams, tk, c, p)))


def jax_prefill(arch):
    jb, jparams = models(arch)[:2]

    def make():
        lg, cache = jax.jit(jb.prefill_fn(jctx()))(jparams, {"tokens": prompt(arch),
                                                             **extras(arch)})
        return np.asarray(lg), {k: np.asarray(v) for k, v in cache["scan"].items()}
    return memo(("prefill", arch), make)


# ---------------------------------------------------------------------------
# M-RoPE and the stub front ends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("streams", ["vision", "random"])
def test_apply_mrope_matches_jax(streams):
    """Each stream's angles on its own section of the frequency bands, the
    rotation interleaved: the reference's at the qwen2-vl and reduced
    sections."""
    rng = np.random.default_rng(7)
    for hd, sections in ((128, (16, 24, 24)), (32, (4, 6, 6))):
        x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
        pos = (np.asarray(jfront.mrope_positions(2, 12, 6, 2)) if streams == "vision" else
               rng.integers(0, 500, (3, 2, 12)).astype(np.int32))
        want = np.asarray(jrope.apply_mrope(x, pos, theta=1e6, sections=sections))
        got = rope.apply_mrope(t(x), t(pos), theta=1e6, sections=sections)
        np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=str(sections))


def test_apply_mrope_on_equal_streams_is_apply_rope_bit_for_bit():
    """Text positions (three equal streams) recover standard RoPE at the
    same theta, bit for bit; sections that do not fill ``hd // 2`` raise."""
    x = torch.randn(2, 5, 3, 32, generator=torch.Generator().manual_seed(0))
    pos = torch.randint(0, 4000, (2, 5), generator=torch.Generator().manual_seed(1))
    got = rope.apply_mrope(x, pos[None].expand(3, 2, 5), theta=1e6, sections=(4, 6, 6))
    torch.testing.assert_close(got, rope.apply_rope(x, pos, theta=1e6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="head_dim // 2 = 16"):
        rope.apply_mrope(x, pos[None].expand(3, 2, 5), sections=(16, 24, 24))


@pytest.mark.parametrize("case", [(2, 300, 256, 0), (3, 20, 9, 0), (1, 16, 9, 4), (2, 8, 12, 0),
                                  (2, 10, 0, 0), (1, 7, 5, 2)])
def test_mrope_positions_match_jax_exactly(case):
    """The reference's integers: the patch grid, and the text continuing at
    ``n_patches // g + 1`` (patches past S, no patches, an explicit grid)."""
    want = np.asarray(jfront.mrope_positions(*case))
    got = frontends.mrope_positions(*case)
    assert got.dtype == torch.int32 and got.shape == want.shape == (3, case[0], case[1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_stub_front_ends_draw_on_the_generators_device():
    """Shapes, scale, mask and determinism of the stand-ins; the reference
    draws from ``jax.random``, so the parity tests feed both sides numpy."""
    emb = frontends.audio_frame_embeddings(torch.Generator().manual_seed(0), 2, 64, 32)
    again = frontends.audio_frame_embeddings(torch.Generator().manual_seed(0), 2, 64, 32)
    assert emb.shape == (2, 64, 32) and emb.dtype == torch.float32
    torch.testing.assert_close(emb, again, rtol=0, atol=0)
    assert abs(emb.std().item() - 0.02) < 2e-3
    vis, mask = frontends.vision_patch_embeddings(torch.Generator().manual_seed(1), 2, 16, 32, 5,
                                                  dtype=torch.bfloat16)
    assert vis.shape == (2, 16, 32) and vis.dtype == torch.bfloat16
    assert mask.tolist() == [True] * 5 + [False] * 11


# ---------------------------------------------------------------------------
# the data: the launcher's batches and shard_batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batches_match_the_reference_launchers_bit_for_bit(arch):
    for reduced in (True, False):
        jb, pb = jax_get_arch(arch), get_arch(arch)
        if reduced:
            jb, pb = jb.reduced(), pb.reduced()
        want, got = jax_launch_train.make_batches(jb, 2, 12), launch_train.make_batches(pb, 2, 12)
        for _ in range(2):
            w, g = next(want), next(got)
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _ctx(dp, dp_rank):
    return types.SimpleNamespace(tp=1, tp_rank=0, dp=dp, dp_rank=dp_rank)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_batch_splits_the_front_end_extras_by_rows(arch):
    """``positions_thw`` [3, B, S] splits on its batch axis, ``vision_mask``
    [S] stays whole, every [B, ...] leaf splits on axis 0; B comes from the
    tokens; a batch dp does not divide stays whole."""
    batch = {"tokens": t(prompt(arch)), "labels": t(prompt(arch, 4)),
             **{k: t(v) for k, v in extras(arch).items()}}
    for r in range(2):
        got = shard_batch(batch, _ctx(2, r))
        rows = slice(2 * r, 2 * r + 2)
        for k, v in batch.items():
            want = (v if k == "vision_mask" else v[:, rows] if k == "positions_thw" else v[rows])
            torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)
    odd = {k: v[:, :3] if k == "positions_thw" else v if k == "vision_mask" else v[:3]
           for k, v in batch.items()}
    assert shard_batch(odd, _ctx(2, 1)) is odd


def test_shard_batch_keeps_todays_batches():
    """An LM batch without extras splits as before, each leaf's rows on
    axis 0; a DLRM batch over the world (its rows, and its tables'
    indices)."""
    rng = np.random.default_rng(0)
    lm = {"tokens": t(rng.integers(0, 9, (4, 6))), "labels": t(rng.integers(0, 9, (4, 6)))}
    for r in range(2):
        got = shard_batch(lm, _ctx(2, r))
        for k, v in lm.items():
            torch.testing.assert_close(got[k], v[2 * r:2 * r + 2], rtol=0, atol=0)
    assert shard_batch(lm, _ctx(1, 0)) is lm
    dlrm = {"dense": t(rng.standard_normal((4, 3))), "labels": t(rng.standard_normal(4)),
            "indices": t(rng.integers(0, 9, (4, 2, 5)))}
    got = shard_batch(dlrm, _ctx(2, 1))
    torch.testing.assert_close(got["indices"], dlrm["indices"][:, 1:], rtol=0, atol=0)
    torch.testing.assert_close(got["dense"], dlrm["dense"][2:], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# one rank: prefill, the hand-off, training, the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_config_matches_the_reference_field_for_field(arch, reduced):
    jb, pb = jax_get_arch(arch), get_arch(arch)
    if reduced:
        jb, pb = jb.reduced(), pb.reduced()
    assert [f.name for f in dataclasses.fields(pb.config)] == \
        [f.name for f in dataclasses.fields(jb.config)]
    for f in dataclasses.fields(jb.config):
        assert getattr(pb.config, f.name) == getattr(jb.config, f.name), f.name
    assert (pb.family, pb.optimizer, pb.microbatches) == (jb.family, jb.optimizer,
                                                          jb.microbatches)
    if reduced and arch == "qwen2-vl-2b":
        assert (pb.config.mrope_sections, pb.config.head_dim) == ((4, 6, 6), 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_gives_the_ports_own_tree(arch):
    """The converter needs nothing new for these configs: the JAX tree
    converts to the port's own init's structure, shapes and dtypes, each
    leaf the reference's bits."""
    _, _, pb, pparams, tree = models(arch)
    own = pb.init_params(torch.Generator().manual_seed(0))
    shapes = lambda p: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[-7:]), p)
    assert shapes(own) == shapes(pparams)
    for i, lp in enumerate(pparams["layers"]):
        np.testing.assert_array_equal(lp["attn"]["w_qkv"].numpy(),
                                      tree["layers"]["l0"]["attn"]["w_qkv"][i])
    np.testing.assert_array_equal(pparams["embed"]["table"].numpy(), tree["embed"]["table"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, mode):
    """Last logits and every layer's k (after M-RoPE) and v."""
    _, _, pb, pparams, _ = models(arch)
    want, jcache = jax_prefill(arch)
    batch = {"tokens": t(prompt(arch)), **{k: t(v) for k, v in extras(arch).items()}}
    logits, cache = pb.prefill_fn(CPU[mode])(pparams, batch)
    assert logits.shape == (B, 1, pb.config.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), jcache[key], **F32, err_msg=key)
    # the front end reaches the model: without it the logits move
    plain, _ = pb.prefill_fn(CPU[mode])(pparams, {"tokens": batch["tokens"], **(
        {"positions_thw": batch["positions_thw"]} if "positions_thw" in batch else {})})
    assert not torch.allclose(plain, logits, **F32)


def _decode_cache(pb, cache):
    dc = pb.init_cache(cache["k"].shape[1], "cpu")
    for key in dc:
        dc[key][:, :, :cache[key].shape[2]] = cache[key]
    return dc


@pytest.mark.parametrize("arch", ARCHS)
def test_handoff_decode_streams_match_jax(arch):
    """Four greedy decode steps from the front-end prefill's cache (the text
    phase: three equal streams at the cache index), every mode: the logits
    and the tokens are the reference's."""
    jb, jparams, pb, pparams, _ = models(arch)
    jl, jcache = jax_prefill(arch)
    steps = 4

    def make():
        jdec = jax_decode(arch)
        jc = jb.init_cache(B)
        jc = {"scan": {k: jc["scan"][k].at[:, :, :S].set(jcache[k]) for k in jc["scan"]}}
        tok, out = np.argmax(jl, axis=-1).astype(np.int32), []
        for i in range(steps):
            lg, jc = jdec(tok, jc, np.full((B,), S + i, np.int32))
            out.append(np.asarray(lg))
            tok = np.argmax(out[-1], axis=-1).astype(np.int32)
        return np.stack(out)
    want = memo(("decode", arch), make)
    batch = {"tokens": t(prompt(arch)), **{k: t(v) for k, v in extras(arch).items()}}
    for mode in MODES:
        lg, cache = pb.prefill_fn(CPU[mode])(pparams, batch)
        cache, dec = _decode_cache(pb, cache), pb.decode_fn(CPU[mode])
        tok, got = lg.argmax(-1).to(torch.int32), []
        for i in range(steps):
            lg, cache = dec(pparams, tok, cache, torch.full((B,), S + i, dtype=torch.int32))
            got.append(lg.numpy())
            tok = lg.argmax(-1).to(torch.int32)
        np.testing.assert_allclose(np.stack(got), want, **F32, err_msg=mode)
        np.testing.assert_array_equal(np.stack(got).argmax(-1), want.argmax(-1))


def test_decode_after_a_vision_prefill_rotates_at_the_cache_index():
    """A fact of the reference, kept: ``mrope_positions``' text continues at
    ``n_patches // g + 1`` (17 after 256 patches on a grid of 16, not 256),
    but decode rotates token S at position S, three equal streams (the
    reference has no ``rope_deltas``).  So a decode step after a vision
    prefill of S is a prefill of S + 1 whose last column is (S, S, S), not
    one that continues the streams."""
    thw = frontends.mrope_positions(1, 300, 256)
    assert thw[:, 0, 256].tolist() == [17, 17, 17] == np.asarray(
        jfront.mrope_positions(1, 300, 256))[:, 0, 256].tolist()
    _, _, pb, pparams, _ = models("qwen2-vl-2b")
    ex = extras("qwen2-vl-2b", b=B, s=S + 1)
    tokens = t(prompt("qwen2-vl-2b", s=S + 1))
    head = {"tokens": tokens[:, :S], "vision_embeds": t(ex["vision_embeds"][:, :S]),
            "vision_mask": t(ex["vision_mask"][:S]),
            "positions_thw": t(ex["positions_thw"][..., :S])}
    _, cache = pb.prefill_fn(CPU["bulk"])(pparams, head)
    dec, _ = pb.decode_fn(CPU["bulk"])(pparams, tokens[:, S:], _decode_cache(pb, cache),
                                       torch.full((B,), S, dtype=torch.int32))
    full = {**{k: t(v) for k, v in ex.items()}, "tokens": tokens}
    continued = full["positions_thw"][0, 0, S].item()
    assert continued == N_PATCHES // 3 + 1 + (S - N_PATCHES) != S
    at_index = full["positions_thw"].clone()
    at_index[..., S] = S
    want, _ = pb.prefill_fn(CPU["bulk"])(pparams, {**full, "positions_thw": at_index})
    torch.testing.assert_close(dec, want, **F32)
    other, _ = pb.prefill_fn(CPU["bulk"])(pparams, full)
    assert not torch.allclose(dec, other, **F32)


def test_mrope_batch_without_its_positions_raises():
    _, _, pb, pparams, _ = models("qwen2-vl-2b")
    with pytest.raises(ValueError, match="positions_thw"):
        pb.prefill_fn(CPU["bulk"])(pparams, {"tokens": t(prompt("qwen2-vl-2b"))})


def jax_steps(arch, steps=6, batch=B, seq=S):
    """The reference's jitted AdamW step over the reference launcher's
    batches: each step's loss."""
    jb, jparams = models(arch)[:2]

    def make():
        tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(lr=3e-3, warmup_steps=5,
                                                              total_steps=steps))
        fn = jax.jit(jstep.build_train_step(jb.loss_fn(jctx()), tc))
        state, out = jstep.init_train_state(tc, jparams), []
        it = jax_launch_train.make_batches(jb, batch, seq)
        for _ in range(steps):
            state, m = fn(state, next(it))
            out.append(float(m["loss"]))
        return out
    return memo(("steps", arch, steps, batch, seq), make)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_six_train_steps_match_jax(arch, mode):
    """Six AdamW steps through ``build_train_step`` on the launcher's
    batches with their extras: the losses are the reference's, and fall."""
    _, _, pb, _, tree = models(arch)
    params = params_from_numpy(tree)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tc = TrainConfig(optimizer=OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=6))
    step = build_train_step(pb.loss_fn(CPU[mode]), tc, ctx=CPU[mode])
    state, got = init_train_state(tc, params), []
    it = launch_train.make_batches(pb, B, S)
    for _ in range(6):
        state, m = step(state, to_device(next(it), "cpu"))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, jax_steps(arch), **STEPS)
    assert got[-1] < got[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_matches_the_reference_loop(monkeypatch, arch, capsys):
    """``python -m repro_torch.launch.train --arch ARCH --reduced --device
    cpu`` (kernel mode) on the JAX init's weights: the reference loop's
    losses on the reference launcher's batches, extras included."""
    tree = models(arch)[4]
    monkeypatch.setattr(ArchBundle, "init_params", lambda self, gen: params_from_numpy(tree))
    got = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "6",
                             "--batch", str(B), "--seq", str(S)])
    np.testing.assert_allclose(got, jax_steps(arch), **STEPS)
    assert "done at step 6" in capsys.readouterr().out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_streams_match_the_reference_engine(arch, paged, capsys):
    """The serve launcher (``--reduced``, kernel mode, in this process, the
    dense engine and ``--paged``) on the reference's weights and prompts
    gives the greedy streams of the reference's ``DecodeEngine``."""
    jb, _, pb, pparams, _ = models(arch)
    n_req, batch, max_new = 6, B, 5

    def make():
        eng = JaxDecodeEngine(jax_decode(arch), jb.init_cache, batch, max_seq=jb.config.max_seq)
        for r in launch_serve.make_requests(n_req, pb.config.vocab, max_new):
            eng.submit(JaxRequest(uid=r.uid, prompt=r.prompt, max_new=max_new))
        return {r.uid: r.tokens for r in eng.run_until_drained(max_steps=200)}
    want = memo(("engine", arch), make)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ArchBundle, "init_params", lambda self, gen, ctx=None, training=False:
                   pparams)
        fin = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests",
                                 str(n_req), "--batch", str(batch), "--max-new", str(max_new)]
                                + (["--paged", "--block-size", "8", "--chunk", "4"] if paged
                                   else []))
    assert {r.uid: r.tokens for r in fin} == want
    assert f"served {n_req} requests, {n_req * max_new} tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# over (dp, tp) worlds: prefill, paged serving, the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, layout, **inputs):
    """The task's per-rank results at (dp, tp) = ``layout`` (both pairs run
    it and must agree)."""
    dp, tp = layout
    out = world.run(name, tp, dp=dp, **inputs)
    for a, b in zip(out[:2], out[2:]):
        for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(u, v)
    return out[:2]


def block(a, n, d, axis):
    size = a.shape[axis] // n
    return np.take(a, np.arange(d * size, (d + 1) * size), axis=axis)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=["tp2", "dp2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_over_a_world_matches_jax(world, arch, layout, mode):
    """Every rank's logits are JAX's; its cache its replica's rows of its tp
    rank's sequence chunk (the patches cross the chunks at tp = 2)."""
    dp, tp = layout
    want, cache = jax_prefill(arch)
    per_rank = run(world, "prefill_task", layout, tree=models(arch)[4], tokens=prompt(arch),
                   mode=mode, arch=arch, extras=extras(arch))
    for r, (logits, k, v) in enumerate(per_rank):
        np.testing.assert_allclose(logits, want, **F32)
        for got, name in ((k, "k"), (v, "v")):
            rows = block(cache[name], dp, r // tp, 1)
            np.testing.assert_allclose(got, block(rows, tp, r % tp, 2), **F32, err_msg=name)


def serve_steps(vocab):
    """Two C = 4 prefill chunks (slot 2 idle, slot 3 a chunk of 3), then a
    C = 1 decode step, on tables of 8 blocks of 8 striped over 2."""
    rng = np.random.default_rng(5)
    pos = [np.array(p, np.int32) for p in ([0, 0, 0, 0], [4, 4, 0, 3])]
    n_new = [np.array(n, np.int32) for n in ([4, 4, 0, 3], [4, 2, 0, 1])]
    steps = [(rng.integers(0, vocab, (4, 4)).astype(np.int32), p, n) for p, n in zip(pos, n_new)]
    steps.append((rng.integers(0, vocab, (4, 1)).astype(np.int32), np.array([8, 6, 0, 4],
                                                                            np.int32),
                  np.array([1, 1, 0, 1], np.int32)))
    return steps


SERVE_TABLES = np.array([[0, 4], [1, 5], [-1, -1], [6, 2]], np.int32)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=["tp2", "dp2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serve_step_over_a_world_matches_jax(world, arch, layout, mode):
    """Mixed chunk and decode steps of ``serve_step`` (the text phase: M-RoPE
    on three equal streams) over the pool striped over tp (replicated over
    data): the live slots' logits are JAX's on every rank."""
    jb, jparams, _, _, tree = models(arch)
    steps = serve_steps(jb.config.vocab)

    def make():
        fn = jb.serve_step_fn(jctx())
        jserve = jax.jit(lambda tk, pl, tb, p, n: fn(jparams, tk, pl, tb, p, n))
        jpool, logits = jb.init_paged_pool(8, 8), []
        for tk, pos, nn in steps:
            lg, jpool = jserve(tk, jpool, SERVE_TABLES, pos, nn)
            logits.append(np.asarray(lg))
        return logits
    want = memo(("serve", arch), make)
    live = [0, 1, 3]
    for logits, _, _ in run(world, "paged_serve_task", layout, tree=tree, arch=arch, mode=mode,
                            steps=steps, tables=SERVE_TABLES, nb=8, block=8):
        for got, w in zip(logits, want):
            np.testing.assert_allclose(got[live], w[live], **F32)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=["tp2", "dp2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_over_a_world_match_jax(world, arch, layout, mode):
    """``loss_fn`` on the training shards with the front end's extras: the
    loss (every rank the same) and every gradient, each rank's shard
    against its slice of the reference's ``jax.value_and_grad``."""
    jb, jparams, _, _, tree = models(arch)
    labels = prompt(arch, 4)
    batch = {"tokens": prompt(arch), "labels": labels, **extras(arch)}

    def make():
        loss, grads = jax.jit(jax.value_and_grad(jb.loss_fn(jctx())))(jparams, batch)
        return float(loss), jax.tree.map(np.asarray, grads)
    want_loss, want = memo(("loss", arch), make)
    dp, tp = layout
    names = [".".join(map(str, p)) for p, _ in tree_paths(params_from_numpy(tree))]
    per_rank = run(world, "loss_grads_task", layout, tree=tree, tokens=prompt(arch),
                   labels=labels, mode=mode, arch=arch, extras=extras(arch))
    for r, (loss, grads) in enumerate(per_rank):
        np.testing.assert_allclose(loss, want_loss, **LOSS)
        place = types.SimpleNamespace(tp=tp, tp_rank=r % tp, dp=dp, dp_rank=r // tp)
        shards = [a.numpy() for a in tree_leaves(params_from_numpy(want, "cpu", place,
                                                                   training=True))]
        for name, g, w in zip(names, grads, shards, strict=True):
            np.testing.assert_allclose(g, w, **GRAD, err_msg=f"rank {r} {name}")
