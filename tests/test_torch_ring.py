"""The port's sequence-sharded prefill at tp = 2 and 4 against the JAX package:
the KV ring of ``context_attention`` in bulk, fused and kernel mode, the
sequence-sharded embedding ring, the reduced chatglm3-6b's and gemma2-27b's
``prefill_fn``, the ring's calibration builder, and reduced gemma2's decode
at tp = 4 with windows that cross the ranks' cache rows.

The same numpy inputs, made from a seed, go through each JAX function on a
(1, tp) data x model mesh of conftest's CPU devices and through its port on
a gloo world of CPU processes (``tests/torch_world.py``), each rank on its
chunk of the sequence.  The port's kernel mode runs the flash op a hop,
whose plain version a CPU tensor takes, with the ring's online-softmax
merge; it is held to the JAX package's fused mode (the same ring; the JAX
package's kernel mode is its fused ring too).  The JAX package runs its
blockwise attention at blocks of 16, and every span here is a multiple of
them: its ``_span_flash`` drops the tail blocks (ROADMAP Queue 3).  f32 at
``TOL["f32"]`` of tests/test_parity_matrix.py; a compressed wire at its
``WIRE_TOL``.
"""
import json
import re

import jax
import numpy as np
import pytest

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from torch_world import World

TOL = dict(rtol=3e-4, atol=3e-4)                 # TOL["f32"]
WIRE_TOL = {"f32": TOL, "bf16": dict(rtol=3e-2, atol=3e-2),
            "fp8": dict(rtol=2e-1, atol=2e-1)}   # WIRE_TOL of test_parity_matrix.py
TPS = [2, 4]
JAX_MODE = {"bulk": "bulk", "fused": "fused", "kernel": "fused"}
B, S, HQ, HKV, HD = 2, 64, 4, 2, 16
# (causal, window, softcap) of the attention cases
CASES = {"causal": (True, None, None), "window 24": (True, 24, None),
         "cap 30": (True, None, 30.0), "non-causal": (False, None, None)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, tp, **inputs):
    """The task's per-rank results at tp (the tp = 2 pairs must agree)."""
    out = world.run(name, tp, **inputs)
    if tp == 2:
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(u, v)
    return out[:tp]


def jctx(tp, mode="fused", **fusion):
    return JaxContext.from_mesh(make_mesh((1, tp), ("data", "model")),
                                fusion=JaxFusion(mode=mode, **fusion))


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal((B, S, h, HD)).astype(np.float32) for h in (HQ, HKV, HKV))


_JAX = {}


def jax_attention(qkv, tp, mode, case, **fusion):
    """The JAX package's context_attention on a (1, tp) mesh, memoised."""
    key = (tp, mode, case, tuple(sorted(fusion.items())))
    if key not in _JAX:
        causal, window, cap = CASES[case]
        c = jctx(tp, mode, **fusion)
        _JAX[key] = np.asarray(jax.jit(lambda q, k, v: jattn.context_attention(
            c, q, k, v, causal=causal, window=window, softcap_val=cap, q_block=16,
            kv_block=16))(*qkv))
    return _JAX[key]


# ---------------------------------------------------------------------------
# the KV ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["bulk", "fused", "kernel"])
@pytest.mark.parametrize("tp", TPS)
def test_context_attention_matches_jax(world, qkv, tp, mode, case):
    """Each rank's chunk of the output against the JAX package's; in kernel
    mode rank d calls the flash op 1 + d times a causal unwindowed layer
    (a hop wholly above the diagonal launches nothing), every hop otherwise."""
    causal, window, cap = CASES[case]
    want = jax_attention(qkv, tp, JAX_MODE[mode], case)
    q, k, v = qkv
    per_rank = run(world, "ring_attention_task", tp, q=q, k=k, v=v, mode=mode, causal=causal,
                   window=window, cap=cap)
    got = np.concatenate([r[0][0] for r in per_rank], axis=1)
    np.testing.assert_allclose(got, want, **TOL)
    calls = [r[2][0] for r in per_rank]
    if mode != "kernel":
        assert calls == [0] * tp
    elif causal and window is None:
        assert calls == [1 + d for d in range(tp)]
    elif not causal:
        assert calls == [tp] * tp


@pytest.mark.parametrize("mode", ["fused", "kernel"])
@pytest.mark.parametrize("tp", TPS)
def test_ring_sub_chunks_and_skew(world, qkv, tp, mode):
    """chunks_per_rank 2 (each sub-chunk rings on its own) against the JAX
    package's ring at granularity 2, and skew 1 bit-identical to skew 0:
    the rotation reorders only the waits and sends."""
    want = jax_attention(qkv, tp, "fused", "window 24", granularity=2)
    q, k, v = qkv
    per_rank = run(world, "ring_attention_task", tp, q=q, k=k, v=v, mode=mode, window=24,
                   qs=2, skews=(0, 1))
    for skew in (0, 1):
        got = np.concatenate([r[0][skew] for r in per_rank], axis=1)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"skew {skew}")
    for outs, _, _ in per_rank:
        np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("mode", ["fused", "kernel"])
@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_ring_compressed_wire(world, qkv, wire, mode):
    """A bf16 and an fp8 wire (the KV payload rounds once at its source)
    against the JAX package's ring on the same wire, at tp = 4."""
    want = jax_attention(qkv, 4, "fused", "causal", wire=wire)
    q, k, v = qkv
    per_rank = run(world, "ring_attention_task", 4, q=q, k=k, v=v, mode=mode, wire=wire)
    got = np.concatenate([r[0][0] for r in per_rank], axis=1)
    np.testing.assert_allclose(got, want, **WIRE_TOL[wire])


@pytest.mark.parametrize("window,hops", [(None, 3), (24, 2), (16, 1), (40, 3)])
def test_windowed_ring_bounds_its_hops(world, qkv, window, hops):
    """A windowed causal layer runs ceil(window / s_loc) hops (of tp - 1 = 3
    at s_loc = 16): each hop sends k and v once a sub-chunk, 2 sub-chunks
    here; bulk mode sends nothing on the ring."""
    q, k, v = qkv
    for mode, want in (("fused", 2 * 2 * hops), ("bulk", 0)):
        for _, sends, _ in run(world, "ring_attention_task", 4, q=q, k=k, v=v, mode=mode,
                               window=window, qs=2):
            assert sends == [want], mode


# ---------------------------------------------------------------------------
# the embedding ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["comm_aware", "oblivious"])
@pytest.mark.parametrize("tp", TPS)
def test_embedding_seq_shard_matches_jax(world, rng, tp, schedule):
    """The reference's ring reduce-scatter of the vocabulary partials (every
    rank's chunk, exact), and its fall back to the all-reduce and the whole
    sequence where S does not split over the ranks."""
    table = rng.standard_normal((64, 16)).astype(np.float32)
    c = jctx(tp, schedule=schedule)
    for tokens in (rng.integers(-2, 66, (2, 8)).astype(np.int32),
                   rng.integers(0, 64, (1, 6 if tp == 4 else 5)).astype(np.int32)):
        want = np.asarray(jax.jit(lambda tb, tk: jlayers.embedding_lookup(
            c, {"table": tb}, tk, seq_shard=True, scale=2.0))(table, tokens))
        per_rank = run(world, "embedding_seq_task", tp, table=table, tokens=tokens,
                       schedule=schedule, scale=2.0)
        split = tokens.shape[1] % tp == 0
        got = np.concatenate(per_rank, axis=1) if split else per_rank[0]
        np.testing.assert_array_equal(got, want)
        if not split:
            for r in per_rank:
                np.testing.assert_array_equal(r, want)


# ---------------------------------------------------------------------------
# the slice: reduced chatglm3-6b and gemma2-27b prefill at tp > 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name in ("chatglm3-6b", "gemma2-27b"):
        jb = jax_get_arch(name).reduced()
        jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
        out[name] = jb, jparams, jax.tree.map(np.asarray, jparams)
    return out


@pytest.mark.parametrize("arch,mode", [("chatglm3-6b", "bulk"), ("chatglm3-6b", "fused"),
                                       ("chatglm3-6b", "kernel"), ("gemma2-27b", "bulk"),
                                       ("gemma2-27b", "fused")])
@pytest.mark.parametrize("tp", TPS)
def test_prefill_matches_jax(world, jax_models, tp, arch, mode):
    """``prefill_fn`` of 2 x 32 tokens: the logits (every rank the same) and
    each rank's chunk of every layer's k and v against the JAX package's
    ``prefill_forward``.  gemma2 (window 16, caps) at tp = 4 has chunks of 8:
    its local layers' ring stops at 2 of 3 hops."""
    jb, jparams, tree = jax_models[arch]
    tokens = np.random.default_rng(3).integers(0, jb.config.vocab, (2, 32)).astype(np.int32)
    want, cache = jax.jit(lambda p, tk: jb.prefill_fn(jctx(tp, JAX_MODE[mode]))(
        p, {"tokens": tk}))(jparams, tokens)
    per_rank = run(world, "prefill_task", tp, tree=tree, tokens=tokens, mode=mode, arch=arch)
    for logits, _, _ in per_rank:
        assert logits.shape == (2, 1, jb.config.vocab)
        np.testing.assert_allclose(logits, np.asarray(want), **TOL)
        np.testing.assert_array_equal(logits, per_rank[0][0])
    for name, i in (("k", 1), ("v", 2)):
        got = np.concatenate([r[i] for r in per_rank], axis=2)
        np.testing.assert_allclose(got, np.asarray(cache["scan"][name]), **TOL, err_msg=name)


def test_prefill_refuses_a_prompt_that_does_not_split(world, jax_models):
    _, _, tree = jax_models["chatglm3-6b"]
    with pytest.raises(RuntimeError, match="S must be a multiple of tp"):
        world.run("prefill_task", 4, tree=tree, tokens=np.zeros((1, 30), np.int32),
                  mode="fused")


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_gemma2_decode_across_shard_boundaries_matches_jax(world, jax_models, mode):
    """Reduced gemma2's decode_step at tp = 4 (16 cache rows a rank, window
    16): positions past the window whose windows reach from one rank's rows
    into another's, teacher-forced; logits and every rank's cache rows
    against the JAX decode step."""
    jb, jparams, tree = jax_models["gemma2-27b"]
    steps = 6
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jb.config.vocab, (steps, 4, 1)).astype(np.int32)
    starts = np.array([12, 20, 29, 40], np.int32)    # windows over ranks 0-1, 0-1, 1-2, 1-2-3
    positions = np.stack([starts + s for s in range(steps)]).astype(np.int32)
    c = jctx(4, mode)
    jdec = jax.jit(lambda tk, cache, p: jb.decode_fn(c)(jparams, tk, cache, p))
    jcache, want = jb.init_cache(4), []
    for tok, pos in zip(tokens, positions):
        lg, jcache = jdec(tok, jcache, pos)
        want.append(np.asarray(lg))
    per_rank = run(world, "decode_steps_task", 4, tree=tree, mode=mode, tokens=tokens,
                   positions=positions, arch="gemma2-27b")
    for logits, _, _ in per_rank:
        np.testing.assert_allclose(logits, np.stack(want), **TOL)
    for name, i in (("k", 1), ("v", 2)):
        got = np.concatenate([r[i] for r in per_rank], axis=2)
        np.testing.assert_allclose(got, np.asarray(jcache["scan"][name]), **TOL)


# ---------------------------------------------------------------------------
# calibration, and what still does not run at tp > 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 24])
def test_ring_attention_calibration_agrees_on_every_rank(world, qkv, window):
    """The ring's 'auto' key is re-scored by measurement through
    ``_build_ring_attention`` (windowed where its hops fall short of the
    ring): every rank measures every candidate and takes the same
    decision."""
    q, k, v = qkv
    per_rank = run(world, "calibrate_ring_task", 4, q=q, k=k, v=v, window=window)
    assert all(r == per_rank[0] for r in per_rank)
    decisions, report = per_rank[0]
    assert [op for op, *_ in report] == ["ring_attention"]
    (_, model_q, measured_q, cands, fallback), = report
    assert not fallback and measured_q in cands and len(cands) > 1
    assert [json.loads(key)["op"] for key, _, _ in decisions] == ["ring_attention"]


@pytest.mark.parametrize("what,item", [("compression", None),
                                       ("adafactor", None),
                                       ("paged", "item 5")])
def test_training_and_paged_serving_still_raise_at_tp2(world, what, item):
    """Paged serving of a MoE model at tp > 1 raises, naming its ROADMAP
    entry; gradient compression and Adafactor over shards (``item`` None)
    build their steps without a refusal."""
    for msg in run(world, "refusal_task", 2, what=what):
        if item is None:
            assert msg is None, msg
        else:
            assert msg is not None and re.search(f"ROADMAP Queue 1 {item}", msg), msg
