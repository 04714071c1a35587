"""deepseek-v3 over the (dp, tp) world against the JAX package.

MLA's prefill through the latent ring (fused mode) and the latents'
all-gather (bulk mode), its absorbed decode with the latent-width partial
merge, the shared expert in the sequence-sharded MoE layer and in decode
EP, and reduced deepseek-v3-671b's prefill (logits and each rank's chunk of
the latent caches) and decode steps, at tp = 2 and (dp, tp) = (2, 2).  The
same numpy inputs, made from a seed, go through the JAX package on a (dp,
tp) data x model mesh of conftest's CPU devices (its bulk mode; compiles
memoised) and through the port on a gloo world of CPU processes
(``tests/torch_world.py``), each rank on its part.  Tolerance ``TOL["f32"]``
of tests/test_parity_matrix.py.  Kernel mode at tp > 1 raises, naming the
real-peer half of ROADMAP item 1.
"""
import re

import jax
import numpy as np
import pytest
from test_parity_matrix import TOL
from test_torch_mla import ARCH, MCFG, SHARED_MOE, mla_params, shared_moe_params, whole_cache

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from torch_world import World

F32 = TOL["f32"]
LAYOUTS = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, layout, **inputs):
    """The task's per-rank results at (dp, tp) = ``layout`` (a tp = 2 world
    runs on both pairs, which must agree)."""
    dp, tp = layout
    out = world.run(name, tp, dp=dp, **inputs)
    if dp * tp == 2:
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(u, v)
    return out[:dp * tp]


def jctx(layout, mode="bulk"):
    return JaxContext.from_mesh(make_mesh(layout, ("data", "model")),
                                fusion=JaxFusion(mode=mode))


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def block(a, n, d, axis):
    size = a.shape[axis] // n
    return np.take(a, np.arange(d * size, (d + 1) * size), axis=axis)


def part(a, layout, r, seq_axis=None, row_axis=0):
    """Rank r's part of a whole array: its replica's rows, and its tp block
    along ``seq_axis`` where the array is sequence-sharded."""
    dp, tp = layout
    a = block(a, dp, r // tp, row_axis)
    return a if seq_axis is None else block(a, tp, r % tp, seq_axis)


# ---------------------------------------------------------------------------
# MLA's attention
# ---------------------------------------------------------------------------
def mla_inputs():
    rng = np.random.default_rng(10)
    D, ckv, dr = MCFG["d_model"], MCFG["kv_lora_rank"], MCFG["qk_rope_dim"]
    return dict(params=mla_params(0), x=rng.standard_normal((4, 16, D)).astype(np.float32),
                x_dec=rng.standard_normal((4, 1, D)).astype(np.float32),
                c_cache=rng.standard_normal((4, 32, ckv)).astype(np.float32),
                kr_cache=rng.standard_normal((4, 32, dr)).astype(np.float32),
                pos=np.array([0, 9, 31, 17], np.int32))


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mla_attention_matches_jax(world, layout, mode):
    """Prefill: each rank's output and latents are its blocks of the JAX
    package's; fused mode sends the latent chunk (c [b, S / tp, kv_lora],
    k_rope [b, S / tp, rope]) tp - 1 times, bulk mode none on the ring.
    Decode over the sequence-sharded latent cache: every rank's output is
    its replica's rows of the JAX package's (the partials merged at latent
    width)."""
    inp = mla_inputs()
    dp, tp = layout

    def make():
        c, cfg = jctx(layout), jmla.MLAConfig(**MCFG)
        o, (lc, lk) = jax.jit(lambda p, v: jmla.mla_context_attention(c, p, cfg, v))(
            inp["params"], inp["x"])
        dec = jax.jit(lambda p, *a: jmla.mla_decode_attention(c, p, cfg, *a))(
            inp["params"], inp["x_dec"], inp["c_cache"], inp["kr_cache"], inp["pos"])
        return [np.asarray(a) for a in (o, lc, lk, dec)]
    want_o, want_c, want_kr, want_dec = memo(("mla", layout), make)
    b, s_loc = 4 // dp, 16 // tp
    for r, (o, lc, lk, sent, dec) in enumerate(run(world, "mla_attention_task", layout,
                                                   cfg=MCFG, mode=mode, **inp)):
        np.testing.assert_allclose(o, part(want_o, layout, r, 1), **F32, err_msg=f"rank {r}")
        np.testing.assert_allclose(lc, part(want_c, layout, r, 1), **F32)
        np.testing.assert_allclose(lk, part(want_kr, layout, r, 1), **F32)
        latent = [(b, s_loc, MCFG["kv_lora_rank"]), (b, s_loc, MCFG["qk_rope_dim"])]
        assert sent == ([latent] * (tp - 1) if mode == "fused" else [])
        np.testing.assert_allclose(dec, part(want_dec, layout, r), **F32, err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# the shared expert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["seq_sharded_tp2", "decode_ep_tp2", "decode_ep_dp2"])
def test_shared_expert_over_the_world_matches_jax(world, case):
    """The MoE layer with its shared expert: sequence-sharded at tp = 2
    (``_moe_local`` on each rank's positions) and as decode EP at tp = 2
    and (2, 2) (the shared expert on the replicated rows after the world's
    sum), bulk and fused mode, against the JAX package's layer on the same
    mesh."""
    params = shared_moe_params(6)
    seq = case == "seq_sharded_tp2"
    layout = (2, 2) if case.endswith("dp2") else (1, 2)
    S = 16 if seq else 1
    x = np.random.default_rng(7).standard_normal((4, S, 64)).astype(np.float32)
    want = memo(("shared", case), lambda: np.asarray(jax.jit(lambda p, v: jmoe.moe_apply(
        jctx(layout), p, v, jmoe.MoEConfig(**SHARED_MOE)))(params, x)))
    for mode in ("bulk", "fused"):
        for r, (outs, _) in enumerate(run(world, "moe_layer_task", layout, params=params, x=x,
                                          cfg=SHARED_MOE, mode=mode, seq_sharded=seq)):
            np.testing.assert_allclose(outs[0], part(want, layout, r, 1 if seq else None),
                                       **F32, err_msg=f"{mode} rank {r}")


# ---------------------------------------------------------------------------
# the whole reduced deepseek-v3
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def deepseek():
    jb = jax_get_arch(ARCH).reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_matches_jax(world, deepseek, layout, mode):
    """``prefill_fn`` of 4 x 16 tokens (the latent ring or gather in every
    MLA layer, the dense prefix's AG/RS products, the MoE layers' exchanges
    with the shared expert): the logits on every rank and each rank's chunk
    of the latent caches [L, b, S / tp, ...] against the JAX package's on
    the same mesh."""
    jb, jparams, tree = deepseek
    tokens = np.random.default_rng(3).integers(0, jb.config.vocab, (4, 16)).astype(np.int32)

    def make():
        lg, cache = jax.jit(lambda p, tk: jb.prefill_fn(jctx(layout))(p, {"tokens": tk}))(
            jparams, tokens)
        return np.asarray(lg), whole_cache(cache)
    want, cache = memo(("prefill", layout), make)
    for r, (logits, c, kr) in enumerate(run(world, "prefill_task", layout, tree=tree,
                                            tokens=tokens, mode=mode, arch=ARCH)):
        np.testing.assert_allclose(logits, want, **F32, err_msg=f"rank {r}")
        for got, name in ((c, "c"), (kr, "kr")):
            np.testing.assert_allclose(got, part(cache[name], layout, r, 2, 1), **F32,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_steps_match_jax(world, deepseek, layout, mode):
    """Five decode steps at ragged per-slot positions (the cache's 64 rows
    sharded over tp: slots cross the shard boundary): the logits of every
    step on every rank and each rank's rows of the latent caches."""
    jb, jparams, tree = deepseek
    rng = np.random.default_rng(4)
    steps, B = 5, 4
    tokens = rng.integers(0, jb.config.vocab, (steps, B, 1)).astype(np.int32)
    positions = np.stack([np.array([0, 14, 29, 40]) + 1 + s for s in range(steps)]
                         ).astype(np.int32)

    def make():
        dec = jax.jit(lambda tk, c, p: jb.decode_fn(jctx(layout))(jparams, tk, c, p))
        cache, logits = jb.init_cache(B), []
        for tok, pos in zip(tokens, positions):
            lg, cache = dec(tok, cache, pos)
            logits.append(np.asarray(lg))
        return np.stack(logits), whole_cache(cache)
    want, cache = memo(("decode", layout), make)
    for r, (logits, c, kr) in enumerate(run(world, "decode_steps_task", layout, tree=tree,
                                            mode=mode, tokens=tokens, positions=positions,
                                            arch=ARCH)):
        np.testing.assert_allclose(logits, want, **F32, err_msg=f"rank {r}")
        for got, name in ((c, "c"), (kr, "kr")):
            np.testing.assert_allclose(got, part(cache[name], layout, r, 2, 1), **F32,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("what", ["mla_prefill", "mla_decode"])
def test_kernel_mode_over_ranks_raises(world, what):
    """Kernel mode of reduced deepseek-v3 at tp = 2 raises, naming the
    real-peer half of ROADMAP item 1; nothing falls back."""
    for msg in world.run("refusal_task", 2, what=what):
        assert msg is not None and re.search("ROADMAP Queue 1 item 1 .*real-peer", msg), msg

