"""The port's paged serving at tp = 2 and 4 against the JAX package.

The pool's blocks are striped over the ranks as the reference's are: rank d
holds global blocks ``[d NB / tp, (d + 1) NB / tp)`` and a sink of its own.
``paged_cache_update`` / ``paged_attention`` on each rank's stripe, and
``serve_step`` of reduced chatglm3-6b and gemma2-27b (window 16 reaching
across two stripes) in bulk and fused mode, go through a gloo world of CPU
processes (``tests/torch_world.py``); the JAX package's functions run on
conftest's (2, 4) data x model mesh (its numbers do not depend on the mesh).
Each rank's stripe is held to its slice of the JAX pool, every rank's logits
to JAX's (the live slots), and the paged engine's token streams at tp to the
port's dense engine at one rank.  The same numpy inputs, made from a seed, go
to both.  Tolerance: ``TOL["f32"]`` of tests/test_parity_matrix.py.
"""
import jax
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.serve.engine import PagedDecodeEngine as JaxPagedDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.kv_cache import OutOfBlocks as JaxOutOfBlocks
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.serve.kv_cache import PagedKVCache
from torch_world import World

TPS = [2, 4]
BS = 8                       # tokens a block (the reduced models' max_seq is 64)
NB = 32                      # pool blocks: 8 / 16 a stripe
ARCHS = ("chatglm3-6b", "gemma2-27b")


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


def stripe(a, tp, d, axis):
    n = a.shape[axis] // tp
    return np.take(a, np.arange(d * n, (d + 1) * n), axis=axis)


_MEMO = {}


def memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name in ARCHS:
        jb = jax_get_arch(name).reduced()
        jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
        out[name] = jb, jparams, jax.tree.map(np.asarray, jparams)
    return out


# ---------------------------------------------------------------------------
# paged_cache_update / paged_attention on a stripe
# ---------------------------------------------------------------------------
# block 2, MB 3, 8 blocks: 4 / 2 a stripe.  Slot 0 crosses a block and pads
# into a sentinel entry; slot 1's last rows fall past the table; slot 2 is
# idle with an all-sentinel table; slot 3's blocks sit on different stripes
# and its padding rows point at real blocks (tests/test_torch_paged.py's).
OPS_NB, OPS_BLK = 8, 2
OPS_TABLES = np.array([[5, 2, -1], [0, 7, 3], [-1, -1, -1], [1, 6, 4]], np.int32)
OPS_CASES = {4: (np.array([1, 4, 0, 3], np.int32), np.array([3, 4, 0, 2], np.int32)),
             1: (np.array([5, 6, 0, 2], np.int32), np.array([1, 1, 0, 1], np.int32))}


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("tp", TPS)
def test_paged_ops_on_stripes_match_jax(world, ctx, rng, tp, C, window):
    """Each rank writes only its stripe (every other row, a sentinel, a row
    past the table, an idle slot or another rank's block, lands in its own
    sink) and the merged attention of the stripes is JAX's over the whole
    pool; a window of 3 reaches across blocks on different stripes."""
    pos0, n_new = OPS_CASES[C]
    pos = pos0[:, None] + np.arange(C, dtype=np.int32)[None]
    valid = np.arange(C)[None] < n_new[:, None]
    pk, pv = (rng.standard_normal((OPS_NB, OPS_BLK, 2, 8)).astype(np.float32) for _ in range(2))
    new = rng.standard_normal((4, C, 2, 8)).astype(np.float32)
    q = rng.standard_normal((4, C, 4, 8)).astype(np.float32)
    jk = np.asarray(jax.jit(lambda p, n: jattn.paged_cache_update(
        ctx, p, n, OPS_TABLES, pos, valid))(pk, new))
    jv = np.asarray(jax.jit(lambda p, n: jattn.paged_cache_update(
        ctx, p, n, OPS_TABLES, pos, valid))(pv, new))
    want = np.asarray(jax.jit(lambda q_, k_, v_: jattn.paged_attention(
        ctx, q_, k_, v_, OPS_TABLES, pos, window=window))(q, jk, jv))
    live = [i for i in range(4) if n_new[i]]
    for d, (sk, sv, sink, out) in enumerate(run(world, "paged_ops_task", tp, pool_k=pk,
                                                pool_v=pv, new=new, tables=OPS_TABLES, pos=pos,
                                                valid=valid, q=q, window=window)):
        np.testing.assert_array_equal(sk, stripe(jk, tp, d, 0))
        np.testing.assert_array_equal(sv, stripe(jv, tp, d, 0))
        assert np.isfinite(out).all() and np.isfinite(sink).all()
        np.testing.assert_allclose(out[live], want[live], **TOL["f32"], err_msg=f"rank {d}")


# ---------------------------------------------------------------------------
# striped allocation
# ---------------------------------------------------------------------------
LENGTHS = (25, 8, 0, 18)     # the tokens each slot's blocks cover (slot 2 idle)


def striped_tables(tp, cls=PagedKVCache):
    """The slots' tables from an allocator of NB blocks over tp stripes."""
    kv = cls(NB, BS, 64 // BS, n_stripes=tp)
    for uid, n in enumerate(LENGTHS):
        if n:
            kv.register(uid)
            kv.ensure(uid, n)
    return kv.tables_for([uid if n else None for uid, n in enumerate(LENGTHS)])


@pytest.mark.parametrize("tp", TPS)
def test_striped_allocation_matches_jax(tp):
    """The allocator hands a slot's blocks out round-robin over the stripes,
    as the JAX package's does: the same tables, consecutive blocks of a
    slot on different ranks."""
    got = striped_tables(tp)
    np.testing.assert_array_equal(got, striped_tables(tp, JaxPagedKVCache))
    per = NB // tp
    for row, n in zip(got, LENGTHS):
        owners = [b // per for b in row if b >= 0]
        assert len(owners) == -(-n // BS)
        assert all(a != b for a, b in zip(owners, owners[1:]))


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------
def serve_steps(rng, vocab):
    """Three C = 8 steps then one C = 1 step over LENGTHS: slot 0 prefills 24
    tokens (its window of 16 crosses stripes) and decodes; slot 1 prefills 5
    then decodes; slot 2 stays idle; slot 3 prefills 16 and decodes."""
    C = 8
    pos = [np.array(p, np.int32) for p in ([0, 0, 0, 0], [8, 5, 0, 8], [16, 6, 0, 16])]
    n_new = [np.array(n, np.int32) for n in ([8, 5, 0, 8], [8, 1, 0, 8], [8, 1, 0, 1])]
    steps = [(rng.integers(0, vocab, (4, C)).astype(np.int32), p, n) for p, n in zip(pos, n_new)]
    steps.append((rng.integers(0, vocab, (4, 1)).astype(np.int32),
                  np.array([24, 7, 0, 17], np.int32), np.array([1, 1, 0, 1], np.int32)))
    return steps


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", TPS)
def test_serve_step_at_tp_matches_jax(world, ctx, jax_models, tp, arch, mode):
    """Four mixed steps (prefill chunks, decode, an idle slot, sentinel
    table entries) on striped tables: every rank's logits are JAX's for the
    live slots and finite for the idle one, and each rank's stripe of the
    pool is its slice of JAX's."""
    jb, jparams, tree = jax_models[arch]
    steps = serve_steps(np.random.default_rng(3), jb.config.vocab)
    tables = striped_tables(tp)

    def make():
        fn = jb.serve_step_fn(ctx.with_fusion(JaxFusion(mode=mode)))
        jserve = jax.jit(lambda tk, pl, tb, p, n: fn(jparams, tk, pl, tb, p, n))
        jpool, logits = jb.init_paged_pool(NB, BS), []
        for tk, pos, nn in steps:
            lg, jpool = jserve(tk, jpool, tables, pos, nn)
            logits.append(np.asarray(lg))
        return logits, {k: np.asarray(v) for k, v in jpool["scan"].items()}
    want, jpool = memo((arch, tp, mode), make)
    live = [0, 1, 3]
    per_rank = run(world, "paged_serve_task", tp, tree=tree, arch=arch, mode=mode, steps=steps,
                   tables=tables, nb=NB, block=BS)
    for d, (logits, pk, pv) in enumerate(per_rank):
        for s, (got, w) in enumerate(zip(logits, want)):
            assert np.isfinite(got).all()
            np.testing.assert_array_equal(got, per_rank[0][0][s])
            np.testing.assert_allclose(got[live], w[live], **TOL["f32"],
                                       err_msg=f"rank {d} step {s}")
        np.testing.assert_allclose(pk, stripe(jpool["k"], tp, d, 1), **TOL["f32"])
        np.testing.assert_allclose(pv, stripe(jpool["v"], tp, d, 1), **TOL["f32"])


# ---------------------------------------------------------------------------
# the engine: striped streams against the dense ones
# ---------------------------------------------------------------------------
def dense_streams(tree, prompts, max_new=6):
    """The port's dense engine at one rank on the prompts (batch 4)."""
    pb = get_arch("chatglm3-6b").reduced()
    params = params_from_numpy(tree)
    dec = pb.decode_fn(ParallelContext(device="cpu", fusion=FusionConfig(mode="bulk")))
    dense = DecodeEngine(lambda tk, c, p: dec(params, tk, c, p),
                         lambda b: pb.init_cache(b, "cpu"), 4, device="cpu",
                         max_seq=pb.config.max_seq)
    for i, p in enumerate(prompts):
        dense.submit(Request(uid=i, prompt=p, max_new=max_new))
    return sorted((r.uid, r.tokens) for r in dense.run_until_drained(max_steps=500))


@pytest.mark.parametrize("tp,mode", [(2, "bulk"), (4, "fused")])
def test_paged_engine_at_tp_serves_the_dense_streams(world, jax_models, tp, mode):
    """The paged engine at tp (chunked prefill of 8 over striped blocks, the
    launcher's seeded prompts) gives the token streams of the port's dense
    engine at one rank, and every stripe held blocks."""
    _, _, tree = jax_models["chatglm3-6b"]
    prompts = [r.prompt for r in launch_serve.make_requests(6, 512, 1)]
    want = dense_streams(tree, prompts)
    for streams, peak, stripes, _, _ in run(world, "paged_engine_task", tp, tree=tree,
                                            arch="chatglm3-6b", mode=mode, prompts=prompts,
                                            max_new=6, batch=4, num_blocks=NB, block=BS,
                                            chunk=8):
        assert streams == want
        assert 0 < peak <= NB and len(stripes) == tp
        assert all(0 < s <= NB // tp for s in stripes)


def jax_engine_counts(ctx, jb, jparams, prompts, tp, num_blocks, chunk, max_new):
    """The JAX package's paged engine over ``tp`` stripes: its streams and
    how often it deferred an admission (an OutOfBlocks inside ``_admit``)
    and preempted a request (it keeps no counts of its own)."""
    fn = jb.serve_step_fn(ctx)
    eng = JaxPagedDecodeEngine(jax.jit(lambda tk, pl, tb, p, n: fn(jparams, tk, pl, tb, p, n)),
                               jb.init_paged_pool, 4, num_blocks=num_blocks, block_size=BS,
                               max_seq=jb.config.max_seq, chunk=chunk, n_stripes=tp)
    counts, inside = [0, 0], []
    admit, preempt, ensure = eng._admit, eng._preempt, eng.kv.ensure

    def ensure_(uid, length):
        try:
            ensure(uid, length)
        except JaxOutOfBlocks:
            counts[0] += bool(inside)
            raise

    def admit_(finished):
        inside.append(1)
        try:
            admit(finished)
        finally:
            inside.pop()

    def preempt_(i, req):
        counts[1] += 1
        preempt(i, req)
    eng.kv.ensure, eng._admit, eng._preempt = ensure_, admit_, preempt_
    for i, p in enumerate(prompts):
        eng.submit(JaxRequest(uid=i, prompt=p, max_new=max_new))
    done = eng.run_until_drained(max_steps=500)
    return sorted((r.uid, r.tokens) for r in done), counts


@pytest.mark.parametrize("tp", TPS)
def test_small_striped_pool_defers_and_preempts_as_jax(world, ctx, jax_models, tp):
    """4 blocks of 8 tokens striped over tp ranks for 6 requests over 4 slots
    (chunk 3): every rank defers admissions and preempts requests as often
    as the JAX package's engine over the same stripes, with its streams
    (the ranks' streams, counts and stripe peaks all equal)."""
    jb, jparams, tree = jax_models["chatglm3-6b"]
    prompts = [r.prompt for r in launch_serve.make_requests(6, 512, 1)]
    want, counts = memo(("engine", tp), lambda: jax_engine_counts(
        ctx, jb, jparams, prompts, tp, 4, 3, 8))
    per_rank = run(world, "paged_engine_task", tp, tree=tree, arch="chatglm3-6b", mode="fused",
                   prompts=prompts, max_new=8, batch=4, num_blocks=4, block=BS, chunk=3)
    for streams, peak, stripes, deferred, preempted in per_rank:
        assert (streams, peak, stripes, deferred, preempted) == per_rank[0]
        assert streams == want
        assert [deferred, preempted] == counts and deferred >= 1 and preempted >= 1
        assert peak == 4


def test_init_paged_pool_stripes_over_tp():
    """A rank's pool is its stripe of the global blocks and one sink; blocks
    that do not stripe over tp raise."""
    pb = get_arch("chatglm3-6b").reduced()
    cfg = pb.config
    for tp in (2, 4):
        pool = pb.init_paged_pool(NB, BS, "cpu", tp)
        assert pool["k"].shape == (cfg.n_layers, NB // tp + 1, BS, cfg.n_kv_heads, cfg.hd)
        with pytest.raises(ValueError, match="stripe"):
            pb.init_paged_pool(NB + 1, BS, "cpu", tp)
    assert torch.equal(pb.init_paged_pool(NB, BS, "cpu")["k"],
                       torch.zeros(cfg.n_layers, NB + 1, BS, cfg.n_kv_heads, cfg.hd))
