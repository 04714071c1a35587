"""The port's paged serving path against the JAX package's.

Paged KV writes and attention (``paged_cache_update``, ``paged_attention``)
against the JAX functions under the conftest ``ctx`` (a (2, 4) data x model
mesh of CPU devices, its pool blocks sharded over 4 ranks), the port on the
CPU at one rank; ``serve_step`` of reduced chatglm3-6b (and reduced
dbrx-132b through the MoE branch) against JAX's; the ``PagedDecodeEngine``
token streams against the JAX engine's, the port's dense engine's, across a
reshard and a journal; and the launcher's ``--paged``.  The same numpy
inputs, made from a seed, go to both; JAX weights are carried across by
``params_from_numpy``.  The port's pool holds one sink block past the
reference's ``NB`` (``models/attention.py``): its first ``NB`` blocks are
compared.  f32 matrix products run in full f32.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.serve import engine as jengine
from repro.serve.kv_cache import OutOfBlocks as JaxOutOfBlocks
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.serve import engine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
BS = 8                      # tokens per block for the reduced models (max_seq 64)
PROMPTS = [[5, 3, 7], [2, 9, 4, 8], [1], [6, 6]]
N_GEN = 5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def with_sink(pool):
    """A reference pool [NB, ...] (numpy) as the port's [NB + 1, ...]."""
    return np.concatenate([pool, np.zeros_like(pool[:1])])


# ---------------------------------------------------------------------------
# paged_cache_update / paged_attention
# ---------------------------------------------------------------------------
# block 2, MB 3 (6 tokens a table), NB 8 over the reference's 4 ranks.  Slot 0
# crosses a block and pads into a sentinel entry; slot 1's last two rows fall
# past the table, where clamping would alias its live rows at block 3 slots 0
# and 1; slot 2 is idle with an all-sentinel table; slot 3's padding rows
# point at real blocks.  C = 1: a sentinel block, a position past the table,
# an idle slot and one live write.
NB, BLK = 8, 2
TABLES = np.array([[5, 2, -1], [0, 7, 3], [-1, -1, -1], [1, 6, 4]], np.int32)
CASES = {4: (np.array([1, 4, 0, 3], np.int32), np.array([3, 4, 0, 2], np.int32)),
         1: (np.array([5, 6, 0, 2], np.int32), np.array([1, 1, 0, 1], np.int32))}


def _positions(C):
    pos0, n_new = CASES[C]
    pos = pos0[:, None] + np.arange(C, dtype=np.int32)[None]
    return pos, np.arange(C)[None] < n_new[:, None], n_new


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 4])
def test_paged_cache_update_matches_jax_and_drops(ctx, rng, C, dtype):
    npt, jdt, tdt = DTYPES[dtype]
    pool = rng.standard_normal((NB, BLK, 2, 8)).astype(npt)
    new = rng.standard_normal((4, C, 2, 8)).astype(npt)
    pos, valid, _ = _positions(C)
    want = np.asarray(jax.jit(lambda p, n: jattn.paged_cache_update(
        ctx, p, n, TABLES, pos, valid))(jnp.asarray(pool, jdt), jnp.asarray(new, jdt)),
        np.float32)
    got_t = t(with_sink(pool)).to(tdt)
    out = attention.paged_cache_update(CPU["kernel"], got_t, t(new).to(tdt), t(TABLES),
                                       t(pos), t(valid))
    assert out is got_t and got_t.shape == (NB + 1, BLK, 2, 8)      # in place
    np.testing.assert_array_equal(got_t[:NB].float().numpy(), want)
    live = {(int(TABLES[b, p // BLK]), p % BLK) for b in range(4) for c, p in
            enumerate(pos[b]) if valid[b, c] and p // BLK < 3 and TABLES[b, p // BLK] >= 0}
    before = np.asarray(jnp.asarray(pool, jdt), np.float32)
    changed = {(b, s) for b in range(NB) for s in range(BLK)
               if not np.array_equal(want[b, s], before[b, s])}
    assert changed == live                  # every dropped row left the pool alone


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window,cap", [(None, None), (3, 5.0)])
@pytest.mark.parametrize("kv_block", [1024, 4])       # one span; spans of 2 blocks
@pytest.mark.parametrize("C", [1, 4])
def test_paged_attention_matches_jax(ctx, rng, C, kv_block, window, cap, dtype):
    npt, jdt, tdt = DTYPES[dtype]
    q = rng.standard_normal((4, C, 4, 8)).astype(npt)
    pk, pv = (rng.standard_normal((NB, BLK, 2, 8)).astype(npt) for _ in range(2))
    pos, _, n_new = _positions(C)
    kw = dict(window=window, scale=0.3, softcap_val=cap, kv_block=kv_block)
    want = np.asarray(jax.jit(lambda q_, k_, v_: jattn.paged_attention(
        ctx, q_, k_, v_, TABLES, pos, **kw))(*(jnp.asarray(a, jdt) for a in (q, pk, pv))),
        np.float32)
    got = attention.paged_attention(CPU["kernel"], t(q).to(tdt), t(with_sink(pk)).to(tdt),
                                    t(with_sink(pv)).to(tdt), t(TABLES), t(pos), **kw)
    assert got.dtype == tdt and got.shape == (4, C, 4, 8)
    live = n_new > 0            # an idle slot's all-masked rows are discarded
    np.testing.assert_allclose(got.float().numpy()[live], want[live], **TOL[dtype])


def test_sink_block_is_never_read(rng):
    """Whatever the sink holds, attention's output does not change."""
    q = t(rng.standard_normal((4, 4, 4, 8)).astype(np.float32))
    pk, pv = (t(with_sink(rng.standard_normal((NB, BLK, 2, 8)).astype(np.float32)))
              for _ in range(2))
    pos = t(_positions(4)[0])
    a = attention.paged_attention(CPU["bulk"], q, pk, pv, t(TABLES), pos)
    pk[NB], pv[NB] = 1e4, -1e4
    torch.testing.assert_close(attention.paged_attention(CPU["bulk"], q, pk, pv, t(TABLES), pos),
                               a, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def glm():
    jb = jax_get_arch("chatglm3-6b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch("chatglm3-6b").reduced()
    return jb, jparams, pb, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _tables(cfg, B):
    MB = cfg.max_seq // BS
    return np.array([[i * MB + m for m in range(MB)] for i in range(B)], np.int32), B * MB


def _dense_port(pb, pparams, mode):
    """Greedy generation through the port's decode_step, the reference
    test's loop: (tokens per slot, logits per step)."""
    B = len(PROMPTS)
    dec = pb.decode_fn(CPU[mode])
    cache = pb.init_cache(B, "cpu")
    pos = np.zeros(B, np.int32)
    toks = np.array([[p[0]] for p in PROMPTS], np.int32)
    consumed, out, logs = [1] * B, [[] for _ in range(B)], []
    for _ in range(max(map(len, PROMPTS)) + N_GEN):
        lg, cache = dec(pparams, t(toks), cache, t(pos))
        lg = lg[:, 0].numpy()
        logs.append(lg)
        for i in range(B):
            pos[i] += 1
            if consumed[i] < len(PROMPTS[i]):
                toks[i, 0] = PROMPTS[i][consumed[i]]
                consumed[i] += 1
            else:
                out[i].append(int(lg[i].argmax()))
                toks[i, 0] = out[i][-1]
    return out, logs


def _jax_serve(ctx, jb, jparams):
    fn = jb.serve_step_fn(ctx)
    return jax.jit(lambda tk, pl, tb, p, n: fn(jparams, tk, pl, tb, p, n))


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_paged_decode_matches_dense_and_jax(ctx, glm, mode):
    """C = 1 steps over a paged pool give the dense path's logits and tokens
    (the reference's test), and JAX serve_step's logits and pool."""
    jb, jparams, pb, pparams = glm
    cfg, B = pb.config, len(PROMPTS)
    dense_out, dense_logits = _dense_port(pb, pparams, mode)
    tables, nb = _tables(cfg, B)
    pool, jpool = pb.init_paged_pool(nb, BS, "cpu"), jb.init_paged_pool(nb, BS)
    serve, jserve = pb.serve_step_fn(CPU[mode]), _jax_serve(ctx, jb, jparams)
    pos = np.zeros(B, np.int32)
    toks = np.array([[p[0]] for p in PROMPTS], np.int32)
    consumed, out = [1] * B, [[] for _ in range(B)]
    ones = np.ones(B, np.int32)
    for step in range(max(map(len, PROMPTS)) + N_GEN):
        jl, jpool = jserve(toks, jpool, tables, pos, ones)
        lg, pool = serve(pparams, t(toks), pool, t(tables), t(pos), t(ones))
        assert lg.shape == (B, cfg.vocab) and lg.dtype == torch.float32
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL["f32"])
        np.testing.assert_allclose(lg.numpy(), dense_logits[step], **TOL["f32"])
        for i in range(B):
            pos[i] += 1
            if consumed[i] < len(PROMPTS[i]):
                toks[i, 0] = PROMPTS[i][consumed[i]]
                consumed[i] += 1
            else:
                out[i].append(int(lg[i].argmax()))
                toks[i, 0] = out[i][-1]
    assert out == dense_out
    for key in ("k", "v"):
        np.testing.assert_allclose(pool[key][:, :nb].numpy(), np.asarray(jpool["scan"][key]),
                                   **TOL["f32"])


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_chunked_prefill_matches_dense_and_jax(ctx, glm, mode):
    """One C = 4 prefill chunk per prompt, then C = 1 decode, reproduces the
    token-by-token dense generation (the reference's test) and JAX's
    first-chunk logits."""
    jb, jparams, pb, pparams = glm
    cfg, (B, C) = pb.config, (len(PROMPTS), 4)
    dense_out, _ = _dense_port(pb, pparams, mode)
    tables, nb = _tables(cfg, B)
    pool = pb.init_paged_pool(nb, BS, "cpu")
    serve = pb.serve_step_fn(CPU[mode])
    tk, nn = np.zeros((B, C), np.int32), np.array([len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        tk[i, :len(p)] = p
    zeros = np.zeros(B, np.int32)
    jl, _ = _jax_serve(ctx, jb, jparams)(tk, jb.init_paged_pool(nb, BS), tables, zeros, nn)
    lg, pool = serve(pparams, t(tk), pool, t(tables), t(zeros), t(nn))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL["f32"])
    out = [[int(lg[i].argmax())] for i in range(B)]
    pos, ones = nn.copy(), t(np.ones(B, np.int32))
    toks = np.array([[o[0]] for o in out], np.int32)
    for _ in range(1, N_GEN):
        lg, pool = serve(pparams, t(toks), pool, t(tables), t(pos), ones)
        for i in range(B):
            pos[i] += 1
            out[i].append(int(lg[i].argmax()))
            toks[i, 0] = out[i][-1]
    assert out == [d[:N_GEN] for d in dense_out]


def _mixed_steps(rng, vocab, C=4):
    """Two C-wide steps: slot 0 prefills 7 tokens over both (mid-chunk in the
    second), slots 1 and 3 prefill then decode, slot 2 stays idle."""
    tk = [rng.integers(0, vocab, (4, C)).astype(np.int32) for _ in range(2)]
    pos = [np.array([0, 0, 0, 0], np.int32), np.array([4, 2, 0, 3], np.int32)]
    n_new = [np.array([4, 2, 0, 3], np.int32), np.array([3, 1, 0, 1], np.int32)]
    return list(zip(tk, pos, n_new))


def _check_steps(jserve, serve, jpool, pool, tables, steps, nb, live, tol):
    for s, (tk, pos, nn) in enumerate(steps):
        jl, jpool = jserve(tk, jpool, tables, pos, nn)
        lg, pool = serve(t(tk), pool, t(tables), t(pos), t(nn))
        np.testing.assert_allclose(lg.numpy()[live], np.asarray(jl)[live], **tol,
                                   err_msg=f"step {s}")
    jp = jpool["scan"] if "scan" in jpool else jpool
    for key in ("k", "v"):
        np.testing.assert_allclose(pool[key][:, :nb].numpy(), np.asarray(jp[key]), **tol)


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_mixed_step_matches_jax(ctx, rng, glm, mode):
    """A slot mid-chunk, a slot decoding and an idle slot in one step: the
    live slots' logits and the pool's first NB blocks match JAX's, and the
    idle slot writes nothing."""
    jb, jparams, pb, pparams = glm
    tables, nb = _tables(pb.config, 4)
    tables[2] = -1
    pool = pb.init_paged_pool(nb, BS, "cpu")
    serve = pb.serve_step_fn(CPU[mode])
    _check_steps(_jax_serve(ctx, jb, jparams), lambda *a: serve(pparams, *a),
                 jb.init_paged_pool(nb, BS), pool, tables,
                 _mixed_steps(rng, pb.config.vocab), nb, [0, 1, 3], TOL["f32"])
    MB = tables.shape[1]
    assert not pool["k"][:, 2 * MB:3 * MB].any()          # slot 2's blocks untouched


def test_dbrx_serve_step_matches_jax_bulk(rng):
    """Reduced dbrx-132b (8 experts, top-2) through the MoE branch in bulk
    mode, against JAX at tp = 1 (capacity drops follow the same tokens)."""
    jctx = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")), JaxFusion(mode="bulk"))
    jb = jax_get_arch("dbrx-132b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch("dbrx-132b").reduced()
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tables, nb = _tables(pb.config, 4)
    serve = pb.serve_step_fn(CPU["bulk"])
    _check_steps(_jax_serve(jctx, jb, jparams), lambda *a: serve(pparams, *a),
                 jb.init_paged_pool(nb, BS), pb.init_paged_pool(nb, BS, "cpu"), tables,
                 _mixed_steps(rng, pb.config.vocab), nb, [0, 1, 3], TOL["f32"])


def test_unported_paged_paths_raise(glm):
    _, _, pb, _ = glm
    # pool_logical_specs is ported (the reference's [L, blocks over tp, ...])
    assert pb.pool_specs(pb.init_paged_pool(4, BS, "cpu")) == {
        k: (None, "seq", None, None, None) for k in ("k", "v")}
    # serve_with_chaos is ported (tests/test_torch_runtime_world.py); a GQA
    # pool with dense-prefix layers holds all of them, as the reference's
    # does; MLA keeps its dense latent cache, as the reference refuses it a
    # pool; the recurrent families and DLRM have none
    cfg = transformer.TransformerConfig(name="gqa-prefix", n_layers=2, d_model=64, n_heads=4,
                                        n_kv_heads=4, d_ff=128, vocab=64, dense_prefix=1)
    assert transformer.init_paged_pool(cfg, 4, BS, "cpu")["k"].shape[0] == 2
    mla = get_arch("deepseek-v3-671b").reduced()
    with pytest.raises(NotImplementedError, match="dense latent cache"):
        transformer.init_paged_pool(mla.config, 4, BS, "cpu")
    assert pb.supports_paged and get_arch("dbrx-132b").supports_paged
    assert not mla.supports_paged
    assert not get_arch("rwkv6-7b").supports_paged and not get_arch("dlrm").supports_paged


# ---------------------------------------------------------------------------
# PagedDecodeEngine
# ---------------------------------------------------------------------------
def _prompts(n, vocab):
    return [r.prompt for r in launch_serve.make_requests(n, vocab, 1)]


def _port_paged(pb, pparams, batch, chunk, num_blocks=None, mode="kernel"):
    serve = pb.serve_step_fn(CPU[mode])
    cfg = pb.config
    return engine.PagedDecodeEngine(
        lambda tk, pl, tb, p, n: serve(pparams, tk, pl, tb, p, n),
        lambda nb, bs: pb.init_paged_pool(nb, bs, "cpu"), batch,
        num_blocks=num_blocks or batch * cfg.max_seq // 2 // BS, block_size=BS,
        max_seq=cfg.max_seq, chunk=chunk, device="cpu")


def _jax_paged(ctx, jb, jparams, batch, chunk, num_blocks=None):
    cfg = jb.config
    return jengine.PagedDecodeEngine(
        _jax_serve(ctx, jb, jparams), jb.init_paged_pool, batch,
        num_blocks=num_blocks or batch * cfg.max_seq // 2 // BS, block_size=BS,
        max_seq=cfg.max_seq, chunk=chunk, n_stripes=ctx.tp)


def _count_jax(eng):
    """The reference engine keeps no counts: count its deferrals (an
    OutOfBlocks inside _admit) and preemptions on the instance."""
    counts = {"deferred": 0, "preempted": 0}
    admit, preempt, ensure = eng._admit, eng._preempt, eng.kv.ensure
    inside = []

    def ensure_(uid, length):
        try:
            ensure(uid, length)
        except JaxOutOfBlocks:
            counts["deferred"] += bool(inside)
            raise

    def admit_(finished):
        inside.append(1)
        try:
            admit(finished)
        finally:
            inside.pop()

    def preempt_(i, req):
        counts["preempted"] += 1
        preempt(i, req)

    eng.kv.ensure, eng._admit, eng._preempt = ensure_, admit_, preempt_
    return counts


def _drain(eng, prompts, max_new=8, cls=engine.Request):
    for i, pr in enumerate(prompts):
        eng.submit(cls(uid=i, prompt=pr, max_new=max_new))
    fin = eng.run_until_drained(max_steps=500)
    assert fin.drained and len(fin) == len(prompts)
    return {r.uid: r.tokens for r in fin}


@pytest.mark.parametrize("n_req,chunk", [(4, 8), (6, 3)])
def test_paged_streams_match_jax_engine_and_dense(ctx, glm, n_req, chunk):
    jb, jparams, pb, pparams = glm
    prompts = _prompts(n_req, pb.config.vocab)
    want = _drain(_jax_paged(ctx, jb, jparams, 4, chunk), prompts, cls=jengine.Request)
    peng = _port_paged(pb, pparams, 4, chunk)
    got = _drain(peng, prompts)
    assert got == want and all(len(v) == 8 for v in got.values())
    assert peng.kv.used_blocks == 0 and peng.deferred == peng.preempted == 0
    dense = engine.DecodeEngine(lambda tk, c, p: pb.decode_fn(CPU["kernel"])(pparams, tk, c, p),
                                lambda b: pb.init_cache(b, "cpu"), 4, device="cpu",
                                max_seq=pb.config.max_seq)
    assert _drain(dense, prompts) == got


def test_small_pool_defers_and_preempts_as_jax(ctx, glm):
    """4 blocks of 8 tokens for 6 requests over 4 slots: admissions are
    deferred and requests preempted, as often as in the reference engine,
    and every request still drains with the same tokens."""
    jb, jparams, pb, pparams = glm
    prompts = _prompts(6, pb.config.vocab)
    jeng = _jax_paged(ctx, jb, jparams, 4, 3, num_blocks=4)
    counts = _count_jax(jeng)
    want = _drain(jeng, prompts, cls=jengine.Request)
    peng = _port_paged(pb, pparams, 4, 3, num_blocks=4)
    assert _drain(peng, prompts) == want
    assert (peng.deferred, peng.preempted) == (counts["deferred"], counts["preempted"])
    assert peng.deferred >= 1 and peng.preempted >= 1
    assert peng.kv.used_blocks == 0 and peng.kv.peak_blocks == 4


def test_reshard_mid_drain_keeps_the_streams(ctx, glm):
    jb, jparams, pb, pparams = glm
    prompts = _prompts(6, pb.config.vocab)
    want = _drain(_port_paged(pb, pparams, 4, 3), prompts)
    eng = _port_paged(pb, pparams, 4, 3)
    for i, pr in enumerate(prompts):
        eng.submit(engine.Request(uid=i, prompt=pr, max_new=8))
    fin = engine.DrainResult()
    for _ in range(6):
        fin.extend(eng.step()[1])
    inflight = sum(r is not None for r in eng.slots)
    serve = pb.serve_step_fn(CPU["bulk"])
    assert eng.reshard(lambda tk, pl, tb, p, n: serve(pparams, tk, pl, tb, p, n),
                       lambda nb, bs: pb.init_paged_pool(nb, bs, "cpu"), batch_size=3,
                       num_blocks=12) == inflight > 0
    assert eng.kv.used_blocks == 0 and eng.pool["k"].shape[1] == 13 and len(eng.slots) == 3
    fin.extend(eng.run_until_drained(max_steps=500))
    assert {r.uid: r.tokens for r in fin} == want
    dense = engine.DecodeEngine(lambda tk, c, p: pb.decode_fn(CPU["kernel"])(pparams, tk, c, p),
                                lambda b: pb.init_cache(b, "cpu"), 4, device="cpu",
                                max_seq=pb.config.max_seq)
    for i, pr in enumerate(prompts):
        dense.submit(engine.Request(uid=i, prompt=pr, max_new=8))
    fin = engine.DrainResult(r for _ in range(5) for r in dense.step()[1])
    assert dense.reshard(dense.decode_fn, lambda b: pb.init_cache(b, "cpu"), 2) > 0
    fin.extend(dense.run_until_drained(max_steps=500))
    assert {r.uid: r.tokens for r in fin} == want


def test_journal_round_trip_matches_jax_journal(ctx, glm):
    jb, jparams, pb, pparams = glm
    prompts = _prompts(6, pb.config.vocab)
    want = _drain(_port_paged(pb, pparams, 4, 3), prompts)
    peng, jeng = _port_paged(pb, pparams, 4, 3), _jax_paged(ctx, jb, jparams, 4, 3)
    for i, pr in enumerate(prompts):
        peng.submit(engine.Request(uid=i, prompt=pr, max_new=8))
        jeng.submit(jengine.Request(uid=i, prompt=pr, max_new=8))
    done = {}
    for _ in range(7):
        done.update({r.uid: r.tokens for r in peng.step()[1]})
        jeng.step()
    journal = json.loads(json.dumps(engine.request_journal(peng)))
    assert journal == jengine.request_journal(jeng) and any(e["tokens"] for e in journal)
    fresh = _port_paged(pb, pparams, 4, 3)
    assert engine.resubmit_journal(fresh, journal) == len(journal)
    done.update({r.uid: r.tokens for r in fresh.run_until_drained(max_steps=500)})
    assert done == want


def test_paged_engine_counts_and_timestamps(glm):
    _, _, pb, pparams = glm
    eng = _port_paged(pb, pparams, 2, 4, num_blocks=8)
    for i, pr in enumerate(_prompts(5, pb.config.vocab)):
        eng.submit(engine.Request(uid=i, prompt=pr, max_new=4))
    eng.submit(engine.Request(uid=9, prompt=[3], max_new=0))
    fin = eng.run_until_drained(max_steps=200)
    assert fin.drained and len(fin) == 6
    for r in fin:
        if r.uid == 9:                      # zero budget: retired without a slot
            assert r.done and r.tokens == [] and r.t_first is None
        else:
            assert r.t_submit <= r.t_first <= r.t_done and len(r.tokens) == 4
    assert eng.kv.used_blocks == 0 and 0 < eng.kv.peak_blocks <= 8


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_paged_serves_the_dense_streams(capsys, tmp_path):
    base = ["--reduced", "--device", "cpu", "--requests", "6", "--max-new", "6"]
    dense = {r.uid: r.tokens for r in launch_serve.main(base)}
    capsys.readouterr()
    paged = launch_serve.main(base + ["--paged", "--chunk", "3"])
    out = capsys.readouterr().out
    assert "paged pool: 8 x 16-token blocks = 0.1 MiB vs dense B x S_max 0.1 MiB" in out
    assert "served 6 requests, 36 tokens" in out and "paged" in out
    assert {r.uid: r.tokens for r in paged} == dense
    journal = tmp_path / "journal.json"
    journal.write_text(json.dumps([{"uid": 4, "prompt": paged[0].prompt, "max_new": 6,
                                    "tokens": paged[0].tokens[:2]}]))
    again = launch_serve.main(base + ["--paged", "--journal", str(journal)])
    assert "journal: resubmitted 1 unfinished requests" in capsys.readouterr().out
    assert [r.tokens for r in again] == [paged[0].tokens]


def test_launcher_paged_refuses_other_families():
    with pytest.raises(SystemExit, match="--paged requires a GQA transformer"):
        launch_serve.main(["--arch", "dlrm", "--reduced", "--device", "cpu", "--paged"])
    with pytest.raises(NotImplementedError, match="rwkv6-7b has no serving launcher"):
        launch_serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu", "--paged"])
