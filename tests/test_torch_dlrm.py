"""The port's DLRM slice against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``repro_torch`` on the CPU.  The JAX kernels run in
interpret mode, as the JAX package's own tests run them: ``fused_embedding_a2a``
on a 1-D ("model",) mesh of 4 CPU devices, ``embedding_all_to_all`` and the
DLRM forward on a (1, 1) mesh, the port's one-card world.  On the CPU the
port's kernel wrappers run their plain versions (the CUDA kernels run only
on a card, in chip_smoke.py).  f32 matrix products run in full f32.
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
from repro.core.embedding_all_to_all import embedding_all_to_all as jax_emb_a2a
from repro.core.scheduling import ring_offsets as jax_ring_offsets
from repro.data.synthetic import DLRMBatches as JaxDLRMBatches
from repro.kernels.embedding_pool.ops import embedding_pool as jax_embedding_pool
from repro.kernels.fused_embedding_a2a.ops import fused_embedding_a2a as jax_fused_emb
from repro.kernels.fused_embedding_a2a.ref import fused_embedding_a2a_ref as jax_fused_emb_ref
from repro.models import dlrm as jdlrm
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.configs.registry import get_arch
from repro_torch.core import embedding_all_to_all as emb_a2a
from repro_torch.core.collectives import direct_all_to_all_compute
from repro_torch.core.scheduling import ring_offsets
from repro_torch.data.synthetic import DLRMBatches
from repro_torch.kernels.embedding_pool import ops as pool_ops
from repro_torch.kernels.embedding_pool.ref import embedding_pool_ref, embedding_pool_tables_ref
from repro_torch.kernels.fused_embedding_a2a import ops as fused_ops
from repro_torch.kernels.fused_embedding_a2a.ref import (fused_embedding_a2a_ref,
                                                         fused_embedding_a2a_ref_ranks)
from repro_torch.models import dlrm
from repro_torch.models.convert import dlrm_params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from torch_tune import clear_both, same_decisions, v5e_ctx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_DEV = 4
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables_idx(rng, n_tab, v, d, b, L):
    tabs = rng.standard_normal((n_tab, v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, n_tab, L)).astype(np.int32)
    return tabs, idx


@pytest.fixture(scope="module")
def ctx4():
    return JaxContext.from_mesh(make_mesh((N_DEV,), ("model",)))


@pytest.fixture(scope="module")
def ctx1():
    """The JAX package at world 1, kernel mode: the port's one-card world."""
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")), JaxFusion(mode="kernel"))


# ---------------------------------------------------------------------------
# embedding_pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,d,b,L,dtype", [
    (50, 16, 8, 5, "f32"), (128, 32, 4, 7, "f32"), (16, 8, 2, 1, "f32"),   # test_kernels' sweep
    (128, 32, 4, 7, "bf16"),
])
def test_embedding_pool_matches_jax_kernel(rng, v, d, b, L, dtype):
    tab = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, L)).astype(np.int32)
    idx[0, 0], idx[-1, -1] = 0, v - 1
    if dtype == "bf16":
        jtab = jnp.asarray(tab, jnp.bfloat16)
        want = np.asarray(jax_embedding_pool(jtab, idx).astype(jnp.float32))
        ptab = t(np.array(jtab.astype(jnp.float32))).to(torch.bfloat16)
    else:
        want = np.asarray(jax_embedding_pool(tab, idx))
        ptab = t(tab)
    for fn in (embedding_pool_ref, pool_ops.embedding_pool):
        got = fn(ptab, t(idx))
        assert got.dtype == ptab.dtype and got.shape == (b, d)
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("n_tab,b,L", [(3, 5, 4), (1, 2, 1), (6, 16, 7)])
def test_embedding_pool_tables_is_the_per_table_pool(rng, n_tab, b, L):
    tabs, idx = _tables_idx(rng, n_tab, 40, 12, b, L)
    got = pool_ops.embedding_pool_tables(t(tabs), t(idx))
    want = torch.stack([pool_ops.embedding_pool(t(tabs[k]), t(idx[:, k]))
                        for k in range(n_tab)], dim=1)
    assert got.shape == (b, n_tab, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(embedding_pool_tables_ref(t(tabs), t(idx)), want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["int64", "tables", "ndim", "dtype", "empty_bag"])
def test_embedding_pool_wrapper_rejects_bad_input(rng, bad):
    tabs, idx = (t(a) for a in _tables_idx(rng, 2, 8, 4, 3, 2))
    err = {"int64": TypeError, "dtype": TypeError}.get(bad, ValueError)
    args = {"int64": (tabs, idx.long()), "tables": (tabs[:1], idx),
            "ndim": (tabs, idx[0]), "dtype": (tabs.double(), idx),
            "empty_bag": (tabs, idx[:, :, :0])}[bad]
    with pytest.raises(err):
        pool_ops.embedding_pool_tables(*args)


def test_backward_through_the_pooling_kernel_raises(rng):
    tabs, idx = (t(a) for a in _tables_idx(rng, 2, 8, 4, 3, 2))
    tabs.requires_grad_(True)
    out = pool_ops.embedding_pool_tables(tabs, idx)
    with pytest.raises(NotImplementedError, match="no backward.*bulk or fused mode"):
        out.sum().backward()


# ---------------------------------------------------------------------------
# fused_embedding_a2a
# ---------------------------------------------------------------------------
def _ranks(tabs, idx, n):
    """Global tables [T, V, D] and indices [B, T, L] -> the port's
    per-source shards [n, T_loc, V, D] and [n, B, T_loc, L]."""
    T, v, d = tabs.shape
    B, _, L = idx.shape
    return (t(tabs.reshape(n, T // n, v, d)),
            t(idx.reshape(B, n, T // n, L).transpose(1, 0, 2, 3)))


@pytest.mark.parametrize("comm_aware", [True, False])
@pytest.mark.parametrize("t_loc,v,d,b,L", [(2, 32, 16, 16, 4), (1, 16, 8, 8, 2)])
def test_fused_embedding_a2a_ranks_matches_jax_kernel(ctx4, rng, comm_aware, t_loc, v, d, b, L):
    tabs, idx = _tables_idx(rng, N_DEV * t_loc, v, d, b, L)
    want = np.asarray(jax.jit(lambda i, tb: jax_fused_emb(
        ctx4, i, tb, comm_aware=comm_aware))(idx, tabs))          # [B, T, D], B sharded
    got = fused_ops.fused_embedding_a2a_ranks(*_ranks(tabs, idx, N_DEV), comm_aware=comm_aware)
    assert got.shape == (N_DEV, b // N_DEV, N_DEV * t_loc, d)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), **TOL["f32"])


def test_fused_embedding_a2a_ref_matches_jax_ref(rng):
    tabs, idx = _tables_idx(rng, 6, 20, 8, 12, 3)
    tr, ir = _ranks(tabs, idx, 3)
    want = np.asarray(jax_fused_emb_ref(tr.numpy(), ir.numpy()))
    got = fused_embedding_a2a_ref_ranks(tr, ir)
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])
    torch.testing.assert_close(fused_embedding_a2a_ref(tr, ir), got, rtol=0, atol=0)


def test_fused_embedding_a2a_one_card_is_the_pool(rng):
    tabs, idx = (t(a) for a in _tables_idx(rng, 3, 20, 8, 5, 3))
    got = fused_ops.fused_embedding_a2a(CPU["kernel"], idx, tabs)
    torch.testing.assert_close(got, pool_ops.embedding_pool_tables(tabs, idx), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["ranks", "tables", "batch", "int64"])
def test_fused_embedding_a2a_wrapper_rejects_bad_input(rng, bad):
    tabs, idx = _ranks(*_tables_idx(rng, 4, 8, 4, 4, 2), 2)
    err = TypeError if bad == "int64" else ValueError
    args = {"ranks": (tabs, idx[:1]), "tables": (tabs[:, :1], idx),
            "batch": (tabs, idx[:, :3]), "int64": (tabs, idx.long())}[bad]
    with pytest.raises(err):
        fused_ops.fused_embedding_a2a_ranks(*args)


# ---------------------------------------------------------------------------
# embedding_all_to_all and its pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,schedule,skew", [(1, "comm_aware", 0), (4, "comm_aware", 0),
                                                 (4, "oblivious", 0), (5, "comm_aware", 2),
                                                 (3, "oblivious", 1)])
def test_ring_offsets_match_jax(world, schedule, skew):
    assert ring_offsets(world, schedule, skew) == jax_ring_offsets(world, schedule, skew)


def test_direct_all_to_all_compute_on_one_card():
    calls = []

    def produce(f):
        calls.append(f)
        return torch.full((2, 3), float(f))

    got = direct_all_to_all_compute(CPU["kernel"], produce, (6, 3), chunks_per_rank=3)
    assert calls == [0, 1, 2] and got.shape == (1, 6, 3)
    assert got[0, :, 0].tolist() == [0, 0, 1, 1, 2, 2]
    y = torch.ones(4, 3)
    assert direct_all_to_all_compute(CPU["kernel"], lambda f: y, (4, 3))[0].data_ptr() == \
        y.data_ptr()                                # q = 1: no copy
    with pytest.raises(ValueError, match="feasible_chunks_per_rank"):
        direct_all_to_all_compute(CPU["kernel"], produce, (6, 3), chunks_per_rank=4)
    with pytest.raises(ValueError, match="name the group"):   # over data: say which
        direct_all_to_all_compute(types.SimpleNamespace(tp=1, dp=2), produce, (6, 3))


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
@pytest.mark.parametrize("q", [1, 2, 3])
def test_embedding_all_to_all_matches_jax_kernel(ctx1, rng, mode, q):
    tabs, idx = _tables_idx(rng, 5, 30, 16, 16, 4)
    want = np.asarray(jax.jit(lambda i, tb: jax_emb_a2a(
        ctx1, i, tb, mode="kernel", chunks_per_rank=q))(idx, tabs))
    got = emb_a2a.embedding_all_to_all(CPU[mode], t(idx), t(tabs), chunks_per_rank=q)
    assert got.shape == (16, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


@pytest.mark.parametrize("q,launches", [(1, 1), (2, 2), (3, 2), (4, 4)])
def test_kernel_mode_pools_one_fragment_per_launch(rng, monkeypatch, q, launches):
    """One pooling call per fine chunk, each over all tables; 3 clamps to 2
    at B = 16."""
    rows = []

    def counted(tables, idx):
        rows.append((idx.shape[0], tables.shape[0]))
        return pool_ops.embedding_pool_tables(tables, idx)

    monkeypatch.setattr(emb_a2a, "embedding_pool_tables", counted)
    tabs, idx = (t(a) for a in _tables_idx(rng, 5, 30, 8, 16, 4))
    got = emb_a2a.embedding_all_to_all(CPU["kernel"], idx, tabs, chunks_per_rank=q)
    assert rows == [(16 // launches, 5)] * launches
    torch.testing.assert_close(got, embedding_pool_tables_ref(tabs, idx), rtol=0, atol=0)


def test_bulk_pooling_is_one_library_call(rng, monkeypatch):
    """Bulk mode pools every table in one F.embedding_bag call over the
    tables viewed as one [T * V, D] weight."""
    calls = []
    bag = emb_a2a.F.embedding_bag
    monkeypatch.setattr(emb_a2a.F, "embedding_bag",
                        lambda ix, w, **kw: calls.append((tuple(ix.shape), tuple(w.shape)))
                        or bag(ix, w, **kw))
    tabs, idx = (t(a) for a in _tables_idx(rng, 4, 30, 8, 6, 5))
    got = emb_a2a.embedding_all_to_all(CPU["bulk"], idx, tabs)
    assert calls == [((6 * 4, 5), (4 * 30, 8))]
    torch.testing.assert_close(got, embedding_pool_tables_ref(tabs, idx), **TOL["f32"])


@pytest.mark.parametrize("what", ["bad_wire", "zero_granularity"])
def test_unported_embedding_paths_raise(rng, what):
    tabs, idx = (t(a) for a in _tables_idx(rng, 2, 8, 4, 4, 2))
    err, kw, match = {
        "bad_wire": (ValueError, dict(wire="f16"), "wire"),
        "zero_granularity": (ValueError, dict(chunks_per_rank=0), "granularity"),
    }[what]
    with pytest.raises(err, match=match):
        emb_a2a.embedding_all_to_all(CPU["kernel"], idx, tabs, **kw)


@pytest.mark.parametrize("kw", [dict(chunks_per_rank="auto"), dict(wire="auto")],
                         ids=["auto_granularity", "auto_wire"])
def test_embedding_auto_choices_match_jax(ctx1, rng, kw):
    """'auto' resolves through tune_all_to_all: the JAX package's decision on
    the same inputs under the same link constants, and its pooled output."""
    tabs, idx = _tables_idx(rng, 5, 30, 16, 16, 4)
    clear_both()
    want = np.asarray(jax.jit(lambda i, tb: jax_emb_a2a(ctx1, i, tb, **kw))(idx, tabs))
    got = emb_a2a.embedding_all_to_all(v5e_ctx(mode="kernel"), t(idx), t(tabs), **kw)
    assert len(same_decisions()) == 1
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


def test_fusion_config_sets_the_kernel_granularity(rng, monkeypatch):
    rows = []
    monkeypatch.setattr(emb_a2a, "embedding_pool_tables",
                        lambda tb, ix: rows.append(ix.shape[0]) or embedding_pool_tables_ref(tb, ix))
    tabs, idx = (t(a) for a in _tables_idx(rng, 2, 8, 4, 8, 2))
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode="kernel", granularity=4))
    emb_a2a.embedding_all_to_all(ctx, idx, tabs)
    assert rows == [2] * 4
    # "auto" takes the granularity the JAX package's tuner takes on these inputs
    clear_both()
    jc = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                              JaxFusion(mode="kernel", granularity="auto"))
    jax.eval_shape(lambda i, tb: jax_emb_a2a(jc, i, tb), idx.numpy(), tabs.numpy())
    rows.clear()
    emb_a2a.embedding_all_to_all(v5e_ctx(mode="kernel", granularity="auto"), idx, tabs)
    ((q, _),) = same_decisions().values()
    assert rows == [8 // q] * q


# ---------------------------------------------------------------------------
# the slice: reduced DLRM against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced():
    jb = jax_get_arch("dlrm").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch("dlrm").reduced()
    cfg = pb.config
    batch = next(DLRMBatches(cfg.n_tables, cfg.table_vocab, cfg.pooling, cfg.n_dense, 16, seed=0))
    return jb, jparams, pb, dlrm_params_from_numpy(jax.tree.map(np.asarray, jparams)), batch


def test_registry_matches_reference_reduced_dlrm():
    jb, pb = jax_get_arch("dlrm"), get_arch("dlrm")
    assert pb.family == jb.family == "dlrm"
    for full in (False, True):
        jcfg = jb.config if full else jb.reduced().config
        pcfg = pb.config if full else pb.reduced().config
        for f in dataclasses.fields(jcfg):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    assert pb.shapes() == jb.shapes() == {"train_8k": {"batch": 8192, "kind": "dlrm_train"}}
    assert get_arch("chatglm3-6b").shapes() == jax_get_arch("chatglm3-6b").shapes()
    assert callable(get_arch("chatglm3-6b").loss_fn(CPU["bulk"]))   # dense training
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        get_arch("rwkv6-7b").loss_fn(CPU["bulk"])
    with pytest.raises(ValueError, match="does not decode"):
        pb.decode_fn(CPU["bulk"])


def test_dlrm_init_follows_the_reference_tree(reduced):
    jb, jparams, pb, _, _ = reduced
    p = pb.init_params(torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    got = {"tables": (tuple(p["tables"].shape), "float32"),
           **{k: [{n: (tuple(v.shape), str(v.dtype)[6:]) for n, v in layer.items()}
                  for layer in p[k]] for k in ("bottom", "top")}}
    assert got == want
    assert abs(p["tables"].std().item() - 0.02) < 2e-3      # embed_init
    w0 = p["bottom"][0]["w"]                                # dense_init, fan_in 4
    assert w0.abs().max() <= 2 * 4 ** -0.5 + 1e-6
    assert all(not layer["b"].any() for layer in p["bottom"] + p["top"])


def test_dlrm_params_from_numpy_carries_the_tree(reduced):
    _, jparams, _, pparams, _ = reduced
    tree = jax.tree.map(np.asarray, jparams)
    np.testing.assert_array_equal(pparams["tables"].numpy(), tree["tables"])
    for k in ("bottom", "top"):
        for got, want in zip(pparams[k], tree[k], strict=True):
            for n in ("w", "b"):
                np.testing.assert_array_equal(got[n].numpy(), want[n])


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_dlrm_forward_and_loss_match_jax(ctx1, reduced, mode):
    jb, jparams, pb, pparams, batch = reduced
    jcfg = jb.config
    want = np.asarray(jax.jit(lambda p, b: jdlrm.dlrm_forward(ctx1, p, jcfg, b, mode="kernel"))(
        jparams, batch))
    want_loss = float(jax.jit(lambda p, b: jdlrm.dlrm_loss(ctx1, p, jcfg, b, mode="kernel"))(
        jparams, batch))
    pbatch = {k: t(v) for k, v in batch.items()}
    got = dlrm.dlrm_forward(CPU[mode], pparams, pb.config, pbatch)
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])
    loss = pb.loss_fn(CPU[mode])(pparams, pbatch)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL["f32"])


def test_interaction_pairs_follow_jnp_triu_order(rng):
    bottom = rng.standard_normal((3, 4)).astype(np.float32)
    pooled = rng.standard_normal((3, 5, 4)).astype(np.float32)
    want = np.asarray(jdlrm._interaction(bottom, pooled))
    got = dlrm._interaction(t(bottom), t(pooled))
    assert got.shape == (3, 4 + 6 * 5 // 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


def test_dlrm_training_through_kernel_mode_raises(reduced):
    """Kernel-mode pooling has no backward, as in the reference; bulk mode
    differentiates through the library's pooling."""
    _, _, pb, pparams, batch = reduced
    pbatch = {k: t(v) for k, v in batch.items()}
    params = {"tables": pparams["tables"].clone().requires_grad_(True),
              "bottom": pparams["bottom"], "top": pparams["top"]}
    with pytest.raises(NotImplementedError, match="no backward.*bulk or fused mode"):
        pb.loss_fn(CPU["kernel"])(params, pbatch).backward()
    pb.loss_fn(CPU["bulk"])(params, pbatch).backward()
    assert params["tables"].grad is not None and params["tables"].grad.abs().sum() > 0


def test_dlrm_batches_match_jax():
    args = (4, 100, 3, 5, 7)
    port, ref = DLRMBatches(*args, seed=3), JaxDLRMBatches(*args, seed=3)
    for _ in range(3):
        got, want = next(port), next(ref)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
