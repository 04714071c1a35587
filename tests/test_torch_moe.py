"""The port's MoE modules and reduced dbrx-132b decode against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``repro_torch`` on the CPU.  The JAX kernels run in
interpret mode on a 1-D ("model",) mesh of 4 CPU devices, as the JAX
package's own tests run them; the port's emulated n-rank worlds run their
plain versions here (the CUDA kernels run only on a card, in
chip_smoke.py).  The JAX MoE layer and decode run at tp = 1 on a (1, 1)
mesh, the port's one-card world.  f32 matrix products run in full f32.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL, WIRE_TOL

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.core.collectives import feasible_chunks_per_rank as jax_feasible
from repro.core import moe_all_to_all as jmoe_a2a
from repro.core.moe_all_to_all import moe_dispatch_all_to_all
from repro.kernels.fused_gemm_a2a.ops import fused_gemm_a2a as jax_fused_gemm_a2a
from repro.models import moe as jmoe
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.registry import get_arch
from repro_torch.core import moe_all_to_all as pmoe_a2a
from repro_torch.core.collectives import feasible_chunks_per_rank
from repro_torch.kernels.fused_dispatch_a2a import ops as dispatch_ops
from repro_torch.kernels.fused_dispatch_a2a.ref import (fused_dispatch_a2a_ref,
                                                        fused_dispatch_a2a_ref_ranks)
from repro_torch.kernels.fused_gemm_a2a import ops as gemm_ops
from repro_torch.kernels.fused_gemm_a2a.ref import (fused_gemm_a2a_ref,
                                                    fused_gemm_a2a_ref_ranks)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.serve.engine import DecodeEngine, Request
from torch_tune import clear_both, same_decisions, v5e_ctx

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_DEV = 4
CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ctx4():
    return JaxContext.from_mesh(make_mesh((N_DEV,), ("model",)))


@pytest.fixture(scope="module")
def ctx1():
    """The JAX package at tp = 1: the port's one-card world."""
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                JaxFusion(mode="bulk"))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,E,K,cf,norm,scale", [
    (4, 16, 4, 1.25, True, 1.0),      # dbrx decode: C = 2, drops
    (12, 8, 2, 1.25, True, 1.0),      # the reduced config
    (9, 8, 3, 0.5, False, 2.5),       # heavy drops, no renormalisation
    (3, 4, 1, 4.0, True, 1.0),        # no drops
])
def test_route_matches_jax(rng, T, E, K, cf, norm, scale):
    cfg = dict(n_experts=E, top_k=K, d_model=32, d_ff=8, capacity_factor=cf,
               norm_topk_prob=norm, router_scale=scale)
    toks = rng.standard_normal((T, 32)).astype(np.float32)
    w_r = rng.standard_normal((32, E)).astype(np.float32)
    jw, je, jp, jv, jc = jmoe._route(jmoe.MoEConfig(**cfg), toks, w_r)
    pw, pe, pp, pv, pc = moe._route(moe.MoEConfig(**cfg), t(toks), t(w_r))
    assert pc == jc
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **TOL["f32"])
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_dispatch_buf_and_unpermute_match_jax(rng):
    cfg_j = jmoe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=8, capacity_factor=0.75)
    cfg_p = moe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=8, capacity_factor=0.75)
    toks = rng.standard_normal((10, 16)).astype(np.float32)
    w_r = rng.standard_normal((16, 8)).astype(np.float32)
    jw, je, jp, jv, C = jmoe._route(cfg_j, toks, w_r)
    pw, pe, pp, pv, _ = moe._route(cfg_p, t(toks), t(w_r))
    jbuf = jmoe._dispatch_buf(cfg_j, toks, je, jp, jv, C, np.float32)
    pbuf = moe._dispatch_buf(cfg_p, t(toks), pe, pp, pv, C, torch.float32)
    np.testing.assert_array_equal(pbuf.numpy(), np.asarray(jbuf))
    out = rng.standard_normal((8, C, 16)).astype(np.float32)
    want = jmoe._unpermute(cfg_j, out, jw, je, jp, jv, (2, 5, 16), np.float32)
    got = moe._unpermute(cfg_p, t(out), pw, pe, pp, pv, (2, 5, 16), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


# ---------------------------------------------------------------------------
# the two kernels' emulated worlds against the JAX kernels
# ---------------------------------------------------------------------------
SHAPES = {"even": (2, 2, 8, 16, 24), "ragged": (2, 3, 6, 20, 12)}   # B, E_loc, C, D, F


def _ranks_view(xd):
    """Global [B, n, n * E_loc, C, D] (dim 1 = destination, experts sharded
    over the ranks) -> the port's [rank, n, B, E_loc, C, D]."""
    b, n, e, c, d = xd.shape
    return t(xd.reshape(b, n, n, e // n, c, d).transpose(2, 1, 0, 3, 4, 5))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("comm_aware,q,skew", [(True, 1, 0), (False, 2, 0), (True, 2, 1),
                                               (True, 4, 0)])
def test_dispatch_ranks_match_jax_kernel(ctx4, rng, shape, wire, comm_aware, q, skew):
    b, e_loc, c, d, _ = SHAPES[shape]
    xd = rng.standard_normal((b, N_DEV, N_DEV * e_loc, c, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: moe_dispatch_all_to_all(
        ctx4, v, mode="kernel", chunks_per_rank=q, wire=wire, skew=skew,
        schedule="comm_aware" if comm_aware else "oblivious"))(xd))
    got = dispatch_ops.fused_dispatch_a2a_ranks(_ranks_view(xd), comm_aware=comm_aware,
                                                chunks_per_rank=q, skew=skew, wire=wire)
    tol = TOL["f32"] if wire == "f32" else WIRE_TOL["bf16"]
    np.testing.assert_allclose(got.numpy(), _ranks_view(want).numpy(), **tol)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("comm_aware,skew", [(True, 0), (False, 1)])
def test_gemm_a2a_ranks_match_jax_kernel(ctx4, rng, shape, wire, comm_aware, skew):
    b, e_loc, c, d, f = SHAPES[shape]
    e = N_DEV * e_loc
    xd = rng.standard_normal((b, N_DEV, e, c, d)).astype(np.float32)
    wu, wg = (rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5 for _ in range(2))
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * f ** -0.5
    want = np.asarray(jax.jit(lambda v: jax_fused_gemm_a2a(
        ctx4, v, wu, wg, wd, act=jax.nn.silu, comm_aware=comm_aware, skew=skew,
        wire=wire))(xd))
    per_rank = [t(w.reshape((N_DEV, e_loc) + w.shape[1:])) for w in (wu, wg, wd)]
    got = gemm_ops.fused_gemm_a2a_ranks(_ranks_view(xd), *per_rank, act="silu",
                                        comm_aware=comm_aware, skew=skew, wire=wire)
    tol = TOL["f32"] if wire == "f32" else WIRE_TOL["bf16"]
    np.testing.assert_allclose(got.numpy(), _ranks_view(want).numpy(), **tol)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_one_rank_chain_is_dispatch_then_ffn(rng, act):
    """At one rank the chain is the dispatch's plain version (the identity)
    followed by the FFN's; also the JAX formula for each activation."""
    x = t(rng.standard_normal((1, 1, 3, 5, 16)).astype(np.float32))
    wu, wg = (t(rng.standard_normal((3, 16, 12)).astype(np.float32)) for _ in range(2))
    wd = t(rng.standard_normal((3, 12, 16)).astype(np.float32))
    got = gemm_ops.fused_moe_chain(x, wu, wg, wd, act=act, chunks_per_rank=5)
    want = fused_gemm_a2a_ref(fused_dispatch_a2a_ref(x), wu, wg, wd, act)
    assert torch.equal(got, want)
    jact = {"silu": jax.nn.silu, "gelu": jax.nn.gelu, "relu": jax.nn.relu}[act]
    xn, un, gn, dn = (a.numpy() for a in (x, wu, wg, wd))
    h = np.einsum("...ecd,edf->...ecf", xn, un)
    g = np.einsum("...ecd,edf->...ecf", xn, gn)
    ref = np.einsum("...ecf,efd->...ecd", np.asarray(jact(g)) * h, dn)
    np.testing.assert_allclose(got.numpy(), ref, **TOL["f32"])


def test_ranks_plain_versions_route_blocks_by_source(rng):
    """out[r, s] = x[s, r]; only blocks that cross ranks take the bf16 wire."""
    x = t(rng.standard_normal((3, 3, 1, 2, 2, 8)).astype(np.float32))
    out = fused_dispatch_a2a_ref_ranks(x, "bf16")
    for r in range(3):
        for s in range(3):
            want = x[s, r] if s == r else x[s, r].to(torch.bfloat16).float()
            assert torch.equal(out[r, s], want)
    w = [t(rng.standard_normal((3, 2, 8, 4)).astype(np.float32)) for _ in range(2)]
    wd = t(rng.standard_normal((3, 2, 4, 8)).astype(np.float32))
    y = fused_gemm_a2a_ref_ranks(x, *w, wd, "silu")
    np.testing.assert_allclose(y[1, 2].numpy(),
                               fused_gemm_a2a_ref(x[2, 1], w[0][2], w[1][2], wd[2],
                                                  "silu").numpy(), **TOL["f32"])


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, input checks
# ---------------------------------------------------------------------------
def _gemm_operands(rng, n=None, e=2, c=3, d=16, f=8):
    lead = () if n is None else (n,)
    x = t(rng.standard_normal(lead + (n or 1, 1, e, c, d)).astype(np.float32))
    wu, wg = (t(rng.standard_normal(lead + (e, d, f)).astype(np.float32)) for _ in range(2))
    wd = t(rng.standard_normal(lead + (e, f, d)).astype(np.float32))
    return x, wu, wg, wd


@pytest.mark.parametrize("name", ["dispatch", "dispatch_ranks", "gemm", "gemm_ranks",
                                  "chain"])
def test_cpu_tensor_takes_plain_version(rng, name):
    """A CPU tensor gets the plain version's result and launches nothing."""
    if name.startswith("dispatch"):
        ranks = name.endswith("ranks")
        x = _gemm_operands(rng, 3 if ranks else None)[0]
        fn = dispatch_ops.fused_dispatch_a2a_ranks if ranks else dispatch_ops.fused_dispatch_a2a
        args, want = (x,), (fused_dispatch_a2a_ref_ranks(x) if ranks
                            else fused_dispatch_a2a_ref(x))
    elif name == "chain":
        args = _gemm_operands(rng)
        fn, want = gemm_ops.fused_moe_chain, fused_gemm_a2a_ref(*args, "silu")
    else:
        ranks = name.endswith("ranks")
        args = _gemm_operands(rng, 3 if ranks else None)
        fn = gemm_ops.fused_gemm_a2a_ranks if ranks else gemm_ops.fused_gemm_a2a
        want = fused_gemm_a2a_ref_ranks(*args, "silu") if ranks else fused_gemm_a2a_ref(*args,
                                                                                        "silu")
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["wire", "chunks_zero", "chunks_auto", "ndim", "square"])
def test_dispatch_wrapper_rejects_bad_input(bad):
    x, kwargs = torch.zeros(1, 1, 2, 4, 8), {}
    fn = dispatch_ops.fused_dispatch_a2a
    if bad == "wire":
        kwargs["wire"] = "f16"
    elif bad == "chunks_zero":
        kwargs["chunks_per_rank"] = 0
    elif bad == "chunks_auto":
        kwargs["chunks_per_rank"] = "auto"
    elif bad == "ndim":
        x = torch.zeros(2, 4, 8)
    else:
        fn, x = dispatch_ops.fused_dispatch_a2a_ranks, torch.zeros(2, 3, 1, 2, 4, 8)
    with pytest.raises(ValueError):
        fn(x, **kwargs)


@pytest.mark.parametrize("bad", ["wire", "act", "dtype", "experts", "depth", "down",
                                 "device", "ranks"])
def test_gemm_wrapper_rejects_bad_input(rng, bad):
    x, wu, wg, wd = _gemm_operands(rng)
    kwargs = {}
    fn, err = gemm_ops.fused_gemm_a2a, ValueError
    if bad == "wire":
        kwargs["wire"] = "int8"
    elif bad == "act":
        kwargs["act"] = "swish"
    elif bad == "dtype":
        wg, err = wg.to(torch.bfloat16), TypeError
    elif bad == "experts":
        wu = wu[:1]
    elif bad == "depth":
        wg = wg[:, :8]
    elif bad == "down":
        wd = wd.transpose(1, 2)
    elif bad == "device":
        wd = wd.to("meta")
    else:
        fn = gemm_ops.fused_gemm_a2a_ranks
        x, wu, wg, wd = _gemm_operands(rng, 3)
        wu, wg, wd = wu[:2], wg[:2], wd[:2]
    with pytest.raises(err):
        fn(x, wu, wg, wd, **kwargs)


def test_one_rank_entries_refuse_a_larger_world(rng):
    x, wu, wg, wd = _gemm_operands(rng)
    x2 = torch.cat([x, x])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dispatch_ops.fused_dispatch_a2a(x2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gemm_ops.fused_gemm_a2a(x2, wu, wg, wd)


def test_fp8_wire_clamps_to_bf16(rng):
    x, wu, wg, wd = _gemm_operands(rng)
    with pytest.warns(UserWarning, match="bf16"):
        y = gemm_ops.fused_moe_chain(x, wu, wg, wd, wire="fp8")
    assert torch.equal(y, fused_gemm_a2a_ref(x, wu, wg, wd, "silu"))


@pytest.mark.parametrize("dim,q", [(8, 3), (6, 4), (5, 5), (12, 8), (7, 2), (16, 1)])
def test_chunks_per_rank_clamp_matches_jax(dim, q):
    assert feasible_chunks_per_rank(dim, 1, q) == jax_feasible(dim, 1, q)


# ---------------------------------------------------------------------------
# the MoE layer at tp = 1
# ---------------------------------------------------------------------------
def _moe_case(rng, cfg_kw, B=4, S=3):
    D, E, Fd = cfg_kw["d_model"], cfg_kw["n_experts"], cfg_kw["d_ff"]
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "w_gate": rng.standard_normal((E, D, Fd)).astype(np.float32) * D ** -0.5,
         "w_up": rng.standard_normal((E, D, Fd)).astype(np.float32) * D ** -0.5,
         "w_down": rng.standard_normal((E, Fd, D)).astype(np.float32) * Fd ** -0.5}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
@pytest.mark.parametrize("cfg_kw", [
    dict(n_experts=8, top_k=2, d_model=64, d_ff=32),                      # reduced dbrx
    dict(n_experts=16, top_k=4, d_model=48, d_ff=40, capacity_factor=0.6),
    dict(n_experts=4, top_k=1, d_model=32, d_ff=24, norm_topk_prob=False,
         router_scale=2.0, act="gelu"),
], ids=["reduced", "drops", "gelu"])
def test_moe_apply_matches_jax_bulk(ctx1, rng, mode, cfg_kw):
    p, x = _moe_case(rng, cfg_kw)
    jcfg = jmoe.MoEConfig(**cfg_kw)
    want = np.asarray(jax.jit(lambda p, x: jmoe.moe_apply(ctx1, p, x, jcfg))(p, x))
    got = moe.moe_apply(CPU[mode], {k: t(v) for k, v in p.items()}, t(x),
                        moe.MoEConfig(**cfg_kw))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


def _record_kernels(monkeypatch):
    """Kernel name -> the keyword arguments the MoE layer's exchanges
    (``core/moe_all_to_all.py``) pass the two kernels."""
    seen = {}
    for name in ("fused_dispatch_a2a", "fused_gemm_a2a"):
        real = getattr(pmoe_a2a, name)

        def rec(*args, _n=name, _f=real, **kwargs):
            seen[_n] = kwargs
            return _f(*args, **kwargs)
        monkeypatch.setattr(pmoe_a2a, name, rec)
    return seen


def test_moe_apply_passes_fusion_settings_to_the_kernels(rng, monkeypatch):
    cfg_kw = dict(n_experts=8, top_k=2, d_model=16, d_ff=8)
    p, x = _moe_case(rng, cfg_kw)
    seen = _record_kernels(monkeypatch)
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(
        mode="kernel", schedule="oblivious", granularity=2, skew=1, wire="bf16"))
    moe.moe_apply(ctx, {k: t(v) for k, v in p.items()}, t(x), moe.MoEConfig(**cfg_kw))
    assert seen == {"fused_dispatch_a2a": dict(comm_aware=False, chunks_per_rank=2, skew=1,
                                               wire="bf16"),
                    "fused_gemm_a2a": dict(act="silu", comm_aware=False, skew=1, wire="bf16")}


def test_moe_auto_choices_match_jax(rng, monkeypatch):
    """Kernel mode's 'auto' granularity and wire resolve through
    tune_all_to_all under the kernel's op, as the JAX package's
    ``moe_all_to_all._resolve(kernel=True)`` resolves the dispatch and the
    combine on the same shapes under the same link constants; the layer's
    output stays the JAX package's."""
    cfg_kw = dict(n_experts=8, top_k=2, d_model=16, d_ff=8)
    p, x = _moe_case(rng, cfg_kw)
    cfg = moe.MoEConfig(**cfg_kw)
    seen = _record_kernels(monkeypatch)
    params = {k: t(v) for k, v in p.items()}
    C = moe._route(cfg, t(x).reshape(-1, 16), params["router"])[-1]
    jc = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                              fusion=JaxFusion(mode="kernel", granularity="auto", wire="auto"))
    common = dict(sub_dim=C, chunk_elems=8 * C * 16, dtype_bytes=4, kernel=True)
    clear_both()
    jd = jmoe_a2a._resolve(jc, None, None, flops_per_dest=0.0, **common)
    jcomb = jmoe_a2a._resolve(jc, 1, None, flops_per_dest=2.0 * 3 * 8 * C * 16 * 8, **common)
    got = moe.moe_apply(v5e_ctx(mode="kernel", granularity="auto", wire="auto"), params, t(x), cfg)
    assert len(same_decisions()) == 2
    assert (seen["fused_dispatch_a2a"]["chunks_per_rank"], seen["fused_dispatch_a2a"]["wire"],
            seen["fused_gemm_a2a"]["wire"]) == (jd.q, jd.wire, jcomb.wire)
    want = np.asarray(jmoe.moe_apply(jc.with_fusion(JaxFusion(mode="bulk")), p, x,
                                     jmoe.MoEConfig(**cfg_kw)))
    np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])


@pytest.mark.parametrize("what", ["fused", "aux_loss", "decode_ep", "staged"])
def test_moe_unported_paths_raise(rng, what):
    """What is left of the layer's unported paths: the reference's staged
    kernel path (an artefact of its interpreter) raises, naming ROADMAP;
    fused mode, decode EP (at one rank all the experts are its own) and the
    load-balance loss run and give the JAX package's values.  (Shared
    experts run since deepseek-v3's slice: tests/test_torch_mla.py.)"""
    cfg_kw = dict(n_experts=4, top_k=2, d_model=16, d_ff=8)
    p, x = _moe_case(rng, cfg_kw)
    params, cfg, ctx = {k: t(v) for k, v in p.items()}, moe.MoEConfig(**cfg_kw), CPU["kernel"]
    jc = JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")), JaxFusion(mode="bulk"))
    want = np.asarray(jmoe.moe_apply(jc, p, x, jmoe.MoEConfig(**cfg_kw)))
    if what == "staged":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            moe._moe_kernel_staged(ctx, params, t(x), cfg)
    elif what == "fused":
        got = moe.moe_apply(ctx, params, t(x), cfg, mode="fused")
        np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])
    elif what == "decode_ep":
        got = moe._moe_decode_ep(ctx, params, t(x), cfg)
        np.testing.assert_allclose(got.numpy(), want, **TOL["f32"])
    else:
        probs = np.asarray(jax.nn.softmax(x.reshape(-1, 16) @ p["router"], axis=-1))
        gate_i = np.argsort(-probs, axis=-1)[:, :2]
        np.testing.assert_allclose(
            moe.moe_aux_loss(t(probs), t(gate_i), 4).item(),
            float(jmoe.moe_aux_loss(probs, gate_i, 4)), rtol=1e-6)


def test_moe_init_follows_the_reference_layout():
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert p["router"].shape == (64, 8) and p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (8, 64, 32)
    assert p["w_down"].shape == (8, 32, 64) and p["w_down"].dtype == torch.bfloat16
    # fan_in = shape[0] = the expert count, as the reference draws them
    assert p["w_up"].float().abs().max() <= 2 * 8 ** -0.5 + 1e-2
    assert p["w_up"].float().std() > 0.5 * 8 ** -0.5


# ---------------------------------------------------------------------------
# the slice: reduced dbrx-132b decode against the JAX decode at tp = 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dbrx():
    jb = jax_get_arch("dbrx-132b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch("dbrx-132b").reduced()
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jb, jparams, pb, pparams


def test_registry_matches_reference_reduced_dbrx():
    jcfg = jax_get_arch("dbrx-132b").reduced().config
    pcfg = get_arch("dbrx-132b").reduced().config
    for f in dataclasses.fields(pcfg):
        if f.name not in ("mla", "moe"):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(pcfg.moe):
        assert getattr(pcfg.moe, f.name) == getattr(jcfg.moe, f.name), f.name
    full = get_arch("dbrx-132b").config
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.vocab) == (
        40, 6144, 48, 8, 100352)
    assert (full.moe.n_experts, full.moe.top_k, full.moe.d_ff) == (16, 4, 10752)


def test_params_from_numpy_carries_moe_leaves(dbrx):
    jb, jparams, pb, pparams = dbrx
    tree = jax.tree.map(np.asarray, jparams)
    assert len(pparams["layers"]) == pb.config.n_layers
    for i, lp in enumerate(pparams["layers"]):
        for name in ("router", "w_gate", "w_up", "w_down"):
            want = tree["layers"]["l0"]["ffn"][name][i]
            assert lp["ffn"][name].shape == want.shape
            np.testing.assert_array_equal(lp["ffn"][name].numpy(), want)
    assert pparams["layers"][0]["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["kernel", "bulk"])
def test_dbrx_decode_steps_match_jax(ctx1, rng, dbrx, mode):
    """5 decode steps of reduced dbrx-132b (f32): logits and caches at
    TOL["f32"]."""
    jb, jparams, pb, pparams = dbrx
    B = 4
    jdec = jax.jit(lambda tk, c, p: jb.decode_fn(ctx1)(jparams, tk, c, p))
    pdec = pb.decode_fn(CPU[mode])
    jcache, pcache = jb.init_cache(B), pb.init_cache(B, "cpu")
    for s in range(5):
        tok = rng.integers(0, pb.config.vocab, (B, 1)).astype(np.int32)
        pos = (2 * s + np.arange(B)).astype(np.int32)
        jl, jcache = jdec(tok, jcache, pos)
        pl, pcache = pdec(pparams, t(tok), pcache, t(pos))
        assert pl.shape == (B, 1, pb.config.vocab) and pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL["f32"],
                                   err_msg=f"step {s}")
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(), np.asarray(jcache["scan"][name]),
                                   **TOL["f32"])


@pytest.mark.parametrize("n_req,batch", [(4, 4), (5, 2)])
def test_dbrx_greedy_streams_match_jax_engine(ctx1, dbrx, n_req, batch):
    jb, jparams, pb, pparams = dbrx
    prompts = [r.prompt for r in launch_serve.make_requests(n_req, pb.config.vocab, 1)]
    decode = jb.decode_fn(ctx1)
    jeng = JaxDecodeEngine(jax.jit(lambda tk, c, p: decode(jparams, tk, c, p)),
                           jb.init_cache, batch, max_seq=jb.config.max_seq)
    pdecode = pb.decode_fn(CPU["kernel"])
    peng = DecodeEngine(lambda tk, c, p: pdecode(pparams, tk, c, p),
                        lambda b: pb.init_cache(b, "cpu"), batch, device="cpu",
                        max_seq=pb.config.max_seq)
    for i, pr in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=pr, max_new=6))
        peng.submit(Request(uid=i, prompt=pr, max_new=6))
    jfin = {r.uid: r.tokens for r in jeng.run_until_drained(max_steps=200)}
    pfin = peng.run_until_drained(max_steps=200)
    assert pfin.drained and len(pfin) == n_req
    assert {r.uid: r.tokens for r in pfin} == jfin


def test_launcher_serves_reduced_dbrx_on_cpu(capsys):
    streams = []
    for mode in ("kernel", "bulk"):
        fin = launch_serve.main(["--arch", "dbrx-132b", "--reduced", "--device", "cpu",
                                 "--requests", "3", "--batch", "2", "--max-new", "4",
                                 "--fusion", mode])
        assert sorted(r.uid for r in fin) == [0, 1, 2]
        streams.append({r.uid: r.tokens for r in fin})
    assert streams[0] == streams[1]
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
