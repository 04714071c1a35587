"""The port's vocab-sharded cross-entropy against the JAX package.

The same numpy inputs, made from a seed, go through the JAX
``sharded_cross_entropy`` (on a one-device mesh, so its ring has no hops,
as on one card) and the port's, on the CPU in f32: the loss, and its
gradients with respect to the activations and the table (the JAX custom VJP
against the port's ``autograd.Function``).  Tolerances are those of
``tests/test_loss.py``: loss rtol 1e-5, gradients rtol 2e-3, atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.core.loss import sharded_cross_entropy as jax_ce
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.core import loss as ploss
from repro_torch.core.loss import sharded_cross_entropy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from torch_tune import clear_both, same_decisions, v5e_ctx

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
B, S, D, V = 4, 16, 32, 64


@pytest.fixture(scope="module")
def jctx():
    return JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")), fusion=JaxFusion())


def _ctx(granularity=1, mode="kernel"):
    return ParallelContext(device="cpu", fusion=FusionConfig(mode=mode, granularity=granularity))


def _inputs(rng, s=S, v=V):
    x = rng.standard_normal((B, s, D)).astype(np.float32)
    e = rng.standard_normal((v, D)).astype(np.float32)
    y = rng.integers(0, v, (B, s)).astype(np.int32)
    return x, e, y


def _port(x, e, y, ctx, **kw):
    xt, et = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, e))
    loss = sharded_cross_entropy(ctx, xt, et, torch.from_numpy(y), **kw)
    loss.backward()
    return loss.detach(), xt.grad, et.grad


def _jax(jctx, x, e, y, **kw):
    loss, (dx, de) = jax.jit(jax.value_and_grad(
        lambda x, e: jax_ce(jctx, x, e, y, **kw), argnums=(0, 1)))(x, e)
    return float(loss), np.asarray(dx), np.asarray(de)


@pytest.mark.parametrize("cap", [None, 20.0])
@pytest.mark.parametrize("granularity", [1, 2])
def test_ce_loss_and_grads_match_jax(jctx, rng, cap, granularity):
    x, e, y = _inputs(rng)
    want = _jax(jctx, x, e, y, logit_softcap=cap, chunks_per_rank=granularity)
    got = _port(x, e, y, _ctx(granularity), logit_softcap=cap)
    np.testing.assert_allclose(got[0].item(), want[0], **LOSS_TOL)
    for name, g, w in zip(("dx", "dE"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("cap", [None, 5.0])
def test_ce_matches_autograd_through_the_whole_logits(rng, cap):
    """The chunked analytic backward equals autograd through the full
    [tokens, V] logits (plain PyTorch), at granularity 4."""
    x, e, y = _inputs(rng)
    got = _port(x, e, y, _ctx(4), logit_softcap=cap)
    xt, et = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, e))
    lg = xt @ et.T
    if cap:
        lg = torch.tanh(lg / cap) * cap
    want = torch.nn.functional.cross_entropy(lg.reshape(-1, V), torch.from_numpy(y).long()
                                             .reshape(-1))
    want.backward()
    torch.testing.assert_close(got[0], want.detach(), **LOSS_TOL)
    torch.testing.assert_close(got[1], xt.grad, **GRAD_TOL)
    torch.testing.assert_close(got[2], et.grad, **GRAD_TOL)


def test_ce_labels_outside_the_vocabulary_match_jax(jctx, rng):
    """A label outside the table contributes its logsumexp alone and no
    label correction, as in the reference."""
    x, e, y = _inputs(rng)
    y[0, :3] = [-1, V, V + 7]
    want = _jax(jctx, x, e, y)
    got = _port(x, e, y, _ctx())
    np.testing.assert_allclose(got[0].item(), want[0], **LOSS_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("granularity,s,want", [(4, 6, 3), (5, 16, 4), (3, 7, 1), (2, 16, 2)])
def test_ce_granularity_is_clamped_to_a_divisor(monkeypatch, rng, granularity, s, want):
    seen = []
    real = ploss._LocalCE.apply
    monkeypatch.setattr(ploss._LocalCE, "apply",
                        lambda *a: seen.append(a[-1]) or real(*a))
    x, e, y = _inputs(rng, s=s)
    got = _port(x, e, y, _ctx(granularity))
    ref = _port(x, e, y, _ctx(1))
    assert seen == [want, 1]
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **GRAD_TOL)


def test_ce_bf16_grads_keep_the_inputs_dtypes(rng):
    x, e, y = _inputs(rng)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    et = torch.from_numpy(e).bfloat16().requires_grad_(True)
    loss = sharded_cross_entropy(_ctx(2), xt, et, torch.from_numpy(y))
    loss.backward()
    assert loss.dtype == torch.float32
    assert xt.grad.dtype == et.grad.dtype == torch.bfloat16
    assert torch.isfinite(xt.grad.float()).all() and torch.isfinite(et.grad.float()).all()


@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_ce_compressed_wire_matches_jax(jctx, rng, wire):
    """A compressed wire at tp = 1: the loss is untouched (the ring has no
    hop) and dx rounds once through the wire on the final hop home, as the
    reference's does even at n = 1."""
    x, e, y = _inputs(rng)
    want = _jax(jctx, x, e, y, wire=wire, chunks_per_rank=2)
    got = _port(x, e, y, _ctx(2), wire=wire)
    np.testing.assert_allclose(got[0].item(), want[0], **LOSS_TOL)
    for name, g, w in zip(("dx", "dE"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=name)
    exact = _port(x, e, y, _ctx(2))[1]
    assert not torch.equal(got[1], exact)       # the wire rounded dx


@pytest.mark.parametrize("kw,err,match", [
    ({"chunks_per_rank": 0}, ValueError, ">= 1"),
])
def test_ce_refuses(rng, kw, err, match):
    x, e, y = (torch.from_numpy(a) for a in _inputs(rng))
    with pytest.raises(err, match=match):
        sharded_cross_entropy(_ctx(), x, e, y, **kw)


def _auto_matches_jax(jctx, rng, port_ctx, jax_kw, port_kw):
    """The port's 'auto' CE against the JAX package's: the same tune_ce_ring
    decision under the same link constants, the same loss and gradients."""
    x, e, y = _inputs(rng)
    clear_both()
    want = _jax(jctx, x, e, y, **jax_kw)
    got = _port(x, e, y, port_ctx, **port_kw)
    assert len(same_decisions()) == 1
    np.testing.assert_allclose(float(got[0]), want[0], **LOSS_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_ce_auto_granularity_matches_jax(jctx, rng):
    _auto_matches_jax(jctx, rng, v5e_ctx(mode="kernel"), {"chunks_per_rank": "auto"},
                      {"chunks_per_rank": "auto"})


def test_ce_auto_granularity_from_the_context_matches_jax(jctx, rng):
    jc = jctx.with_fusion(JaxFusion(granularity="auto", wire="auto"))
    _auto_matches_jax(jctx=jc, rng=rng, port_ctx=v5e_ctx(mode="kernel", granularity="auto",
                                                         wire="auto"),
                      jax_kw={}, port_kw={})
