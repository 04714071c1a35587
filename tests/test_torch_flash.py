"""The port's flash-attention op and prefill attention against the JAX package.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``repro_torch`` on the CPU.  The JAX flash kernel runs
in interpret mode, as the JAX package's own tests run it; ``context_attention``
runs under the conftest ``ctx`` (a (2, 4) data x model mesh of CPU
devices), the port on one rank.  On the CPU the port's op runs its plain
version and ``context_attention`` its plain ``_span_flash`` (the CUDA kernel
runs only on a card, in chip_smoke.py).  f32 unless a test says otherwise.

The gradients (the port's analytic ``flash_backward``, the reference's
``_span_flash_bwd``) are held to the JAX package's on a one-device mesh
(the ring attention of one card, no hops), at rtol 2e-3, atol 1e-5: the
bounds of ``tests/test_loss.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.compat import make_mesh
from repro.models import attention as jattn
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention
from repro_torch.parallel.sharding import FusionConfig, ParallelContext

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = {m: ParallelContext(device="cpu", fusion=FusionConfig(mode=m)) for m in ("kernel", "bulk")}
F32 = TOL["f32"]
# bf16 inputs against the TPU kernel: the TPU kernel rounds P to bf16 before
# the PV product and the port keeps it in f32, and both round the output to
# bf16 once (a step of 2^-8 relative): TOL["bf16"].
BF16 = TOL["bf16"]
GRAD = dict(rtol=2e-3, atol=1e-5)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(rng, b, s, hq, hkv, d, dtype=np.float32):
    return tuple(rng.standard_normal((b, s, h, d)).astype(dtype) for h in (hq, hkv, hkv))


def _fold(a):
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _unfold(a, b, h):
    bh, s, d = a.shape
    return a.reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _jax_ref(q, k, v, causal):
    """The JAX oracle on [B, S, H, d], each kv head repeated over its group."""
    b, _, hq, d = q.shape
    g = hq // k.shape[2]
    k, v = (np.repeat(a, g, axis=2) for a in (k, v))
    out = jax_flash_ref(_fold(q), _fold(k), _fold(v), scale=d ** -0.5, causal=causal)
    return _unfold(np.asarray(out), b, hq)


# ---------------------------------------------------------------------------
# the op (plain version on the CPU) against the JAX kernel and its oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,hd", [(64, 16), (32, 32), (128, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel_and_ref(rng, s, hd, causal):
    q, k, v = _qkv(rng, 2, s, 3, 3, hd)
    want_kernel = np.asarray(jax_flash(q, k, v, causal=causal, bq=16, bkv=16))
    got = flash_attention(t(q), t(k), t(v), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **F32)
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, causal), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_jax_ref(rng, causal):
    q, k, v = (_fold(a) for a in _qkv(rng, 2, 48, 3, 3, 16))
    want = np.asarray(jax_flash_ref(q, k, v, scale=0.3, causal=causal))
    got = flash_attention_ref(t(q), t(k), t(v), scale=0.3, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (6, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gqa_matches_ref_on_expanded_kv(rng, hq, hkv, causal):
    q, k, v = _qkv(rng, 2, 40, hq, hkv, 16)
    got = flash_attention(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, causal), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_against_the_tpu_kernel(rng, causal):
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(rng, 2, 64, 2, 2, 32))
    want = np.asarray(jax_flash(q, k, v, causal=causal, bq=16, bkv=16).astype(jnp.float32))
    tq, tk, tv = (t(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("s", [1, 37, 40, 129])
def test_flash_attention_any_s_matches_ref(rng, s):
    """No block divisor needed: every row is computed at a ragged S."""
    q, k, v = _qkv(rng, 2, s, 4, 2, 16)
    for causal in (True, False):
        got = flash_attention(t(q), t(k), t(v), causal=causal, scale=0.2)
        want = flash_attention_plain(t(q), t(k), t(v), causal=causal, scale=0.2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        b, _, hq, d = q.shape
        g = hq // k.shape[2]
        ref = jax_flash_ref(_fold(q), _fold(np.repeat(k, g, 2)), _fold(np.repeat(v, g, 2)),
                            scale=0.2, causal=causal)
        np.testing.assert_allclose(got.numpy(), _unfold(np.asarray(ref), b, hq), **F32)


@pytest.mark.parametrize("bad", ["window", "softcap", "heads", "dtype", "backward"])
def test_flash_attention_refuses(rng, bad):
    q, k, v = (t(a) for a in _qkv(rng, 1, 8, 4, 2, 16))
    if bad == "window":
        # a window takes at least the diagonal (test_flash_window_and_cap_* compute)
        for w in (0, -3, 2.5):
            with pytest.raises(ValueError, match="window"):
                flash_attention(q, k, v, window=w)
    elif bad == "softcap":
        for c in (0.0, -2.0):
            with pytest.raises(ValueError, match="softcap"):
                flash_attention(q, k, v, softcap=c)
    elif bad == "heads":
        with pytest.raises(ValueError, match="multiple of Hkv"):
            flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16), v[:, :, :1].expand(1, 8, 3, 16))
    elif bad == "dtype":
        with pytest.raises(TypeError):
            flash_attention(q, k.double(), v.double())
    else:
        # the analytic backward is not itself differentiable
        q.requires_grad_(True)
        w = torch.ones_like(q, requires_grad=True)
        (dq,) = torch.autograd.grad(flash_attention(q, k, v), q, w, create_graph=True)
        with pytest.raises(RuntimeError, match="differentiate twice"):
            dq.sum().backward()


# ---------------------------------------------------------------------------
# a sliding window and a softcap (gemma2): the plain version against the
# reference's blockwise attention, which is what the kernel computes for them
# ---------------------------------------------------------------------------
WINDOW_CAP = [(12, None), (None, 2.0), (16, 50.0), (7, 3.0), (100, None)]


def _jax_span_kw(q, k, v, *, causal, window, cap, scale, qb=16, kb=16):
    return _jax_span(q, k, v, causal=causal, window=window, cap=cap, qb=qb, kb=kb, scale=scale)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_and_cap_match_jax_span(rng, window, cap, causal):
    """f32: the op (its plain version on the CPU) and ``flash_attention_plain``
    against ``_span_flash`` at blocks of 16 dividing S = 64; windows of 7 and
    12 are not block multiples, 100 is wider than S.  q is scaled so that
    the scores reach several times the cap."""
    q, k, v = _qkv(rng, 2, 64, 4, 2, 16)
    q = q * 4.0
    want = _jax_span_kw(q, k, v, causal=causal, window=window, cap=cap, scale=0.25)
    got = flash_attention(t(q), t(k), t(v), causal=causal, scale=0.25, window=window,
                          softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    plain = flash_attention_plain(t(q), t(k), t(v), causal=causal, scale=0.25, window=window,
                                  softcap=cap)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


@pytest.mark.parametrize("window,cap", WINDOW_CAP[:4])
def test_flash_window_and_cap_bf16(rng, window, cap):
    """bf16 inputs, causal: the op against ``_span_flash`` on the same
    bf16-representable values in f32 (the kernel sums the scores in f32 from
    bf16 inputs); the output rounds once to bf16."""
    q, k, v = (t(a).to(torch.bfloat16) for a in _qkv(rng, 2, 48, 4, 2, 32))
    q = q * 3
    want = _jax_span_kw(*(a.float().numpy() for a in (q, k, v)), causal=True, window=window,
                        cap=cap, scale=32 ** -0.5)
    got = flash_attention(q, k, v, window=window, softcap=cap)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("s,window", [(37, 5), (40, 16), (129, 33)])
def test_flash_window_any_s(rng, s, window):
    """A ragged S (no block divisor) with a window off every block: the
    plain version against the dense ``flash_attention_ref`` of the JAX
    package on the rows the window keeps, masked by hand."""
    q, k, v = _qkv(rng, 1, s, 2, 1, 16)
    got = flash_attention(t(q), t(k), t(v), window=window, softcap=5.0, scale=0.3).numpy()
    sc = np.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) * 0.3
    sc = 5.0 * np.tanh(sc / 5.0)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    sc = np.where((j <= i) & (i - j < window), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkd->bqhd", p / p.sum(-1, keepdims=True), v[:, :, 0])
    np.testing.assert_allclose(got, want, **F32)


def test_flash_window_wider_than_s_is_no_window(rng):
    q, k, v = (t(a) for a in _qkv(rng, 1, 20, 2, 2, 16))
    torch.testing.assert_close(flash_attention(q, k, v, window=20), flash_attention(q, k, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(flash_attention(q, k, v, window=10 ** 12),
                               flash_attention(q, k, v), rtol=0, atol=0)


def test_flash_attention_counts_only_kernel_launches(rng):
    q, k, v = (t(a) for a in _qkv(rng, 1, 8, 2, 2, 16))
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before        # the CPU runs the plain version
    assert flash_ops.KERNEL_D == (64, 128, 224)       # 224: zamba2-7b's shared attention


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "tile"),                       # chatglm3's heads: TMA + wgmma
    (torch.bfloat16, 64, "cuda_core"),                   # the tile kernel takes d = 128 only
    (torch.float32, 128, "cuda_core"),                   # tensor cores would be TF32
    (torch.float32, 64, "cuda_core"),
    (torch.bfloat16, 224, "cuda_core"),                  # zamba2's heads: no tile path at 224
    (torch.float32, 224, "cuda_core"),
])
def test_flash_path_choice(dtype, d, want):
    assert flash_ops.flash_path(dtype, d) == want


@pytest.mark.parametrize("offset", [0, 1, 7, 8])
def test_flash_launch_operands_are_16_byte_aligned(offset):
    """The launch passes q, k and v through ``_aligned``: a view that starts
    off 16 bytes is copied, so the tile path's TMA bases are always aligned."""
    buf = torch.arange(2 * 3 * 4 * 128 + offset, dtype=torch.bfloat16)
    view = buf[offset:].view(2, 3, 4, 128)
    got = flash_ops._aligned(view)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert (got.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)
    torch.testing.assert_close(got, view, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,d,path", [
    (np.float32, 128, "tile"),                           # f32 is never on the tile path
    (np.float32, 64, "tile"),
    (np.float32, 16, "cuda_core"),                       # no kernel takes d = 16
    (np.float32, 128, "tensor"),                         # no such path
])
def test_flash_attention_forced_path_that_does_not_fit_raises(rng, dtype, d, path):
    q, k, v = (t(a) for a in _qkv(rng, 1, 8, 4, 2, d, dtype))
    before = (flash_attention.launches, dict(flash_attention.path_launches))
    with pytest.raises(ValueError, match="does not take"):
        flash_attention(q, k, v, _path=path)
    assert (flash_attention.launches, flash_attention.path_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", [None, "cuda_core", "tile"])
def test_flash_attention_cpu_takes_plain_on_every_path(rng, dtype, path):
    """A CPU tensor runs the plain version whatever path is asked for (where
    that path fits), and counts no launch on either path."""
    if path == "tile" and dtype == torch.float32:
        path = "cuda_core"
    q, k, v = (t(a).to(dtype) for a in _qkv(rng, 2, 33, 4, 2, 128))
    before = (flash_attention.launches, dict(flash_attention.path_launches))
    got = flash_attention(q, k, v, _path=path)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), rtol=0, atol=0)
    assert (flash_attention.launches, flash_attention.path_launches) == before


# ---------------------------------------------------------------------------
# the model's blockwise attention and context_attention
# ---------------------------------------------------------------------------
def _jax_span(q, k, v, *, causal, window, cap, qb, kb, scale):
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    pos = jnp.arange(s)
    carry = jattn._span_flash(jnp.asarray(q).reshape(b, s, hkv, g, hd), k, v, pos, pos,
                              jattn._init_carry(b, hkv, g, s, hd), causal=causal,
                              window=window, scale=scale, cap=cap, q_block=qb, kv_block=kb)
    return np.asarray(jattn._finalize(carry, b, s, hq, hd))


@pytest.mark.parametrize("causal,window,cap", [(True, None, None), (False, None, None),
                                               (True, 12, None), (True, None, 2.0),
                                               (False, 20, 3.0)])
@pytest.mark.parametrize("qb,kb", [(16, 32), (64, 64)])
def test_span_flash_matches_jax(rng, causal, window, cap, qb, kb):
    q, k, v = _qkv(rng, 2, 64, 4, 2, 16)
    want = _jax_span(q, k, v, causal=causal, window=window, cap=cap, qb=qb, kb=kb, scale=0.25)
    got = attention.span_attention(t(q), t(k), t(v), causal=causal, window=window,
                                   scale=0.25, cap=cap, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_span_flash_ragged_computes_every_row(rng):
    """At S = 40 with blocks of 16 the port computes all 40 rows and matches
    the oracle; the reference's ``_span_flash`` loops ``sq // q_block`` and
    ``sk // kv_block`` times and returns zeros for rows 32-39 (ROADMAP
    Queue 3): a known difference, pinned here."""
    q, k, v = _qkv(rng, 2, 40, 4, 2, 16)
    scale = 16 ** -0.5                                    # _jax_ref's
    got = attention.span_attention(t(q), t(k), t(v), causal=True, window=None, scale=scale,
                                   cap=None, q_block=16, kv_block=16)
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, True), **F32)
    jax_out = _jax_span(q, k, v, causal=True, window=None, cap=None, qb=16, kb=16, scale=scale)
    assert np.all(jax_out[:, 32:] == 0) and np.abs(got.numpy()[:, 32:]).min() > 0
    np.testing.assert_allclose(got.numpy()[:, :32], jax_out[:, :32], **F32)


@pytest.mark.parametrize("jax_mode", ["bulk", "fused"])
@pytest.mark.parametrize("window,cap", [(None, None), (12, None), (None, 2.0)])
def test_context_attention_matches_jax(ctx, rng, jax_mode, window, cap):
    q, k, v = _qkv(rng, 4, 32, 4, 2, 16)
    want = np.asarray(jax.jit(lambda q, k, v: jattn.context_attention(
        ctx, q, k, v, causal=True, window=window, softcap_val=cap, mode=jax_mode))(q, k, v))
    for mode, c in CPU.items():
        got = attention.context_attention(c, t(q), t(k), t(v), causal=True, window=window,
                                          softcap_val=cap)
        assert got.shape == q.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=mode)


def test_context_attention_fused_mode_raises(rng, jctx1):
    """Fused mode at tp = 1 is the reference's KV ring with no hop: its
    output and its gradient (the analytic backward) against the JAX
    package's fused mode on one device (at tp > 1 the ring's backward is
    held to the JAX package's in tests/test_torch_ring_train.py)."""
    q, k, v = _qkv(rng, 2, 32, 4, 2, 16)
    do = rng.standard_normal(q.shape).astype(np.float32)
    fused = ParallelContext(device="cpu")
    for kw in (dict(), dict(window=12), dict(softcap_val=2.0)):
        want = np.asarray(jax.jit(lambda q, k, v: jattn.context_attention(
            jctx1["fused"], q, k, v, causal=True, **kw))(q, k, v))
        got = attention.context_attention(fused, t(q), t(k), t(v), causal=True, **kw)
        np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=str(kw))
        for name, gt_, w in zip(("dq", "dk", "dv"), _port_grads(fused, q, k, v, do, **kw),
                                _jax_grads(jctx1["fused"], q, k, v, do, **kw)):
            np.testing.assert_allclose(gt_.numpy(), w, **GRAD, err_msg=f"{kw} {name}")


@pytest.mark.parametrize("sq,sk,delta,causal,window,cap", [
    (32, 16, 32, True, None, None),      # a hop from a lower rank: every key seen
    (32, 16, 8, True, None, None),       # the diagonal cuts the span
    (16, 32, -40, True, None, None),     # wholly above the diagonal: every row empty
    (32, 16, 24, True, 24, None),        # the window cuts the span: some rows empty
    (32, 16, 16, False, None, 2.0),
    (32, 32, -8, False, 12, 30.0)], ids=str)
def test_flash_span_of_its_own_matches_jax_span(rng, sq, sk, delta, causal, window, cap):
    """The op (its plain version on the CPU) with keys of their own length at
    an offset ``delta`` and ``stats=True``, against the JAX package's
    ``_span_flash`` with ``qpos = delta + arange(Sq)`` and ``kpos =
    arange(Sk)``: o, m and l of every row that sees a key; a row that sees
    none gives o = 0, m = -1e30 and l = 0."""
    b, hq, hkv, hd = 2, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, hd)).astype(np.float32) for _ in "kv")
    o, m, l = flash_attention(t(q), t(k), t(v), causal=causal, window=window, softcap=cap,
                              delta=delta, stats=True)
    assert torch.equal(flash_attention(t(q), t(k), t(v), causal=causal, window=window,
                                       softcap=cap, delta=delta), o)
    jm, jl, jo = jattn._span_flash(
        jnp.asarray(q).reshape(b, sq, hkv, hq // hkv, hd), k, v, delta + jnp.arange(sq),
        jnp.arange(sk), jattn._init_carry(b, hkv, hq // hkv, sq, hd), causal=causal,
        window=window, scale=hd ** -0.5, cap=cap, q_block=16, kv_block=16)
    qpos, kpos = delta + np.arange(sq), np.arange(sk)
    seen = np.ones((sq, sk), bool)
    if causal:
        seen &= kpos[None] <= qpos[:, None]
    if window is not None:
        seen &= qpos[:, None] - kpos[None] < window
    rows = seen.any(axis=1)
    want_o = np.asarray(jattn._finalize((jm, jl, jo), b, sq, hq, hd))
    np.testing.assert_allclose(o.numpy()[:, rows], want_o[:, rows], **F32)
    np.testing.assert_allclose(m.numpy()[..., rows], np.asarray(jm).reshape(b, hq, sq)[..., rows],
                               **F32)
    np.testing.assert_allclose(l.numpy()[..., rows], np.asarray(jl).reshape(b, hq, sq)[..., rows],
                               **F32)
    assert (o.numpy()[:, ~rows] == 0).all() and (l.numpy()[..., ~rows] == 0).all()
    assert (m.numpy()[..., ~rows] == np.float32(-1e30)).all()
    assert rows.all() != (delta in (-40, 24))


def test_flash_span_defaults_are_one_span(rng):
    """Sk = Sq and delta = 0 are the call without them, to the bit, with and
    without statistics; statistics or a span of its own under autograd
    raise (a ring hop is differentiated through context_attention's
    ring)."""
    q, k, v = (t(a) for a in _qkv(rng, 2, 40, 4, 2, 16))
    for kw in (dict(), dict(window=12, softcap=3.0), dict(causal=False)):
        base = flash_attention(q, k, v, **kw)
        assert torch.equal(flash_attention(q, k, v, delta=0, **kw), base)
        o, m, l = flash_attention(q, k, v, delta=0, stats=True, **kw)
        assert torch.equal(o, base)
        want_m, want_l = flash_attention_plain(q, k, v, stats=True, **kw)[1:]
        assert torch.equal(m, want_m) and torch.equal(l, want_l)
    qg = q.clone().requires_grad_(True)
    for kw in (dict(stats=True), dict(delta=4)):
        with pytest.raises(NotImplementedError, match="through context_attention's ring"):
            flash_attention(qg, k, v, **kw)
    with pytest.raises(NotImplementedError, match="through context_attention's ring"):
        flash_attention(qg, k[:, :16], v[:, :16])


# ---------------------------------------------------------------------------
# training: the softmax statistics and the analytic backward
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jctx1():
    """A one-device mesh: the reference's ring attention with no hops."""
    return {m: JaxContext.from_mesh(make_mesh((1, 1), ("data", "model")),
                                    fusion=JaxFusion(mode=m)) for m in ("fused", "bulk")}


def _jax_carry(q, k, v, *, causal, window=None, cap=None, qb=16, kb=16, scale=None):
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    pos = jnp.arange(s)
    return jattn._span_flash(jnp.asarray(q).reshape(b, s, hkv, hq // hkv, hd), k, v, pos, pos,
                             jattn._init_carry(b, hkv, hq // hkv, s, hd), causal=causal,
                             window=window, scale=scale, cap=cap, q_block=qb, kv_block=kb)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (6, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_match_the_reference_carry(rng, hq, hkv, causal):
    """The op's m and l ([B, Hq, S]) against the final (m, l) carry of the
    reference's blockwise loop: the residuals its fwd_rule keeps."""
    q, k, v = _qkv(rng, 2, 48, hq, hkv, 16)
    out, m, l = flash_attention_plain(t(q), t(k), t(v), causal=causal, stats=True)
    assert m.shape == l.shape == (2, hq, 48) and m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(out, flash_attention_plain(t(q), t(k), t(v), causal=causal),
                               rtol=0, atol=0)
    jm, jl, _ = _jax_carry(q, k, v, causal=causal)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm).reshape(2, hq, 48), **F32)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(2, hq, 48), **F32)


@pytest.mark.parametrize("causal,window,cap", [(True, None, None), (False, None, None),
                                               (True, 12, None), (True, None, 2.0),
                                               (False, 20, 3.0)])
@pytest.mark.parametrize("hq,hkv,qb,kb", [(4, 2, 16, 32), (4, 4, 64, 64), (6, 2, 32, 16)])
def test_span_flash_bwd_matches_jax(rng, causal, window, cap, hq, hkv, qb, kb):
    """The port's ``_span_flash_bwd`` against the reference's on the same
    inputs and statistics; S = 64 is a multiple of both blocks."""
    b, s, hd, scale = 2, 64, 16, 0.25
    g = hq // hkv
    q, k, v = _qkv(rng, b, s, hq, hkv, hd)
    do = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    m, l, o = _jax_carry(q, k, v, causal=causal, window=window, cap=cap, scale=scale)
    o5 = np.asarray(o / jnp.maximum(l, 1e-30)[..., None]).transpose(0, 3, 1, 2, 4)
    q5, do5 = q.reshape(b, s, hkv, g, hd), do.reshape(b, s, hkv, g, hd)
    delta = np.einsum("bqhgd,bqhgd->bhgq", do5, o5)
    pos = np.arange(s)
    kw = dict(causal=causal, window=window, scale=scale, cap=cap, q_block=qb, kv_block=kb)
    want = jattn._span_flash_bwd(q5, k, v, do5, delta, m, l, pos, pos,
                                 jnp.zeros(q5.shape, jnp.float32), **kw)
    got = attention._span_flash_bwd(t(q5), t(k), t(v), t(do5), t(delta), t(np.asarray(m)),
                                    t(np.asarray(l)), torch.arange(s), torch.arange(s),
                                    torch.zeros(q5.shape), **kw)
    for name, gt_, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt_.numpy(), np.asarray(w), **GRAD, err_msg=name)


@pytest.mark.parametrize("window,cap", [(12, None), (None, 2.0), (16, 50.0), (7, 3.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_with_window_and_cap_match_the_reference_carry(rng, window, cap, causal):
    """m and l of the capped, masked scores against the reference's final
    carries of ``_span_flash`` with the same window and cap."""
    q, k, v = _qkv(rng, 2, 48, 4, 2, 16)
    q = q * 4.0
    out, m, l = flash_attention_plain(t(q), t(k), t(v), causal=causal, window=window,
                                      softcap=cap, stats=True)
    torch.testing.assert_close(out, flash_attention_plain(t(q), t(k), t(v), causal=causal,
                                                          window=window, softcap=cap),
                               rtol=0, atol=0)
    jm, jl, _ = _jax_carry(q, k, v, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm).reshape(2, 4, 48), **F32)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(2, 4, 48), **F32)


def _jax_grads(ctx, q, k, v, do, **kw):
    fn = lambda q, k, v: jnp.sum(jattn.context_attention(ctx, q, k, v, causal=True, **kw) * do)
    return [np.asarray(a) for a in jax.jit(jax.grad(fn, argnums=(0, 1, 2)))(q, k, v)]


def _port_grads(c, q, k, v, do, **kw):
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    out = attention.context_attention(c, qt, kt, vt, causal=True, **kw)
    return torch.autograd.grad((out * t(do)).sum(), (qt, kt, vt))


@pytest.mark.parametrize("window,cap", [(None, None), (12, None), (None, 2.0)])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
def test_context_attention_grads_match_jax(rng, jctx1, window, cap, hq, hkv):
    """dq, dk, dv of ``context_attention`` against ``jax.grad``: kernel mode
    (the analytic backward) against the reference's ring attention (its
    custom VJP), bulk mode (autograd through ``_span_flash``) against its
    bulk branch (autodiff)."""
    q, k, v = _qkv(rng, 2, 32, hq, hkv, 16)
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(window=window, softcap_val=cap)
    for jmode, mode in (("fused", "kernel"), ("bulk", "bulk")):
        want = _jax_grads(jctx1[jmode], q, k, v, do, **kw)
        got = _port_grads(CPU[mode], q, k, v, do, **kw)
        for name, gt_, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(gt_.numpy(), w, **GRAD, err_msg=f"{mode} {name}")


def test_flash_op_grads_match_jax_and_bulk(rng, jctx1):
    """The flash op's own backward (the one a card runs after the kernel),
    on the CPU's plain forward with its statistics: against the
    reference's ring attention and the port's bulk-mode autograd."""
    q, k, v = _qkv(rng, 2, 40, 4, 2, 16)
    do = rng.standard_normal(q.shape).astype(np.float32)
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    got = torch.autograd.grad((flash_attention(qt, kt, vt) * t(do)).sum(), (qt, kt, vt))
    bulk = _port_grads(CPU["bulk"], q, k, v, do)
    q32, k32, v32 = (a[:, :32] for a in (q, k, v))      # the reference drops ragged rows
    want = _jax_grads(jctx1["fused"], q32, k32, v32, do[:, :32])
    got32 = _port_grads(CPU["kernel"], q32, k32, v32, do[:, :32])
    for name, gt_, b_ in zip(("dq", "dk", "dv"), got, bulk):
        torch.testing.assert_close(gt_, b_, **GRAD, msg=name)
    for name, gt_, w in zip(("dq", "dk", "dv"), got32, want):
        np.testing.assert_allclose(gt_.numpy(), w, **GRAD, err_msg=name)


@pytest.mark.parametrize("window,cap", [(12, None), (None, 2.0), (7, 3.0), (16, 50.0)])
def test_flash_op_grads_with_window_and_cap_match_jax(rng, jctx1, window, cap):
    """The flash op's own backward with a window and a cap (the window and
    cap it saves and hands to ``flash_backward``) against the reference's
    ring attention (its custom VJP) and the port's bulk-mode autograd
    through ``span_attention``."""
    q, k, v = _qkv(rng, 2, 32, 4, 2, 16)
    q = q * 3.0
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(window=window, softcap_val=cap)
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(qt, kt, vt, window=window, softcap=cap)
    got = torch.autograd.grad((out * t(do)).sum(), (qt, kt, vt))
    want = _jax_grads(jctx1["fused"], q, k, v, do, **kw)
    bulk = _port_grads(CPU["bulk"], q, k, v, do, **kw)
    for name, gt_, w, b_ in zip(("dq", "dk", "dv"), got, want, bulk):
        np.testing.assert_allclose(gt_.numpy(), w, **GRAD, err_msg=name)
        torch.testing.assert_close(gt_, b_, **GRAD, msg=name)


def test_flash_op_without_grad_saves_nothing(monkeypatch, rng):
    """No gradient wanted (prefill, serving): the op asks for no statistics."""
    seen = []
    real = flash_ops.flash_attention_plain
    monkeypatch.setattr(flash_ops, "flash_attention_plain",
                        lambda *a, **kw: seen.append(kw["stats"]) or real(*a, **kw))
    q, k, v = (t(a) for a in _qkv(rng, 1, 8, 2, 2, 16))
    flash_attention(q, k, v)
    with torch.no_grad():
        flash_attention(q.requires_grad_(True), k, v)
    flash_attention(q, k, v)
    assert seen == [False, False, True]
