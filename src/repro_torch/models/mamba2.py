"""Mamba-2 (SSD) block with the chunked selective scan.

Scalar-per-head decay makes the chunked form a plain matmul structure: the
pairwise decay ratios exp(la_t - la_s) for s <= t lie in (0, 1], so the
algorithm is safe at any chunk size.  The reference computes the scan and
the causal conv outside any Pallas kernel, and so does the port: plain
PyTorch, f32 for the scan.  The out projection is row-parallel through
``matmul_allreduce``: the fused GEMV/GEMM + AllReduce kernel in kernel mode
on a CUDA tensor, the paper's operator at every Mamba block.

Training differentiates the scan by autograd (:func:`ssd_chunked` computes
every chunk's intra-chunk term at once, then carries the state chunk after
chunk: the same products per chunk as the reference's ``lax.scan`` over
``jax.checkpoint``-ed chunks, whose recompute the caller's group remat
stands in for).

Over tp the heads are split (:func:`param_specs`): rank r holds heads
``[r H / tp, (r + 1) H / tp)``, that is ``w_in``'s z, x and dt columns of
its heads and its B and C columns whole, ``conv``'s x channels of its heads
and its B and C channels whole, the heads' entries of ``A_log``, ``D``,
``dt_bias`` and the gated norm's weight, and ``w_out``'s rows of its heads.
The block's input is the same on every rank and so is its output (the out
projection sums over the ranks).  The gated norm normalises over the whole
d_inner: each rank's sum of squares is summed over tp.  B and C are the
same on every rank and each rank's heads use them, so their weights'
gradients are summed over tp (``copy_to_tp``), as is the sum of squares'.
The caller passes the block's input through ``copy_to_tp`` before its norm
(``models/zamba2.py``), so the input's gradient is whole on every rank.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_reduce, copy_to_tp
from repro_torch.core.matmul_allreduce import matmul_allreduce
from repro_torch.models.common import dense_init
from repro_torch.models.layers import rms_norm_init
from repro_torch.parallel.sharding import HeadsAxis, ParallelContext

LOG_DECAY_MIN = -60.0    # every clip(..., -60, 0) of the reference


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64          # N
    head_dim: int = 64         # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim


def mamba2_init(gen: torch.Generator, cfg: Mamba2Config, dtype):
    """The reference's leaves and init scales; ``w_in``'s columns are
    ``[z, x, B, C, dt]``."""
    D, Di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_in": dense_init(gen, (D, 2 * Di + 2 * N + H), dtype),
        "conv": dense_init(gen, (cfg.conv_width, Di + 2 * N), dtype, scale=0.3),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": rms_norm_init(Di, gen.device),
        "w_out": dense_init(gen, (Di, D), dtype),
    }


def param_specs(cfg: Mamba2Config) -> dict:
    """The logical specs of a block's leaves in the port's layout by heads:
    the reference's ``"fsdp"`` dims kept (split over data in training), its
    tp dims split by heads (segmented where B and C stay whole,
    ``parallel.sharding.HeadsAxis``), and ``A_log``, ``D``, ``dt_bias`` and
    the norm, which the reference keeps whole, split by heads as well."""
    Di, N, H = cfg.d_inner, cfg.d_state, cfg.n_heads
    return {"w_in": ("fsdp", HeadsAxis((Di, False), (Di, False), (2 * N, True), (H, False))),
            "conv": (None, HeadsAxis((Di, False), (2 * N, True))),
            "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",), "norm": ("heads",),
            "w_out": ("heads", "fsdp")}


def check_heads(cfg: Mamba2Config, tp: int):
    if cfg.n_heads % tp:
        raise ValueError(f"tp={tp} does not divide the {cfg.n_heads} Mamba heads")


def _decay(x):
    """exp(clip(x, -60, 0)), the reference's guarded decay."""
    return torch.exp(x.clamp(LOG_DECAY_MIN, 0.0))


def ssd_chunked(x, dt, A_log, B, C, state, chunk: int):
    """Chunked SSD scan, f32.

    x: [b, T, H, P]; dt: [b, T, H]; B, C: [b, T, N]; state: [b, H, N, P].
    h_t = a_t h_{t-1} + dt_t B_t x_t^T;  y_t = C_t . h_t, with a_t =
    exp(-dt_t exp(A_log_h)) a scalar per head.  Returns (y [b, T, H, P],
    the final state).

    The reference scans the chunks (``lax.scan``); here what needs no state
    (each chunk's intra-chunk output and its own contribution to the state)
    is computed for every chunk at once, then a Python loop over the chunks
    carries the state, then every chunk's inter-chunk output is added: the
    same products per chunk.  The intra-chunk product is contracted in two
    steps ([b, t, s, H] scores scaled by dt, then over s), never
    materialising the [b, t, s, H, P] tensor of a three-operand einsum.
    T must be at most the chunk or a multiple of it: the reference reshapes
    T into T // chunk chunks and has no tail."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"ssd_chunked: T = {T} is longer than the chunk {c} and not a multiple "
                         f"of it (the reference reshapes T into whole chunks and has no tail)")
    n = T // c
    a = -torch.exp(A_log)[None, None] * dt                     # log a_t [b, T, H]
    xx = x.reshape(b, n, c, H, P)
    dtt = dt.reshape(b, n, c, H)
    BB = B.reshape(b, n, c, N)
    CC = C.reshape(b, n, c, N)
    la = torch.cumsum(a.reshape(b, n, c, H), dim=2)            # inclusive, per chunk
    # intra-chunk: y_t = sum_{s<=t} exp(la_t - la_s) (C_t . B_s) dt_s x_s
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    dec = _decay(la[:, :, :, None] - la[:, :, None, :]) * mask[None, None, :, :, None]
    scores = torch.einsum("bktn,bksn->bkts", CC, BB)[..., None] * dec       # [b,n,t,s,H]
    y = torch.einsum("bktsh,bkshp->bkthp", scores * dtt[:, :, None], xx)
    del dec, scores
    # each chunk's own state term: sum_s exp(la_end - la_s) dt_s B_s x_s^T
    la_end = la[:, :, -1]                                        # [b, n, H]
    sdec = _decay(la_end[:, :, None] - la) * dtt                 # [b, n, c, H]
    local = torch.einsum("bksn,bkshp->bkhnp", BB, sdec[..., None] * xx)
    # the carried state, chunk after chunk; starts[k] is chunk k's
    starts = []
    end_dec = _decay(la_end)[..., None, None]                    # [b, n, H, 1, 1]
    for k in range(n):
        starts.append(state)
        state = end_dec[:, k] * state + local[:, k]
    # inter-chunk: y_t += exp(la_t) C_t . S
    y = y + torch.einsum("bktn,bkhnp->bkthp", CC, torch.stack(starts, 1)) * _decay(la)[..., None]
    return y.reshape(b, T, H, P), state


def ssd_step(x, dt, A_log, B, C, state):
    """Single-token SSD step.  x: [b, 1, H, P]; returns (y [b, 1, H, P],
    state')."""
    xx, dtt, BB, CC = x[:, 0], dt[:, 0], B[:, 0], C[:, 0]
    a = torch.exp(-torch.exp(A_log)[None] * dtt)                 # [b, H]
    upd = torch.einsum("bh,bn,bhp->bhnp", dtt, BB, xx)
    state = a[..., None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", CC, state)
    return y[:, None], state


def _causal_conv(x, kernel, conv_state=None):
    """Depthwise causal conv1d.  x: [b, T, C]; kernel: [W, C].  The taps
    are summed in the reference's order, each product and sum at x's dtype.
    Returns (out [b, T, C], the last W - 1 inputs [b, W - 1, C])."""
    W = kernel.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = xp[:, 0:T] * kernel[0][None, None]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * kernel[i][None, None]
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return out, new_state


def _gated_norm(ctx: ParallelContext, y, weight, width: int, eps: float = 1e-6):
    """The reference's ``rms_norm(y, weight)`` over the whole d_inner of
    ``width`` where y [..., width / tp] is this rank's heads: the sum of
    squares summed over tp (its gradient too: each rank's heads use it),
    divided by ``width``.  At tp = 1 both collectives are the identity."""
    yf = y.float()
    ss = copy_to_tp(ctx, all_reduce(ctx, torch.sum(yf * yf, dim=-1, keepdim=True)))
    return (yf * torch.rsqrt(ss / width + eps) * weight.float()).to(y.dtype)


def mamba2_apply(ctx: ParallelContext, p, cfg: Mamba2Config, x, *, state=None,
                 conv_state=None):
    """x: [B, T, D], the same on every rank.  Without ``state`` the chunked
    scan from a zero state (prefill and training); with it (decode, T = 1)
    one step from ``state`` and ``conv_state``.  Returns (out [B, T, D], the
    same on every rank, (ssm state [B, H / tp, N, P] f32, conv state [B,
    W - 1, Di / tp + 2N])): this rank's heads' states, B and C's conv
    channels whole."""
    b, T, D = x.shape
    n = ctx.tp
    Di, N, H, P = cfg.d_inner // n, cfg.d_state, cfg.n_heads // n, cfg.head_dim
    w_in, conv = p["w_in"], p["conv"]
    if n == 1:
        z, xin, Bc, Cc, dt = torch.split(x @ w_in, [Di, Di, N, N, H], dim=-1)
    else:
        # B and C are the same on every rank and every rank's heads use them;
        # w_in's columns are read as views, its shard never copied
        z, xin = torch.split(x @ w_in[:, :2 * Di], [Di, Di], dim=-1)
        Bc, Cc = torch.split(x @ copy_to_tp(ctx, w_in[:, 2 * Di:2 * Di + 2 * N]), [N, N], dim=-1)
        dt = x @ w_in[:, 2 * Di + 2 * N:]
        conv = torch.cat([conv[:, :Di], copy_to_tp(ctx, conv[:, Di:])], dim=1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, conv, conv_state)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [Di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    xh = xin.reshape(b, T, H, P).float()
    if state is None:
        state0 = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
        y, new_state = ssd_chunked(xh, dt, p["A_log"], Bc.float(), Cc.float(), state0, cfg.chunk)
    else:
        y, new_state = ssd_step(xh, dt, p["A_log"], Bc.float(), Cc.float(), state)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(b, T, Di).to(x.dtype)
    y = _gated_norm(ctx, y, p["norm"], cfg.d_inner) * F.silu(z)
    # row-parallel out projection: the fused GEMV/GEMM + AllReduce (the
    # paper's operator); the kernel takes contiguous operands
    out = matmul_allreduce(ctx, y.contiguous(), p["w_out"])
    return out, (new_state, new_conv)
