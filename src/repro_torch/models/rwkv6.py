"""RWKV-6 "Finch": attention-free time-mix with data-dependent decay.

The port runs the reference's serving entry points on one card:
``prefill_forward`` over a prompt, whose time-mix evaluates the WKV6
recurrence chunkwise in the hand-written kernel (``kernels/rwkv6``), and
``decode_step`` from the carried state, whose single-token recurrence
(``wkv6_step``) stays plain PyTorch, as the reference leaves it to XLA.
The row-parallel products (time-mix ``w_o``, channel-mix ``w_v``) go
through ``matmul_allreduce``, the paper's fused GEMV/GEMM + AllReduce.
Training (``train_forward``, a WKV6 backward) and the multi-card state
layout wait for ROADMAP Queue 1 item 7.  Layers are a Python loop over a
per-layer list; the reference's dtype promotions are kept: ``mu``, ``w0``,
``u`` and ``ln_x`` are f32, and the recurrence runs in f32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.matmul_allreduce import matmul_allreduce
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models.common import DTYPES, dense_init
from repro_torch.models.layers import embedding_init, embedding_lookup, rms_norm, rms_norm_init
from repro_torch.parallel.sharding import ParallelContext


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_size: int = 64
    lora_r: int = 64            # decay/token-shift LoRA rank
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    chunk: int = 64
    remat: bool = True
    sub_quadratic: bool = True

    @property
    def n_heads(self):
        return self.d_model // self.head_size

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]


def _layer_init(gen, cfg: RWKV6Config):
    D, R, dev, pd = cfg.d_model, cfg.lora_r, gen.device, cfg.pdtype
    f32 = dict(dtype=torch.float32, device=dev)
    tm = {
        # data-dependent token-shift mixing (5 streams: r, k, v, w, g)
        "mu": torch.zeros((5, D), **f32),
        "lora_a": dense_init(gen, (D, 5 * R), pd, scale=0.01),
        "lora_b": dense_init(gen, (5, R, D), pd, scale=0.01),
        "w_r": dense_init(gen, (D, D), pd),
        "w_k": dense_init(gen, (D, D), pd),
        "w_v": dense_init(gen, (D, D), pd),
        "w_g": dense_init(gen, (D, D), pd),
        # data-dependent decay: w = exp(-exp(w0 + lora_w(x)))
        "w0": torch.zeros((D,), **f32),
        "wlora_a": dense_init(gen, (D, R), pd, scale=0.01),
        "wlora_b": dense_init(gen, (R, D), pd, scale=0.01),
        "u": torch.zeros((D,), **f32),   # bonus
        "ln_x": rms_norm_init(D, dev),
        "w_o": dense_init(gen, (D, D), pd),
    }
    cm = {
        "mu": torch.zeros((2, D), **f32),
        "w_k": dense_init(gen, (D, cfg.d_ff), pd),
        "w_v": dense_init(gen, (cfg.d_ff, D), pd),
        "w_r": dense_init(gen, (D, D), pd),
    }
    return {"ln1": rms_norm_init(D, dev), "tm": tm, "ln2": rms_norm_init(D, dev), "cm": cm}


def rwkv6_init(gen: torch.Generator, cfg: RWKV6Config):
    """Random parameters on ``gen``'s device: {"embed": {"table"},
    "final_norm", "layers": [per-layer dict, ...]}, the reference's shapes
    and init scales (``mu``, ``w0`` and ``u`` are zeros, as there)."""
    return {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "final_norm": rms_norm_init(cfg.d_model, gen.device),
        "layers": [_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
    }


def wkv6_step(r, k, v, w, u, state):
    """Single-token recurrence (decode).  r, k, v, w: [B, 1, H, N]; u: [H, N];
    state: [B, H, N, N].  Returns (o [B, 1, H, N], state')."""
    rr, kk, vv, ww = (a[:, 0] for a in (r, k, v, w))
    kv = torch.einsum("bhn,bhm->bhnm", kk, vv)
    o = torch.einsum("bhn,bhnm->bhm", rr, state + u[None, :, :, None] * kv)
    return o[:, None], ww[..., None] * state + kv


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------
def _ddlerp(x, x_prev, mu, lora_a, lora_b):
    """RWKV6 data-dependent token shift for 5 streams at once.

    x, x_prev: [B, T, D]; returns [5, B, T, D] at x's dtype.  The f32 ``mu``
    promotes the mixing to f32, and the LoRA runs in f32, as in the
    reference (whose jnp products promote bf16 weights against f32)."""
    delta = x_prev - x
    base = x + delta * mu[:, None, None]          # [5, B, T, D] in f32
    xx = x + delta * mu[0][None, None]            # probe stream for the lora
    r_ = torch.tanh(xx @ lora_a.float())          # [B, T, 5R]
    R = lora_b.shape[1]
    r5 = r_.reshape(x.shape[0], x.shape[1], 5, R)
    adj = torch.einsum("btfr,frd->fbtd", r5, lora_b.float())
    return (base + delta[None] * adj).to(x.dtype)


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix(ctx, p, cfg: RWKV6Config, x, x_prev=None, state=None):
    """x: [B, T, D].  Without ``state``, the chunked recurrence from a zero
    state (the WKV6 kernel on a card); with it (decode, T = 1), one step.
    Returns (out [B, T, D], wkv state [B, H, N, N] f32)."""
    B, T, D = x.shape
    H, N = cfg.n_heads, cfg.head_size
    xp = _shift(x) if x_prev is None else torch.cat([x_prev, x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(x, xp, p["mu"], p["lora_a"], p["lora_b"])
    r = (xr @ p["w_r"]).reshape(B, T, H, N)
    k = (xk @ p["w_k"]).reshape(B, T, H, N)
    v = (xv @ p["w_v"]).reshape(B, T, H, N)
    g = F.silu(xg @ p["w_g"])
    lw = p["w0"][None, None] + torch.tanh(xw @ p["wlora_a"]) @ p["wlora_b"]
    w = torch.exp(-torch.exp(lw.float())).reshape(B, T, H, N)
    u = p["u"].reshape(H, N)
    if state is None:
        o, new_state = wkv6(r.float(), k.float(), v.float(), w, u, chunk=cfg.chunk)
    else:
        o, new_state = wkv6_step(r.float(), k.float(), v.float(), w, u, state)
    o = o.reshape(B, T, D).to(x.dtype)
    o = rms_norm(o, p["ln_x"]) * g
    # row-parallel output projection: the paper's GEMV/GEMM + AllReduce
    return matmul_allreduce(ctx, o, p["w_o"]), new_state


def channel_mix(ctx, p, x, x_prev=None):
    xp = _shift(x) if x_prev is None else torch.cat([x_prev, x[:, :-1]], dim=1)
    delta = xp - x
    xk = (x + delta * p["mu"][0][None, None]).to(x.dtype)
    xr = (x + delta * p["mu"][1][None, None]).to(x.dtype)
    k = torch.square(F.relu(xk @ p["w_k"]))
    v = matmul_allreduce(ctx, k, p["w_v"])        # fused GEMM + AllReduce
    r = torch.sigmoid(xr @ p["w_r"])
    return r * v


def _lm_logits(params, x):
    """Logits [B, 1, V] in f32, tied to the embedding table."""
    table = params["embed"]["table"]
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype)).float()


def prefill_forward(ctx: ParallelContext, params, cfg: RWKV6Config, batch):
    """Prefill: forward over the prompt ``batch["tokens"]`` [B, S], collecting
    the recurrent state per layer.  Returns (last-position logits [B, 1, V]
    f32, state {"tm_x", "cm_x": [L, B, 1, D], "wkv": [L, B, H, N, N] f32})."""
    x = embedding_lookup(ctx, params["embed"], batch["tokens"], seq_shard=False).to(cfg.cdtype)
    tm_x, cm_x, wkv = [], [], []
    for lp in params["layers"]:
        xin = rms_norm(x, lp["ln1"])
        a, s = time_mix(ctx, lp["tm"], cfg, xin)
        x = x + a
        xin2 = rms_norm(x, lp["ln2"])
        x = x + channel_mix(ctx, lp["cm"], xin2)
        tm_x.append(xin[:, -1:])
        cm_x.append(xin2[:, -1:])
        wkv.append(s)
    x = rms_norm(x[:, -1:], params["final_norm"])
    state = {"tm_x": torch.stack(tm_x), "cm_x": torch.stack(cm_x), "wkv": torch.stack(wkv)}
    return _lm_logits(params, x), state


def init_state(cfg: RWKV6Config, batch_size: int, device):
    """Zeroed decode state: per layer the time-mix and channel-mix inputs
    of the previous token and the wkv state."""
    D, H, N, L = cfg.d_model, cfg.n_heads, cfg.head_size, cfg.n_layers
    return {
        "tm_x": torch.zeros((L, batch_size, 1, D), dtype=cfg.cdtype, device=device),
        "cm_x": torch.zeros((L, batch_size, 1, D), dtype=cfg.cdtype, device=device),
        "wkv": torch.zeros((L, batch_size, H, N, N), dtype=torch.float32, device=device),
    }


init_cache = init_state     # the name the registry's decoders share


def decode_step(ctx: ParallelContext, params, cfg: RWKV6Config, tokens, state, pos):
    """One decode step.  tokens: [B, 1]; ``pos`` is taken for the registry's
    signature and unused, as in the reference (the state carries the
    position).  Returns (logits [B, 1, V] f32, new state); the state passed
    in is left as it was."""
    del pos
    x = embedding_lookup(ctx, params["embed"], tokens, seq_shard=False).to(cfg.cdtype)
    tm_x, cm_x, wkv = [], [], []
    for i, lp in enumerate(params["layers"]):
        xin = rms_norm(x, lp["ln1"])
        a, s = time_mix(ctx, lp["tm"], cfg, xin, x_prev=state["tm_x"][i], state=state["wkv"][i])
        x = x + a
        xin2 = rms_norm(x, lp["ln2"])
        x = x + channel_mix(ctx, lp["cm"], xin2, x_prev=state["cm_x"][i])
        tm_x.append(xin)
        cm_x.append(xin2)
        wkv.append(s)
    x = rms_norm(x, params["final_norm"])
    state = {"tm_x": torch.stack(tm_x), "cm_x": torch.stack(cm_x), "wkv": torch.stack(wkv)}
    return _lm_logits(params, x), state
