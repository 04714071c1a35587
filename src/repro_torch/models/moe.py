"""Mixture-of-Experts layer: capacity-based top-k routing and the expert FFN
fused with the combine All-to-All (paper Sec. III, GEMM + All-to-All).

Port of the JAX package's ``repro.models.moe``.  Routing keeps the
reference's exact semantics: f32 router logits, softmax, top-k,
renormalisation, ``router_scale``; capacity slots from a cumulative count
over the token-major [T*K] assignments; tokens past an expert's capacity
fall back to the residual stream.  The capacity C comes from static shapes,
so routing never synchronises with the host.

Experts are sharded over the tp ranks (expert parallelism, ``n_ep = tp``).
:func:`moe_apply` takes the reference's layout by the global sequence
length S:

  sequence-sharded (S a multiple of tp: prefill and training, which hand it
  the rank's S / tp positions, and every call at tp = 1): :func:`_moe_local`
  routes the rank's tokens, exchanges the dispatch buffer over the tp ranks
  of its data row, runs its experts and sends their outputs back, through
  the two entries of ``core/moe_all_to_all.py``:
    bulk   : bulk All-to-All -> the expert FFN as three einsums -> bulk
             All-to-All (the library baseline)
    fused  : per-destination direct sends (``direct_all_to_all_compute``),
             the combine's FFN computed one destination at a time and each
             block sent the moment it is done
    kernel : the hand-written dispatch-A2A kernel, then the hand-written
             expert-FFN + combine-A2A kernel on its output; one rank only:
             over several they need real peers and raise
  decode EP (S = 1 at tp > 1: rows replicated over the tp ranks):
  :func:`_moe_decode_ep`, weight-stationary over the whole (data, model)
  world, in every mode (the reference's runs no kernel either).

A deepseek-style shared expert (``n_shared_experts``: ``params["shared"]``,
a SwiGLU of ``d_ff * n_shared_experts`` whole on every rank) adds its
output in every path, as the reference's does: in :func:`_moe_local` on
the rank's own rows after the unpermute, in decode EP on the replicated
rows after the world sum.  It is a plain product, outside any kernel, as
in the reference.

The dispatch and the combine each consult the degradation policy
(``core/degrade.py``) under the reference's keys (``moe_dispatch_a2a``,
``moe_combine_a2a``); a quarantined side runs its bulk form.  Kernel mode
resolves the dispatch's granularity and both wires through
``tune_all_to_all`` (``core/autotune.py``) under the kernel's own op.
Every path is differentiable (the kernels' VJPs, the exchanges' own).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_gather_data, all_reduce
from repro_torch.core.moe_all_to_all import fused_expert_ffn_combine, moe_dispatch_all_to_all
from repro_torch.kernels.fused_gemm_a2a.ref import ACTS, expert_ffn_ref
from repro_torch.models.common import dense_init
from repro_torch.parallel.sharding import ParallelContext

# the reference's logical specs of the MoE leaves (src/repro/models/moe.py:47-52)
MOE_PARAM_SPECS = {"router": (None, None), "w_gate": ("tp", "fsdp", None),
                   "w_up": ("tp", "fsdp", None), "w_down": ("tp", None, "fsdp")}
# and of the shared expert's (:56-58): whole over tp, unlike the dense MLP's
SHARED_PARAM_SPECS = {"w_gate": ("fsdp", None), "w_up": ("fsdp", None),
                      "w_down": (None, "fsdp")}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                     # per-expert hidden dim
    n_shared_experts: int = 0     # deepseek-style shared expert(s)
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    router_scale: float = 1.0     # deepseek-v3 routed_scaling_factor
    act: str = "silu"


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype):
    """Router (f32) and expert weights on ``gen``'s device, drawn as the
    reference draws them: ``dense_init`` takes fan_in = shape[0], which is
    the expert count for the [E, D, F] / [E, F, D] expert weights.  With
    ``n_shared_experts`` the shared expert's ``{"w_gate", "w_up",
    "w_down"}`` ([D, Fs], [D, Fs], [Fs, D], Fs = d_ff * n_shared_experts)
    follow under ``"shared"``."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    params = {
        "router": dense_init(gen, (D, E), torch.float32),
        "w_gate": dense_init(gen, (E, D, Fd), dtype),
        "w_up": dense_init(gen, (E, D, Fd), dtype),
        "w_down": dense_init(gen, (E, Fd, D), dtype),
    }
    if cfg.n_shared_experts:
        Fs = Fd * cfg.n_shared_experts
        params["shared"] = {"w_gate": dense_init(gen, (D, Fs), dtype),
                            "w_up": dense_init(gen, (D, Fs), dtype),
                            "w_down": dense_init(gen, (Fs, D), dtype)}
    return params


def _plus_shared(params, x, out, act: str):
    """``out`` plus the shared expert's SwiGLU on x, at x's dtype; ``out``
    itself without a shared expert."""
    shared = params.get("shared")
    if shared is None:
        return out
    h = ACTS[act](x @ shared["w_gate"]) * (x @ shared["w_up"])
    return out + (h @ shared["w_down"]).to(x.dtype)


def moe_apply(ctx: ParallelContext, params, x, cfg: MoEConfig, *, mode: str | None = None,
              seq_sharded: bool = True, rows_split: bool = False):
    """x: [B, S, D] -> [B, S, D] at x's dtype, this rank's rows.

    ``seq_sharded``: x is this rank's S / tp positions of the sequence
    (prefill, training: the global S is a multiple of tp); else x is
    replicated over the tp ranks (decode's S = 1, and paged serving, which
    runs MoE at tp = 1 only).  ``rows_split``: the data replicas split the
    batch's rows (decode EP gathers them).  ``params`` hold this rank's
    ``E / tp`` experts (``MOE_PARAM_SPECS``, fsdp dims whole).

    ``mode`` defaults to ``ctx.fusion.resolve("moe_a2a")``.  In kernel mode
    ``ctx.fusion``'s schedule, skew, granularity (as ``chunks_per_rank``)
    and wire go to the kernels; a CUDA tensor launches them or raises.  At
    tp = 1 every S counts as sequence-sharded, as in the reference, so
    decode EP applies at tp > 1 only."""
    mode = mode or ctx.fusion.resolve("moe_a2a")
    if mode not in ("bulk", "fused", "kernel"):
        raise ValueError(f"moe_apply: unknown mode {mode!r}")
    if seq_sharded or ctx.tp == 1:
        return _moe_local(ctx, cfg, x, params, mode)
    if cfg.n_experts % (ctx.dp * ctx.tp) == 0:
        return _moe_decode_ep(ctx, params, x, cfg, rows_split)
    # the reference's shard_map over replicated rows: every rank routes all
    # of them and the exchanges run as in the sequence-sharded layer
    return _moe_local(ctx, cfg, x, params, mode)


def _moe_decode_ep(ctx: ParallelContext, params, x, cfg: MoEConfig, rows_split: bool = False):
    """Weight-stationary decode MoE: experts over the whole (data, model)
    world.

    Where the replicas split the rows, the tokens are all-gathered over data
    (a few rows of D); every rank routes all of them (the router is whole),
    runs its ``E / (dp tp)`` experts on the tokens routed there, and one
    sum over the world (the tp ranks, then the data ranks) combines the
    contributions; a replica keeps its rows.  No expert weight moves.

    The ranks number their experts model-major: rank (d, m) runs experts
    ``[(m dp + d) E_w, (m dp + d + 1) E_w)``, E_w = E / (dp tp), slice d
    of the tp shard m that serving holds.  The reference numbers them
    data-major (``d tp + m``, src/repro/models/moe.py:169-172), which at dp
    > 1 would need experts outside that shard; the sum is the same up to the
    order of its f32 additions (ROADMAP Queue 3)."""
    D, K = cfg.d_model, cfg.top_k
    e_w = cfg.n_experts // (ctx.dp * ctx.tp)
    toks = x.reshape(-1, D)
    if rows_split:
        toks = all_gather_data(ctx, toks)
    T = toks.shape[0]
    gate_w, gate_i = _gates(cfg, toks, params["router"])
    flat_e, pos, C = _capacity_positions(cfg, gate_i)
    e_rel = flat_e - (ctx.tp_rank * ctx.dp + ctx.dp_rank) * e_w
    mine = (e_rel >= 0) & (e_rel < e_w) & (pos < C)
    e_clip = torch.where(mine, e_rel, 0)
    p_clip = torch.where(mine, pos, 0)
    src = torch.where(mine[:, None], toks.repeat_interleave(K, dim=0), 0).to(x.dtype)
    buf = torch.zeros((e_w, C, D), dtype=x.dtype, device=x.device).index_put(
        (e_clip, p_clip), src, accumulate=True)
    lo = ctx.dp_rank * e_w                      # slice d of this rank's tp shard
    wg, wu, wd = (params[k][lo:lo + e_w] for k in ("w_gate", "w_up", "w_down"))
    out_buf = expert_ffn_ref(buf, wu, wg, wd, cfg.act)
    contrib = out_buf[e_clip, p_clip]                               # [T*K, D]
    w = torch.where(mine, gate_w.reshape(-1), 0.0)
    rows = torch.arange(T, device=x.device).repeat_interleave(K)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device).index_add(
        0, rows, contrib.float() * w[:, None])
    y = all_reduce(ctx, y)
    if ctx.dp > 1:
        y = all_reduce(ctx.data, y)
    if rows_split:
        t_loc = T // ctx.dp
        y = y[ctx.dp_rank * t_loc:(ctx.dp_rank + 1) * t_loc]
    return _plus_shared(params, x, y.reshape(x.shape).to(x.dtype), cfg.act)


def _moe_kernel_staged(*_args, **_kwargs):
    """The reference stages the kernel chain for its CPU interpreter on
    multi-axis meshes (routing, a global kernel entry over a flattened
    mesh, then the unpermute); the CUDA kernels run inside the layer on
    each rank and need no such staging."""
    raise NotImplementedError(
        "the staged kernel path is the reference's CPU-interpreter artefact; the port runs "
        "the MoE kernels inside the layer (moe_apply; ROADMAP Queue 1 item 5)")


def moe_aux_loss(router_probs, gate_i, n_experts: int):
    """Switch-style load-balance loss: ``n_experts`` times the sum over the
    experts of the mean router probability and the share of tokens whose
    first choice the expert is.  router_probs [T, E], gate_i [T, K]."""
    me = router_probs.mean(dim=0)
    ce = F.one_hot(gate_i[:, 0].long(), n_experts).to(router_probs.dtype).mean(dim=0)
    return n_experts * torch.sum(me * ce)


def _gates(cfg: MoEConfig, toks, w_r):
    """Top-k of the f32 router's softmax: (gate_w [T, K], gate_i [T, K])."""
    probs = torch.softmax(toks.float() @ w_r.float(), dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_w * cfg.router_scale, gate_i


def _capacity_positions(cfg: MoEConfig, gate_i):
    """The token-major [T*K] assignments of gate_i [T, K], each one's place
    in its expert's queue, and the capacity: (flat_e, pos, C)."""
    E, T = cfg.n_experts, gate_i.shape[0]
    # capacity floor 1 (a floor of 4 pads decode's few tokens/rank 4x)
    C = int(max(1, -(-T * cfg.top_k * cfg.capacity_factor // E)))
    flat_e = gate_i.reshape(-1)
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    return flat_e, pos.gather(1, flat_e[:, None])[:, 0], C


def _route(cfg: MoEConfig, toks, w_r):
    """Capacity-based top-k routing in f32.

    Returns (gate_w [T, K], e_clip [T*K], p_clip [T*K], valid [T*K], C)."""
    gate_w, gate_i = _gates(cfg, toks, w_r)
    return (gate_w, *_capacity_slots(cfg, gate_i))


def _capacity_slots(cfg: MoEConfig, gate_i):
    """Capacity slots of the experts gate_i [T, K] chose; past C they are
    dropped.  Returns (e_clip [T*K], p_clip [T*K], valid [T*K], C)."""
    flat_e, pos, C = _capacity_positions(cfg, gate_i)
    valid = pos < C
    return torch.where(valid, flat_e, 0), torch.where(valid, pos, 0), valid, C


def _dispatch_buf(cfg: MoEConfig, toks, e_clip, p_clip, valid, C, dtype):
    """Scatter routed tokens into the [E, C, D] capacity-slot buffer.  An
    invalid assignment adds a zero row at slot (0, 0), as the reference's
    ``.at[].add(mode="drop")`` does."""
    src = torch.where(valid[:, None], toks.repeat_interleave(cfg.top_k, dim=0), 0)
    buf = torch.zeros((cfg.n_experts, C, cfg.d_model), dtype=dtype, device=toks.device)
    return buf.index_put((e_clip, p_clip), src.to(dtype), accumulate=True)


def _unpermute(cfg: MoEConfig, out_buf, gate_w, e_clip, p_clip, valid, shape, dtype):
    """Gather expert outputs back to token rows, gate-weighted in f32."""
    picked = out_buf[e_clip, p_clip]                             # [T*K, D]
    picked = torch.where(valid[:, None], picked, 0).reshape(-1, cfg.top_k, cfg.d_model)
    y = (picked.float() * gate_w[..., None]).sum(dim=1)
    return y.reshape(shape).to(dtype)


def _moe_local(ctx: ParallelContext, cfg: MoEConfig, x, params, mode):
    """Per-rank MoE body: route -> dispatch A2A -> expert FFN + combine A2A
    -> unpermute, the exchanges over the tp ranks of this data row."""
    D, E = cfg.d_model, cfg.n_experts
    toks = x.reshape(-1, D)
    gate_w, e_clip, p_clip, valid, C = _route(cfg, toks, params["router"])
    buf = _dispatch_buf(cfg, toks, e_clip, p_clip, valid, C, x.dtype)
    buf = buf.reshape(1, ctx.tp, E // ctx.tp, C, D)
    # fused mode keeps the reference layer's exchanges (one block a
    # destination, f32 wire); kernel mode resolves both as the kernels' own
    fixed = {} if mode == "kernel" else dict(chunks_per_rank=1, wire="f32")
    recv = moe_dispatch_all_to_all(ctx, buf, mode=mode, **fixed)
    comb = fused_expert_ffn_combine(ctx, recv, params["w_up"], params["w_gate"],
                                    params["w_down"], act=cfg.act, mode=mode, **fixed)
    out = _unpermute(cfg, comb.reshape(E, C, D), gate_w, e_clip, p_clip, valid,
                     x.shape, x.dtype)
    return _plus_shared(params, x, out, cfg.act)
