"""Mixture-of-Experts layer: capacity-based top-k routing and the expert FFN
fused with the combine All-to-All (paper Sec. III, GEMM + All-to-All).

Port of the JAX package's ``repro.models.moe`` for one card (n_ep = tp = 1).
Routing keeps the reference's exact semantics: f32 router logits, softmax,
top-k, renormalisation, ``router_scale``; capacity slots from a cumulative
count over the token-major [T*K] assignments; tokens past an expert's
capacity fall back to the residual stream.  The capacity C comes from
static shapes, so routing never synchronises with the host.

  bulk   : dispatch buffer -> bulk All-to-All -> the expert FFN as three
           einsums -> bulk All-to-All (the library baseline)
  kernel : the hand-written dispatch-A2A kernel chained into the hand-written
           expert-FFN + combine-A2A kernel
           (``repro_torch.kernels.fused_gemm_a2a.ops.fused_moe_chain``)

On one card the All-to-Alls move each rank's own block only.  What needs a
multi-card world or training raises and names its ROADMAP item.

The dispatch and the combine each consult the degradation policy
(``core/degrade.py``) under the reference's keys (``moe_dispatch_a2a``,
``moe_combine_a2a``); a quarantined side runs its bulk form.  Kernel mode
resolves the dispatch's granularity and both wires through
``tune_all_to_all`` (``core/autotune.py``) under the kernel's own op.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.autotune import resolve_overlap, tune_all_to_all
from repro_torch.core.collectives import bulk_all_to_all
from repro_torch.core.degrade import degrade_mode
from repro_torch.kernels import clamp_kernel_wire
from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
from repro_torch.kernels.fused_gemm_a2a.ops import fused_gemm_a2a, fused_moe_chain
from repro_torch.kernels.fused_gemm_a2a.ref import ACTS
from repro_torch.models.common import dense_init
from repro_torch.parallel.sharding import ParallelContext

_MOE_ITEM = "ROADMAP Queue 1 item 5 (MoE)"
_FUSED_ITEM = ("ROADMAP Queue 1 item 1 (left: fused mode of the MoE All-to-Alls) and "
               "item 5 (the experts over several ranks)")


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
    the expert count for the [E, D, F] / [E, F, D] expert weights."""
    if cfg.n_shared_experts:
        raise NotImplementedError(f"shared experts: {_MOE_ITEM}")
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (D, E), torch.float32),
        "w_gate": dense_init(gen, (E, D, Fd), dtype),
        "w_up": dense_init(gen, (E, D, Fd), dtype),
        "w_down": dense_init(gen, (E, Fd, D), dtype),
    }


def moe_apply(ctx: ParallelContext, params, x, cfg: MoEConfig, *, mode: str | None = None):
    """x: [B, S, D] -> [B, S, D] at x's dtype.

    ``mode`` defaults to ``ctx.fusion.resolve("moe_a2a")``.  In kernel mode
    ``ctx.fusion``'s schedule, skew, granularity (as ``chunks_per_rank``)
    and wire go to the kernels; a CUDA tensor launches them or raises.
    With one EP rank the tokens count as sequence-sharded even at S = 1,
    as in the reference, so the decode-EP layout of a multi-card world
    (:func:`_moe_decode_ep`) never applies."""
    mode = mode or ctx.fusion.resolve("moe_a2a")
    if "shared" in params or cfg.n_shared_experts:
        raise NotImplementedError(f"shared experts: {_MOE_ITEM}")
    if mode not in ("bulk", "kernel"):
        raise NotImplementedError(f"moe_apply mode={mode!r}: {_FUSED_ITEM}")
    return _moe_local(ctx, cfg, x, params, mode)


def _moe_decode_ep(*_args, **_kwargs):
    """Weight-stationary decode EP over a multi-card (data x model) world."""
    raise NotImplementedError(f"decode EP on a multi-card world: {_MOE_ITEM}")


def _moe_kernel_staged(*_args, **_kwargs):
    """The reference stages the kernel chain for its CPU interpreter on
    multi-axis meshes; the CUDA kernels need no such staging."""
    raise NotImplementedError(f"the staged kernel path of a multi-axis mesh: {_MOE_ITEM}")


def moe_aux_loss(*_args, **_kwargs):
    """Switch-style load-balance loss of MoE training."""
    raise NotImplementedError(f"MoE training: {_MOE_ITEM}")


def _route(cfg: MoEConfig, toks, w_r):
    """Capacity-based top-k routing in f32.

    Returns (gate_w [T, K], e_clip [T*K], p_clip [T*K], valid [T*K], C)."""
    probs = torch.softmax(toks.float() @ w_r.float(), dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1)       # [T, K]
    if cfg.norm_topk_prob:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_w = gate_w * cfg.router_scale
    return (gate_w, *_capacity_slots(cfg, gate_i))


def _capacity_slots(cfg: MoEConfig, gate_i):
    """Capacity slots of the experts gate_i [T, K] chose: the token-major
    [T*K] assignments counted per expert; past C they are dropped.

    Returns (e_clip [T*K], p_clip [T*K], valid [T*K], C)."""
    E, K = cfg.n_experts, cfg.top_k
    T = gate_i.shape[0]
    # capacity floor 1 (a floor of 4 pads decode's few tokens/rank 4x)
    C = int(max(1, -(-T * K * cfg.capacity_factor // E)))
    flat_e = gate_i.reshape(-1)                                  # [T*K]
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    pos = pos.gather(1, flat_e[:, None])[:, 0]
    valid = pos < C
    e_clip = torch.where(valid, flat_e, 0)
    p_clip = torch.where(valid, pos, 0)
    return e_clip, p_clip, valid, C


def _dispatch_buf(cfg: MoEConfig, toks, e_clip, p_clip, valid, C, dtype):
    """Scatter routed tokens into the [E, C, D] capacity-slot buffer.  An
    invalid assignment adds a zero row at slot (0, 0), as the reference's
    ``.at[].add(mode="drop")`` does."""
    src = torch.where(valid[:, None], toks.repeat_interleave(cfg.top_k, dim=0), 0)
    buf = torch.zeros((cfg.n_experts, C, cfg.d_model), dtype=dtype, device=toks.device)
    return buf.index_put_((e_clip, p_clip), src.to(dtype), accumulate=True)


def _unpermute(cfg: MoEConfig, out_buf, gate_w, e_clip, p_clip, valid, shape, dtype):
    """Gather expert outputs back to token rows, gate-weighted in f32."""
    picked = out_buf[e_clip, p_clip]                             # [T*K, D]
    picked = torch.where(valid[:, None], picked, 0).reshape(-1, cfg.top_k, cfg.d_model)
    y = (picked.float() * gate_w[..., None]).sum(dim=1)
    return y.reshape(shape).to(dtype)


def _resolve(ctx: ParallelContext, granularity, wire, *, cap, chunk_elems, flops_per_dest,
             dtype_bytes):
    """The kernel path's ``(chunks_per_rank, wire)``: the reference's
    ``moe_all_to_all._resolve`` with ``kernel=True`` (sub-chunks along the
    capacity axis, fp8 clamped to bf16 in the decision, and a pinned fp8
    clamped after it)."""
    dec = resolve_overlap(
        None, granularity, None, wire,
        lambda fq, wr: tune_all_to_all(chunk_elems, flops_per_dest, dtype_bytes=dtype_bytes,
                                       n_dev=ctx.tp, sub_dim=cap, hw=ctx.hw,
                                       skew=ctx.fusion.skew, wire=wr, fixed_q=fq, kernel=True),
        dim=cap, ring=1)
    if dec.wire == "fp8":
        dec = dec._replace(wire=clamp_kernel_wire(dec.wire, "moe_a2a_kernel"))
    return dec


def _moe_local(ctx: ParallelContext, cfg: MoEConfig, x, params, mode):
    """Per-rank MoE body: route -> dispatch A2A -> expert FFN + combine A2A
    -> unpermute."""
    D, E = cfg.d_model, cfg.n_experts
    n_ep = ctx.tp
    toks = x.reshape(-1, D)
    gate_w, e_clip, p_clip, valid, C = _route(cfg, toks, params["router"])
    buf = _dispatch_buf(cfg, toks, e_clip, p_clip, valid, C, x.dtype)
    buf = buf.reshape(n_ep, E // n_ep, C, D)
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    fc = ctx.fusion
    # the reference's keys: the dispatch buffer in its global [rows, n_ep,
    # E, C, D] layout, and that with the expert width for the combine
    key = (1, n_ep, E, C, D)
    mode_d = degrade_mode("moe_dispatch_a2a", key, mode)
    mode_c = degrade_mode("moe_combine_a2a", key + (wu.shape[-1],), mode)
    flops_c = 2.0 * 3 * (E // n_ep) * C * D * wu.shape[-1]
    dec_d = dec_c = None
    if mode_d == "kernel":
        dec_d = _resolve(ctx, fc.granularity, fc.wire, cap=C, chunk_elems=buf[0].numel(),
                         flops_per_dest=0.0, dtype_bytes=x.element_size())
    if mode_c == "kernel":
        dec_c = _resolve(ctx, 1, fc.wire, cap=C, chunk_elems=buf[0].numel(),
                         flops_per_dest=flops_c, dtype_bytes=x.element_size())
    comm_aware = fc.schedule == "comm_aware"
    if mode_d == mode_c == "kernel":
        comb = fused_moe_chain(buf[:, None], wu, wg, wd, act=cfg.act, comm_aware=comm_aware,
                               chunks_per_rank=dec_d.q, skew=fc.skew, wire=dec_d.wire,
                               combine_wire=dec_c.wire)[:, 0]
    else:
        if mode_d == "kernel":
            recv = fused_dispatch_a2a(buf[:, None], comm_aware=comm_aware,
                                      chunks_per_rank=dec_d.q, skew=fc.skew,
                                      wire=dec_d.wire)[:, 0]
        else:
            recv = bulk_all_to_all(ctx, buf)                     # [n_src, E_loc, C, D]
        if mode_c == "kernel":
            comb = fused_gemm_a2a(recv[:, None], wu, wg, wd, act=cfg.act, comm_aware=comm_aware,
                                  skew=fc.skew, wire=dec_c.wire)[:, 0]
        else:
            g = torch.einsum("necd,edf->necf", recv, wg)         # all GEMMs first...
            u = torch.einsum("necd,edf->necf", recv, wu)
            y = torch.einsum("necf,efd->necd", ACTS[cfg.act](g) * u, wd)
            comb = bulk_all_to_all(ctx, y)                       # ...then one A2A
    return _unpermute(cfg, comb.reshape(E, C, D), gate_w, e_clip, p_clip, valid,
                      x.shape, x.dtype)
