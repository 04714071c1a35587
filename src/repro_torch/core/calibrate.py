"""Measured-sweep calibration pass (serve/train warm-up).

The port of the JAX package's ``core/calibrate.py``.  The autotuner's
alpha-beta model picks ``(chunks_per_rank, wire)`` per
:class:`~repro_torch.core.autotune.TuneKey` when a call site first sees a
shape; this pass rebuilds each hot key's workload from the key itself as an
op-level microbenchmark, times every feasible candidate with
:func:`~repro_torch.core.autotune.measured_best`, and overwrites the model's
decision with the measured winner, so steady state runs on measured
choices (persisted with ``--tune-cache``).

The reference collects its hot keys by tracing a step without running it
(``jax.eval_shape``).  Eager PyTorch has no such trace, so
:func:`warmup_and_calibrate` runs one real step: the caller hands it a
scratch state (a fresh KV cache), so the serving cache and the requests are
untouched.

In a world every rank runs the same sweep in the same order: the times are
all-reduced with MAX before the argmin, and an excluded candidate is
excluded on every rank, so every rank ends with the same decisions.  Every
excluded candidate's error, and every fall back to the model's decision,
is printed and kept in the report.

The reconstruction is a proxy: operand values are random and the model
around the op is absent, but shape, dtype, sharding, ring world and
schedule are exact.  Every op family of the reference's has a builder here,
the CE ring's (``ce_ring``) included; a key without one would stay on its
model decision, as in the reference.
"""
from __future__ import annotations

import logging
import sys
import zlib
from typing import Callable, Iterable, Mapping

import torch

from repro_torch.core import autotune
from repro_torch.core.autotune import TuneKey, calibration_candidates, measured_best
from repro_torch.parallel.sharding import ParallelContext

log = logging.getLogger("repro_torch.calibrate")


def _say(line: str) -> None:
    """One whole line in one write: the ranks of a world share one stdout."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _dtype(key: TuneKey):
    return {2: torch.bfloat16, 4: torch.float32}.get(key.dtype_bytes, torch.float32)


def _randn(ctx: ParallelContext, key: TuneKey, *shapes):
    """Random operands of the key's dtype on the context's device, drawn
    from a seed of the key's op and shape (the same in every process)."""
    g = torch.Generator(device=ctx.device)
    g.manual_seed(zlib.crc32(repr((key.op, key.shape)).encode()))
    return [torch.randn(s, generator=g, device=ctx.device).to(_dtype(key)) for s in shapes]


# ---------------------------------------------------------------------------
# per-op-family microbench builders: (ctx, key) -> build_fn(dec) -> closure
# ---------------------------------------------------------------------------
def _build_matmul_allreduce(ctx: ParallelContext, key: TuneKey):
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    rows, k_local, n_out = key.shape
    x, w = _randn(ctx, key, (rows, k_local), (k_local, n_out))

    def build(dec):
        return lambda: matmul_allreduce(ctx, x, w, mode="fused", chunks_per_rank=dec.q,
                                        wire=dec.wire, skew=key.skew)

    return build


def _build_matmul_reducescatter(ctx: ParallelContext, key: TuneKey):
    from repro_torch.core.allgather_matmul import matmul_reducescatter

    rows, k_local, n_out = key.shape
    s = key.divisor_of or rows
    b = max(rows // s, 1)
    x, w = _randn(ctx, key, (b, s, k_local), (k_local, n_out))

    def build(dec):
        return lambda: matmul_reducescatter(ctx, x, w, mode="fused", chunks_per_rank=dec.q,
                                            wire=dec.wire, skew=key.skew)

    return build


def _build_allgather_matmul(ctx: ParallelContext, key: TuneKey):
    from repro_torch.core.allgather_matmul import allgather_matmul

    b, s_loc, k, n_out_local = key.shape
    x, w = _randn(ctx, key, (b, s_loc, k), (k, n_out_local))

    def build(dec):
        return lambda: allgather_matmul(ctx, x, w, mode="fused", chunks_per_rank=dec.q,
                                        wire=dec.wire, skew=key.skew)

    return build


def _build_all_to_all(ctx: ParallelContext, key: TuneKey):
    """Direct-send A2A of the key's per-destination payload, the shared
    microbench of the MoE and embedding families.  The recorded compute is
    reproduced by a proxy product contracting a synthetic ``k_eq`` dim
    sized so each destination's produce costs about ``flops_per_dest``."""
    from repro_torch.core.collectives import direct_all_to_all_compute

    chunk_elems = int(key.shape[0])
    flops_per_dest = float(key.shape[1])
    sub_dim = key.divisor_of or 1
    rows = max(chunk_elems // max(sub_dim, 1), 1)
    n = key.n_dev
    if n != ctx.tp:
        raise ValueError(f"A2A key world {n} is not this world's tp={ctx.tp}")
    # 2 * sub_dim * k_eq * rows flops per destination ~= flops_per_dest
    k_eq = int(round(flops_per_dest / max(2.0 * sub_dim * rows, 1.0)))
    shapes = [(n, sub_dim, max(k_eq, rows))] + ([(k_eq, rows)] if k_eq > 0 else [])
    x, *w = _randn(ctx, key, *shapes)

    def build(dec):
        q = dec.q
        sub = sub_dim // q

        def produce(f):
            dest, s = divmod(f, q)
            xb = x[dest, s * sub:(s + 1) * sub]
            return xb[:, :k_eq] @ w[0] if w else xb[:, :rows]

        return lambda: direct_all_to_all_compute(ctx, produce, (sub_dim, rows),
                                                 chunks_per_rank=q, sub_axis=0,
                                                 skew=key.skew, wire=dec.wire)

    return build


def _build_ring_attention(ctx: ParallelContext, key: TuneKey):
    """The KV ring of the key's chunk in fused mode: this rank's q, k and v
    chunks of a causal prefill, windowed where the key's ``hops`` fall
    short of the full ring (``window = hops * s_loc``, which bounds the ring
    at those hops), at blocks of ``min(64, s_loc)``."""
    from repro_torch.models.attention import context_attention

    b_loc, s_loc, hq, hkv, hd, hops = key.shape
    window = None if hops >= ctx.tp - 1 else hops * s_loc
    q, k, v = _randn(ctx, key, (b_loc, s_loc, hq, hd), (b_loc, s_loc, hkv, hd),
                     (b_loc, s_loc, hkv, hd))
    blk = min(64, s_loc)

    def build(dec):
        return lambda: context_attention(ctx, q, k, v, causal=True, window=window, mode="fused",
                                         q_block=blk, kv_block=blk, chunks_per_rank=dec.q,
                                         wire=dec.wire, skew=key.skew)

    return build


def _build_ce_ring(ctx: ParallelContext, key: TuneKey):
    """The CE ring of the key's shapes: this rank's sequence chunk x [b,
    s_loc, D], its vocabulary rows [v_loc, D] and the whole labels [b, S],
    the loss alone (the forward's stats ring and all-reduces)."""
    from repro_torch.core.loss import sharded_cross_entropy

    b_loc, s_loc, d_model, v_loc = key.shape
    n = ctx.tp
    x, e = _randn(ctx, key, (b_loc, s_loc, d_model), (v_loc, d_model))
    g = torch.Generator(device=ctx.device)
    g.manual_seed(zlib.crc32(repr((key.op, key.shape, "labels")).encode()))
    y = torch.randint(0, v_loc * n, (b_loc, s_loc * n), generator=g, device=ctx.device)

    def build(dec):
        return lambda: sharded_cross_entropy(ctx, x, e, y, chunks_per_rank=dec.q,
                                             wire=dec.wire, skew=key.skew)

    return build


_BUILDERS: Mapping[str, Callable] = {
    "matmul_allreduce": _build_matmul_allreduce,
    "matmul_reducescatter": _build_matmul_reducescatter,
    "allgather_matmul": _build_allgather_matmul,
    "all_to_all": _build_all_to_all,
    "ring_attention": _build_ring_attention,
    "ce_ring": _build_ce_ring,
}


def add_calibration_cli_args(ap) -> None:
    """The shared ``--calibrate`` warm-up flags (one definition for both
    launchers)."""
    ap.add_argument("--calibrate", action="store_true",
                    help="measured-sweep warm-up: run one step on scratch state (which "
                         "records the hot autotune keys), time every feasible "
                         "(chunks_per_rank, wire) per key and overwrite the model's "
                         "decisions with the measured winners before serving or "
                         "training (pair with --granularity auto or --wire auto; "
                         "persists with --tune-cache)")
    ap.add_argument("--calibrate-iters", type=int, default=3,
                    help="timing iterations per calibration candidate")


def warmup_and_calibrate(ctx: ParallelContext, step_fn: Callable, *args,
                         iters: int = 3, max_q: int | None = None,
                         granularity=None, rank_tag: str = "") -> dict:
    """Run ``step_fn(*args)`` once, without gradients, to record the hot
    keys (the caller passes scratch state: it is written), then the
    measured pass over the keys this step added; a preloaded
    ``--tune-cache`` keeps its entries untimed.  ``granularity`` is the
    launcher's setting, used only to say when it is pinned.  Returns the
    pass's report."""
    if granularity is not None and granularity != "auto":
        _say(f"calibrate{rank_tag}: --granularity is pinned; the measured sweep only "
             f"drives 'auto' decisions")
    before = set(autotune.cache_info())
    with torch.no_grad():
        step_fn(*args)
    hot = [k for k in autotune.cache_info() if k not in before]
    rep = measured_calibration_pass(ctx, keys=hot, iters=iters, max_q=max_q,
                                    rank_tag=rank_tag)
    _say(f"calibrate{rank_tag}: {len(rep)}/{len(hot)} newly traced hot keys re-scored by "
         f"measurement")
    return rep


def measured_calibration_pass(
    ctx: ParallelContext,
    *,
    keys: Iterable[TuneKey] | None = None,
    iters: int = 3,
    warmup: int = 1,
    max_q: int | None = None,
    rank_tag: str = "",
) -> dict[TuneKey, dict]:
    """Re-score every hot key's candidates by measurement and overwrite the
    cached decision with the winner.

    ``keys`` defaults to every cached decision.  A key whose op family has
    no builder, whose world is not this one, or whose workload cannot be
    rebuilt (printed) stays on its model decision; so does one whose every
    candidate fails (printed as a fall back).  Returns ``{key: {"model_q",
    "measured_q", "times", "excluded", "fallback"}}`` (Decision-valued;
    times in seconds)."""
    report: dict[TuneKey, dict] = {}
    todo = list(keys) if keys is not None else list(autotune.cache_info())
    for key in todo:
        builder = _BUILDERS.get(key.op)
        model_q = autotune.cache_info().get(key)
        if builder is None or model_q is None:
            continue
        if key.n_dev != ctx.tp:
            log.info("calibrate: skipping %s (world %d is not this one)", key.op, key.n_dev)
            continue
        cands = calibration_candidates(
            key, max_q if max_q is not None else autotune.MAX_CHUNKS_PER_RANK)
        try:
            build_fn = builder(ctx, key)
        except Exception as e:  # noqa: BLE001 - reported; the key keeps its model decision
            if autotune._fatal(e):
                raise
            _say(f"calibrate{rank_tag}: cannot rebuild {key.op} {key.shape} "
                 f"({type(e).__name__}: {e}); keeping the model's decision {tuple(model_q)}")
            continue
        excluded: dict = {}
        with torch.no_grad():
            best, times = measured_best(build_fn, cands, iters=iters, warmup=warmup,
                                        fallback=model_q, ctx=ctx, errors=excluded)
        autotune.set_decision(key, best)
        report[key] = {"model_q": model_q, "measured_q": best, "times": times,
                       "excluded": excluded, "fallback": not times}
        ms = ", ".join(f"({d.q}, {d.wire}) {t * 1e3:.4f}" for d, t in times.items())
        _say(f"calibrate{rank_tag}: {key.op} {key.shape} model {tuple(model_q)} -> measured "
             f"{tuple(best)}; ms a call: {ms or 'none'}")
        for cand, msg in excluded.items():
            _say(f"calibrate{rank_tag}: {key.op} {key.shape} excluded {tuple(cand)}: {msg}")
        if not times:
            _say(f"calibrate{rank_tag}: {key.op} {key.shape} FALLBACK: every candidate "
                 f"failed; keeping the model's decision {tuple(model_q)}")
    return report
