"""Shape-keyed overlap-granularity autotuner (paper Fig. 13).

The port of the JAX package's ``core/autotune.py``.  Overlap quality is
governed by slice granularity: finer slices hide more wire time until
per-slice overhead wins, and the sweet spot depends on the workload.  This
module picks ``(chunks_per_rank, wire)`` for every fused ring from the
alpha-beta model (:mod:`repro_torch.core.perfmodel`), with an optional
measured refinement (:func:`measured_best`, driven by
``core/calibrate.py``).

Choices are memoized under a :class:`TuneKey`, so a steady-state loop pays
the model sweep once per distinct shape.  The key holds only what the call
site sees (op, shapes, dtype, world size, the link class, the requests),
never a rank or a device: every rank of a world takes the same decision
from the same key, which a ring needs (a rank that picked another q or wire
than its peers would deadlock or corrupt it).  ``FusionConfig.granularity
= "auto"`` routes every fused op through :func:`resolve_overlap`; an
integer pins the knob.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Mapping, NamedTuple, Sequence

import torch

from repro_torch.core.collectives import (WIRE_SETTINGS, feasible_chunks_per_rank,
                                          wire_itemsize)
from repro_torch.core.degrade import pin
from repro_torch.core.perfmodel import (H100_NVLINK, HardwareModel, MeshHardwareModel,
                                        model_fused, resolve_hw)

MAX_CHUNKS_PER_RANK = 16

# A narrower wire dtype must beat the current pick's modeled time by this
# relative margin to be adopted: compression only pays where wire time is
# exposed, and exactness wins ties.
WIRE_MARGIN = 0.02


class Decision(NamedTuple):
    """One memoized overlap decision: the sub-chunk factor and the wire
    dtype the payload travels at (``"f32"`` = uncompressed)."""

    q: int
    wire: str = "f32"


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """Cache key: op family and every fact that moves the decision (shape,
    dtype, world size, the divisibility constraint, the link class, the
    measured skew bucket, the wire *request* and a pinned granularity).
    The same fields and JSON schema as the JAX package's, so a cache file
    written by either package loads in the other."""

    op: str
    shape: tuple
    dtype_bytes: int
    n_dev: int
    divisor_of: int | None
    divisor_ring: int
    hw: HardwareModel
    skew: int = 0
    wire: str = "f32"
    fixed_q: int | None = None


_GRANULARITY_CACHE: dict[TuneKey, Decision] = {}
# A call site's arguments as a plain tuple -> the cache's decision for
# them.  A cache hit through a TuneKey builds a frozen dataclass and
# hashes its link model on every call (28 times a decode step); this memo
# answers the same decision from the arguments as given, and is emptied
# whenever the cache changes.
_MEMO: dict[tuple, Decision] = {}


def cache_info() -> Mapping[TuneKey, Decision]:
    """Read-only view of the memoized decisions (tests/diagnostics)."""
    return dict(_GRANULARITY_CACHE)


def clear_cache() -> None:
    _GRANULARITY_CACHE.clear()
    _MEMO.clear()


def set_decision(key: TuneKey, dec: "Decision | int") -> None:
    """Overwrite one memoized decision: the measured calibration pass
    replaces model choices with measured winners through this door only."""
    _GRANULARITY_CACHE[key] = _as_decision(dec)
    _MEMO.clear()


def _as_decision(dec) -> Decision:
    if isinstance(dec, Decision):
        return dec
    if isinstance(dec, (tuple, list)):
        return Decision(int(dec[0]), str(dec[1]))
    return Decision(int(dec), "f32")


def wire_candidates(request: str, hw: HardwareModel) -> list[str]:
    """Wire dtypes the model may choose from, widest first.  A concrete
    request pins the choice; ``"auto"`` considers fp8 only where the link
    model declares support."""
    if request == "auto":
        return ["f32", "bf16"] + (["fp8"] if hw.fp8_wire else [])
    if request not in WIRE_SETTINGS:
        raise ValueError(f"unknown wire setting {request!r}; expected one "
                         f"of {WIRE_SETTINGS}")
    return [request]


def calibration_candidates(key: TuneKey,
                           max_q: int = MAX_CHUNKS_PER_RANK) -> list[Decision]:
    """Feasible ``(chunks_per_rank, wire)`` candidates for one cached key:
    the (divisor ladder x wire dtypes) the model sweep scored, for the
    measured sweep to re-score on the card."""
    qs = ([int(key.fixed_q)] if key.fixed_q is not None
          else _divisor_candidates(key.divisor_of, key.divisor_ring, max_q))
    return [Decision(q, w) for w in wire_candidates(key.wire, key.hw)
            for q in qs]


# ---------------------------------------------------------------------------
# cache persistence (warm-up calibration across processes)
# ---------------------------------------------------------------------------
def _key_to_json(key: TuneKey) -> dict:
    d = dataclasses.asdict(key)
    d["hw"] = dataclasses.asdict(key.hw)
    d["shape"] = list(key.shape)
    return d


def _key_from_json(d: Mapping) -> TuneKey:
    d = dict(d)
    # tolerate hw-schema drift both ways: missing fields take the
    # defaults, fields this build does not know are dropped
    known = {f.name for f in dataclasses.fields(HardwareModel)}
    d["hw"] = HardwareModel(**{k: v for k, v in d["hw"].items() if k in known})
    d["shape"] = tuple(d["shape"])
    d.setdefault("skew", 0)        # caches written before the skew field
    d.setdefault("wire", "f32")    # ... before the wire field
    d.setdefault("fixed_q", None)  # ... before the pinned-q field
    return TuneKey(**d)


def save_cache(path: str) -> int:
    """Serialize every memoized decision to ``path`` (JSON, the JAX
    package's schema); returns the entries written.  The write is atomic (a
    temporary file, then ``os.replace``).  In a world only rank 0 writes
    (the launchers' rule); every rank reads."""
    entries = [{"key": _key_to_json(k), "chunks_per_rank": dec.q,
                "wire": dec.wire}
               for k, dec in _GRANULARITY_CACHE.items()]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return len(entries)


def load_cache(path: str, *, merge: bool = True) -> int:
    """Load decisions written by :func:`save_cache` (``merge=False``
    replaces the in-process cache); returns the entries loaded.  Entries
    already in the process win on a key collision."""
    with open(path) as f:
        blob = json.load(f)
    if not merge:
        _GRANULARITY_CACHE.clear()
    _MEMO.clear()
    n = 0
    for e in blob["entries"]:
        key = _key_from_json(e["key"])
        if key not in _GRANULARITY_CACHE:
            # entries written before the wire field travel uncompressed
            _GRANULARITY_CACHE[key] = Decision(int(e["chunks_per_rank"]),
                                               str(e.get("wire", "f32")))
            n += 1
    return n


def _divisor_candidates(divisor_of: int | None, ring: int,
                        max_q: int) -> list[int]:
    """Power-of-two sub-chunk factors q whose fine split divides the
    chunked dimension; ``ring`` is the factor the dimension must absorb
    besides q (the ring's world for reduce-scatter chunking, 1 for
    per-destination payloads)."""
    qs = []
    q = 1
    while q <= max_q:
        if divisor_of is None or divisor_of % (ring * q) == 0:
            qs.append(q)
        q *= 2
    return qs or [1]


def choose_overlap(
    op: str,
    *,
    shape: Sequence[int],
    dtype_bytes: int,
    n_dev: int,
    flops: float,
    hbm_bytes: float,
    wire_bytes: float,
    divisor_of: int | None = None,
    divisor_ring: int | None = None,
    max_q: int = MAX_CHUNKS_PER_RANK,
    hw: HardwareModel | MeshHardwareModel = H100_NVLINK,
    axis=None,
    skew: int = 0,
    wire: str = "f32",
    fixed_q: int | None = None,
    allow_fp8: bool = True,
) -> Decision:
    """Pick ``(chunks_per_rank, wire)`` minimizing the modeled fused time.

    ``divisor_of`` constrains q to factors that split the chunked dimension
    evenly (``None``: unconstrained); ``divisor_ring`` is the ring factor
    it must absorb too (default ``n_dev``; 1 for per-destination
    payloads).  ``hw`` is a flat model or a :class:`MeshHardwareModel`
    resolved for ``axis``.  ``wire`` is the request: a dtype pins it,
    ``"auto"`` sweeps the link's candidates widest first and adopts a
    narrower one only when it wins by :data:`WIRE_MARGIN`.  ``fixed_q``
    pins the granularity (a wire-only sweep).  ``skew`` keys a measured
    decision by its bucket (the model ignores it).  ``allow_fp8=False``
    clamps fp8 candidates to bf16 (the device-initiated kernels have no
    per-chunk-scale path) and the clamp is recorded in the cached
    decision.  Memoized under the full key."""
    memo = (op, tuple(shape), dtype_bytes, n_dev, divisor_of, divisor_ring, hw, axis, skew,
            wire, fixed_q)
    hit = _MEMO.get(memo)
    if hit is None:
        hit = _MEMO[memo] = _choose_keyed(
            op, shape=shape, dtype_bytes=dtype_bytes, n_dev=n_dev, flops=flops,
            hbm_bytes=hbm_bytes, wire_bytes=wire_bytes, divisor_of=divisor_of,
            divisor_ring=divisor_ring, max_q=max_q, hw=hw, axis=axis, skew=skew, wire=wire,
            fixed_q=fixed_q, allow_fp8=allow_fp8)
    return hit


def _choose_keyed(op, *, shape, dtype_bytes, n_dev, flops, hbm_bytes, wire_bytes, divisor_of,
                  divisor_ring, max_q, hw, axis, skew, wire, fixed_q, allow_fp8) -> Decision:
    """:func:`choose_overlap` through its :class:`TuneKey` (the reference's
    body)."""
    hw = resolve_hw(hw, axis)
    ring = n_dev if divisor_ring is None else divisor_ring
    key = TuneKey(op, tuple(int(s) for s in shape), int(dtype_bytes),
                  int(n_dev), None if divisor_of is None else int(divisor_of),
                  int(ring), hw, int(skew), str(wire),
                  None if fixed_q is None else int(fixed_q))
    hit = _GRANULARITY_CACHE.get(key)
    if hit is not None:
        return hit
    qs = ([int(fixed_q)] if fixed_q is not None
          else _divisor_candidates(divisor_of, ring, max_q))
    cands = wire_candidates(wire, hw)
    if not allow_fp8:
        cands = list(dict.fromkeys("bf16" if w == "fp8" else w for w in cands))
    best: Decision | None = None
    best_t = float("inf")
    for w in cands:
        factor = wire_itemsize(w, dtype_bytes) / float(dtype_bytes)
        w_best_q, w_best_t = qs[0], float("inf")
        for q in qs:
            t = model_fused(flops, hbm_bytes, wire_bytes * factor, n_dev * q, hw=hw)
            if t < w_best_t:
                w_best_q, w_best_t = q, t
        if best is None or w_best_t < best_t * (1.0 - WIRE_MARGIN):
            best, best_t = Decision(w_best_q, w), w_best_t
    _GRANULARITY_CACHE[key] = best
    return best


def choose_chunks_per_rank(op: str, **kwargs) -> int:
    """Granularity-only convenience over :func:`choose_overlap`."""
    return choose_overlap(op, **kwargs).q


def tune_matmul_allreduce(rows: int, k_local: int, n_out: int, *,
                          dtype_bytes: int, n_dev: int, chunk_dim: int,
                          divisor_ring: int | None = None,
                          allgather_phase: bool = True,
                          hw: HardwareModel | MeshHardwareModel = H100_NVLINK,
                          axis=None, skew: int = 0, wire: str = "f32",
                          fixed_q: int | None = None,
                          allow_fp8: bool = True) -> Decision:
    """Granularity for the row-parallel GEMM/GEMV + AllReduce family.

    ``chunk_dim`` is the ring-chunked dimension (rows or output columns);
    ``allgather_phase=False`` models a bare reduce-scatter
    (``matmul_reducescatter``: half the wire traffic).  ``allow_fp8=False``
    is kernel mode's clamp (see :func:`choose_overlap`)."""
    flops = 2.0 * rows * k_local * n_out
    hbm = float(k_local * n_out * dtype_bytes)
    # the reduce-scatter carry, plus the final all-gather of the AllReduce
    wire_b = float(rows * n_out * dtype_bytes) * (2.0 if allgather_phase else 1.0)
    return choose_overlap(
        "matmul_allreduce" if allgather_phase else "matmul_reducescatter",
        shape=(rows, k_local, n_out),
        dtype_bytes=dtype_bytes, n_dev=n_dev, flops=flops, hbm_bytes=hbm,
        wire_bytes=wire_b, divisor_of=chunk_dim, divisor_ring=divisor_ring,
        hw=hw, axis=axis, skew=skew, wire=wire, fixed_q=fixed_q,
        allow_fp8=allow_fp8)


def tune_allgather_matmul(b: int, s_loc: int, k: int, n_out_local: int, *,
                          dtype_bytes: int, n_dev: int,
                          hw: HardwareModel | MeshHardwareModel = H100_NVLINK,
                          axis=None, skew: int = 0, wire: str = "f32",
                          fixed_q: int | None = None) -> Decision:
    """Granularity for the AllGather x matmul family: the ring forwards the
    input sequence chunk ``[b, s_loc, k]``, so only ``q | s_loc`` counts."""
    flops = 2.0 * b * s_loc * n_dev * k * n_out_local
    hbm = float(k * n_out_local * dtype_bytes)
    wire_b = float(b * s_loc * k * dtype_bytes) * (n_dev - 1)
    return choose_overlap(
        "allgather_matmul", shape=(b, s_loc, k, n_out_local),
        dtype_bytes=dtype_bytes, n_dev=n_dev, flops=flops, hbm_bytes=hbm,
        wire_bytes=wire_b, divisor_of=s_loc, divisor_ring=1, hw=hw,
        axis=axis, skew=skew, wire=wire, fixed_q=fixed_q)


def tune_all_to_all(chunk_elems: int, flops_per_dest: float, *,
                    dtype_bytes: int, n_dev: int, sub_dim: int,
                    hw: HardwareModel | MeshHardwareModel = H100_NVLINK,
                    axis=None, skew: int = 0, wire: str = "f32",
                    fixed_q: int | None = None,
                    kernel: bool = False) -> Decision:
    """Granularity for the direct-send compute + All-to-All family: only
    ``q | sub_dim`` counts.  ``kernel=True`` tunes the device-initiated
    path under its own op (``"all_to_all_kernel"``), fp8 clamped to bf16."""
    wire_b = float(chunk_elems * dtype_bytes) * (n_dev - 1)
    return choose_overlap(
        "all_to_all_kernel" if kernel else "all_to_all",
        shape=(chunk_elems, int(flops_per_dest)),
        dtype_bytes=dtype_bytes, n_dev=n_dev,
        flops=flops_per_dest * n_dev,
        hbm_bytes=float(chunk_elems * dtype_bytes * n_dev),
        wire_bytes=wire_b, divisor_of=sub_dim, divisor_ring=1, hw=hw,
        axis=axis, skew=skew, wire=wire, fixed_q=fixed_q,
        allow_fp8=not kernel)


def tune_ring_attention(b: int, s_loc: int, n_heads: int, n_kv_heads: int,
                        head_dim: int, *, dtype_bytes: int, n_dev: int,
                        hops: int | None = None,
                        hw: HardwareModel | MeshHardwareModel = H100_NVLINK,
                        axis=None, skew: int = 0, wire: str = "f32",
                        fixed_q: int | None = None) -> Decision:
    """Granularity for the ring-attention KV ring: the payload is the local
    K and V chunk, so only ``q | s_loc`` counts; ``hops`` bounds the ring
    for sliding-window layers (default the full ring, ``n_dev - 1``)."""
    hops = n_dev - 1 if hops is None else hops
    ctx_len = s_loc * (hops + 1)
    flops = 4.0 * b * s_loc * ctx_len * n_heads * head_dim
    kv_chunk = float(b * s_loc * n_kv_heads * head_dim * dtype_bytes)
    # hops moves flops and wire, so it is part of the key
    return choose_overlap(
        "ring_attention",
        shape=(b, s_loc, n_heads, n_kv_heads, head_dim, hops),
        dtype_bytes=dtype_bytes, n_dev=n_dev, flops=flops,
        hbm_bytes=2.0 * kv_chunk * (hops + 1),
        wire_bytes=2.0 * kv_chunk * hops,
        divisor_of=s_loc, divisor_ring=1, hw=hw, axis=axis, skew=skew,
        wire=wire, fixed_q=fixed_q)


def tune_ce_ring(b: int, s_loc: int, d_model: int, v_loc: int, *,
                 dtype_bytes: int, n_dev: int,
                 hw: HardwareModel | MeshHardwareModel = H100_NVLINK,
                 axis=None, skew: int = 0, wire: str = "f32",
                 fixed_q: int | None = None) -> Decision:
    """Granularity for the vocab-sharded cross-entropy: the ring forwards
    the ``[b, s_loc, D]`` activation chunk (and the backward its dx), so
    only ``q | s_loc`` counts."""
    flops = 2.0 * b * s_loc * n_dev * d_model * v_loc
    x_chunk = float(b * s_loc * d_model * dtype_bytes)
    return choose_overlap(
        "ce_ring", shape=(b, s_loc, d_model, v_loc),
        dtype_bytes=dtype_bytes, n_dev=n_dev, flops=flops,
        hbm_bytes=float(v_loc * d_model * dtype_bytes),
        wire_bytes=x_chunk * (n_dev - 1),
        divisor_of=s_loc, divisor_ring=1, hw=hw, axis=axis, skew=skew,
        wire=wire, fixed_q=fixed_q)


# ---------------------------------------------------------------------------
# the TPU kernels' tile selection
# ---------------------------------------------------------------------------
def choose_tile_n(b: int, k_local: int, n_total: int, *, n_dev: int,
                  dtype_bytes: int, vmem_budget_bytes: int = 8 << 20,
                  lane: int = 128) -> int:
    """Output-tile width of the JAX package's pipelined fused GEMV/GEMM
    kernels under a VMEM budget: the largest lane-aligned divisor of the
    per-rank chunk whose working set fits, else the largest fitting
    divisor, else 1.  Kept as the pure function it is, held to the
    reference; the Hopper kernels take their tiles from their own plans
    (``kernels/gemv/plan.py``, ``kernels/fused_gemm_a2a/plan.py``), not
    from this."""
    bn = n_total // n_dev

    def working_set(tile: int) -> int:
        weights = 2 * k_local * tile * dtype_bytes
        x_block = b * k_local * dtype_bytes
        out_block = b * n_total * dtype_bytes
        tx = (n_dev - 1) * b * bn * dtype_bytes
        rx = n_dev * b * bn * dtype_bytes
        acc = b * bn * 4
        return weights + x_block + out_block + tx + rx + acc

    divisors = [t for t in range(1, bn + 1) if bn % t == 0]
    aligned = [t for t in divisors if t % lane == 0]
    for pool in (aligned, divisors):
        fitting = [t for t in pool if working_set(t) <= vmem_budget_bytes]
        if fitting:
            return max(fitting)
    return 1


def choose_tile_k(b: int, k: int, n_total: int, tile_n: int, *, n_dev: int,
                  dtype_bytes: int, vmem_budget_bytes: int = 8 << 20,
                  sublane: int = 8) -> int:
    """Contraction-panel depth of the JAX package's K-streamed kernels for
    a chosen ``tile_n`` under the VMEM budget, rounded down to a sublane
    multiple where it streams.  Like :func:`choose_tile_n`, the Hopper
    kernels do not use it."""
    bn = n_total // n_dev
    fixed = (b * k * dtype_bytes
             + b * n_total * dtype_bytes
             + (n_dev - 1) * b * bn * dtype_bytes
             + n_dev * b * bn * dtype_bytes
             + b * bn * 4
             + b * tile_n * 4)
    per_row = 2 * tile_n * dtype_bytes
    tk = (vmem_budget_bytes - fixed) // per_row if per_row else k
    tk = max(1, min(int(tk), k))
    if tk >= sublane and tk != k:
        tk -= tk % sublane
    return tk


def feasible_tile(dim: int, requested: int) -> int:
    """Largest tile <= ``requested`` that divides ``dim``."""
    t = max(1, min(int(requested), dim))
    while dim % t:
        t -= 1
    return t


# ---------------------------------------------------------------------------
# measured refinement
# ---------------------------------------------------------------------------
def _fatal(e: BaseException) -> bool:
    """A CUDA error leaves the context unusable: never excluded, always
    raised.  Running out of memory at a fine granularity is not one."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    return type(e).__name__ in ("AcceleratorError", "CudaError") or "CUDA error" in str(e)


def _sync(out) -> None:
    """Wait for the card to finish ``out`` (a tensor, or tensors in a
    tuple, list or dict)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _sync(o)
    elif isinstance(out, dict):
        for o in out.values():
            _sync(o)


def _world_reduce(ctx, values: list[float], op) -> list[float]:
    """``values`` reduced by ``op`` over the whole world: over the tp group,
    then over the data group at dp > 1; a list of the same length, the same
    on every rank."""
    import torch.distributed as dist

    dev = ctx.device if ctx.backend == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    if ctx.tp > 1:
        dist.all_reduce(t, op=op, group=ctx.group)
    if ctx.dp > 1:
        dist.all_reduce(t, op=op, group=ctx.data_group)
    return t.tolist()


def _world_barrier(ctx):
    """A barrier over the tp group, then over the data group at dp > 1."""
    import torch.distributed as dist

    if ctx.tp > 1:
        dist.barrier(group=ctx.group)
    if ctx.dp > 1:
        dist.barrier(group=ctx.data_group)


def measured_best(build_fn: Callable, candidates: Sequence, *,
                  iters: int = 5, warmup: int = 2, fallback=None,
                  ctx=None, errors: dict | None = None) -> tuple:
    """Time ``build_fn(cand)()`` for each candidate (an int q or a
    :class:`Decision`); return (best, times in seconds).

    Each candidate's window is timed on the host clock
    (``time.perf_counter``) from a synchronised start to a synchronised
    end: ``torch.cuda.synchronize`` on a CUDA result, and in a world
    (``ctx`` of more than one rank) a barrier before and after, since a
    gloo exchange waits on the host, where an event on the stream cannot
    see it.  In a world every rank gets the same times (all-reduced with
    MAX over the whole world, data replicas included: a collective step is
    as slow as its slowest rank), so every rank picks the same winner.

    A candidate that raises is excluded, on every rank, and its error is
    put in ``errors`` (candidate -> message) when a dict is given; a CUDA
    error is raised, never excluded.  In a world a build that fails on one
    rank is excluded before any rank runs the candidate; a candidate that
    fails on one rank midway through its exchanges leaves its peers waiting
    in them.  If every candidate raises,
    ``fallback`` (the model's decision) is returned with empty times;
    with no fallback the last error propagates."""
    import torch.distributed as dist

    world = ctx is not None and (ctx.tp > 1 or ctx.dp > 1)
    barrier = (lambda: _world_barrier(ctx)) if world else (lambda: None)

    def agree(ok: bool) -> bool:
        """Whether the step went through on every rank of the world."""
        return ok if not world else _world_reduce(ctx, [float(ok)], dist.ReduceOp.MIN)[0] == 1

    times: dict = {}
    err: Exception | None = None

    def failed(cand, e):
        nonlocal err
        if _fatal(e):
            raise e
        err = e
        if errors is not None:
            errors[cand] = f"{type(e).__name__}: {e}"

    for cand in candidates:
        # the build runs no collective, so every rank learns of a failed
        # build before the candidate's first exchange
        fn = None
        try:
            fn = build_fn(cand)
        except Exception as e:  # noqa: BLE001 - an excluded candidate is reported
            failed(cand, e)
        ok = agree(fn is not None)
        if ok:
            try:
                for _ in range(warmup):
                    _sync(fn())
                barrier()
                t0 = time.perf_counter()
                for _ in range(iters):
                    out = fn()
                _sync(out)
                barrier()
                times[cand] = (time.perf_counter() - t0) / iters
            except Exception as e:  # noqa: BLE001 - an excluded candidate is reported
                failed(cand, e)
            ok = agree(cand in times)
        if not ok:
            times.pop(cand, None)
            if errors is not None:
                errors.setdefault(cand, "excluded: it raised on another rank")
    if world and times:
        keys = list(times)
        times = dict(zip(keys, _world_reduce(ctx, [times[k] for k in keys],
                                             dist.ReduceOp.MAX)))
    if not times:
        if fallback is not None:
            return fallback, times
        raise err if err is not None else ValueError("no candidates")
    best = min(times, key=times.get)
    return best, times


def parse_granularity(value: str):
    """CLI-facing parser: ``"auto"`` or a positive int (argparse
    ``type=``)."""
    if value == "auto":
        return value
    try:
        q = int(value)
    except ValueError:
        raise ValueError(f"granularity must be an int >= 1 or 'auto', "
                         f"got {value!r}") from None
    if q < 1:
        raise ValueError(f"granularity must be >= 1 or 'auto', got {q}")
    return q


def add_granularity_cli_args(ap) -> None:
    """The shared ``--granularity`` / ``--wire`` / ``--tune-cache`` flags
    (one definition for both launchers)."""
    ap.add_argument("--granularity", default=1, type=parse_granularity,
                    help="chunks_per_rank sub-chunk factor of every fused ring: an "
                         "int >= 1, or 'auto' for the shape-keyed alpha-beta "
                         "autotuner (paper Fig. 13)")
    ap.add_argument("--wire", default="f32", choices=["f32", "bf16", "fp8", "auto"],
                    help="wire dtype of every ring payload: f32 keeps the compute "
                         "dtype (exact), bf16/fp8 compress on the send side with "
                         "f32 accumulation (fp8 with a per-chunk scale), 'auto' "
                         "lets the link class's model choose")
    ap.add_argument("--tune-cache", default=None,
                    help="a persisted autotune cache: loaded (if present) at start, "
                         "saved at the end by rank 0")


def load_cache_if_exists(path: str | None) -> int:
    """Launcher-side preload: a missing or unset path is a cold start, and
    so is a corrupt file; returns the entries loaded."""
    if path and os.path.exists(path):
        try:
            return load_cache(path)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return 0
    return 0


def resolve_granularity(granularity, pick: Callable[[], int]) -> int:
    """Integers pass through; ``"auto"`` defers to the chooser ``pick``."""
    if granularity == "auto":
        return pick()
    q = int(granularity)
    if q < 1:
        raise ValueError(f"granularity must be >= 1 or 'auto', got {granularity!r}")
    return q


def resolve_chunks_per_rank(override, config_granularity,
                            pick: Callable[[], int], *, dim: int,
                            ring: int) -> int:
    """The per-call ``override`` beats ``config_granularity``; ``"auto"``
    defers to ``pick``; the result is clamped so ``dim`` splits evenly
    into ``ring * q`` fine chunks."""
    gran = config_granularity if override is None else override
    return feasible_chunks_per_rank(dim, ring, resolve_granularity(gran, pick))


def resolve_overlap(override_q, config_q, override_wire, config_wire,
                    pick: Callable, *, dim: int, ring: int) -> Decision:
    """Joint ``(chunks_per_rank, wire)`` resolution shared by every fused-op
    call site.  Per-call overrides beat the ``FusionConfig`` settings; when
    either knob is ``"auto"``, ``pick(fixed_q, wire_request)`` runs the
    model sweep (``fixed_q`` pins a concrete granularity while the wire is
    still chosen, and vice versa).  The granularity is clamped so ``dim``
    splits evenly into ``ring * q`` fine chunks.  Inside a checkpointed
    region the decision is pinned (``degrade.pinned``)."""
    return pin(lambda: _resolve(override_q, config_q, override_wire, config_wire, pick,
                                dim=dim, ring=ring))


def _resolve(override_q, config_q, override_wire, config_wire, pick, *, dim, ring):
    gran = config_q if override_q is None else override_q
    wire = config_wire if override_wire is None else override_wire
    if wire not in WIRE_SETTINGS:
        raise ValueError(f"wire must be one of {WIRE_SETTINGS}, got {wire!r}")
    if gran == "auto" or wire == "auto":
        fixed_q = None if gran == "auto" else int(gran)
        if fixed_q is not None and fixed_q < 1:
            raise ValueError(f"granularity must be >= 1 or 'auto', got {gran!r}")
        dec = _as_decision(pick(fixed_q, wire))
    else:
        q = int(gran)
        if q < 1:
            raise ValueError(f"granularity must be >= 1 or 'auto', got {gran!r}")
        dec = Decision(q, wire)
    return Decision(feasible_chunks_per_rank(dim, ring, dec.q), dec.wire)
