"""Fusion settings and the parallel context threaded through the model code.

The model code is SPMD: every rank of a tensor-parallel (tp) world runs it
on its own shard, and the collectives of ``core/collectives.py`` run over
the tp process group the context holds.  Where the JAX package states a
parameter's layout as a logical spec (``("fsdp", "tp")`` and the like) and
lets GSPMD place it, the port slices the whole tensor to this rank's part
with :func:`shard_leaf`.  Data parallelism (``dp > 1``, with the reference's
``fsdp`` weight sharding) is not ported: ROADMAP Queue 1 item 1 (left).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.perfmodel import GLOO_HOST, H100_NVLINK, MeshHardwareModel

# logical axes the reference's ``_resolve`` maps onto the tp axis
# (src/repro/parallel/sharding.py:171-183); ``None``, "none", "batch" and
# "fsdp" map onto the data axes, which are one rank wide while dp = 1
_TP_AXES = ("tp", "model", "vocab", "seq", "heads", "expert")
_WHOLE_AXES = (None, "none", "batch", "fsdp")
_DP_ITEM = ("ROADMAP Queue 1 item 1 (left: data parallel, dp > 1, with the reference's "
            "fsdp weight sharding)")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Controls how dependent compute+collective pairs execute.

    mode:
      "bulk"   - bulk-synchronous baseline: full compute kernel, then the
                 collective (what RCCL/NCCL-style libraries give you).
      "fused"  - the paper's technique, TPU-adapted: the op is decomposed
                 into chunks; each chunk's collective is issued as soon as
                 its compute finishes, so XLA's latency-hiding scheduler
                 overlaps wire time with the remaining chunks' compute.
      "kernel" - device-initiated kernels (remote PUTs from inside the
                 kernel).  In this port: the hand-written CUDA kernels,
                 which a CUDA tensor launches or raises; no fallback.
      "auto"   - trace-time graph mode: every call site emits the bulk
                 reference collectives, and the jaxpr comm-graph analyzer
                 (:mod:`repro.analysis`) rewrites the profitable matches
                 to the fused ops afterwards (``--auto-fuse`` on the
                 launchers).  Model code needs no fused-op calls at all.
    schedule:
      "comm_aware"  - remote-destined chunks are computed first, the
                      locally-consumed chunk last (paper Fig. 6b / 7b).
      "oblivious"   - chunks computed in natural order (paper's baseline
                      scheduling; exists to reproduce Fig. 14).
    granularity: sub-chunk factor ``chunks_per_rank`` — how many slices
      each ring step's payload is split into (paper Fig. 13 knob).  1 is
      the paper's slice-per-peer granularity (one chunk per ring rank);
      larger values put each sub-slice on the wire as soon as it is
      produced, hiding more wire time until per-slice overhead wins.
      "auto" defers to the shape-keyed alpha-beta autotuner
      (:mod:`repro_torch.core.autotune`) per fused-op call site.  Values that
      do not divide the chunked dimension are clamped per-op to the
      largest feasible factor.
    skew: measured straggler rotation (paper Fig. 14).  An integer bucket
      produced by :class:`repro.runtime.straggler.SkewEstimator` from
      per-rank step-time telemetry; every fused op ringing over the *tp*
      axis rotates its static chunk schedule by it (the A2A family
      rotates the remote destination order, the ring-carry family the
      sub-chunk service order).  The schedule is baked into the lowered
      HLO, so changing the bucket requires a re-jit —
      :class:`repro.runtime.straggler.SkewScheduler` owns that loop.
      0 = no measured skew (the default schedules).
    skew_world: the same bucket for ops that ring over the flattened
      full-world axis (the DLRM embedding A2A).  A rotation is only
      meaningful for the ring it was estimated on, so the world-ring ops
      deliberately do not inherit the tp-ring ``skew``
      (``SkewEstimator`` reduces per axis; feed each ring its own
      bucket).
    wire: wire dtype of every ring/A2A payload.  ``"f32"`` keeps the
      compute dtype on the wire (exact — the pre-wire graphs,
      bit-identical); ``"bf16"``/``"fp8"`` compress payloads on the send
      side while all local accumulation stays f32 (fp8 ships a per-chunk
      max-abs scale alongside the payload); ``"auto"`` defers to the link
      class's alpha-beta model (:class:`~repro_torch.core.perfmodel.
      MeshHardwareModel` via ``ParallelContext.hw``) jointly with the
      granularity choice: a slow link picks a narrow wire, a fast one whose
      wire hides behind compute keeps f32.

    In this port ``"bulk"`` and ``"fused"`` run at any tp, ``"kernel"`` at
    tp = 1 (the real-peer kernels wait for a multi-card host); the
    ``"auto"`` granularity and wire resolve at every fused-op call site.
    The ``"auto"`` mode (the comm-graph rewrite) waits for ROADMAP Queue 1
    item 7.
    """

    mode: str = "fused"
    schedule: str = "comm_aware"
    granularity: int | str = 1
    skew: int = 0
    skew_world: int = 0
    wire: str = "f32"
    fuse_ag_matmul: bool = True
    fuse_matmul_rs: bool = True
    fuse_moe_a2a: bool = True
    fuse_embed_a2a: bool = True
    fuse_kv_ag: bool = True

    def resolve(self, which: str) -> str:
        """Effective mode for one of the fused-op families."""
        if self.mode in ("bulk", "auto") or not getattr(self, f"fuse_{which}"):
            # "auto": trace bulk; the comm-graph analyzer rewrites after
            return "bulk"
        return self.mode


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """Device, fusion settings and the tp world threaded through the model code.

    ``device`` defaults to ``"cuda"`` and a CUDA device that is not there
    raises: nothing falls back to the CPU unless the caller asks for it.
    ``tp`` is the tensor-parallel world's size.  At tp > 1 ``group`` is its
    process group (``None``: the default world, which must then be exactly
    tp ranks wide), started beforehand (``launch.mesh.init_world``); the
    context reads this rank's place in it (``tp_rank``) and the world's
    backend (``"gloo"`` or ``"nccl"``).  ``dp`` must be 1.

    ``hw`` is the link model the autotuner decides under (a
    :class:`MeshHardwareModel`).  ``None`` takes it from the world: a gloo
    world of more than one rank stages its payloads through host memory
    (``GLOO_HOST``); an NCCL world, and one rank, take the H100 NVLink
    class (``H100_NVLINK``).  Both classes are provisional until
    ``--calibrate`` measures the choices."""

    device: torch.device | str = "cuda"
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    tp: int = 1
    dp: int = 1
    group: Any = None
    hw: MeshHardwareModel | None = None
    tp_rank: int = dataclasses.field(init=False, default=0)
    backend: str | None = dataclasses.field(init=False, default=None)

    def __post_init__(self):
        dev = torch.device(self.device)
        object.__setattr__(self, "device", dev)
        if self.dp != 1:
            raise NotImplementedError(f"dp={self.dp}: {_DP_ITEM}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.tp > 1:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"tp={self.tp} needs a torch.distributed world of {self.tp} ranks: "
                    f"start one with repro_torch.launch.mesh.init_world")
            group = self.group if self.group is not None else dist.group.WORLD
            size = dist.get_world_size(group)
            if size != self.tp:
                raise ValueError(f"tp={self.tp} but the process group has {size} ranks")
            object.__setattr__(self, "tp_rank", dist.get_rank(group))
            object.__setattr__(self, "backend", str(dist.get_backend(group)))
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        if self.hw is None:
            link = GLOO_HOST if self.tp > 1 and self.backend == "gloo" else H100_NVLINK
            object.__setattr__(self, "hw", MeshHardwareModel.uniform(link))

    def peer(self, tp_rank: int) -> int:
        """The global rank of tp rank ``tp_rank`` (what point-to-point calls take)."""
        if self.group is None:
            return tp_rank
        return dist.get_global_rank(self.group, tp_rank)

    def hw_for(self, axis):
        """The link model of ``axis`` (a name or a tuple of names)."""
        return self.hw.for_axes(axis)

    def with_fusion(self, fusion: FusionConfig) -> "ParallelContext":
        return dataclasses.replace(self, fusion=fusion)


def splits_over_tp(spec) -> bool:
    """Whether a logical ``spec`` splits a dim over the tp ranks (else the
    leaf is whole on every rank)."""
    return any(ax in _TP_AXES for ax in spec)


def shard_leaf(x: torch.Tensor, spec, ctx: ParallelContext) -> torch.Tensor:
    """This rank's part of the whole tensor ``x`` under the reference's
    logical ``spec`` (one entry per dim): a dim named ``"tp"``, ``"vocab"``,
    ``"seq"`` or ``"heads"`` is split into ``ctx.tp`` equal blocks and block
    ``ctx.tp_rank`` kept; ``None`` and ``"fsdp"`` keep the dim whole (at dp
    = 1).  The SPMD counterpart of the reference's
    ``param_sharding_rules``.  At tp = 1, or when no dim splits, ``x``
    itself is returned; otherwise a compact copy, so the whole can be freed."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(x.shape)}")
    split = [i for i, ax in enumerate(spec) if ax in _TP_AXES]
    unknown = [ax for ax in spec if ax not in _TP_AXES and ax not in _WHOLE_AXES]
    if unknown or len(split) > 1:
        raise ValueError(f"logical spec {spec}: one tp axis at most, of {_TP_AXES}")
    if not split or ctx.tp == 1:
        return x
    dim = split[0]
    if x.shape[dim] % ctx.tp:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split over tp={ctx.tp}")
    size = x.shape[dim] // ctx.tp
    return x.narrow(dim, ctx.tp_rank * size, size).clone()
