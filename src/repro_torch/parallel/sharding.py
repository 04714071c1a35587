"""Fusion settings and the parallel context threaded through the model code.

This slice of the port runs on one card: tensor- and data-parallel sizes
are both 1.  A multi-card ``torch.distributed`` world comes with ROADMAP
Queue 1 item 1 (the multi-card tp world: ``core/collectives.py``, ``fused``
mode and symmetric-memory peer pointers for the same kernel).
"""
from __future__ import annotations

import dataclasses

import torch


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
      (:mod:`repro.core.autotune`) per fused-op call site.  Values that
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
      max-abs scale alongside the payload); ``"auto"`` defers to the
      per-mesh-axis alpha-beta model (:class:`~repro.core.perfmodel.
      MeshHardwareModel` via ``ParallelContext.hw``) jointly with the
      granularity choice — a slow DCN axis picks a narrow wire, a fast
      ICI axis whose wire hides behind compute keeps f32.

    In this port so far only ``"bulk"`` and ``"kernel"`` run.
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
    """Device + fusion settings threaded through the model code.

    ``device`` defaults to ``"cuda"`` and a CUDA device that is not there
    raises: nothing falls back to the CPU unless the caller asks for it.
    ``tp`` and ``dp`` are the world's tensor- and data-parallel sizes; only
    1 runs in this slice."""

    device: torch.device | str = "cuda"
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    tp: int = 1
    dp: int = 1

    def __post_init__(self):
        dev = torch.device(self.device)
        object.__setattr__(self, "device", dev)
        if self.tp != 1 or self.dp != 1:
            raise NotImplementedError(
                f"tp={self.tp}, dp={self.dp}: multi-card worlds are ROADMAP "
                f"Queue 1 item 1 (the multi-card tp world); this slice runs "
                f"on one card")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
