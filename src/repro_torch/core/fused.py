"""Public API for the fused computation-collective operators.

This is the "PyTorch custom operator" integration level of the paper:
model code calls these ops, and one ``FusionConfig`` switch flips the
whole model between the bulk-synchronous baseline, the fused-decomposed
rings (the paper's technique) and the hand-written CUDA kernels; nothing
else in the model changes.  ``__all__`` is the JAX package's
(``src/repro/core/fused.py``) name for name, but for these:

``fused_moe_chain`` in place of ``fused_moe_kernel``
    The reference's ``fused_moe_kernel(ctx, x, w_up, w_gate, w_down, *,
    act, ...)`` is a global-array entry that runs the dispatch and
    FFN + combine kernels inside ``shard_map``.  The port is SPMD, one
    process a rank, so its chain (``kernels/fused_gemm_a2a/ops.py``) takes
    this rank's ``[n, B, E_loc, C, D]`` blocks and no context; a different
    signature keeps its own name.
``H100_NVLINK`` and ``GLOO_HOST`` in place of ``V5E`` and ``DCN``
    The reference's link classes are a TPU v5e's ICI and a data-centre
    network.  The port's (``core/perfmodel.py``) are an H100's NVLink and a
    gloo world whose payloads are staged through host memory.

``fused_dispatch_a2a`` keeps the reference's name; like the chain it is the
per-rank entry (the SPMD counterpart of the reference's
``fused_dispatch_a2a_shard``), not the global-array one.
"""
from repro_torch.core.allgather_matmul import allgather_matmul, allgather_seq, matmul_reducescatter
from repro_torch.core.autotune import (
    Decision,
    choose_chunks_per_rank,
    choose_overlap,
    choose_tile_k,
    choose_tile_n,
    load_cache,
    measured_best,
    save_cache,
    tune_ce_ring,
    tune_ring_attention,
)
from repro_torch.core.calibrate import measured_calibration_pass
from repro_torch.core.collectives import (
    all_gather_wire,
    attention_partial_merge,
    direct_all_to_all_compute,
    feasible_chunks_per_rank,
    ring_all_gather_compute,
    ring_reduce_scatter_compute,
    wire_cast,
    wire_uncast,
)
from repro_torch.core.degrade import (
    DegradationPolicy,
    DegradeConfig,
    degrade_mode,
    get_degradation_policy,
    set_degradation_policy,
)
from repro_torch.core.embedding_all_to_all import embedding_all_to_all
from repro_torch.core.loss import sharded_cross_entropy
from repro_torch.core.matmul_allreduce import matmul_allreduce
from repro_torch.core.moe_all_to_all import fused_expert_ffn_combine, moe_dispatch_all_to_all
from repro_torch.core.perfmodel import GLOO_HOST, H100_NVLINK, HardwareModel, MeshHardwareModel
from repro_torch.core.scheduling import (
    best_skew_rotation,
    modeled_execution_skew,
    modeled_finish_times,
    skew_statistic,
)
from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
from repro_torch.kernels.fused_gemm_a2a.ops import fused_moe_chain
from repro_torch.parallel.sharding import FusionConfig, ParallelContext

__all__ = [
    "FusionConfig",
    "ParallelContext",
    "matmul_allreduce",
    "allgather_matmul",
    "matmul_reducescatter",
    "allgather_seq",
    "moe_dispatch_all_to_all",
    "fused_expert_ffn_combine",
    "fused_dispatch_a2a",
    "fused_moe_chain",
    "embedding_all_to_all",
    "sharded_cross_entropy",
    "ring_reduce_scatter_compute",
    "ring_all_gather_compute",
    "direct_all_to_all_compute",
    "attention_partial_merge",
    "feasible_chunks_per_rank",
    "all_gather_wire",
    "wire_cast",
    "wire_uncast",
    "DegradationPolicy",
    "DegradeConfig",
    "degrade_mode",
    "get_degradation_policy",
    "set_degradation_policy",
    "Decision",
    "choose_chunks_per_rank",
    "choose_overlap",
    "choose_tile_k",
    "choose_tile_n",
    "GLOO_HOST",
    "H100_NVLINK",
    "HardwareModel",
    "MeshHardwareModel",
    "load_cache",
    "measured_best",
    "measured_calibration_pass",
    "save_cache",
    "tune_ce_ring",
    "tune_ring_attention",
    "best_skew_rotation",
    "modeled_execution_skew",
    "modeled_finish_times",
    "skew_statistic",
]
