"""Plain PyTorch versions of the fused expert FFN + combine All-to-All kernel.

Per-rank semantics: every EP rank holds dispatched token blocks
``xt [n, B, E_loc, C, D]`` stacked by combine destination plus its local
experts' weights; the kernel returns the blocks computed for this rank by
every source: the gated expert FFN applied per block, followed by a bulk
All-to-All over the leading dim.

:func:`expert_ffn_ref` mirrors the JAX package's ``expert_ffn_ref``: three
einsums at the input dtype, so bf16 inputs round h and g to bf16.  The CUDA
kernel follows the TPU kernel instead and keeps h and g in f32, rounding
only u = act(g) h; tolerances between the two state that difference.
"""
import torch
import torch.nn.functional as F

from repro_torch.kernels.fused_dispatch_a2a.ref import fused_dispatch_a2a_ref_ranks

# the kernel's activation codes, in order (jax.nn.gelu is the tanh form)
ACTS = {"silu": F.silu,
        "gelu": lambda v: F.gelu(v, approximate="tanh"),
        "relu": F.relu}


def expert_ffn_ref(xb, w_up, w_gate, w_down, act):
    """Gated FFN over one block.  xb: [..., E, C, D] with per-expert weights
    [E, D, F] / [E, F, D]."""
    h = torch.einsum("...ecd,edf->...ecf", xb, w_up)
    g = torch.einsum("...ecd,edf->...ecf", xb, w_gate)
    return torch.einsum("...ecf,efd->...ecd", ACTS[act](g) * h, w_down)


def fused_gemm_a2a_ref(xt, w_up, w_gate, w_down, act):
    """One rank (n = 1): the FFN, then the identity All-to-All."""
    return expert_ffn_ref(xt, w_up, w_gate, w_down, act)


def fused_gemm_a2a_ref_ranks(x_ranks, wu_ranks, wg_ranks, wd_ranks, act, wire="f32"):
    """An n-rank world on one device: x_ranks [n, n, B, E_loc, C, D]
    (rank, destination, ...), per-rank weights [n, E_loc, D, F] /
    [n, E_loc, F, D] -> [n, n, B, E_loc, C, D] (rank, source, ...).  Each
    rank's FFN output crosses ranks at the wire dtype."""
    y = torch.stack([expert_ffn_ref(x_ranks[r], wu_ranks[r], wg_ranks[r], wd_ranks[r], act)
                     for r in range(x_ranks.shape[0])])
    return fused_dispatch_a2a_ref_ranks(y, wire)
