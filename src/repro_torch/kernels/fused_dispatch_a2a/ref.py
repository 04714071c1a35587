"""Plain PyTorch versions of the dispatch All-to-All kernel.

Per-rank semantics: every EP rank holds routed token blocks
``xt [n, B, E_loc, C, D]`` stacked by *destination* rank; the kernel returns
the blocks sent to this rank by every source, stacked by source: a bulk
All-to-All over the leading dim (the dispatch moves data only; the expert
FFN happens on the receiving side).
"""
import torch

from repro_torch.kernels import wire_dtype


def fused_dispatch_a2a_ref(xt):
    """One rank (n = 1): the All-to-All over one rank is the identity."""
    return xt.clone()


def fused_dispatch_a2a_ref_ranks(x_ranks, wire="f32"):
    """An n-rank world on one device: x_ranks [n, n, B, E_loc, C, D]
    (rank, destination, ...) -> [n, n, B, E_loc, C, D] (rank, source, ...),
    out[r, s] = x_ranks[s, r].  A block that crosses ranks is rounded to
    the wire dtype once; a rank's own block stays exact.  The send order
    (schedule, sub-chunks, skew) does not change the result."""
    wdt = wire_dtype(x_ranks.dtype, wire)
    out = x_ranks.transpose(0, 1).clone()
    if wdt != out.dtype:
        remote = ~torch.eye(out.shape[0], dtype=torch.bool, device=out.device)
        out[remote] = out[remote].to(wdt).to(out.dtype)
    return out
