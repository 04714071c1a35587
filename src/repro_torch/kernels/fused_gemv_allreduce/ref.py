"""Plain PyTorch versions of the fused GEMV/GEMM + AllReduce kernel.

Per-rank semantics: every rank r holds x_r [B, K_loc] and w_r [K_loc, N];
the kernel returns sum_r x_r @ w_r on every rank.
"""
import torch

from repro_torch.kernels import wire_dtype
from repro_torch.kernels.tile_pipeline import step_schedule


def fused_matmul_allreduce_ref(x, w):
    """tp = 1: x [B, K] @ w [K, N] summed in f32, at x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def fused_matmul_allreduce_ref_ranks(x_ranks, w_ranks, wire="f32",
                                     comm_aware=True):
    """An n-rank world on one device: x_ranks [n, B, K_loc], w_ranks
    [n, K_loc, N] -> [n, B, N], every rank's output.

    Rank d reduces output chunk d: its own f32 partial plus every other
    rank's partial rounded to the wire dtype (as the PUT stages it), summed
    in f32 in source order and cast to x's dtype.  Partials are produced in
    each source's step order (``comm_aware`` picks it); the result does not
    depend on that order."""
    n, b, _ = x_ranks.shape
    big_n = w_ranks.shape[2]
    if big_n % n:
        raise ValueError(f"N={big_n} does not split over {n} ranks")
    bn = big_n // n
    wdt = wire_dtype(x_ranks.dtype, wire)
    step_off, _ = step_schedule(n, 1, comm_aware)
    own = [None] * n
    rx = [[None] * n for _ in range(n)]          # rx[dest][src]
    for src in range(n):
        for off in step_off:
            dest = (src + off) % n
            part = (x_ranks[src].float()
                    @ w_ranks[src, :, dest * bn:(dest + 1) * bn].float())
            if off:
                rx[dest][src] = part.to(wdt)
            else:
                own[dest] = part
    chunks = []
    for d in range(n):
        acc = own[d]
        for s in range(n):
            if s != d:
                acc = acc + rx[d][s].float()
        chunks.append(acc.to(x_ranks.dtype))
    return torch.stack([torch.cat(chunks, dim=1)] * n)
