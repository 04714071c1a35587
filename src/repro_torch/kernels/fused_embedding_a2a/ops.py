"""Wrappers for the device-initiated fused embedding + All-to-All kernel.

A CUDA tensor launches ``csrc/fused_embedding_a2a.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from one
to the other.  The kernel has the two paths of ``embedding_pool`` (``"ring"``
and ``"warp"``), which give the same bits, and launches from the same plan
(``call_plan``); :func:`~repro_torch.kernels.embedding_pool.plan.bag_path`
picks the warp path at one rank and, where the rows fit it, the ring path
in an emulated world of more.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library, peer_flags, sm_count
from repro_torch.kernels.embedding_pool.plan import PATHS, RING_BYTES, call_plan
from repro_torch.kernels.fused_embedding_a2a.ref import (fused_embedding_a2a_ref,
                                                         fused_embedding_a2a_ref_ranks)
from repro_torch.parallel.sharding import ParallelContext

MAX_DEV = 8     # size of the kernel's peer pointer tables (kMaxDev)
REAL_PEERS_ITEM = ("ROADMAP Queue 1 item 1 (left: the real-peer half, symmetric-memory "
                   "pointer tables on a multi-card host)")


def fused_embedding_a2a(ctx: ParallelContext, indices, tables, *, comm_aware=True, _path=None,
                        _ring_bytes=RING_BYTES):
    """indices [B, T, L] int32; tables [T, V, D] -> pooled [B, T, D].

    The world of ``ctx`` is one card (n = 1): the rank pools every bag of
    its tables into its own output and has no peers.  The indices are
    trusted (see ``embedding_pool_tables``).  A CUDA tensor launches the
    kernel or raises, on the path ``bag_path`` chooses or ``_path`` (as
    ``embedding_pool_tables``'s, with ``_ring_bytes``)."""
    n = ctx.tp * ctx.dp
    if n != 1:
        raise NotImplementedError(f"fused_embedding_a2a over {n} ranks needs real peers: "
                                  f"{REAL_PEERS_ITEM}")
    _check(tables[None], indices[None])
    plan = _plan(tables, 1, indices.shape[0], tables.shape[0], _path, _ring_bytes)
    if tables.device.type == "cpu":
        return fused_embedding_a2a_ref(tables[None], indices[None])[0]
    out = _launch(tables[None], indices[None], comm_aware, plan)[0]
    fused_embedding_a2a.launches += 1
    fused_embedding_a2a.path_launches[plan.path] += 1
    return out


fused_embedding_a2a.launches = 0
fused_embedding_a2a.path_launches = dict.fromkeys(PATHS, 0)


def fused_embedding_a2a_ranks(tables, idx, *, comm_aware=True, _path=None,
                              _ring_bytes=RING_BYTES):
    """An n-rank world emulated on one device: tables [n, T_loc, V, D],
    idx [n, B, T_loc, L] (each source rank's tables and its indices for the
    global batch) -> [n, B / n, n * T_loc, D] (each destination's batch
    fragment of every rank's pooled tables).

    On a card, one launch runs all n ranks (``gridDim.y = n``) with the full
    PUT / flag protocol between them, output pointers aimed at per-rank
    slices of one allocation; ``_path`` and ``_ring_bytes`` as
    :func:`fused_embedding_a2a`'s.  It exists to exercise that protocol on
    one card; the one-card path calls :func:`fused_embedding_a2a`."""
    _check(tables, idx)
    n = tables.shape[0]
    plan = _plan(tables, n, idx.shape[1] // n, tables.shape[1], _path, _ring_bytes)
    if tables.device.type == "cpu":
        return fused_embedding_a2a_ref_ranks(tables, idx)
    out = _launch(tables, idx, comm_aware, plan)
    fused_embedding_a2a_ranks.launches += 1
    fused_embedding_a2a_ranks.path_launches[plan.path] += 1
    return out


fused_embedding_a2a_ranks.launches = 0
fused_embedding_a2a_ranks.path_launches = dict.fromkeys(PATHS, 0)


def _check(tables, idx):
    if tables.dim() != 4 or idx.dim() != 4:
        raise ValueError(f"fused_embedding_a2a: need tables [n, T_loc, V, D] and idx "
                         f"[n, B, T_loc, L], got {tuple(tables.shape)} and {tuple(idx.shape)}")
    n, t_loc = tables.shape[:2]
    if idx.shape[0] != n or idx.shape[2] != t_loc:
        raise ValueError(f"fused_embedding_a2a: idx {tuple(idx.shape)} does not match "
                         f"tables {tuple(tables.shape)}")
    if idx.shape[1] % n:
        raise ValueError(f"fused_embedding_a2a: batch {idx.shape[1]} does not split over "
                         f"{n} ranks")
    if idx.shape[3] < 1:
        raise ValueError("fused_embedding_a2a: a bag needs at least one lookup")
    if idx.dtype != torch.int32:
        raise TypeError(f"fused_embedding_a2a: indices must be int32, got {idx.dtype}")
    if tables.device != idx.device:
        raise ValueError(f"fused_embedding_a2a: tables on {tables.device} but idx on "
                         f"{idx.device}")
    dtype_code(tables.dtype)


def _plan(tables, n, b_loc, t_loc, path, ring_bytes):
    """The plan of a call over ``n`` ranks, all in one launch (n > 1: the
    emulated world), sized on a card from this kernel's capacity."""
    capacity = (functools.partial(_ring_ctas, tables.get_device(), dtype_code(tables.dtype),
                                  n > 1) if tables.is_cuda else None)
    return call_plan("fused_embedding_a2a", tables, n, b_loc, t_loc, path, ring_bytes,
                     capacity=capacity, ranks_in_launch=n)


@functools.lru_cache(maxsize=256)
def _ring_ctas(index, code, peers, smem):
    """The ring kernel's CTAs the card holds at once at ``smem`` bytes of
    dynamic shared memory, with the peer protocol (``peers``) or without
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    regs, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        check_launch(load_library().lib.repro_fused_embedding_a2a_info(
            1, code, smem, int(peers), ctypes.byref(regs), ctypes.byref(per_sm)),
            "fused_embedding_a2a capacity")
    return per_sm.value * sm_count(index)


@functools.lru_cache(maxsize=64)
def _tickets(device, n_dev):
    """Each rank's n_dev + 1 counters of finished CTAs (one per fragment, one
    for the rank), zeroed once; the last CTA to count resets its counter."""
    return torch.zeros((n_dev, n_dev + 1), dtype=torch.int32, device=device)


def _launch(tables, idx, comm_aware, plan):
    n, t_loc, v, d = tables.shape
    _, B, _, L = idx.shape
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError("fused_embedding_a2a: the kernel takes contiguous tables and idx")
    if n > MAX_DEV:
        raise ValueError(f"fused_embedding_a2a: at most {MAX_DEV} ranks")
    dev = tables.device
    b_loc = B // n
    out = torch.empty((n, b_loc, n * t_loc, d), dtype=tables.dtype, device=dev)
    ptr_array = ctypes.c_uint64 * n
    out_ptrs = ptr_array(*(out[r].data_ptr() for r in range(n)))
    flag_ptrs, tickets, epoch = ptr_array(), 0, 0
    if n > 1:
        flags = peer_flags(dev, n, n)       # one word per source on each rank
        flag_ptrs = ptr_array(*(flags.words[r].data_ptr() for r in range(n)))
        tickets = _tickets(dev, n).data_ptr()
        epoch = flags.next_epoch()
    with torch.cuda.device(dev):
        lib = load_library().lib
        check_launch(lib.repro_fused_embedding_a2a(
            tables.data_ptr(), tables[0].numel(), v, idx.data_ptr(), idx[0].numel(),
            out_ptrs, flag_ptrs, tickets, 0, n, n, b_loc, t_loc, L, d, epoch,
            int(bool(comm_aware)), dtype_code(tables.dtype), plan.slots, plan.ctas,
            torch.cuda.current_stream().cuda_stream),
            "fused_embedding_a2a")
    return out
