"""Wrappers for the device-initiated expert FFN + combine All-to-All kernel.

Also home of the chained MoE entry: the dispatch kernel
(:mod:`repro_torch.kernels.fused_dispatch_a2a`) lands tokens in exactly the
by-source slot layout the FFN+combine kernel reads, so
:func:`fused_moe_chain` runs dispatch -> expert FFN -> combine as two
launches with nothing in between.  A CUDA tensor launches
``csrc/fused_gemm_a2a.cu`` or raises; a CPU tensor takes the plain version
in ``ref.py``.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (check_launch, clamp_kernel_wire, dtype_code, load_library,
                                 peer_flags, schedule_table, wire_dtype)
from repro_torch.kernels.fused_dispatch_a2a.ops import (MAX_DEV, REAL_PEERS_ITEM,
                                                        fused_dispatch_a2a)
from repro_torch.kernels.fused_gemm_a2a.ref import (ACTS, fused_gemm_a2a_ref,
                                                    fused_gemm_a2a_ref_ranks)

TILE = 32   # columns of u (F) or y (D) per work item (kTileN in csrc/tile_gemv.cuh)
ACT_CODES = {name: i for i, name in enumerate(ACTS)}   # the kernel's `act` codes


def fused_gemm_a2a(xt, w_up, w_gate, w_down, *, act="silu", comm_aware=True, skew=0,
                   wire="f32"):
    """One EP rank: xt [n, B, E_loc, C, D] stacked by combine destination,
    w_up/w_gate [E_loc, D, F], w_down [E_loc, F, D] -> [n, B, E_loc, C, D]
    stacked by source: act(x w_gate) (x w_up) w_down per block, then the
    combine All-to-All.

    The port's world is one card (n = 1), where the exchange keeps the
    rank's own block.  The kernel accumulates in f32 and rounds u and y to
    x's dtype; ``wire="fp8"`` is clamped to bf16 with a one-time warning.
    A CUDA tensor launches the kernel or raises."""
    wire = _check(xt, (w_up, w_gate, w_down), 5, act, wire)
    if xt.shape[0] != 1:
        raise NotImplementedError(f"fused_gemm_a2a over {xt.shape[0]} ranks needs real "
                                  f"peers: {REAL_PEERS_ITEM}")
    if xt.device.type == "cpu":
        return fused_gemm_a2a_ref(xt, w_up, w_gate, w_down, act)
    out = _launch(xt[None], w_up[None], w_gate[None], w_down[None], act, wire, comm_aware,
                  skew)[0]
    fused_gemm_a2a.launches += 1
    return out


fused_gemm_a2a.launches = 0


def fused_gemm_a2a_ranks(x_ranks, wu_ranks, wg_ranks, wd_ranks, *, act="silu",
                         comm_aware=True, skew=0, wire="f32"):
    """An n-rank world emulated on one device: x_ranks [n, n, B, E_loc, C, D]
    (rank, destination, ...), per-rank weights [n, E_loc, D, F] /
    [n, E_loc, F, D] -> [n, n, B, E_loc, C, D] (rank, source, ...).

    On a card, one launch runs all n ranks (``gridDim.y = n``) with the full
    PUT / flag protocol between them.  It exists to exercise that protocol
    on one card; the serving path calls :func:`fused_gemm_a2a`."""
    wire = _check(x_ranks, (wu_ranks, wg_ranks, wd_ranks), 6, act, wire)
    if not x_ranks.shape[0] == x_ranks.shape[1] == wu_ranks.shape[0]:
        raise ValueError(f"fused_gemm_a2a: x {tuple(x_ranks.shape)} and weights "
                         f"{tuple(wu_ranks.shape)} disagree on the number of ranks")
    if x_ranks.device.type == "cpu":
        return fused_gemm_a2a_ref_ranks(x_ranks, wu_ranks, wg_ranks, wd_ranks, act, wire)
    out = _launch(x_ranks, wu_ranks, wg_ranks, wd_ranks, act, wire, comm_aware, skew)
    fused_gemm_a2a_ranks.launches += 1
    return out


fused_gemm_a2a_ranks.launches = 0


def fused_moe_chain(xt, w_up, w_gate, w_down, *, act="silu", comm_aware=True,
                    chunks_per_rank=1, skew=0, wire="f32"):
    """Chained dispatch -> expert FFN -> combine for one EP rank.

    xt: [n, B, E_loc, C, D] stacked by dispatch destination.  The dispatch
    kernel's output (tokens stacked by source) is the FFN+combine kernel's
    input as it stands.  Returns blocks stacked by combine destination
    (= dispatch source): each rank's tokens come home.  ``launches`` counts
    the chains that ran on a card, each one launch of either kernel."""
    xr = fused_dispatch_a2a(xt, comm_aware=comm_aware, chunks_per_rank=chunks_per_rank,
                            skew=skew, wire=wire)
    y = fused_gemm_a2a(xr, w_up, w_gate, w_down, act=act, comm_aware=comm_aware, skew=skew,
                       wire=wire)
    if xt.device.type == "cuda":
        fused_moe_chain.launches += 1
    return y


fused_moe_chain.launches = 0


def _check(x, weights, ndim, act, wire):
    """The wire after the fp8 clamp; raises on operands the kernel does not take."""
    wire = clamp_kernel_wire(wire, "fused_gemm_a2a")
    wire_dtype(x.dtype, wire)
    dtype_code(x.dtype)
    if act not in ACT_CODES:
        raise ValueError(f"fused_gemm_a2a: act must be one of {sorted(ACT_CODES)}, got {act!r}")
    w_up, w_gate, w_down = weights
    lead = ndim - 5          # the rank axis of an emulated world
    if x.dim() != ndim or any(w.dim() != 3 + lead for w in weights):
        raise ValueError(f"fused_gemm_a2a: need x of {ndim} dims and weights of {3 + lead}, "
                         f"got {tuple(x.shape)} and {[tuple(w.shape) for w in weights]}")
    e, d = x.shape[-3], x.shape[-1]
    f = w_up.shape[-1]
    want_ud = w_up.shape[:lead] + (e, d, f)
    if (w_up.shape != want_ud or w_gate.shape != want_ud
            or w_down.shape != w_up.shape[:lead] + (e, f, d)):
        raise ValueError(f"fused_gemm_a2a: x {tuple(x.shape)} needs w_up/w_gate [.., {e}, {d}, F]"
                         f" and w_down [.., {e}, F, {d}], got {[tuple(w.shape) for w in weights]}")
    if any(w.dtype != x.dtype for w in weights):
        raise TypeError(f"fused_gemm_a2a: x is {x.dtype}, weights "
                        f"{[w.dtype for w in weights]}")
    if any(w.device != x.device for w in weights):
        raise ValueError(f"fused_gemm_a2a: x on {x.device}, weights on "
                         f"{[w.device for w in weights]}")
    return wire


def _launch(xr, wu, wg, wd, act, wire, comm_aware, skew):
    n, _, b, e, c, d = xr.shape
    f = wu.shape[-1]
    if not all(t.is_contiguous() for t in (xr, wu, wg, wd)):
        raise ValueError("fused_gemm_a2a: the kernel takes contiguous operands")
    if n > MAX_DEV:
        raise ValueError(f"fused_gemm_a2a: at most {MAX_DEV} ranks")
    wdt = wire_dtype(xr.dtype, wire)
    dev = xr.device
    out = torch.empty_like(xr)
    u = torch.empty((n, n, b, e, c, f), dtype=xr.dtype, device=dev)   # act(g) h, per rank
    # a narrowed wire lands in rx staging, widened into out at the end
    recv = out if n == 1 or wdt == xr.dtype else torch.empty(xr.shape, dtype=wdt, device=dev)
    ptr_array = ctypes.c_uint64 * n
    out_ptrs = ptr_array(*(out[r].data_ptr() for r in range(n)))
    recv_ptrs = ptr_array(*(recv[r].data_ptr() for r in range(n)))
    # per rank: one word per (group, F tile) for u, then one per
    # (source, group, D tile) for the y tiles arriving from each source
    tiles = -(-f // TILE) + -(-d // TILE)
    flags = peer_flags(dev, n, n * b * e * tiles)
    flag_ptrs = ptr_array(*(flags.words[r].data_ptr() for r in range(n)))
    sched = schedule_table(dev, n, 1, bool(comm_aware), int(skew))
    with torch.cuda.device(dev):
        lib = load_library().lib
        check_launch(lib.repro_fused_gemm_a2a(
            xr.data_ptr(), wu.data_ptr(), wg.data_ptr(), wd.data_ptr(), xr[0].numel(),
            wu[0].numel(), u.data_ptr(), u[0].numel(), out_ptrs, recv_ptrs, flag_ptrs,
            sched.data_ptr(), 0, n, n, b, e, c, d, f, flags.next_epoch(), ACT_CODES[act],
            dtype_code(xr.dtype), int(wdt != xr.dtype),
            torch.cuda.current_stream().cuda_stream), "fused_gemm_a2a")
    return out
