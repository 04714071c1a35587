"""Wrappers for the device-initiated dispatch All-to-All kernel.

A CUDA tensor launches ``csrc/fused_dispatch_a2a.cu`` or raises; a CPU
tensor takes the plain version in ``ref.py``.  There is no fallback from
one to the other.  A call launches from a plan built once per call
signature (shape, dtype, wire, chunks_per_rank, comm_aware, skew, device):
the checked wire and q, the schedule table, the flag words and a C plan
holding every constant argument and the grid, so that a repeated call
allocates its output and makes one foreign call.

:func:`fused_dispatch_a2a` is differentiable: the exchange is its own
adjoint, so its backward is the same kernel (on a CUDA tensor; the plain
version on a CPU one) applied to the cotangent, with the forward's
settings (the reference's ``custom_vjp``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.collectives import feasible_chunks_per_rank
from repro_torch.kernels import (PlanCache, check_launch, clamp_kernel_wire, dtype_code,
                                 launch_on, load_library, new_handle, peer_flags, schedule_table,
                                 wire_dtype)
from repro_torch.kernels.fused_dispatch_a2a.ref import (fused_dispatch_a2a_ref,
                                                        fused_dispatch_a2a_ref_ranks)

MAX_DEV = 8     # size of the kernel's peer pointer tables (kMaxDev)
REAL_PEERS_ITEM = ("ROADMAP Queue 1 item 1 (left: the real-peer half, symmetric-memory "
                   "pointer tables on a multi-card host)")
_PLANS = PlanCache()


def fused_dispatch_a2a(xt, *, comm_aware=True, chunks_per_rank=1, skew=0, wire="f32"):
    """One EP rank: xt [n, B, E_loc, C, D] stacked by destination rank ->
    the same shape stacked by source rank.

    The port's world is one card (n = 1), where the exchange keeps the
    rank's own block: the kernel copies it.  ``chunks_per_rank`` (a
    positive int) is clamped to the largest divisor of C no larger than
    it; ``wire="fp8"`` is clamped to bf16 with a one-time warning.  A CUDA
    tensor launches the kernel or raises.  Differentiable
    (:class:`_DispatchA2A`)."""
    kw = dict(comm_aware=comm_aware, chunks_per_rank=chunks_per_rank, skew=skew, wire=wire)
    if torch.is_grad_enabled() and xt.requires_grad:
        return _DispatchA2A.apply(kw, xt)
    return _dispatch_forward(xt, **kw)


class _DispatchA2A(torch.autograd.Function):
    """The exchange, and as its backward the same exchange of the cotangent."""

    @staticmethod
    def forward(fctx, kw, xt):
        fctx.kw = kw
        return _dispatch_forward(xt, **kw)

    @staticmethod
    def backward(fctx, g):
        return None, _dispatch_forward(g.contiguous(), **fctx.kw)


def _dispatch_forward(xt, *, comm_aware, chunks_per_rank, skew, wire):
    if not xt.is_cuda:
        _check(xt, 5, chunks_per_rank, wire)
        _one_rank(xt)
        return fused_dispatch_a2a_ref(xt)
    out = _run(xt, 5, chunks_per_rank, wire, comm_aware, skew)
    fused_dispatch_a2a.launches += 1
    return out


fused_dispatch_a2a.launches = 0


def fused_dispatch_a2a_ranks(x_ranks, *, comm_aware=True, chunks_per_rank=1, skew=0,
                             wire="f32"):
    """An n-rank world emulated on one device: x_ranks [n, n, B, E_loc, C, D]
    (rank, destination, ...) -> (rank, source, ...).

    On a card, one launch runs all n ranks (``gridDim.y = n``) with the full
    PUT / flag protocol between them, pointer tables aimed at per-rank
    slices of single allocations.  It exists to exercise that protocol on
    one card; the serving path calls :func:`fused_dispatch_a2a`."""
    if not x_ranks.is_cuda:
        wire, _ = _check(x_ranks, 6, chunks_per_rank, wire)
        _square(x_ranks)
        return fused_dispatch_a2a_ref_ranks(x_ranks, wire)
    out = _run(x_ranks, 6, chunks_per_rank, wire, comm_aware, skew)
    fused_dispatch_a2a_ranks.launches += 1
    return out


fused_dispatch_a2a_ranks.launches = 0


def _check(x, ndim, chunks_per_rank, wire):
    """(wire after the fp8 clamp, the feasible chunks_per_rank)."""
    wire = clamp_kernel_wire(wire, "fused_dispatch_a2a")
    wire_dtype(x.dtype, wire)
    dtype_code(x.dtype)
    if x.dim() != ndim:
        raise ValueError(f"fused_dispatch_a2a: need {ndim} dims [.., n, B, E_loc, C, D], "
                         f"got {tuple(x.shape)}")
    if isinstance(chunks_per_rank, bool) or not isinstance(chunks_per_rank, int) \
            or chunks_per_rank < 1:
        raise ValueError(f"fused_dispatch_a2a: chunks_per_rank must be a positive int, "
                         f"got {chunks_per_rank!r}")
    return wire, feasible_chunks_per_rank(x.shape[-2], 1, chunks_per_rank)


def _one_rank(x):
    if x.shape[0] != 1:
        raise NotImplementedError(f"fused_dispatch_a2a over {x.shape[0]} ranks needs "
                                  f"real peers: {REAL_PEERS_ITEM}")


def _square(x):
    if x.shape[0] != x.shape[1]:
        raise ValueError(f"fused_dispatch_a2a: {x.shape[0]} ranks hold blocks for "
                         f"{x.shape[1]} destinations")


def _run(x, ndim, chunks_per_rank, wire, comm_aware, skew):
    """Launch one rank's call (ndim 5) or the n-rank world (ndim 6) from its
    plan; a new signature is checked in full first."""
    key = (x.shape, x.dtype, x.get_device(), wire, chunks_per_rank, type(chunks_per_rank),
           comm_aware, skew)
    plan = _PLANS.get(key)
    if plan is None:
        wire, q = _check(x, ndim, chunks_per_rank, wire)
        if ndim == 5:
            _one_rank(x)
        else:
            _square(x)
        plan = _PLANS.put(key, _DispatchPlan(x if ndim == 6 else x[None], q, wire, comm_aware,
                                             skew))
    if not x.is_contiguous():
        raise ValueError("fused_dispatch_a2a: the kernel takes a contiguous x")
    out = torch.empty_like(x)
    check_launch(plan.launch(x.data_ptr(), out.data_ptr()), "fused_dispatch_a2a")
    return out


class _DispatchPlan:
    """What a call of one signature launches, built once: the schedule
    table, the flag words, the rx staging of a narrowed wire (reused call
    after call on the stream's order) and the C plan."""

    def __init__(self, xr, q, wire, comm_aware, skew):
        n, _, b, e, c, d = xr.shape
        if n > MAX_DEV:
            raise ValueError(f"fused_dispatch_a2a: at most {MAX_DEV} ranks")
        wdt = wire_dtype(xr.dtype, wire)
        dev = xr.device
        self.index = xr.get_device()
        self.flags, self.rx_ptr = None, None
        flag_ptrs = (ctypes.c_uint64 * n)()
        if n > 1:
            self.flags = peer_flags(dev, n, n * b * e * c)   # one word per (source, row) on each rank
            for r in range(n):
                flag_ptrs[r] = self.flags.words[r].data_ptr()
            if wdt != xr.dtype:
                # a narrowed wire lands in rx staging, widened into out at the end
                self.rx = torch.empty(xr.shape, dtype=wdt, device=dev)
                self.rx_ptr = self.rx.data_ptr()
        self.sched = schedule_table(dev, n, q, bool(comm_aware), int(skew))
        self.lib = load_library().lib
        with torch.cuda.device(self.index):
            self.handle = new_handle(self.lib.repro_dispatch_plan, flag_ptrs,
                                     self.sched.data_ptr(), 0, n, n, b, e, c, d, q,
                                     dtype_code(xr.dtype), int(wdt != xr.dtype),
                                     name="fused_dispatch_a2a")

    def launch(self, x_ptr, out_ptr) -> int:
        epoch = self.flags.next_epoch() if self.flags is not None else 0
        return launch_on(self.index, self.lib.repro_dispatch_launch, self.handle, x_ptr, out_ptr,
                         self.rx_ptr, epoch)

    def free(self):
        if self.handle is not None:
            self.lib.repro_dispatch_plan_free(self.handle)
            self.handle = None
