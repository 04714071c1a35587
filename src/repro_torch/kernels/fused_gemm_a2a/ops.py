"""Wrappers for the device-initiated expert FFN + combine All-to-All kernel.

Also home of the chained MoE entry: the dispatch kernel
(:mod:`repro_torch.kernels.fused_dispatch_a2a`) lands tokens in exactly the
by-source slot layout the FFN+combine kernel reads, so
:func:`fused_moe_chain` runs dispatch -> expert FFN -> combine as two
launches with nothing in between.  A CUDA tensor launches
``csrc/fused_gemm_a2a.cu`` or raises; a CPU tensor takes the plain version
in ``ref.py``.  There is no fallback from one to the other.

The kernel has three paths, chosen by :func:`gemm_a2a_path`: ``"stream"``
(decode rows, C <= 8: 128-column units on the streaming loop's TMA ring,
K split over a thread-block cluster, partition from :mod:`.plan`) wherever
TMA can read the weights; ``"tile"`` (prefill and training rows, C > 8, in
bf16 at widths TMA reads: ``csrc/tile_mma.cuh``'s tensor-core loop, u =
act(x w_gate) (x w_up) over [128, 64] blocks, then y = u w_down over [128,
128] blocks, two launches); ``"panel"`` (``csrc/tile_gemv.cuh``'s loop) for
the rest.  A call launches from a plan built once per call signature
(:class:`~repro_torch.kernels.PlanCache`): the tensor maps, grid, flag
words, schedule table and, on the stream and panel paths, the u scratch
(the tile path's u, [.., C, F] at x's dtype, comes from the caching
allocator on each call: at prefill rows it is hundreds of MB a capacity).

:func:`fused_gemm_a2a` and :func:`fused_dispatch_a2a` are differentiable.
The expert FFN's backward differentiates the plain version (``ref.py``:
the three einsums at x's dtype, then the exchange, the identity on one
rank) recomputed from the saved operands, as the reference's
``custom_vjp`` does; the kernel keeps g and h in f32 where the plain
version rounds them, so the gradient is that of the plain version at the
kernel's inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (PlanCache, check_launch, clamp_kernel_wire, cluster_capacity,
                                 dtype_code, launch_on, load_library, new_handle, peer_flags,
                                 schedule_table, sm_count, wire_dtype)
from repro_torch.kernels.fused_dispatch_a2a.ops import (MAX_DEV, REAL_PEERS_ITEM,
                                                        fused_dispatch_a2a)
from repro_torch.kernels.fused_gemm_a2a.plan import TILE_N, ffn_plan, ffn_stream_fits
from repro_torch.kernels.fused_gemm_a2a.ref import (ACTS, fused_gemm_a2a_ref,
                                                    fused_gemm_a2a_ref_ranks)
from repro_torch.kernels.gemv.plan import MAX_ROWS

PANEL_TILE = 32   # columns of u (F) or y (D) per panel item (kTileN in csrc/tile_gemv.cuh)
TILE_M = TILE_D = 128   # rows and y columns of a tile-path unit (kMmaBM, kMmaBN)
ACT_CODES = {name: i for i, name in enumerate(ACTS)}   # the kernel's `act` codes
PATHS = ("stream", "tile", "panel")
_PLANS = PlanCache()


def tile_fits(dtype, c, d, f, aligned=True) -> bool:
    """Whether the tile path takes a call: bf16 above ``MAX_ROWS`` capacity
    rows, D and F multiples of 8 (TMA's 16-byte rows), aligned operands."""
    return (dtype == torch.bfloat16 and c > MAX_ROWS and d % 8 == 0 and f % 8 == 0
            and aligned)


def gemm_a2a_path(dtype, n_dev, b, e, c, d, f, aligned=True) -> str:
    """The kernel path of one rank's call with x [n_dev, b, e, c, d] and
    weights [e, d, f] / [e, f, d]: ``"stream"`` where it fits
    (:func:`~repro_torch.kernels.fused_gemm_a2a.plan.ffn_stream_fits`: C <=
    8), ``"tile"`` where :func:`tile_fits` (bf16 prefill and training
    rows), else ``"panel"`` (f32 and ragged widths)."""
    if ffn_stream_fits(dtype, n_dev, b, e, c, d, f, aligned):
        return "stream"
    return "tile" if tile_fits(dtype, c, d, f, aligned) else "panel"


def fused_gemm_a2a(xt, w_up, w_gate, w_down, *, act="silu", comm_aware=True, skew=0,
                   wire="f32", _path=None):
    """One EP rank: xt [n, B, E_loc, C, D] stacked by combine destination,
    w_up/w_gate [E_loc, D, F], w_down [E_loc, F, D] -> [n, B, E_loc, C, D]
    stacked by source: act(x w_gate) (x w_up) w_down per block, then the
    combine All-to-All.

    The port's world is one card (n = 1), where the exchange keeps the
    rank's own block.  The kernel accumulates in f32 and rounds u and y to
    x's dtype; ``wire="fp8"`` is clamped to bf16 with a one-time warning.
    A CUDA tensor launches the kernel or raises, on the path
    :func:`gemm_a2a_path` chooses or ``_path`` (one of :data:`PATHS`, for
    timing them; a path that does not fit the call raises, on the CPU
    too).  Differentiable (:class:`_GemmA2A`: the plain version's VJP)."""
    args = (xt, w_up, w_gate, w_down)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _GemmA2A.apply(dict(act=act, comm_aware=comm_aware, skew=skew, wire=wire,
                                   _path=_path), *args)
    return _gemm_a2a_forward(*args, act=act, comm_aware=comm_aware, skew=skew, wire=wire,
                             _path=_path)


def _gemm_a2a_forward(xt, w_up, w_gate, w_down, *, act, comm_aware, skew, wire, _path):
    if not xt.is_cuda:
        wire = _check(xt, (w_up, w_gate, w_down), 5, act, wire)
        _one_rank(xt)
        _resolve_path(_path, xt[None], w_up, w_gate, w_down)
        return fused_gemm_a2a_ref(xt, w_up, w_gate, w_down, act)
    out, path = _run(xt, (w_up, w_gate, w_down), 5, act, wire, comm_aware, skew, _path)
    fused_gemm_a2a.launches += 1
    fused_gemm_a2a.path_launches[path] += 1
    return out


class _GemmA2A(torch.autograd.Function):
    """The kernel (or, on the CPU, its plain version) forward; the backward
    differentiates the plain version, ``fused_gemm_a2a_ref`` (the three
    einsums, then the one-rank exchange, which is the identity), recomputed
    from the saved operands."""

    @staticmethod
    def forward(fctx, kw, xt, w_up, w_gate, w_down):
        fctx.act = kw["act"]
        fctx.save_for_backward(xt, w_up, w_gate, w_down)
        return _gemm_a2a_forward(xt, w_up, w_gate, w_down, **kw)

    @staticmethod
    def backward(fctx, g):
        saved = fctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, fctx.needs_input_grad[1:])]
            y = fused_gemm_a2a_ref(*ins, fctx.act)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, g))
        return (None,) + tuple(next(got) if t.requires_grad else None for t in ins)


fused_gemm_a2a.launches = 0
fused_gemm_a2a.path_launches = dict.fromkeys(PATHS, 0)


def fused_gemm_a2a_ranks(x_ranks, wu_ranks, wg_ranks, wd_ranks, *, act="silu",
                         comm_aware=True, skew=0, wire="f32", _path=None):
    """An n-rank world emulated on one device: x_ranks [n, n, B, E_loc, C, D]
    (rank, destination, ...), per-rank weights [n, E_loc, D, F] /
    [n, E_loc, F, D] -> [n, n, B, E_loc, C, D] (rank, source, ...).

    On a card, one launch runs all n ranks (``gridDim.y = n``) with the full
    PUT / flag protocol between them.  It exists to exercise that protocol
    on one card; the serving path calls :func:`fused_gemm_a2a`."""
    if not x_ranks.is_cuda:
        wire = _check(x_ranks, (wu_ranks, wg_ranks, wd_ranks), 6, act, wire)
        _square(x_ranks, wu_ranks)
        _resolve_path(_path, x_ranks, wu_ranks, wg_ranks, wd_ranks)
        return fused_gemm_a2a_ref_ranks(x_ranks, wu_ranks, wg_ranks, wd_ranks, act, wire)
    out, path = _run(x_ranks, (wu_ranks, wg_ranks, wd_ranks), 6, act, wire, comm_aware, skew,
                     _path)
    fused_gemm_a2a_ranks.launches += 1
    fused_gemm_a2a_ranks.path_launches[path] += 1
    return out


fused_gemm_a2a_ranks.launches = 0
fused_gemm_a2a_ranks.path_launches = dict.fromkeys(PATHS, 0)


def fused_moe_chain(xt, w_up, w_gate, w_down, *, act="silu", comm_aware=True,
                    chunks_per_rank=1, skew=0, wire="f32", combine_wire=None):
    """Chained dispatch -> expert FFN -> combine for one EP rank.

    xt: [n, B, E_loc, C, D] stacked by dispatch destination.  The dispatch
    kernel's output (tokens stacked by source) is the FFN+combine kernel's
    input as it stands.  Returns blocks stacked by combine destination
    (= dispatch source): each rank's tokens come home.  ``wire`` is the
    dispatch's payload dtype, ``combine_wire`` (``None``: ``wire``) the
    combine's, as the autotuner decides each side apart.  ``launches``
    counts the chains that ran on a card, each one launch of either
    kernel."""
    xr = fused_dispatch_a2a(xt, comm_aware=comm_aware, chunks_per_rank=chunks_per_rank,
                            skew=skew, wire=wire)
    y = fused_gemm_a2a(xr, w_up, w_gate, w_down, act=act, comm_aware=comm_aware, skew=skew,
                       wire=wire if combine_wire is None else combine_wire)
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


def _one_rank(x):
    if x.shape[0] != 1:
        raise NotImplementedError(f"fused_gemm_a2a over {x.shape[0]} ranks needs real "
                                  f"peers: {REAL_PEERS_ITEM}")


def _square(x, w):
    if not x.shape[0] == x.shape[1] == w.shape[0]:
        raise ValueError(f"fused_gemm_a2a: x {tuple(x.shape)} and weights "
                         f"{tuple(w.shape)} disagree on the number of ranks")


def _resolve_path(path, xr, wu, wg, wd):
    """The path a call takes: ``path`` if given (raises where it does not
    fit the call), else :func:`gemm_a2a_path`'s choice.  ``xr`` is
    [n, n, B, E, C, D], with the rank axis even at n = 1."""
    n, _, b, e, c, d = xr.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (wu, wg, wd))
    chosen = gemm_a2a_path(xr.dtype, n, b, e, c, d, wu.shape[-1], aligned)
    if path is None:
        return chosen
    if path not in PATHS:
        raise ValueError(f"fused_gemm_a2a: path must be one of {PATHS}, got {path!r}")
    if path == "stream" and chosen != "stream":
        raise ValueError(f"fused_gemm_a2a: the stream path takes C <= 8 and weights whose D and F "
                         f"rows are a multiple of 16 bytes at aligned bases; got C={c}, D={d}, "
                         f"F={wu.shape[-1]} {xr.dtype}")
    if path == "tile" and not tile_fits(xr.dtype, c, d, wu.shape[-1], aligned):
        raise ValueError(f"fused_gemm_a2a: the tile path takes bf16 at C > {MAX_ROWS}, D and F "
                         f"multiples of 8, aligned weights; got C={c}, D={d}, F={wu.shape[-1]} "
                         f"{xr.dtype}")
    return path


def _run(x, weights, ndim, act, wire, comm_aware, skew, path):
    """Launch one rank's call (ndim 5) or the n-rank world (ndim 6) from its
    plan; a new signature is checked in full first.  Returns (out, path)."""
    key = (x.shape, x.dtype, x.get_device(),
           tuple((w.shape, w.dtype, w.get_device(), w.data_ptr()) for w in weights),
           act, wire, bool(comm_aware), int(skew), path)
    plan = _PLANS.get(key)
    if plan is None:
        wire = _check(x, weights, ndim, act, wire)
        if ndim == 5:
            _one_rank(x)
        else:
            _square(x, weights[0])
        lead = (lambda t: t) if ndim == 6 else (lambda t: t[None])
        plan = _PLANS.put(key, _GemmA2APlan(lead(x), *(lead(w) for w in weights), act, wire,
                                            comm_aware, skew, path), owner=tuple(weights))
    if not all(t.is_contiguous() for t in (x, *weights)):
        raise ValueError("fused_gemm_a2a: the kernel takes contiguous operands")
    out = torch.empty_like(x)
    check_launch(plan.launch(x.data_ptr(), out.data_ptr()), "fused_gemm_a2a")
    return out, plan.path


class _GemmA2APlan:
    """What a call of one signature launches, built once: the path, the
    schedule table, the flag words, the u scratch and, with a narrowed
    wire, the rx staging (both reused call after call on the stream's
    order), and the stream path's C plan or the panel path's constant
    arguments."""

    def __init__(self, xr, wu, wg, wd, act, wire, comm_aware, skew, path):
        n, _, b, e, c, d = xr.shape
        f = wu.shape[-1]
        if n > MAX_DEV:
            raise ValueError(f"fused_gemm_a2a: at most {MAX_DEV} ranks")
        self.path = _resolve_path(path, xr, wu, wg, wd)
        wdt = wire_dtype(xr.dtype, wire)
        dev, self.index = xr.device, xr.get_device()
        self.u_shape = (n, n, b, e, c, f)   # act(g) h, per rank
        # the tile path takes its u from the caching allocator at each call
        self.u = None if self.path == "tile" else torch.empty(self.u_shape, dtype=xr.dtype,
                                                              device=dev)
        # a narrowed wire lands in rx staging, widened into out at the end
        self.recv = None if n == 1 or wdt == xr.dtype else torch.empty(xr.shape, dtype=wdt,
                                                                       device=dev)
        # per rank: one word per (group, F tile) for u, then one per
        # (source, group, D tile) for the y tiles arriving from each source;
        # the tile path has no u words, and its y words are per (source,
        # group, row block, D tile)
        if self.path == "tile":
            words = n * b * e * -(-c // TILE_M) * -(-d // TILE_D)
        else:
            tile = TILE_N if self.path == "stream" else PANEL_TILE
            words = n * b * e * (-(-f // tile) + -(-d // tile))
        self.flags = peer_flags(dev, n, words)
        flag_ptrs = (ctypes.c_uint64 * n)(*(self.flags.words[r].data_ptr() for r in range(n)))
        self.sched = schedule_table(dev, n, 1, bool(comm_aware), int(skew))
        self.lib = load_library().lib
        code, wire_code = dtype_code(xr.dtype), int(wdt != xr.dtype)
        if self.path == "tile":
            self.handle = None
            self.flag_ptrs = flag_ptrs
            self.fixed = (wu.data_ptr(), wg.data_ptr(), wd.data_ptr())
            self.dims = (n, b, e, c, d, f, ACT_CODES[act])
        elif self.path == "stream":
            with torch.cuda.device(self.index):
                fp = ffn_plan(n, b, e, c, d, f, ranks_in_launch=n, sms=sm_count(self.index),
                              capacity=cluster_capacity(self.lib.repro_gemm_a2a_stream_capacity,
                                                        code, wire_code, name="fused_gemm_a2a"))
                if fp is None:
                    raise RuntimeError(f"fused_gemm_a2a: the card holds no cluster of the stream "
                                       f"path at C={c}, D={d}, F={f} over {n} ranks")
                self.handle = new_handle(
                    self.lib.repro_gemm_a2a_stream_plan, wu.data_ptr(), wg.data_ptr(),
                    wd.data_ptr(), flag_ptrs, self.sched.data_ptr(), 0, n, n, b, e, c, d, f,
                    fp.rows_per_block, fp.splits, fp.ks_up, fp.ks_down, ACT_CODES[act], code,
                    wire_code, name="fused_gemm_a2a")
            self.stream_plan = fp   # the partition, for the record (chip_smoke.py prints it)
        else:
            self.handle = None
            self.flag_ptrs = flag_ptrs
            self.fixed = (wu.data_ptr(), wg.data_ptr(), wd.data_ptr(), xr[0].numel(),
                          wu[0].numel(), self.u[0].numel())
            self.dims = (n, b, e, c, d, f, ACT_CODES[act], code, wire_code)

    def launch(self, x_ptr, out_ptr) -> int:
        epoch = self.flags.next_epoch()
        if self.path == "tile":
            n, b, e, c, d, f, act = self.dims
            u = torch.empty(self.u_shape, dtype=torch.bfloat16, device=self.flags.words.device)
            per_rank = n * b * e * c * d * 2
            out_ptrs = (ctypes.c_uint64 * n)(*(out_ptr + r * per_rank for r in range(n)))
            wu, wg, wd = self.fixed
            return launch_on(self.index, self.lib.repro_gemm_a2a_tile, x_ptr, wu, wg, wd,
                             u.data_ptr(), out_ptrs, self.flag_ptrs, self.sched.data_ptr(), 0,
                             n, n, b, e, c, d, f, epoch, act)
        u_ptr = self.u.data_ptr()
        if self.handle is not None:
            recv_ptr = out_ptr if self.recv is None else self.recv.data_ptr()
            return launch_on(self.index, self.lib.repro_gemm_a2a_stream_launch, self.handle,
                             x_ptr, u_ptr, out_ptr, recv_ptr, epoch)
        n, b, e, c, d, f, act, code, wire_code = self.dims
        per_rank = n * b * e * c * d
        ptr_array = ctypes.c_uint64 * n
        item = self.u.element_size()
        out_ptrs = ptr_array(*(out_ptr + r * per_rank * item for r in range(n)))
        recv_ptrs = out_ptrs if self.recv is None else ptr_array(
            *(self.recv[r].data_ptr() for r in range(n)))
        wu, wg, wd, x_stride, w_stride, u_stride = self.fixed
        return launch_on(self.index, self.lib.repro_fused_gemm_a2a, x_ptr, wu, wg, wd, x_stride,
                         w_stride, u_ptr, u_stride, out_ptrs, recv_ptrs, self.flag_ptrs,
                         self.sched.data_ptr(), 0, n, n, b, e, c, d, f, epoch, act, code,
                         wire_code)

    def free(self):
        if self.handle is not None:
            self.lib.repro_gemm_a2a_stream_plan_free(self.handle)
            self.handle = None
