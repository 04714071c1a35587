"""Embedding-pool wrappers: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The kernel (``csrc/embedding_pool.cu``) has two paths: ``"ring"`` (rows by
bulk copies into a ring in shared memory, persistent CTAs), which takes
rows that are a whole number of 16-byte vectors at aligned tables, and
``"warp"`` (rows through registers, one warp a bag), which takes any.
Both give the same bits.
:func:`~repro_torch.kernels.embedding_pool.plan.bag_path` picks the warp
path for a one-rank call, the faster there on an H100.  The partition comes from
:func:`~repro_torch.kernels.embedding_pool.plan.call_plan`, sized on a card
from the CTAs it holds at once.

Both entries go through one ``torch.autograd.Function`` whose backward
raises: the TPU kernel has no VJP (``jax.grad`` through it raises, and so
does the reference's kernel-mode DLRM), and a ctypes launch is invisible to
autograd, so without it a gradient would be lost silently.  DLRM trains in
bulk or fused mode, whose pooling is the library's.  The backward raises on
the CPU too, where the plain version runs, so kernel mode behaves the same
on both devices.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library, sm_count
from repro_torch.kernels.embedding_pool.plan import PATHS, RING_BYTES, call_plan
from repro_torch.kernels.embedding_pool.ref import embedding_pool_tables_ref

NO_BACKWARD = ("the embedding_pool kernel has no backward, nor has the TPU kernel (jax.grad "
               "through the reference's kernel mode raises too): DLRM trains in bulk or fused "
               "mode")


def embedding_pool(table, idx):
    """table [V, D]; idx [B, L] int32 -> [B, D] mean-pooled bags (the JAX
    package's signature).  One launch of the table-batched kernel."""
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"embedding_pool: need table [V, D] and idx [B, L], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    return embedding_pool_tables(table[None], idx[:, None])[:, 0]


def embedding_pool_tables(tables, idx, *, _path=None, _ring_bytes=RING_BYTES):
    """tables [T, V, D] (f32 or bf16); idx [b, T, L] int32 -> [b, T, D].

    out[i, t] = mean over l of tables[t, idx[i, t, l]], summed in f32 in
    lookup order, divided by L once and cast to the tables' dtype.  One
    launch covers every table.  The indices are trusted, as the TPU kernel
    trusts them: an index outside [0, V) reads outside its table (checking
    would cost a host synchronisation).  A CUDA tensor launches
    ``csrc/embedding_pool.cu`` or raises, on the path ``bag_path`` chooses
    (the warp path: one rank) or ``_path`` (one of ``PATHS``, for timing
    both; a path that does not fit the call raises, on the CPU too);
    ``_ring_bytes`` sets the ring path's ring (for phase 14's sweep).  A CPU
    tensor takes the plain version."""
    if tables.dim() != 3 or idx.dim() != 3 or idx.shape[1] != tables.shape[0]:
        raise ValueError(f"embedding_pool: need tables [T, V, D] and idx [b, T, L], got "
                         f"{tuple(tables.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"embedding_pool: indices must be int32, got {idx.dtype}")
    if idx.shape[2] < 1:
        raise ValueError("embedding_pool: a bag needs at least one lookup")
    if tables.device != idx.device:
        raise ValueError(f"embedding_pool: tables on {tables.device} but idx on {idx.device}")
    dtype_code(tables.dtype)
    b, n_tab, _ = idx.shape
    capacity = (functools.partial(_ring_ctas, tables.get_device(), dtype_code(tables.dtype))
                if tables.is_cuda else None)
    plan = call_plan("embedding_pool", tables, 1, b, n_tab, _path, _ring_bytes,
                     capacity=capacity)
    return _Pool.apply(tables, idx, plan)


embedding_pool_tables.launches = 0
embedding_pool_tables.path_launches = dict.fromkeys(PATHS, 0)


@functools.lru_cache(maxsize=256)
def _ring_ctas(index, code, smem):
    """The ring kernel's CTAs the card holds at once at ``smem`` bytes of
    dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    regs, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        check_launch(load_library().lib.repro_embedding_pool_info(
            1, code, smem, ctypes.byref(regs), ctypes.byref(per_sm)), "embedding_pool capacity")
    return per_sm.value * sm_count(index)


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, idx, plan):
        if tables.device.type == "cpu":
            return embedding_pool_tables_ref(tables, idx)
        out = _launch(tables, idx, plan)
        embedding_pool_tables.launches += 1
        embedding_pool_tables.path_launches[plan.path] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(NO_BACKWARD)


def _launch(tables, idx, plan):
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_pool: the kernel takes contiguous tables and idx")
    n_tab, v, d = tables.shape
    b, _, L = idx.shape
    out = torch.empty((b, n_tab, d), dtype=tables.dtype, device=tables.device)
    with torch.cuda.device(tables.device):
        lib = load_library().lib
        check_launch(lib.repro_embedding_pool(
            tables.data_ptr(), v, idx.data_ptr(), out.data_ptr(), b, n_tab, L, d,
            dtype_code(tables.dtype), plan.slots, plan.ctas,
            torch.cuda.current_stream().cuda_stream), "embedding_pool")
    return out
