"""Embedding-pool wrappers: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Both entries go through one ``torch.autograd.Function`` whose backward
raises: the TPU kernel has no VJP (``jax.grad`` through it raises), and a
ctypes launch is invisible to autograd, so without it a gradient would be
lost silently.  The backward raises on the CPU too, where the plain version
runs, so kernel mode behaves the same on both devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, dtype_code, load_library
from repro_torch.kernels.embedding_pool.ref import embedding_pool_tables_ref

_TRAIN_ITEM = "ROADMAP Queue 1 item 4 (training)"


def embedding_pool(table, idx):
    """table [V, D]; idx [B, L] int32 -> [B, D] mean-pooled bags (the JAX
    package's signature).  One launch of the table-batched kernel."""
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"embedding_pool: need table [V, D] and idx [B, L], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    return embedding_pool_tables(table[None], idx[:, None])[:, 0]


def embedding_pool_tables(tables, idx):
    """tables [T, V, D] (f32 or bf16); idx [b, T, L] int32 -> [b, T, D].

    out[i, t] = mean over l of tables[t, idx[i, t, l]], summed in f32 in
    lookup order, divided by L once and cast to the tables' dtype.  One
    launch covers every table.  The indices are trusted, as the TPU kernel
    trusts them: an index outside [0, V) reads outside its table (checking
    would cost a host synchronisation).  A CUDA tensor launches
    ``csrc/embedding_pool.cu`` or raises; a CPU tensor takes the plain
    version."""
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
    return _Pool.apply(tables, idx)


embedding_pool_tables.launches = 0


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, idx):
        if tables.device.type == "cpu":
            return embedding_pool_tables_ref(tables, idx)
        out = _launch(tables, idx)
        embedding_pool_tables.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(f"embedding_pool has no backward kernel (nor has the "
                                  f"TPU kernel): training DLRM is {_TRAIN_ITEM}")


def _launch(tables, idx):
    if not (tables.is_contiguous() and idx.is_contiguous()):
        raise ValueError("embedding_pool: the kernel takes contiguous tables and idx")
    n_tab, v, d = tables.shape
    b, _, L = idx.shape
    out = torch.empty((b, n_tab, d), dtype=tables.dtype, device=tables.device)
    with torch.cuda.device(tables.device):
        lib = load_library().lib
        check_launch(lib.repro_embedding_pool(
            tables.data_ptr(), v, idx.data_ptr(), out.data_ptr(), b, n_tab, L, d,
            dtype_code(tables.dtype), torch.cuda.current_stream().cuda_stream),
            "embedding_pool")
    return out
