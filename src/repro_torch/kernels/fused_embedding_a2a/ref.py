"""Plain PyTorch version of the fused embedding + All-to-All kernel.

Every rank holds ``T_loc`` tables and the indices of the *global* batch on
them; it pools all of them and owes each rank the fragment of pooled vectors
for that rank's batch shard, which lands at this source's table columns."""
import torch

from repro_torch.kernels.embedding_pool.ref import embedding_pool_tables_ref


def fused_embedding_a2a_ref(all_tables, idx):
    """Global semantics given every rank's shards, as the JAX
    ``fused_embedding_a2a_ref``.

    all_tables [n, T_loc, V, D]; idx [n, B, T_loc, L] (per source rank)
    -> [n, B_loc, n * T_loc, D] per destination rank, where
    out[dst, b, s * T_loc + t] = mean_l all_tables[s, t, idx[s, dst * B_loc + b, t, l]].
    The destination order (``comm_aware``) does not change the result."""
    n, t_loc, _, d = all_tables.shape
    b_loc = idx.shape[1] // n
    pooled = torch.stack([embedding_pool_tables_ref(all_tables[s], idx[s])
                          for s in range(n)])           # [src, B, T_loc, D]
    return (pooled.view(n, n, b_loc, t_loc, d)           # [src, dst, b, t, D]
            .permute(1, 2, 0, 3, 4).reshape(n, b_loc, n * t_loc, d))


# The emulated world's oracle: fused_embedding_a2a_ranks takes every rank's
# shards, which is the reference oracle's own signature.
fused_embedding_a2a_ref_ranks = fused_embedding_a2a_ref
