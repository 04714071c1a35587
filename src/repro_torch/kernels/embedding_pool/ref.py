"""Plain PyTorch versions of the embedding-pool kernel."""
import torch


def embedding_pool_ref(table, idx):
    """table [V, D]; idx [B, L] -> [B, D]: the gathered rows' mean, taken in
    f32 and cast to the table's dtype, as the JAX ``embedding_pool_ref``."""
    return table[idx].float().mean(dim=1).to(table.dtype)


def embedding_pool_tables_ref(tables, idx):
    """tables [T, V, D]; idx [b, T, L] -> [b, T, D], one table at a time,
    so the gather's transient is [b, L, D], never [b, T, L, D]."""
    return torch.stack([embedding_pool_ref(tables[t], idx[:, t])
                        for t in range(tables.shape[0])], dim=1)
