"""Stub modality front ends (backbone-only, as in the JAX package).

They produce the precomputed frame and patch embeddings that the
transformer merges into its input (``models/transformer._embed_inputs``):
deterministic, shape-correct and cheap stand-ins for EnCodec (musicgen) and
the dynamic-resolution ViT (qwen2-vl).  The embeddings are drawn from an
explicit ``torch.Generator`` on its own device; the reference draws from
``jax.random``, whose bits torch does not reproduce, so tests feed both
sides the same numpy arrays.  ``mrope_positions`` is the reference's numpy
integers exactly.
"""
from __future__ import annotations

import numpy as np
import torch


def audio_frame_embeddings(gen: torch.Generator, batch: int, seq: int, d_model: int,
                           dtype=torch.float32):
    """Stub EnCodec conditioning frames on ``gen``'s device: [B, S, D]."""
    return torch.randn((batch, seq, d_model), generator=gen, device=gen.device,
                       dtype=dtype) * 0.02


def vision_patch_embeddings(gen: torch.Generator, batch: int, seq: int, d_model: int,
                            n_patches: int, dtype=torch.float32):
    """Stub ViT patch embeddings occupying the first ``n_patches`` positions,
    on ``gen``'s device: (embeds [B, S, D], mask [S] bool)."""
    emb = torch.randn((batch, seq, d_model), generator=gen, device=gen.device,
                      dtype=dtype) * 0.02
    return emb, torch.arange(seq, device=gen.device) < n_patches


def mrope_positions(batch: int, seq: int, n_patches: int, grid_h: int = 0, device="cpu"):
    """Synthetic (t, h, w) position streams for M-RoPE, [3, B, S] int32:
    vision patches on a 2D grid of ``grid_h`` columns (default the square
    root of ``n_patches``), text tokens continuing with equal t/h/w
    positions from ``n_patches // grid_h + 1``."""
    g = grid_h or max(1, int(np.sqrt(max(n_patches, 1))))
    t = np.zeros((seq,), np.int32)
    h = np.zeros((seq,), np.int32)
    w = np.zeros((seq,), np.int32)
    for i in range(min(n_patches, seq)):
        h[i] = i // g
        w[i] = i % g
    base = (max(n_patches, 1) // g) + 1
    for i in range(n_patches, seq):
        t[i] = h[i] = w[i] = base + (i - n_patches)
    pos = np.stack([t, h, w])[:, None, :].repeat(batch, axis=1)
    return torch.from_numpy(pos).to(device)
