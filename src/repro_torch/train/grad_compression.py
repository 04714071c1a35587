"""Compressed gradient reduction with error feedback.

Two schemes, both with error-feedback residuals so the compression error
is re-injected next step:

  int8:  per-tensor symmetric quantization (scale max|g| / 127);
  topk:  magnitude top-k sparsification (k = ``topk_ratio`` of the entries);
         everything else accumulates in the residual.

They wrap the gradients before the optimizer, after the JAX package's
``train/grad_compression.py``.  On one card there is no data-parallel
reduction for the payload to shrink, so this models the compression loss
and the error feedback only; gradients and residuals are updated in place.
As in the reference, whose layers are stacked, a layer leaf is compressed
together with the same leaf of every other layer at its position of the
layer pattern (one int8 scale, one top-k over the stack:
``optimizer.leaf_groups``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train.optimizer import leaf_groups, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"          # none | int8 | topk
    topk_ratio: float = 0.01


def init_residuals(cfg: CompressionConfig, params):
    if cfg.scheme == "none":
        return {}
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _int8_scale(gs):
    return torch.clamp_min(torch.stack([g.abs().max() for g in gs]).max(), 1e-12) / 127.0


def _quantize_int8(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _dequantize_int8(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_decompress(cfg: CompressionConfig, grads, residuals, period: int = 1):
    """Compress each gradient group plus its residuals; returns (the
    gradients, overwritten with their decompressed values, and the
    residuals, updated in place with what the compression dropped).
    ``period``: the model's layer pattern (``optimizer.leaf_groups``)."""
    if cfg.scheme == "none":
        return grads, residuals
    if cfg.scheme not in ("int8", "topk"):
        raise ValueError(cfg.scheme)
    for (_, gs, _), (_, rs, _) in zip(leaf_groups(grads, period),
                                      leaf_groups(residuals, period)):
        g32 = [g.float() + r for g, r in zip(gs, rs)]
        if cfg.scheme == "int8":
            scale = _int8_scale(g32)
            kept = [_dequantize_int8(_quantize_int8(x, scale), scale) for x in g32]
        else:
            flat = torch.cat([x.reshape(-1) for x in g32])
            k = max(1, int(flat.numel() * cfg.topk_ratio))
            idx = torch.topk(flat.abs(), k).indices
            flat = torch.zeros_like(flat).index_copy_(0, idx, flat[idx])
            kept = [c.view(x.shape) for c, x in zip(flat.split([x.numel() for x in g32]), g32)]
        for g, r, x, c in zip(gs, rs, g32, kept):
            r.copy_(x - c)
            g.copy_(c)
    return grads, residuals
