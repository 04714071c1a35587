"""Plain PyTorch version of the GEMV kernel."""
import torch


def gemv_ref(x, w):
    """x: [B, K]; w: [K, N] -> [B, N] at x's dtype, summed in f32."""
    return (x.float() @ w.float()).to(x.dtype)
