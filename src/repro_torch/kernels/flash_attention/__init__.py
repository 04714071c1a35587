"""Causal flash-attention forward (CUDA kernel + plain version)."""
