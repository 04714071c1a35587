"""Device-initiated MoE dispatch All-to-All (CUDA kernel + plain version)."""
