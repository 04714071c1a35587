"""Device-initiated fused embedding pooling + All-to-All (CUDA kernel + plain version)."""
