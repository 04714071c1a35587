"""Mean-pooled embedding gather (CUDA kernel + plain version)."""
