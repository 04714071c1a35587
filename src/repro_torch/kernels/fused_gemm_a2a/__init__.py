"""Device-initiated expert FFN + combine All-to-All (CUDA kernel + plain version)."""
