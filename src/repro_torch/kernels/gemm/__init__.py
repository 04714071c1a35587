"""Tiled GEMM kernel (port of repro.kernels.gemm)."""
