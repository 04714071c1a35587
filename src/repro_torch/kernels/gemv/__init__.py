"""Tiled GEMV kernel (port of repro.kernels.gemv)."""
