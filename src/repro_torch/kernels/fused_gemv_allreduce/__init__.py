"""Device-initiated fused GEMV + AllReduce kernel (port of repro.kernels.fused_gemv_allreduce)."""
