"""PyTorch/CUDA port of the fused computation-collective system.

A second package beside the JAX reference ``repro``: it imports torch and
numpy, never jax and nothing of ``repro``.  Kernels are hand-written CUDA
for Hopper (``repro_torch.kernels``).
"""
