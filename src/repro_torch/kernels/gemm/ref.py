"""Plain PyTorch version of the GEMM kernel."""


def gemm_ref(x, w):
    """x [M, K] @ w [K, N] -> [M, N] at x's dtype, summed in f32."""
    return (x.float() @ w.float()).to(x.dtype)
