"""The port's GEMM op against the JAX package's GEMM kernel.

The same numpy inputs, made from a seed, go through the JAX ``gemm`` (its
Pallas kernel in interpret mode, as the JAX package's own tests run it) and
the port's ``gemm``, which on the CPU runs its plain version (the CUDA
kernel runs only on a card, in chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_parity_matrix import TOL

from repro.kernels.gemm.ops import gemm as jax_gemm
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ref import gemm_ref

torch.backends.cuda.matmul.allow_tf32 = False


def _operands(rng, m, k, n, dtype):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    if dtype == "bf16":
        x, w = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, w))
    return x, w


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,k,n", [(64, 96, 128), (128, 128, 64), (32, 64, 32), (16, 256, 16),
                                   # ragged M, N and K: whole-dimension blocks in the reference
                                   (33, 100, 7), (1, 5, 3), (9, 257, 129)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gemm_matches_jax_kernel(rng, m, k, n, dtype):
    x, w = _operands(rng, m, k, n, dtype)
    want = np.asarray(jax_gemm(x, w).astype(jnp.float32))
    gemm_ops.gemm.launches = 0
    got = gemm_ops.gemm(_torch(x), _torch(w), bm=64, bn=64, bk=32)
    assert gemm_ops.gemm.launches == 0                 # the CPU takes the plain version
    assert got.shape == (m, n) and got.dtype == _torch(x).dtype
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    torch.testing.assert_close(got, gemm_ref(_torch(x), _torch(w)), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["inner", "ndim", "dtypes", "f64"])
def test_gemm_wrapper_rejects_bad_input(bad):
    x, w = torch.ones(4, 3), torch.ones(3, 5)
    err = {"dtypes": TypeError, "f64": TypeError}.get(bad, ValueError)
    args = {"inner": (x, w[:2]), "ndim": (x[0], w), "dtypes": (x, w.to(torch.bfloat16)),
            "f64": (x.double(), w.double())}[bad]
    with pytest.raises(err):
        gemm_ops.gemm(*args)


@pytest.mark.parametrize("dtype,k,n,aligned,want", [
    (torch.bfloat16, 4096, 4096, True, "tile"),
    (torch.bfloat16, 4104, 1032, True, "tile"),            # ragged edges: TMA zero-fills
    (torch.bfloat16, 64, 8, True, "tile"),
    (torch.float32, 4096, 4096, True, "cuda_core"),        # tensor cores would be TF32
    (torch.bfloat16, 4097, 1000, True, "cuda_core"),       # K off TMA's 16-byte rows
    (torch.bfloat16, 1000, 4097, True, "cuda_core"),       # N off them
    (torch.bfloat16, 4096, 4096, False, "cuda_core"),      # an unaligned base
])
def test_gemm_path_choice(dtype, k, n, aligned, want):
    assert gemm_ops.gemm_path(dtype, k, n, aligned) == want
