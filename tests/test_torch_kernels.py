"""The port's kernel modules against the JAX package's kernels.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as tests/test_kernels.py runs it on the CPU) and the
port's plain versions.  The CUDA kernels themselves run only on a card
(chip_smoke.py); here a CPU tensor takes each wrapper's plain version,
and the wrappers' input checks are exercised.  f32 matrix products run in
full f32 (TF32 off for cuBLAS and cuDNN).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce as jax_fused
from repro.kernels.gemv.ops import gemv as jax_gemv
from repro.kernels.tile_pipeline import step_schedule as jax_step_schedule
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.kernels import clamp_kernel_wire, source_digest
from repro_torch.kernels.fused_gemv_allreduce import ops as fused_ops
from repro_torch.kernels.fused_gemv_allreduce.ref import (
    fused_matmul_allreduce_ref, fused_matmul_allreduce_ref_ranks)
from repro_torch.kernels.gemv import ops as gemv_ops
from repro_torch.kernels.gemv.ref import gemv_ref
from repro_torch.kernels.tile_pipeline import step_schedule

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_parity_matrix.py: f32 sums in another order; one bf16
# rounding of each remote partial on the wire
TOL_F32 = dict(rtol=3e-4, atol=3e-4)
WIRE_TOL_BF16 = dict(rtol=3e-2, atol=3e-2)
N_DEV = 4


@pytest.fixture(scope="module")
def ctx4():
    return JaxContext.from_mesh(make_mesh((N_DEV,), ("model",)))


@pytest.mark.parametrize("rows,k,n", [(4, 32, 64), (1, 64, 32), (8, 16, 128),
                                      # many rows: the tile path's row blocks, one ragged
                                      (64, 32, 128), (130, 64, 256)])
@pytest.mark.parametrize("comm_aware", [True, False])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ref_ranks_matches_jax_kernel(ctx4, rng, rows, k, n, comm_aware, wire):
    """The 4-rank plain version against the JAX device-initiated kernel."""
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, w: jax_fused(
        ctx4, x, w, comm_aware=comm_aware, wire=wire))(x, w))
    k_loc = k // N_DEV
    x_ranks = torch.from_numpy(
        np.ascontiguousarray(x.reshape(rows, N_DEV, k_loc).transpose(1, 0, 2)))
    w_ranks = torch.from_numpy(w.reshape(N_DEV, k_loc, n))
    got = fused_matmul_allreduce_ref_ranks(x_ranks, w_ranks, wire, comm_aware)
    assert got.shape == (N_DEV, rows, n)
    tol = TOL_F32 if wire == "f32" else WIRE_TOL_BF16
    for r in range(N_DEV):
        np.testing.assert_allclose(got[r].numpy(), want, **tol)


@pytest.mark.parametrize("k,n", [(96, 128), (256, 64), (64, 32)])
@pytest.mark.parametrize("batched", [False, True])
def test_gemv_matches_jax_kernel(rng, k, n, batched):
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((4, k) if batched else (k,)).astype(np.float32)
    want = np.asarray(jax_gemv(x, w))
    got = gemv_ops.gemv(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL_F32)


def test_fused_ref_tp1_is_the_f32_product(rng):
    """At tp = 1 the kernel's result is the f32-accumulated product."""
    x = rng.standard_normal((4, 48)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32)
    got = fused_matmul_allreduce_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), x @ w, **TOL_F32)


def _cpu_case(name, rng):
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    if name == "gemv":
        return gemv_ops.gemv, (x, w), gemv_ref(x, w)
    if name == "fused":
        return (fused_ops.fused_matmul_allreduce, (x, w),
                fused_matmul_allreduce_ref(x, w))
    xr, wr = x.reshape(4, 4, 16).transpose(0, 1).contiguous(), w.reshape(4, 16, 128)
    return (fused_ops.fused_matmul_allreduce_ranks, (xr, wr),
            fused_matmul_allreduce_ref_ranks(xr, wr))


@pytest.mark.parametrize("name", ["gemv", "fused", "fused_ranks"])
def test_cpu_tensor_takes_plain_version(rng, name):
    """A CPU tensor gets the plain version's result and launches nothing."""
    fn, args, want = _cpu_case(name, rng)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "wire"])
def test_fused_wrapper_rejects_bad_input(bad):
    x, w = torch.zeros(4, 64), torch.zeros(64, 128)
    kwargs = {}
    if bad == "dtype":
        w = w.to(torch.bfloat16)
    elif bad == "shape":
        w = torch.zeros(32, 128)
    elif bad == "device":
        w = w.to("meta")
    else:
        kwargs["wire"] = "fp8"
    with pytest.raises((TypeError, ValueError)):
        fused_ops.fused_matmul_allreduce(x, w, **kwargs)


BF16, F32 = torch.bfloat16, torch.float32


DECODE_PATH = "tile" if fused_ops.TILE_ROWS <= 4 else "stream"


@pytest.mark.parametrize("dtype,rows,k,n,n_dev,aligned,want", [
    (BF16, 4, 13696, 4096, 1, True, DECODE_PATH),          # chatglm3-6b decode (w_down)
    (BF16, 4, 14336, 4096, 1, True, DECODE_PATH),          # rwkv6-7b decode (channel-mix w_v)
    (BF16, fused_ops.TILE_ROWS, 4096, 4096, 1, True, "tile"),
    (BF16, fused_ops.TILE_ROWS - 1, 4096, 4096, 1, True, "stream"),
    (BF16, 2048, 14336, 4096, 1, True, "tile"),            # rwkv6-7b prefill (channel-mix w_v)
    (BF16, 256, 3424, 4096, 4, True, "tile"),              # bn = 1024: 8 tiles per rank
    (F32, 2048, 4096, 4096, 1, True, "stream"),            # f32 stays exact on CUDA cores
    (F32, 4, 1000, 1000, 1, True, "stream"),               # 4000-byte rows: TMA takes them
    (BF16, 2048, 4100, 4096, 1, True, "stream"),           # K off TMA's 16-byte rows
    (BF16, 2048, 4096, 4064, 1, True, "stream"),           # N not whole 128-column tiles
    (BF16, 256, 3424, 4 * 96, 4, True, "stream"),          # bn = 96 not a multiple of 128
    (BF16, 4, 1000, 1001, 1, True, "panel"),               # rows of 2002 bytes: not for TMA
    (F32, 4, 1000, 1002, 1, True, "panel"),                # rows of 4008 bytes
    (F32, 8, 400000, 4096, 1, True, "panel"),              # x's slice past shared memory
    (BF16, 2048, 4096, 4096, 1, False, "panel"),           # an unaligned base
    (BF16, 4, 4096, 4096, 1, False, "panel"),
])
def test_fused_path_choice(dtype, rows, k, n, n_dev, aligned, want):
    assert fused_ops.fused_path(dtype, rows, k, n, n_dev, aligned) == want


@pytest.mark.parametrize("dtype,k,path", [(F32, 64, "tile"), (BF16, 60, "tile"),
                                          (BF16, 64, "simt")])
def test_fused_forced_path_rejects_what_it_cannot_take(dtype, k, path):
    """A forced path the shape does not fit raises before anything is
    launched (the GEMV path takes every shape the wrapper takes)."""
    x, w = torch.zeros(1, 4, k, dtype=dtype), torch.zeros(1, k, 256, dtype=dtype)
    with pytest.raises(ValueError):
        fused_ops._launch(x, w, "f32", True, path)


def test_gemv_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        gemv_ops.gemv(torch.zeros(4, 64), torch.zeros(32, 128))
    with pytest.raises(TypeError):
        gemv_ops.gemv(torch.zeros(4, 64), torch.zeros(64, 128, dtype=torch.bfloat16))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("tiles", [1, 2, 3])
@pytest.mark.parametrize("comm_aware", [True, False])
def test_step_schedule_matches_jax(n_dev, tiles, comm_aware):
    for skew in range(3):
        assert (step_schedule(n_dev, tiles, comm_aware, skew)
                == jax_step_schedule(n_dev, tiles, comm_aware, skew))


def test_clamp_kernel_wire_warns_once():
    op = "test_torch_kernels.clamp"
    with pytest.warns(UserWarning, match="clamps"):
        assert clamp_kernel_wire("fp8", op) == "bf16"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert clamp_kernel_wire("fp8", op) == "bf16"
        assert clamp_kernel_wire("f32", op) == "f32"


def test_source_digest_covers_every_source():
    """The build cache key changes with every CUDA source and header."""
    from repro_torch.kernels import CSRC

    names = {p.name for p in CSRC.glob("*.cu*")}
    assert {"gemv.cu", "fused_gemv_allreduce.cu", "tile_gemv.cuh"} <= names
    assert len(source_digest()) == 16 and source_digest() == source_digest()


def test_bf16_inputs_through_plain_versions(rng):
    """bf16 operands: f32 accumulation, one rounding to bf16 at the end."""
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = fused_matmul_allreduce_ref(xb, wb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                              preferred_element_type=jnp.float32).astype(jnp.bfloat16),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def _c_entries():
    """Every ``extern "C"`` function of the CUDA sources: name -> its
    parameters' C types (``void* p`` -> ``void*``)."""
    import re

    from repro_torch.kernels import CSRC

    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" [\w\s*]*?(\w+)\(([^)]*)\)',
                                       src.read_text()):
            out[name] = [" ".join(p.split()[:-1]) for p in params.split(",") if p.strip()]
    return out


_C_TYPES = {"int": "c_int", "unsigned": "c_uint", "long long": "c_longlong", "float": "c_float"}


@pytest.mark.parametrize("name", sorted(_c_entries()))
def test_c_entries_match_their_ctypes_declarations(name):
    """The argument list ctypes passes (``kernels._declare``) against the C
    signature, type by type: a scalar of the wrong width or a missing
    argument (a window or softcap added to one side only) would reach the
    kernel as garbage, on the card only."""
    import ctypes
    import types

    from repro_torch import kernels

    class Lib:
        def __getattr__(self, attr):
            setattr(self, attr, types.SimpleNamespace())
            return getattr(self, attr)

    lib = Lib()
    kernels._declare(lib)
    declared = getattr(lib, name).argtypes
    params = _c_entries()[name]
    assert len(declared) == len(params), (declared, params)
    for c_type, ct in zip(params, declared):
        base = c_type.replace("const ", "").strip()
        if "*" in base or base in ("void", "void*"):
            assert ct is ctypes.c_void_p or issubclass(ct, ctypes._Pointer) or \
                ct.__name__.startswith("LP_"), (c_type, ct)
        else:
            assert ct is getattr(ctypes, _C_TYPES[base]), (c_type, ct)
