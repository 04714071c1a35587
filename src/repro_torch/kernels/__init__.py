"""Hand-written Hopper (sm_90a) kernels for the compute hot spots.

Each kernel package holds:
  ref.py  - the plain PyTorch version (the CPU path and the on-card oracle)
  ops.py  - the wrapper: checks its inputs, allocates outputs and scratch,
            launches the CUDA kernel on PyTorch's current stream for a CUDA
            tensor, calls ``ref.py`` for a CPU tensor, and counts launches
The CUDA C++ sources live in ``csrc/``.  :func:`load_library` compiles them
with ``nvcc`` into one shared library with a plain C interface the first time
a kernel is launched (and again whenever a source changes) and loads it with
``ctypes``.  Nothing is compiled or loaded at import time, so every module
imports on a machine without CUDA.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import warnings
import weakref
from pathlib import Path

import torch

from repro_torch.kernels.tile_pipeline import step_schedule

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/repro_torch (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_FP8_CLAMP_WARNED: set = set()


def clamp_kernel_wire(wire: str, op: str) -> str:
    """Device-initiated kernels stage PUT payloads at the wire dtype but
    have no per-chunk-scale path, so ``"fp8"`` is clamped to ``"bf16"``.
    Warns once per op family so ``--wire fp8`` users see the clamp."""
    if wire != "fp8":
        return wire
    if op not in _FP8_CLAMP_WARNED:
        _FP8_CLAMP_WARNED.add(op)
        warnings.warn(
            f"{op}: wire='fp8' is an XLA-path feature (per-chunk scale); "
            f"the device-initiated kernel clamps the PUT payload to bf16",
            stacklevel=3)
    return "bf16"


def wire_dtype(dtype: torch.dtype, wire: str) -> torch.dtype:
    """PUT payload dtype: ``"f32"`` keeps the compute dtype on the wire;
    ``"bf16"`` narrows an f32 payload to bf16."""
    if wire not in ("f32", "bf16"):
        raise ValueError(f"kernel wire dtype must be 'f32' or 'bf16', got {wire!r}")
    return torch.bfloat16 if wire == "bf16" and dtype.itemsize > 2 else dtype


class PeerFlags:
    """Flag words of an n-rank world, ``words_per_rank`` per rank, zeroed
    once.

    Each call publishes a new epoch, so the words never need resetting;
    0 is never an epoch, and a wait compares with the current epoch only,
    so kernels may share words."""

    def __init__(self, n_dev, words_per_rank, device):
        self.words = torch.zeros((n_dev, words_per_rank), dtype=torch.int32,
                                 device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch = self.epoch % 0xFFFFFFFF + 1
        return self.epoch


@functools.lru_cache(maxsize=64)
def peer_flags(device, n_dev, words_per_rank) -> PeerFlags:
    return PeerFlags(n_dev, words_per_rank, device)


@functools.lru_cache(maxsize=64)
def schedule_table(device, n_dev, subs_per_rank, comm_aware, skew=0):
    """The step schedule as a device table [offsets | sub-chunks], copied
    to the card once per shape rather than once per call."""
    offs, subs = step_schedule(n_dev, subs_per_rank, comm_aware, skew)
    return torch.tensor(offs + subs, dtype=torch.int32, device=device)


def source_digest() -> str:
    """Hash of every CUDA source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return found


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date build was loaded
    build_log: str         # nvcc/ptxas output of the build ("" when loaded)


def _build(target: Path) -> str:
    """Compile each source in parallel (one nvcc each), then link."""
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        so_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so_tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, target)   # atomic: a reader never sees half a file
    return "\n".join(log)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptrs = ctypes.POINTER(ctypes.c_uint64)
    lib.repro_gemv.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.repro_gemv.restype = i32
    lib.repro_fused_gemv_allreduce.argtypes = [
        vp, vp, i64, i64, ptrs, ptrs, ptrs, vp, i32, i32, i32, i32, i32, i32,
        i32, ctypes.c_uint, i32, i32, vp]
    lib.repro_fused_gemv_allreduce.restype = i32
    lib.repro_fused_gemm_allreduce_tile.argtypes = [
        vp, vp, ptrs, ptrs, ptrs, vp, i32, i32, i32, i32, i32, i32, i32, ctypes.c_uint, vp]
    lib.repro_fused_gemm_allreduce_tile.restype = i32
    handle = ctypes.POINTER(vp)
    lib.repro_gemv_stream_plan.argtypes = [handle, vp, i32, i32, i32, i32, i32, i32, i32]
    lib.repro_gemv_stream_plan.restype = i32
    lib.repro_fused_stream_plan.argtypes = [
        handle, vp, ptrs, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32]
    lib.repro_fused_stream_plan.restype = i32
    lib.repro_stream_capacity.argtypes = [i32, i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
    lib.repro_stream_capacity.restype = i32
    lib.repro_stream_launch.argtypes = [vp, vp, vp, vp, ctypes.c_uint, vp]
    lib.repro_stream_launch.restype = i32
    lib.repro_stream_plan_free.argtypes = [vp]
    lib.repro_stream_plan_free.restype = None
    lib.repro_dispatch_plan.argtypes = [
        handle, ptrs, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32]
    lib.repro_dispatch_plan.restype = i32
    lib.repro_dispatch_launch.argtypes = [vp, vp, vp, vp, ctypes.c_uint, vp]
    lib.repro_dispatch_launch.restype = i32
    lib.repro_dispatch_plan_free.argtypes = [vp]
    lib.repro_dispatch_plan_free.restype = None
    lib.repro_fused_gemm_a2a.argtypes = [
        vp, vp, vp, vp, i64, i64, vp, i64, ptrs, ptrs, ptrs, vp, i32, i32,
        i32, i32, i32, i32, i32, i32, ctypes.c_uint, i32, i32, i32, vp]
    lib.repro_fused_gemm_a2a.restype = i32
    lib.repro_gemm_a2a_stream_plan.argtypes = [
        handle, vp, vp, vp, ptrs, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, i32]
    lib.repro_gemm_a2a_stream_plan.restype = i32
    lib.repro_gemm_a2a_stream_capacity.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
    lib.repro_gemm_a2a_stream_capacity.restype = i32
    lib.repro_gemm_a2a_stream_launch.argtypes = [vp, vp, vp, vp, vp, ctypes.c_uint, vp]
    lib.repro_gemm_a2a_stream_launch.restype = i32
    lib.repro_gemm_a2a_stream_plan_free.argtypes = [vp]
    lib.repro_gemm_a2a_stream_plan_free.restype = None
    lib.repro_gemm_a2a_tile.argtypes = [
        vp, vp, vp, vp, vp, ptrs, ptrs, vp, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_uint, i32, vp]
    lib.repro_gemm_a2a_tile.restype = i32
    lib.repro_embedding_pool.argtypes = [vp, i64, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.repro_embedding_pool.restype = i32
    lib.repro_fused_embedding_a2a.argtypes = [
        vp, i64, i64, vp, i64, ptrs, ptrs, vp, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_uint, i32, i32, i32, i32, vp]
    lib.repro_fused_embedding_a2a.restype = i32
    lib.repro_embedding_pool_info.argtypes = [i32, i32, i32, ctypes.POINTER(i32),
                                              ctypes.POINTER(i32)]
    lib.repro_embedding_pool_info.restype = i32
    lib.repro_fused_embedding_a2a_info.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32),
                                                   ctypes.POINTER(i32)]
    lib.repro_fused_embedding_a2a_info.restype = i32
    lib.repro_wkv6.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.repro_wkv6.restype = i32
    lib.repro_gemm.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.repro_gemm.restype = i32
    lib.repro_gemm_tile.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.repro_gemm_tile.restype = i32
    f32 = ctypes.c_float
    lib.repro_flash_attention.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                          i32, f32, i32, i32, f32, i32, vp]
    lib.repro_flash_attention.restype = i32
    lib.repro_flash_attention_tile.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                               i32, i32, f32, i32, i32, f32, vp]
    lib.repro_flash_attention_tile.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if the sources changed) and load the kernels' shared library."""
    target = BUILD_DIR / f"librepro_torch_{source_digest()}.so"
    seconds, log = 0.0, ""
    if not target.exists():
        t0 = time.perf_counter()
        log = _build(target)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return KernelLibrary(lib=lib, path=target, build_seconds=seconds,
                         build_log=log)


def check_launch(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = load_library().lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({code})")


class PlanCache:
    """Launch plans cached per call signature.

    A wrapper looks its call's key up here first and builds a plan only for
    a new key, so a repeated call skips the checks, the schedule and flag
    lookups and the marshalling of constant arguments.  A plan made for one
    weight tensor (``owner``) goes when that tensor is freed, so a model's
    plans live as long as its weights.  Past ``size`` plans the least
    recently used goes first.  A plan's ``free`` method (a C plan's) is
    called when it goes."""

    def __init__(self, size=1024):
        self.size = size
        self.plans: collections.OrderedDict = collections.OrderedDict()  # key -> (plan, finalizer)

    def __len__(self):
        return len(self.plans)

    def get(self, key):
        entry = self.plans.get(key)
        if entry is None:
            return None
        self.plans.move_to_end(key)
        return entry[0]

    def put(self, key, plan, owner=None):
        """Keep ``plan`` under ``key``; with an ``owner`` tensor (or a tuple
        of them), until it (or the tensor it is a view of) is freed: the
        first of them to go takes the plan with it."""
        while len(self.plans) >= self.size:
            self.drop(next(iter(self.plans)))
        owners = () if owner is None else owner if isinstance(owner, tuple) else (owner,)
        done = []
        for o in owners:
            f = weakref.finalize(o if o._base is None else o._base, self.drop, key)
            f.atexit = False
            done.append(f)
        self.plans[key] = (plan, done)
        return plan

    def drop(self, key):
        """Forget ``key``'s plan, if any, and free it."""
        plan, done = self.plans.pop(key, (None, ()))
        for f in done:
            f.detach()
        if hasattr(plan, "free"):
            plan.free()


@functools.cache
def _raw_stream_getter():
    # the current stream's handle as an int, without building a Stream object
    return getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(index: int) -> int:
    """The handle of PyTorch's current stream on device ``index``."""
    get = _raw_stream_getter()
    return get(index) if get is not None else torch.cuda.current_stream(index).cuda_stream


def launch_on(index: int, launch, *args) -> int:
    """``launch(*args, stream)`` on PyTorch's current stream of device
    ``index``, entering that device only when it is not the current one."""
    if torch.cuda.current_device() == index:
        return launch(*args, stream_handle(index))
    with torch.cuda.device(index):
        return launch(*args, stream_handle(index))


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_capacity(query, *args, name: str):
    """A ``capacity(splits, rows_per_block, ks)`` for
    :func:`~repro_torch.kernels.gemv.plan.stream_plan` that asks the card
    through ``query(*args, rows_per_block, splits, ks, &clusters)``; call
    it on the device the plan is for."""
    def capacity(splits, rows_per_block, ks):
        got = ctypes.c_int()
        check_launch(query(*args, rows_per_block, splits, ks, ctypes.byref(got)), name)
        return got.value
    return capacity


def new_handle(build, *args, name: str) -> ctypes.c_void_p:
    """A C plan handle from ``build(&handle, *args)``; raises if refused."""
    h = ctypes.c_void_p()
    check_launch(build(ctypes.byref(h), *args), name)
    return h


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' element-type code."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
