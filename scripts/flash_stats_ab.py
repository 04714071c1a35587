#!/usr/bin/env python3
"""The flash tile kernel with and without its softmax statistics, against
the kernel of a parent checkout that had none, on the card.

  git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
  python3 scripts/flash_stats_ab.py [--parent build/parent]

Builds ``flash_attention.cu`` of this checkout and of the parent (whose
``repro_flash_attention_tile`` takes no m/l pointers) into shared libraries
under ``build/flash_stats_ab/``, prints each build's registers, checks that
the three calls (parent; this checkout without statistics; with them) give
bit-identical outputs at chatglm3-6b's prefill shape ([4, 2048, 32/2, 128]
bf16, causal), and times them with CUDA events (200 launches each) in four
rounds of alternating order.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S, HQ, HKV, D = 4, 2048, 32, 2, 128


def build(srcs, out):
    from repro_torch.kernels import NVCC_FLAGS, _nvcc

    out.mkdir(parents=True, exist_ok=True)
    procs = {n: (out / f"flash_{n}.so", subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out / f"flash_{n}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for n, src in srcs.items()}
    libs = {}
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(log)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln][-1:]
        print(f"{n}: flash_tile_kernel {regs}", flush=True)
        libs[n] = ctypes.CDLL(str(so))
    return libs


def time_ms(torch, fn, iters=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_stats_ab: no CUDA device is available", file=sys.stderr)
        return 2
    csrc = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
    libs = build({"parent": Path(args.parent) / csrc, "change": ROOT / csrc},
                 ROOT / "build" / "flash_stats_ab")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["parent"].repro_flash_attention_tile.argtypes = [vp] * 4 + [i32] * 5 + [f32, i32, vp]
    libs["change"].repro_flash_attention_tile.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, vp]
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, HQ, D), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, HKV, D), generator=g, device="cuda").bfloat16() for _ in "kv")
    o = torch.empty_like(q)
    m, l = (torch.empty((B, HQ, S), device="cuda") for _ in "ml")
    ptrs = [t.data_ptr() for t in (q, k, v, o)]
    dims = (B, S, HQ, HKV, D, D ** -0.5, 1)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    calls = {
        "parent": lambda: libs["parent"].repro_flash_attention_tile(*ptrs, *dims, stream()),
        "change": lambda: libs["change"].repro_flash_attention_tile(*ptrs, None, None, *dims,
                                                                     stream()),
        "change+stats": lambda: libs["change"].repro_flash_attention_tile(
            *ptrs, m.data_ptr(), l.data_ptr(), *dims, stream()),
    }
    outs = {}
    for n, fn in calls.items():
        if fn() != 0:
            raise SystemExit(f"{n}: launch refused")
        torch.cuda.synchronize()
        outs[n] = o.clone()
    same = all(torch.equal(outs["parent"], x) for x in outs.values())
    times = {n: [] for n in calls}
    for order in (list(calls), list(calls)[::-1]) * 2:
        for n in order:
            times[n].append(time_ms(torch, calls[n]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; [{B},{S},{HQ}/{HKV},{D}] bf16 causal; outputs bit-identical: {same}")
    for n, ts in times.items():
        print(f"{n}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
