#!/usr/bin/env python3
"""The flash kernels of this checkout (with a sliding window and a softcap)
against those of a parent checkout that had neither, on the card.

  git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
  python3 scripts/flash_window_ab.py [--parent build/parent]

Builds ``flash_attention.cu`` of both checkouts into shared libraries under
``build/flash_window_ab/``, prints each build's ptxas lines for the tile
kernel (registers, and where ptxas injected warpgroup waits: the line
number is a measure of the kernel's size), checks that without a window
and a cap both give bit-identical outputs on both paths, and times with
CUDA events (100 launches each, four rounds in alternating order) at
chatglm3-6b's prefill shape [4, 2048, 32/2, 128] and gemma2-27b's head
layout [4, 2048, 32/16, 128], bf16, causal: the parent, this checkout
without the cap, and with gemma2's cap of 50.  Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S, HQ, D = 4, 2048, 32, 128


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
        lines = log.splitlines()
        tile = [i for i, ln in enumerate(lines) if "Compiling entry" in ln and "flash_tile" in ln]
        for i in tile:
            info = [ln.strip() for ln in lines[i:i + 4] if "registers" in ln or "spill" in ln]
            print(f"{n}: {lines[i].split()[-3]} {info}", flush=True)
        print(f"{n}: " + " | ".join(ln.split("ptxas info    : ")[-1][:90] for ln in lines
                                    if "C7519" in ln and "flash_tile" in ln), flush=True)
        libs[n] = ctypes.CDLL(str(so))
    return libs


def time_ms(torch, fn, iters=100):
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
        print("flash_window_ab: no CUDA device is available", file=sys.stderr)
        return 2
    csrc = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
    libs = build({"parent": Path(args.parent) / csrc, "change": ROOT / csrc},
                 ROOT / "build" / "flash_window_ab")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["parent"].repro_flash_attention_tile.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, vp]
    libs["parent"].repro_flash_attention.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, i32, vp]
    libs["change"].repro_flash_attention_tile.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, i32,
                                                                                f32, vp]
    libs["change"].repro_flash_attention.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, i32, f32,
                                                                           i32, vp]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    same_all = True
    for hkv in (2, 16):
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((B, S, HQ, D), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, hkv, D), generator=g, device="cuda").bfloat16() for _ in "kv")
        o = torch.empty_like(q)
        ptrs = [t.data_ptr() for t in (q, k, v, o)] + [None, None]
        dims = (B, S, HQ, hkv, D, D ** -0.5, 1)
        calls = {
            "parent": lambda: libs["parent"].repro_flash_attention_tile(*ptrs, *dims, stream()),
            "change": lambda: libs["change"].repro_flash_attention_tile(*ptrs, *dims, 0, 0.0,
                                                                         stream()),
            "change cap 50": lambda: libs["change"].repro_flash_attention_tile(
                *ptrs, *dims, 0, 50.0, stream()),
        }
        outs = {}
        for n, fn in calls.items():
            if fn() != 0:
                raise SystemExit(f"{n}: launch refused")
            torch.cuda.synchronize()
            outs[n] = o.clone()
        # and the CUDA-core path, once, for bits
        for n, fn in (("parent", lambda: libs["parent"].repro_flash_attention(*ptrs, *dims, 1,
                                                                            stream())),
                      ("change", lambda: libs["change"].repro_flash_attention(
                          *ptrs, *dims, 0, 0.0, 1, stream()))):
            if fn() != 0:
                raise SystemExit(f"{n} CUDA-core path: launch refused")
            torch.cuda.synchronize()
            outs[f"{n} cuda_core"] = o.clone()
        same = (torch.equal(outs["parent"], outs["change"])
                and torch.equal(outs["parent cuda_core"], outs["change cuda_core"]))
        same_all &= same
        times = {n: [] for n in calls}
        for order in (list(calls), list(calls)[::-1]) * 2:
            for n in order:
                times[n].append(time_ms(torch, calls[n]))
        print(f"{card}; [{B},{S},{HQ}/{hkv},{D}] bf16 causal, tile path; parent and change "
              f"bit-identical without window and cap (tile and CUDA-core paths): {same}")
        for n, ts in times.items():
            print(f"  {n}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
