#!/usr/bin/env python3
"""The flash kernels of this checkout (keys of their own length Sk at an
offset delta from the queries, for the KV ring) against those of a parent
checkout that had one S for both, on the card.

  git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
  python3 scripts/flash_ring_ab.py [--parent build/parent]

Builds ``flash_attention.cu`` of both checkouts into shared libraries under
``build/flash_ring_ab/`` (one nvcc each, in parallel), prints each build's
registers and spills for the tile kernel, checks that with Sk = Sq and
delta = 0 both give bit-identical outputs and statistics on both paths
(causal, non-causal, and gemma2's window and cap), and times both with CUDA
events (100 launches each, four rounds in alternating order) at chatglm3-6b's
prefill shape [4, 2048, 32/2, 128] and gemma2-27b's head layout [4, 2048,
32/16, 128] with its window of 1024 and cap of 50, bf16, causal.  Prints one
A/B line a shape.  Needs one CUDA card and ``nvcc``.
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
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "flash_tile" in ln:
                info = [x.strip() for x in lines[i:i + 4] if "registers" in x or "spill" in x]
                print(f"{n}: {ln.split()[-3]} {info}", flush=True)
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
        print("flash_ring_ab: no CUDA device is available", file=sys.stderr)
        return 2
    csrc = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
    libs = build({"parent": Path(args.parent) / csrc, "change": ROOT / csrc},
                 ROOT / "build" / "flash_ring_ab")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the parent: (q, k, v, o, m, l, B, S, Hq, Hkv, D, scale, causal, window, softcap[, dtype],
    # stream); the change adds Sk and delta after S
    libs["parent"].repro_flash_attention_tile.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, i32,
                                                                                f32, vp]
    libs["parent"].repro_flash_attention.argtypes = [vp] * 6 + [i32] * 5 + [f32, i32, i32, f32,
                                                                           i32, vp]
    libs["change"].repro_flash_attention_tile.argtypes = [vp] * 6 + [i32] * 7 + [f32, i32, i32,
                                                                                f32, vp]
    libs["change"].repro_flash_attention.argtypes = [vp] * 6 + [i32] * 7 + [f32, i32, i32, f32,
                                                                           i32, vp]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    same_all = True
    for hkv, window, cap in ((2, 0, 0.0), (16, 1024, 50.0)):
        g = torch.Generator(device="cuda").manual_seed(0)
        q = (torch.randn((B, S, HQ, D), generator=g, device="cuda") * (20.0 if cap else 1.0)
             ).bfloat16()
        k, v = (torch.randn((B, S, hkv, D), generator=g, device="cuda").bfloat16() for _ in "kv")
        o = torch.empty_like(q)
        m, l = (torch.empty((B, HQ, S), device="cuda") for _ in "ml")
        scale = 144 ** -0.5 if cap else D ** -0.5
        outs = {}
        for causal in (1, 0):
            for stats in (False, True):
                ptrs = [t.data_ptr() for t in (q, k, v, o)] + (
                    [m.data_ptr(), l.data_ptr()] if stats else [None, None])
                for n, lib in libs.items():
                    dims = (B, S, HQ, hkv, D) if n == "parent" else (B, S, S, 0, HQ, hkv, D)
                    for path, fn in (("tile", lib.repro_flash_attention_tile),
                                     ("cuda_core", lib.repro_flash_attention)):
                        extra = () if path == "tile" else (1,)
                        if fn(*ptrs, *dims, scale, causal, window, cap, *extra, stream()) != 0:
                            raise SystemExit(f"{n} {path}: launch refused")
                        torch.cuda.synchronize()
                        outs[n, path, causal, stats] = (o.clone(), m.clone(), l.clone())
        same = all(all(torch.equal(a, b) for a, b in zip(outs["parent", *key],
                                                        outs["change", *key]))
                   for key in {k_[1:] for k_ in outs})
        same_all &= same
        ptrs = [t.data_ptr() for t in (q, k, v, o)] + [None, None]
        calls = {
            "parent": lambda: libs["parent"].repro_flash_attention_tile(
                *ptrs, B, S, HQ, hkv, D, scale, 1, window, cap, stream()),
            "change": lambda: libs["change"].repro_flash_attention_tile(
                *ptrs, B, S, S, 0, HQ, hkv, D, scale, 1, window, cap, stream()),
        }
        times = {n: [] for n in calls}
        for order in (list(calls), list(calls)[::-1]) * 2:
            for n in order:
                times[n].append(time_ms(torch, calls[n]))
        print(f"{card}; [{B},{S},{HQ}/{hkv},{D}] bf16, window {window or 'none'}, cap "
              f"{cap or 'none'}; parent and change (Sk = Sq, delta = 0) bit-identical, o, m and "
              f"l, causal and not, tile and CUDA-core paths: {same}; tile path causal, ms: "
              + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in ts) for n, ts in times.items()),
              flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
