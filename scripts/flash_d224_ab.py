#!/usr/bin/env python3
"""The CUDA-core flash kernel of this checkout, which takes head size 224
(zamba2-7b's shared attention), against a parent checkout's that took 64
and 128 only, on the card.

  git archive <parent> src/repro_torch/kernels/csrc | tar -x -C build/parent
  python3 scripts/flash_d224_ab.py [--parent build/parent]

Builds ``flash_attention.cu`` of both checkouts into shared libraries under
``build/flash_d224_ab/`` (one nvcc each, in parallel) and prints each
build's registers and spills for every instantiation of the CUDA-core
kernel.  At head sizes 64 and 128, f32 and bf16, causal and not, with and
without statistics, at Sk = Sq and at a ragged Sk with an offset, both
builds must give bit-identical o, m and l on the CUDA-core path (and on the
tile path at bf16 128).  Then times both builds' CUDA-core kernel at
[4, 2048, 32/2, 128] bf16 causal with CUDA events (20 launches each, four
rounds in alternating order), and the change's at zamba2's [4, 2048,
32/32, 224] bf16 causal.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
            m = re.search(r"Compiling entry function '(\S*flash_attention_kernel\S*)'", ln)
            if m:
                info = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                print(f"{n}: {m[1]} {info}", flush=True)
        libs[n] = ctypes.CDLL(str(so))
    return libs


def time_ms(torch, fn, iters=20):
    for _ in range(3):
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
        print("flash_d224_ab: no CUDA device is available", file=sys.stderr)
        return 2
    csrc = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
    libs = build({"parent": Path(args.parent) / csrc, "change": ROOT / csrc},
                 ROOT / "build" / "flash_d224_ab")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (q, k, v, o, m, l, B, Sq, Sk, delta, Hq, Hkv, D, scale, causal, window, softcap
    #  [, dtype], stream), the same in both builds
    for lib in libs.values():
        lib.repro_flash_attention.argtypes = [vp] * 6 + [i32] * 7 + [f32, i32, i32, f32, i32, vp]
        lib.repro_flash_attention_tile.argtypes = [vp] * 6 + [i32] * 7 + [f32, i32, i32, f32, vp]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    cases, same_all = 0, True
    for d in (64, 128):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for b, sq, sk, delta, hq, hkv in ((2, 300, 300, 0, 8, 2), (1, 100, 1000, 900, 4, 4),
                                              (2, 37, 37, 0, 4, 1)):
                q = torch.randn((b, sq, hq, d), generator=g, device="cuda").to(dtype)
                k, v = (torch.randn((b, sk, hkv, d), generator=g, device="cuda").to(dtype)
                        for _ in "kv")
                for causal in (1, 0):
                    for stats in (False, True):
                        outs = {}
                        for n, lib in libs.items():
                            o = torch.full_like(q, float("nan"))
                            m, l = (torch.full((b, hq, sq), float("nan"), device="cuda")
                                    for _ in "ml")
                            ptrs = [t.data_ptr() for t in (q, k, v, o)] + (
                                [m.data_ptr(), l.data_ptr()] if stats else [None, None])
                            dims = (b, sq, sk, delta, hq, hkv, d, d ** -0.5, causal, 0, 0.0)
                            paths = [("cuda_core", lambda: lib.repro_flash_attention(
                                *ptrs, *dims, code, stream()))]
                            if dtype == torch.bfloat16 and d == 128:
                                paths.append(("tile", lambda: lib.repro_flash_attention_tile(
                                    *ptrs, *dims, stream())))
                            for path, call in paths:
                                if call() != 0:
                                    raise SystemExit(f"{n} {path}: launch refused")
                                torch.cuda.synchronize()
                                outs[n, path] = (o.clone(), m.clone(), l.clone())
                        for path in {p_ for _, p_ in outs}:
                            a_, b_ = outs["parent", path], outs["change", path]
                            same = all(torch.equal(x, y) or (stats is False and i > 0)
                                       for i, (x, y) in enumerate(zip(a_, b_)))
                            cases += 1
                            if not same:
                                same_all = False
                                print(f"DIFFER: d {d} {dtype} [{b},{sq},{hq}/{hkv}] Sk {sk} "
                                      f"delta {delta} causal {causal} stats {stats} {path}",
                                      flush=True)
    print(f"{card}; d 64 and 128, f32 and bf16, Sk = Sq and a ragged Sk at an offset, causal and "
          f"not, with and without statistics, CUDA-core path (and tile path at bf16 128): parent "
          f"and change bit-identical in all {cases} cases: {same_all}", flush=True)
    B, S = 4, 2048
    shapes = {"[4,2048,32/2,128]": (32, 2, 128), "[4,2048,32/32,224]": (32, 32, 224)}
    for name, (hq, hkv, d) in shapes.items():
        q = torch.randn((B, S, hq, d), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, hkv, d), generator=g, device="cuda").bfloat16() for _ in "kv")
        o = torch.empty_like(q)
        ptrs = [t.data_ptr() for t in (q, k, v, o)] + [None, None]
        dims = (B, S, S, 0, hq, hkv, d, d ** -0.5, 1, 0, 0.0, 1)
        names = ["parent", "change"] if d != 224 else ["change"]
        times = {n: [] for n in names}
        for order in (names, names[::-1]) * 2:
            for n in order:
                times[n].append(time_ms(torch, lambda: libs[n].repro_flash_attention(
                    *ptrs, *dims, stream())))
        print(f"{card}; CUDA-core path {name} bf16 causal, ms: "
              + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in ts) for n, ts in times.items()),
              flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
