#!/usr/bin/env python3
"""Where the WKV6 kernel's time goes, on the card.

  python3 scripts/wkv6_phases.py

Builds ``src/repro_torch/kernels/csrc/wkv6.cu`` as it is and, beside it,
copies with one part of the kernel taken out (the sub-chunk pairs, the
factor pass, the attention product, the two row products, the summary
product, the state from the cluster's peers, the clusters themselves, the
whole intra-chunk part), each into its own shared library under
``build/wkv6_phases/``.  It times each at rwkv6-7b's prefill shape (r, k,
v, w [4, 512, 64, 64] f32, chunk 64) with CUDA events, in two rounds, and
prints the times and what each removal saved.  The copies compute wrong
results; only their times are read.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPE, CHUNK = (4, 512, 64, 64), 64

# name -> [(text in wkv6.cu, its replacement)]
VARIANTS = {
    "full": [],
    "no sub-chunk pairs": [("  wkv_pairs(l, sm);\n  __syncthreads();\n", "")],
    "no factor pass": [("  wkv_factor(l, sm);\n", "")],
    "no att product": [("  wkv_att(l, sm);\n", "")],
    "no att v and r' S": [("wkv_rows_product(acc", "if (0) wkv_rows_product(acc")],
    "no summary product": [("wkv_state_product(l, sm, sm.Lsum", "if (0) wkv_state_product(l, sm, sm.Lsum")],
    "no state from the peers": [("for (int q = 0; q < rank; ++q)", "for (int q = 0; q < 0; ++q)")],
    "no clusters": [("for (int q = 0; q < rank; ++q)", "for (int q = 0; q < 0; ++q)"),
                    ("attr[0].val.clusterDim.x = cl;", "attr[0].val.clusterDim.x = 1;")],
    "no intra-chunk part": [("    wkv_intra(l, sm, acc);", "")],
}


def build(out: Path) -> dict:
    """One shared library per variant, compiled in parallel."""
    from repro_torch.kernels import CSRC, NVCC_FLAGS, _nvcc

    src = (CSRC / "wkv6.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"wkv6.cu no longer holds {old!r} ({name})")
            text = text.replace(old, new)
        cu, so = out / f"wkv6_{i}.cu", out / f"libwkv6_{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name!r} variant:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.repro_wkv6.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.repro_wkv6.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, time_ms, wkv6_inputs

    libs = build(ROOT / "build" / "wkv6_phases")
    b, t, h, n = SHAPE
    r, k, v, w, u = wkv6_inputs(torch.Generator(device="cuda").manual_seed(1), b, t, h, n)
    o = torch.empty_like(r)
    state = torch.empty((b, h, n, n), device="cuda")
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            def run(lib=lib):
                code = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                      u.data_ptr(), o.data_ptr(), state.data_ptr(), b, t, h, n,
                                      CHUNK, torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f"{name}: launch failed ({code})")
            times[name].append(time_ms(run, iters=30, warmup=3))
    full = min(times["full"])
    card = card_line()
    for name, ts in times.items():
        print(f"{name}: {', '.join(f'{t_:.4f}' for t_ in ts)} ms"
              + ("" if name == "full" else f" (saves {full - min(ts):.4f} ms)"))
    print(json.dumps({"shape": list(SHAPE), "chunk": CHUNK, "card": card,
                      "ms": {k_: min(v_) for k_, v_ in times.items()}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
