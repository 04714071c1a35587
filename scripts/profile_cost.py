#!/usr/bin/env python3
"""What torch.profiler costs at a paged serve step, on the card: the seconds
that ``chip_smoke.profile_device`` takes with the host's operator events
and the CUDA activity (its former setting) against the CUDA activity alone,
over 1 and 3 steps, with the device ops and device time each records.

  python3 scripts/profile_cost.py

Full-width chatglm3-6b (seed-0 weights), kernel mode, ``serve_step`` at
batch 4 and C = 8 on a 512-block pool.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profiled(run, n, activities):
    """(seconds the profile took, device ops a step, device ms a step)."""
    import torch
    from torch.profiler import profile

    t = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    return time.perf_counter() - t, len(ev) / n, busy / n


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profile_cost: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import load_library
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    load_library()
    bundle = get_arch("chatglm3-6b")
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    serve = bundle.serve_step_fn(ParallelContext(device="cuda",
                                                 fusion=FusionConfig(mode="kernel")))
    pool = bundle.init_paged_pool(512, 16, "cuda")
    B, C = 4, 8
    tok = torch.randint(0, 1000, (B, C), device="cuda", dtype=torch.int32)
    tables = torch.arange(B * 64, device="cuda", dtype=torch.int32).reshape(B, 64)
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    n_new = torch.full((B,), C, dtype=torch.int32, device="cuda")
    run = lambda i: serve(params, tok, pool, tables, pos, n_new)
    for _ in range(3):
        run(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    for name, acts in (("host events and CUDA activity",
                        [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                       ("CUDA activity only", [ProfilerActivity.CUDA])):
        for n in (1, 3):
            sec, ops, busy = profiled(run, n, acts)
            print(f"{name}, {n} steps: {sec:.2f} s; {ops:.0f} device ops a step, device busy "
                  f"{busy:.2f} ms a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
