#!/usr/bin/env python3
"""Which peak learning rate full-width chatglm3-6b trains at, on the card.

  python3 scripts/train_lr_sweep.py [--lrs 3e-3,1e-3,3e-4,1e-4,3e-5]

Runs the port's launcher (``python -m repro_torch.launch.train``: 28
layers, 16 x 64 tokens of ``LMBatches``, AdamW with f32 moments, warmup 5
steps, weights and batches from seed 0) for 6 kernel-mode steps at each
peak learning rate, through ``chip_smoke.launch_run``, and prints each
run's losses, whether the sixth lies below the first, and its step times.
The launcher's default, 3e-3, is the reference launcher's, sized for the
reduced model (d_model 64).  Needs one CUDA card with 80 GB.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="3e-3,1e-3,3e-4,1e-4,3e-5")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import load_library

    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    load_library()
    for lr in args.lrs.split(","):
        losses, _, _, _, summary, _ = cs.launch_run(
            ["--steps", "6", "--batch", "16", "--seq", "64", "--log-every", "100", "--lr", lr,
             "--fusion", "kernel"], 16 * 64)
        print(f"lr {lr}: loss {'fell' if losses[-1] < losses[0] else 'rose'}; {summary}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
