"""Serving launcher: batched greedy decode through the fused kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --requests 8 --batch 4 --max-new 16 --fusion kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
      --reduced --device cpu

rwkv6-7b is refused (see ``_RWKV6_REFUSAL``): its prefill and decode
run through ``get_arch("rwkv6-7b").prefill_fn`` / ``decode_fn``.

A dense model's FFN down projection runs the fused GEMV+AllReduce kernel;
an MoE model's experts run the dispatch-A2A kernel chained into the expert
FFN + combine-A2A kernel.  Full-width dbrx-132b (264 GB of bf16 weights)
does not fit one card: ``chip_smoke.py`` serves it cut to 8 of its 40
layers.

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device the default raises.  Weights are random, drawn from a fixed seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import load_library
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.serve.engine import DecodeEngine, Request


# The reference's launcher cannot serve rwkv6 either, so neither does the port.
_RWKV6_REFUSAL = (
    "rwkv6-7b has no serving launcher: the reference's `repro.launch.serve "
    "--arch rwkv6-7b` raises AttributeError at src/repro/launch/serve.py:146 "
    "(RWKV6Config has no max_seq), and its DecodeEngine._admit resets only a "
    "reused slot's position, which rwkv6's decode_step ignores, so a new "
    "request would inherit the previous one's recurrent state (ROADMAP "
    "Queue 3).  Call get_arch('rwkv6-7b').prefill_fn / decode_fn instead.")


def make_requests(n: int, vocab: int, max_new: int) -> list[Request]:
    """The reference launcher's seeded prompts: 2-5 random token ids each."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=rng.integers(2, 6)).tolist()
        reqs.append(Request(uid=i, prompt=prompt, max_new=max_new))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fusion", default="kernel", choices=["kernel", "bulk"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bundle = get_arch(args.arch)
    if bundle.family == "rwkv6":
        raise NotImplementedError(_RWKV6_REFUSAL)
    ctx = ParallelContext(device=args.device,
                          fusion=FusionConfig(mode=args.fusion))
    if args.reduced:
        bundle = bundle.reduced()
    cfg = bundle.config
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = bundle.init_params(gen)
    decode = bundle.decode_fn(ctx)
    engine = DecodeEngine(lambda t, c, pos: decode(params, t, c, pos),
                          lambda b: bundle.init_cache(b, ctx.device),
                          args.batch, device=ctx.device, max_seq=cfg.max_seq)
    for r in make_requests(args.requests, cfg.vocab, args.max_new):
        engine.submit(r)

    where = "cpu"
    if ctx.device.type == "cuda":
        where = torch.cuda.get_device_name(ctx.device)
        if args.fusion == "kernel":
            load_library()   # build the kernels outside the timed drain
    t0 = time.perf_counter()
    finished = engine.run_until_drained(
        max_steps=args.requests * (cfg.max_seq - 1))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    dt = time.perf_counter() - t0
    if not finished.drained:
        print("WARNING: stopped at max_steps before draining — results truncated")
    total_tokens = sum(len(r.tokens) for r in finished)
    print(f"served {len(finished)} requests, {total_tokens} tokens in "
          f"{dt:.3f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"batch={args.batch}, fusion={args.fusion}, device={where})")
    for r in finished[:4]:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.tokens[:12]}")
    return finished


if __name__ == "__main__":
    main()
