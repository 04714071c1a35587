"""Training launcher: a few AdamW (or the config's optimizer) steps on
synthetic data through the fused operators.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --steps 6 --batch 16 --seq 64 --fusion kernel
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 6
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --tp 2 --backend gloo --reduced --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --dp 2 --tp 2 --backend gloo --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --tables 32 --fusion fused \
      --batch 8192 --steps 3 --lr 1e-3

Dense transformers train (``bundle.loss_fn``: ``train_forward`` with remat,
the vocab-sharded CE ring), in ``kernel`` mode (every attention forward is
the flash kernel, a launch a KV-ring hop at tp > 1; its backward the
reference's analytic one), ``fused`` mode (the reference's rings in plain
PyTorch, its default) or ``bulk`` mode.  ``--tp N`` trains over a
tensor-parallel world of N processes started by ``torch.distributed.run``
(``launch/mesh.py``; ``--backend`` as the serving launcher's): each rank
draws its shards of the tp = 1 seed-0 weights, runs the same batches on its
chunk of the sequence and updates its shards (``train/step.py``).  ``--dp
D`` runs D data replicas of that world (``D * N`` processes): each replica
its ``--batch / D`` rows of the same global batches, the train state's fsdp
dims split over the replicas (``init_params(..., training=True)``), the
loss the global mean.  Rank 0 prints, and checks at the end that every
rank's losses are its own.
``--layers N`` cuts the model to its first N layers at full width (the
reduced model's heads of 16 are not a size the flash kernel takes, so a
card runs kernel mode at full width).

``--arch dlrm`` trains DLRM on ``DLRMBatches`` of ``--batch`` rows (``--seq``
unused) in bulk or fused mode, at any ``--tp`` and ``--dp``: its tables split
over all ``dp * tp`` ranks, each rank its ``--batch / (dp * tp)`` rows.
``--tables N`` keeps the first N tables, widths kept (DLRM's depth cut: its
512 published tables are 188 GB in f32).  ``--fusion kernel`` (the default)
raises for DLRM before any step: the pooling kernel has no backward, as the
reference's kernel mode has none.
Weights are random, drawn from seed 0; batches are ``LMBatches`` from seed
0, copied to the device ahead of the step (``data.pipeline.prefetch``).  It
prints the reference launcher's per-step line every ``--log-every`` steps
and returns the losses.

``--granularity`` / ``--wire`` set the CE's sub-chunks and wire (``auto``:
the autotuner's choice, ``core/autotune.py``); ``--calibrate`` runs the
loss once without gradients on a fresh first batch to record the hot keys
and times their candidates (``core/calibrate.py``); ``--tune-cache PATH``
loads decisions at the start and saves them at the end.

The reference launcher also runs under a restart-on-failure supervisor with
checkpoints, chaos injection, liveness, skew scheduling, degradation and
the comm-graph rewrite; here each of those flags raises with the ROADMAP
item that brings it.  The port's trainer does not checkpoint.

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.autotune import (add_granularity_cli_args, load_cache_if_exists,
                                       save_cache)
from repro_torch.core.calibrate import add_calibration_cli_args, warmup_and_calibrate
from repro_torch.data.pipeline import prefetch, to_device
from repro_torch.data.synthetic import DLRMBatches, LMBatches
from repro_torch.kernels import load_library
from repro_torch.kernels.embedding_pool.ops import NO_BACKWARD
from repro_torch.launch.mesh import BACKENDS, close_world, init_world
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

_RUNTIME = "ROADMAP Queue 1 item 7 (the runtime)"
# flags of the reference launcher that later slices bring: (flag, dest, ROADMAP item)
_LATER_FLAGS = (
    ("--auto-fuse", "auto_fuse", "ROADMAP Queue 1 item 7 (the comm-graph analyzer)"),
    ("--explain-comm", "explain_comm", "ROADMAP Queue 1 item 7 (the comm-graph analyzer)"),
    ("--skew-schedule", "skew_schedule", f"{_RUNTIME}: the straggler loop"),
    ("--degrade", "degrade", f"{_RUNTIME}: degradation, which only the supervisor feeds"),
    ("--production-mesh", "production_mesh",
     "ROADMAP Queue 1 item 1 (left: the real-peer half, a host of many cards: the reference's "
     "16 x 16 TPU mesh)"),
)
_LATER_VALUES = (
    ("--chaos", "chaos", f"{_RUNTIME}: chaos injection"),
    ("--ckpt-dir", "ckpt_dir", f"{_RUNTIME}: checkpoints and the supervisor"),
    ("--ckpt-every", "ckpt_every", f"{_RUNTIME}: checkpoints and the supervisor"),
    ("--coordinator", "coordinator", f"{_RUNTIME}: multi-process launch"),
    ("--num-processes", "num_processes", f"{_RUNTIME}: multi-process launch"),
    ("--process-id", "process_id", f"{_RUNTIME}: multi-process launch"),
    ("--heartbeat-dir", "heartbeat_dir", f"{_RUNTIME}: liveness"),
    ("--step-deadline", "step_deadline", f"{_RUNTIME}: liveness"),
)
_NOT_TRAINED = {
    "rwkv6": "ROADMAP Queue 1 item 7 (rwkv6 training: a WKV6 backward)",
}


def make_batches(bundle, batch: int, seq: int, seed: int = 0):
    """The reference launcher's batches: numpy ``LMBatches`` over a
    transformer's vocabulary, ``DLRMBatches`` of DLRM's tables (``seq``
    unused)."""
    cfg = bundle.config
    if bundle.family == "dlrm":
        return DLRMBatches(cfg.n_tables, cfg.table_vocab, cfg.pooling, cfg.n_dense, batch, seed)
    if bundle.family != "transformer":
        raise NotImplementedError(f"{bundle.name}: {_NOT_TRAINED[bundle.family]}")
    return LMBatches(cfg.vocab, batch, seq, seed)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers, widths kept (0: all)")
    ap.add_argument("--tables", type=int, default=0,
                    help="DLRM: keep its first N tables, widths kept (0: all)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fusion", default="kernel", choices=["kernel", "fused", "bulk"])
    add_granularity_cli_args(ap)
    add_calibration_cli_args(ap)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (run under torch.distributed.run)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data replicas of the tp world (dp * tp processes)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="the world's backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    for flag, dest, _ in _LATER_FLAGS:
        ap.add_argument(flag, dest=dest, action="store_true", help=argparse.SUPPRESS)
    for flag, dest, _ in _LATER_VALUES:
        ap.add_argument(flag, dest=dest, default=None, help=argparse.SUPPRESS)
    return ap


def _refuse_later(args):
    for flag, dest, item in _LATER_FLAGS + _LATER_VALUES:
        if getattr(args, dest) not in (None, False):
            raise NotImplementedError(f"{flag}: {item}")


def main(argv=None, *, on_phase=None):
    """Parse ``argv``, train, return this rank's per-step losses (floats).
    ``on_phase`` goes to ``build_train_step`` (for timing each part)."""
    args = build_parser().parse_args(argv)
    _refuse_later(args)
    device = init_world(args.tp, args.backend, args.device, dp=args.dp)
    try:
        return _train(args, device, on_phase)
    finally:
        close_world()


def _train(args, device, on_phase):
    bundle = get_arch(args.arch)
    if args.reduced:
        bundle = bundle.reduced()
    if args.layers:
        bundle = dataclasses.replace(bundle, config=dataclasses.replace(
            bundle.config, n_layers=args.layers))
    if args.tables:
        if bundle.family != "dlrm":
            raise ValueError(f"--tables cuts DLRM's tables; {bundle.name} has none")
        bundle = dataclasses.replace(bundle, config=dataclasses.replace(
            bundle.config, n_tables=args.tables))
    if bundle.family == "dlrm" and args.fusion == "kernel":
        raise NotImplementedError(f"--arch dlrm --fusion kernel: {NO_BACKWARD}")
    batches = make_batches(bundle, args.batch, args.seq)
    load_cache_if_exists(args.tune_cache)
    ctx = ParallelContext(device=device, tp=args.tp, dp=args.dp, fusion=FusionConfig(
        mode=args.fusion, granularity=args.granularity, wire=args.wire))
    world = ctx.tp * ctx.dp
    rank0 = ctx.tp_rank == 0 and ctx.dp_rank == 0
    loss_fn = bundle.loss_fn(ctx)
    if ctx.device.type == "cuda" and args.fusion == "kernel":
        load_library()   # build the kernels before the first step
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = (bundle.init_params(gen, ctx, training=True) if world > 1 else
              bundle.init_params(gen))
    tc = TrainConfig(
        optimizer=OptimizerConfig(name=bundle.optimizer, lr=args.lr,
                                  warmup_steps=max(args.steps // 20, 5),
                                  total_steps=args.steps),
        microbatches=bundle.microbatches,
        layer_period=getattr(bundle.config, "local_global_period", 0) or 1)
    specs = bundle.param_specs(params)
    state = init_train_state(tc, params)
    del params
    step_fn = build_train_step(loss_fn, tc, ctx=ctx, param_specs=specs, on_phase=on_phase)
    if args.calibrate:
        # the loss on a fresh iterator's first batch records the hot keys;
        # the training batches and the state are untouched
        batch0 = to_device(next(iter(make_batches(bundle, args.batch, args.seq))), ctx.device)
        warmup_and_calibrate(ctx, loss_fn, state["params"], batch0,
                             iters=args.calibrate_iters, granularity=args.granularity,
                             rank_tag=f" [rank {torch.distributed.get_rank()}]"
                             if world > 1 else "")

    t0 = time.time()
    losses = []
    batch_iter = prefetch(batches, ctx.device)
    for step in range(1, args.steps + 1):
        state, metrics = step_fn(state, next(batch_iter))
        losses.append(float(metrics["loss"]))
        if rank0 and step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / max(step, 1):.2f}s/step)",
                  flush=True)
    if world > 1:
        # the loss is a replicated scalar: every rank's must be rank 0's
        every = [None] * world
        torch.distributed.all_gather_object(every, losses)
        if any(x != every[0] for x in every):
            raise AssertionError(f"the ranks' losses differ: {every}")
    if not rank0:
        return losses
    span = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else "no steps run"
    where = (f" (dp={ctx.dp}, tp={ctx.tp}, {ctx.backend}, fusion={args.fusion})"
             if world > 1 else "")
    print(f"done at step {args.steps}; {span}{where}")
    if world > 1:
        print(f"all {world} ranks' losses equal: True")
    if args.tune_cache:
        save_cache(args.tune_cache)
    return losses


if __name__ == "__main__":
    main()
