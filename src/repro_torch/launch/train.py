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

zamba2-7b trains as the reference's does (AdamW, one microbatch; its
``train_forward``: each group of Mamba blocks and the shared block under
remat, the flash kernel at head size 224 in kernel mode, every Mamba
block's ``w_out`` through the fused GEMM + AllReduce) on the dense
configs' batches, at any ``--tp`` dividing its Mamba heads and any
``--dp`` in bulk and fused mode; ``--layers N`` keeps its first N Mamba
blocks (``chip_smoke.py`` trains 13: two groups of 6 and a tail of 1).
qwen2-vl-2b and musicgen-medium train as the dense configs do, their
batches carrying the reference launcher's front-end extras (``make_batches``:
patch embeddings on the first 8 positions with M-RoPE's streams, or frame
embeddings), bit for bit the reference's.

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

``--ckpt-dir D`` runs the steps under the restart-on-failure supervisor
(``runtime/fault_tolerance.py``): a checkpoint of the whole train state
before the first step and every ``--ckpt-every`` steps (``keep`` 3,
written on a worker thread by world rank 0, each rank's shards gathered
first), restore and batch replay on a failure, and a resume from D's
latest checkpoint in a later call (the seeded batches fast-forwarded past
the steps it took).  ``--chaos SPEC`` injects the seeded fault plan of
``runtime/chaos.py`` (a ``rank_loss`` shrinks the world: the data axis
first, then tp, ``runtime/elastic.py``; the lost ranks take part in
resharding the state, then leave); ``--degrade`` installs the degradation
policy the supervisor feeds; ``--skew-schedule`` feeds each step's time,
gathered over the world, to the skew estimator and swaps in the step built
for a new rotation (``runtime/straggler.py``).  These three are the
supervisor's, so each needs ``--ckpt-dir``.  One deliberate difference
from the reference: its ``--ckpt-dir`` defaults to a fixed directory that
every run checkpoints to and resumes from; the port's defaults to none,
with the plain loop, so that two calls never share a run by accident and a
full-width state is not written unasked.  The reference's production mesh
and comm-graph flags raise, each with the ROADMAP item that brings it.  The
losses returned are a step's last (a replayed step's replace its first);
rank 0 prints them exactly at the end (``losses [...]``), and the step a
resumed run began at.

The multi-process flags (``launch/distributed.py``): ``--coordinator
host:port --num-processes N --process-id i`` join a world of N processes
without ``torch.distributed.run``.  ``--heartbeat-dir D`` (it needs
``--ckpt-dir``) runs the supervisor under the liveness watchdog
(``runtime/watchdog.py``; ``--heartbeat-interval``, ``--stall-after``,
``--step-deadline``): each rank beats its step after every step and arms
its monitor once the first step lands; a peer found dead or stalled ends
the process with the respawn protocol's code (17 for a lost peer, 16 for a
stall; ``runtime/multiprocess.py``) once its checkpoint in flight has
landed, and the respawned generation resumes from ``--ckpt-dir``.  A world
smaller than ``--dp * --tp`` (a respawned generation's) shrinks the shape
by ``runtime/elastic.shrink_context``'s rule, data first, and says so.
``runtime/multiprocess.MultiprocessDriver`` runs the launcher as its
workers:

  MultiprocessDriver(["-m", "repro_torch.launch.train", "--dp", "2", "--backend",
                      "gloo", "--ckpt-dir", C, "--heartbeat-dir", "{heartbeat_dir}"],
                     2, workdir=W).run_elastic()

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import Placement
from repro_torch.configs.registry import get_arch
from repro_torch.core.autotune import (add_granularity_cli_args, load_cache_if_exists,
                                       save_cache)
from repro_torch.core.calibrate import add_calibration_cli_args, warmup_and_calibrate
from repro_torch.core.degrade import DegradationPolicy, set_degradation_policy
from repro_torch.data.pipeline import prefetch, to_device
from repro_torch.data.synthetic import DLRMBatches, LMBatches
from repro_torch.kernels import load_library
from repro_torch.kernels.embedding_pool.ops import NO_BACKWARD
from repro_torch.launch.distributed import (add_distributed_cli_args, build_liveness_from_args,
                                            join_world)
from repro_torch.launch.mesh import BACKENDS, close_world
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.runtime.chaos import (CollectiveTimeout, RankLost, add_chaos_cli_args,
                                       build_fault_plan)
from repro_torch.runtime.elastic import reshard_tree, shrink_context
from repro_torch.runtime.fault_tolerance import SupervisorConfig, TrainSupervisor
from repro_torch.runtime.multiprocess import exit_for_respawn
from repro_torch.runtime.straggler import SkewEstimator, SkewScheduler
from repro_torch.runtime.watchdog import from_liveness
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (TrainConfig, build_train_step, init_train_state,
                                    train_state_specs)

# flags of the reference launcher that later slices bring: (flag, dest, ROADMAP item)
_LATER_FLAGS = (
    ("--auto-fuse", "auto_fuse", "ROADMAP Queue 1 item 7 (the comm-graph analyzer)"),
    ("--explain-comm", "explain_comm", "ROADMAP Queue 1 item 7 (the comm-graph analyzer)"),
    ("--production-mesh", "production_mesh",
     "ROADMAP Queue 1 item 1 (left: the real-peer half, a host of many cards: the reference's "
     "16 x 16 TPU mesh)"),
)
_NOT_TRAINED = {
    "rwkv6": "ROADMAP Queue 1 item 7 (rwkv6 training: a WKV6 backward)",
}


def make_batches(bundle, batch: int, seq: int, seed: int = 0):
    """The reference launcher's batches: numpy ``LMBatches`` over a
    transformer's or zamba2's vocabulary, ``DLRMBatches`` of DLRM's tables
    (``seq`` unused).  A front end's extras come from ``default_rng(seed + 7)`` in
    the reference's order and scale: an audio batch's ``frame_embeds`` [B,
    S, D], a vision batch's ``vision_embeds`` [B, S, D] on the first
    ``min(8, S)`` positions (``vision_mask`` [S]) with ``positions_thw`` [3,
    B, S] three equal streams of ``arange(S)``."""
    cfg = bundle.config
    if bundle.family == "dlrm":
        return DLRMBatches(cfg.n_tables, cfg.table_vocab, cfg.pooling, cfg.n_dense, batch, seed)
    if bundle.family in _NOT_TRAINED:
        raise NotImplementedError(f"{bundle.name}: {_NOT_TRAINED[bundle.family]}")
    base = LMBatches(cfg.vocab, batch, seq, seed)
    if getattr(cfg, "frontend", None) is None:
        return base
    return _with_frontend(base, cfg, batch, seq, seed)


def _with_frontend(base, cfg, batch: int, seq: int, seed: int):
    rng = np.random.default_rng(seed + 7)
    for b in base:
        if cfg.frontend == "audio":
            b["frame_embeds"] = rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.frontend == "vision":
            b["vision_embeds"] = rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
            b["vision_mask"] = np.arange(seq) < min(8, seq)
            b["positions_thw"] = np.tile(np.arange(seq, dtype=np.int32)[None, None],
                                         (3, batch, 1))
        yield b


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
    ap.add_argument("--skew-schedule", action="store_true",
                    help="close the Fig. 14 loop: feed each step's time, gathered over the "
                         "world, to the skew estimator and swap in the step built for a new "
                         "rotation (needs --ckpt-dir)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="run under the fault-tolerant supervisor, checkpointing here and "
                         "resuming from its latest checkpoint (default: none, the plain loop)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    add_chaos_cli_args(ap)
    add_distributed_cli_args(ap)
    for flag, dest, _ in _LATER_FLAGS:
        ap.add_argument(flag, dest=dest, action="store_true", help=argparse.SUPPRESS)
    return ap


def _refuse_later(args):
    for flag, dest, item in _LATER_FLAGS:
        if getattr(args, dest):
            raise NotImplementedError(f"{flag}: {item}")
    if args.ckpt_dir is None:
        for flag, on in (("--chaos", args.chaos is not None), ("--degrade", args.degrade),
                         ("--skew-schedule", args.skew_schedule),
                         ("--heartbeat-dir", args.heartbeat_dir is not None)):
            if on:
                raise ValueError(f"{flag} runs under the supervisor, which needs --ckpt-dir "
                                 f"(a restart restores from it)")


def main(argv=None, *, on_phase=None):
    """Parse ``argv``, train, return this rank's per-step losses (floats).
    ``on_phase`` goes to ``build_train_step`` (for timing each part)."""
    args = build_parser().parse_args(argv)
    _refuse_later(args)
    device = join_world(args)
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
    if args.calibrate:
        # the loss on a fresh iterator's first batch records the hot keys;
        # the training batches and the state are untouched
        batch0 = to_device(next(iter(make_batches(bundle, args.batch, args.seq))), ctx.device)
        warmup_and_calibrate(ctx, loss_fn, state["params"], batch0,
                             iters=args.calibrate_iters, granularity=args.granularity,
                             rank_tag=f" [rank {torch.distributed.get_rank()}]"
                             if world > 1 else "")

    t0 = time.time()
    losses = {}
    hb_writer, liveness = build_liveness_from_args(args)

    def on_metrics(step, metrics):
        losses[step] = float(metrics["loss"])
        if liveness is not None:
            hb_writer.beat(step=step)
            liveness.enabled = True     # armed once the first step lands
        if ctx.world.tp_rank == 0 and step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[step]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / max(step, 1):.2f}s/step)",
                  flush=True)

    sup = None
    if args.ckpt_dir is None:
        step_fn = build_train_step(loss_fn, tc, ctx=ctx, param_specs=specs, on_phase=on_phase)
        batch_iter = prefetch(batches, ctx.device)
        for step in range(1, args.steps + 1):
            state, metrics = step_fn(state, next(batch_iter))
            on_metrics(step, metrics)
        step = args.steps
    else:
        state, step, sup, ctx = _supervised(args, bundle, ctx, tc, specs, state, batches,
                                            on_phase, on_metrics, liveness, hb_writer)
        if sup.left:
            print(f"rank {torch.distributed.get_rank()} left the world at step {step} (not "
                  f"kept by the shrink)", flush=True)
            return []
    losses = [losses[s] for s in sorted(losses)]
    world = ctx.world.tp
    rank0 = ctx.world.tp_rank == 0
    if world > 1:
        # the loss is a replicated scalar: every rank's must be rank 0's
        every = [None] * world
        torch.distributed.all_gather_object(every, losses, group=ctx.world.group)
        if any(x != every[0] for x in every):
            raise AssertionError(f"the ranks' losses differ: {every}")
    if hb_writer is not None:
        # after the last collective: no peer is inside a guarded call that
        # would read this rank's departure as a loss
        hb_writer.stop()
    if not rank0:
        return losses
    span = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses
            else "no steps run (resumed at or past --steps)")
    where = (f" (dp={ctx.dp}, tp={ctx.tp}, {ctx.backend}, fusion={args.fusion})"
             if world > 1 else "")
    stats = "" if sup is None else f"; straggler stats {sup.straggler.summary()}"
    print(f"done at step {step}; {span}{where}{stats}")
    if sup is not None and sup.start_step:
        print(f"resumed at step {sup.start_step}")
        for r in sup.manager.stats:
            print(f"restored step {r['step']}: {r['bytes'] / 1e9:.3f} GB in {r['seconds']:.3f} s "
                  f"({r['bytes'] / r['seconds'] / 1e9:.3f} GB/s)")
    print(f"losses {json.dumps(losses)}")
    if sup is not None and sup.fault_plan is not None:
        print(f"chaos: plan {sup.fault_plan.summary()}; injected {sup.faults_injected}, "
              f"restarts {sup.restarts}, rank losses {sup.rank_losses}, backoffs "
              f"{[round(b, 3) for b in sup.backoffs]}")
    if sup is not None and sup.degradation is not None:
        print(f"degradation: {sup.degradation.summary()}")
    if world > 1:
        print(f"all {world} ranks' losses equal: True")
    if args.tune_cache:
        save_cache(args.tune_cache)
    return losses


def _supervised(args, bundle, ctx, tc, specs, state, batches, on_phase, on_metrics,
                liveness=None, hb_writer=None):
    """The steps under ``TrainSupervisor``, as the reference launcher runs
    them; returns (state, step, supervisor, the final context).  Under
    ``liveness`` a fault the watchdog names ends the process with the
    respawn protocol's code, as the reference's launcher does."""
    state_specs = train_state_specs(tc, specs)
    cur = {"ctx": ctx}

    def build_step(skew: int = 0):
        c = cur["ctx"]
        c = c.with_fusion(dataclasses.replace(c.fusion, skew=skew))
        return build_train_step(bundle.loss_fn(c), tc, ctx=c, param_specs=specs,
                                on_phase=on_phase)

    skew_sched = None
    if args.skew_schedule:
        skew_sched = SkewScheduler(build_step, SkewEstimator({"data": ctx.dp, "model": ctx.tp}),
                                   axis="model")
    degradation = None
    if args.degrade:
        degradation = DegradationPolicy()
        set_degradation_policy(degradation)

    def on_rank_loss(st, exc):
        # elastic shrink: halve the data axis (else tp), reshard, go on
        old = cur["ctx"]
        cur["ctx"] = shrink_context(old)
        st, sup.state_shardings = reshard_tree(st, state_specs, cur["ctx"], old_ctx=old,
                                               training=True)
        if st is None:
            return None, None
        if skew_sched is not None:
            skew_sched.invalidate()     # its builds hold the old world
            return st, skew_sched.fn()
        return st, build_step()

    sup = TrainSupervisor(
        SupervisorConfig(checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every),
        build_step(), state_shardings=Placement(ctx, state_specs, training=True),
        skew_scheduler=skew_sched,
        per_rank_times="process" if skew_sched is not None else None,
        fault_plan=build_fault_plan(args.chaos, num_steps=args.steps),
        degradation=degradation, rebuild_step=build_step, liveness=liveness,
        # with real liveness a lost rank's memory is gone: the survivors leave
        # and a respawned world restores from the checkpoint
        on_rank_loss=None if liveness is not None else on_rank_loss)
    try:
        state, step = sup.run(state, prefetch(batches, ctx.device), args.steps,
                              on_metrics=on_metrics)
    except (RankLost, CollectiveTimeout) as e:
        if not from_liveness(e):
            raise
        # the respawn protocol's exit, once a checkpoint already gathered lands
        try:
            sup.manager.wait()
        except Exception as err:     # the exit goes on: its code says what happened
            print(f"the checkpoint in flight failed: {err!r}", flush=True)
        exit_for_respawn(e, hb_writer)
    finally:
        if degradation is not None:
            set_degradation_policy(None)
    return state, step, sup, cur["ctx"]

if __name__ == "__main__":
    main()
