"""Serving launcher: batched greedy decode through the fused kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
      --requests 8 --batch 4 --max-new 16 --fusion kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --paged --block-size 16 \
      --chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --layers 5
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b --paged
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.serve --tp 4 --fusion fused
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.serve --dp 2 --tp 2 --paged \
      --fusion fused --backend gloo

``--tp N`` serves over a tensor-parallel world of N processes, started by
``torch.distributed.run`` (one process a rank), in ``fused`` or ``bulk``
mode (``kernel`` mode at tp > 1 waits for a host with real peers), dense or
``--paged`` (the pool's blocks striped over the ranks, ``--num-blocks``
rounded to a multiple of tp).  ``--dp D`` runs D data replicas of that
world (``D * N`` processes): the dense engine's batch rows split over the
replicas where D divides ``--batch``, the paged engine replicated, as the
reference's serve launcher replicates its parameters over data; kernel mode
runs at ``--tp 1`` over any ``--dp``.  ``--backend`` is ``nccl`` by default
on cards (one card a rank) and ``gloo`` on the CPU; ``--backend gloo`` also
runs a world whose ranks share one card, its wire staged through host
memory.  Every rank serves the same requests with the same gathered logits;
rank 0 prints, and checks that every rank's token streams are its own.  ``--granularity`` and
``--wire`` set the fused ring's sub-chunks and payload dtype; ``auto`` (either)
lets the autotuner choose per call site (``core/autotune.py``), from the link
class of the world's backend.  ``--calibrate`` runs one decode step on a
scratch cache to record the hot keys, then times every candidate of each
(``core/calibrate.py``) and keeps the fastest; ``--tune-cache PATH`` loads
decisions at the start and saves them (rank 0) at the end.  The decisions
taken print as ``op shape -> (q, wire)``, one line a key; in a world rank 0
checks that every rank took the same ones.

Without ``--paged`` the dense engine serves (a ``B x S_max`` cache, the
prompt fed one token per step); with it the paged engine (a shared pool of
``--block-size``-token blocks, prompts fed ``--chunk`` tokens per step
through ``serve_step``, whose FFN down projection takes B x C rows).
``--journal PATH`` resubmits the unfinished requests a journal file holds
(``serve.engine.request_journal``) in place of the seeded ones.  The
multi-process flags are the train launcher's (``launch/distributed.py``):
``--coordinator``, ``--num-processes``, ``--process-id`` join a world
without ``torch.distributed.run``, and ``--heartbeat-dir`` drains under the
liveness watchdog, armed at once, each tick beating its count: a peer found
dead or stalled (``runtime/watchdog.py``) writes the unfinished requests,
tokens intact, to ``--journal`` and ends the process with the respawn
protocol's code (17 a lost peer, 16 a stall; ``runtime/multiprocess.py``),
and the respawned generation, on a world that may be smaller than ``--dp *
--tp`` (shrunk data first), resubmits the journal and drains.  Rank 0
prints every finished request's stream, those finished before a failure
too.  ``--chaos SPEC`` drains the engine under a seeded fault
plan (``serve.engine.serve_with_chaos``): a timeout, rank failure or NaN
wire drops its tick, a slow link sleeps, a rank loss shrinks the world
(``runtime/elastic.py``: the data axis first, then tp; at one rank it
raises, as the reference's shrink does), re-places the weights over the
survivors (the lost ranks take part in the gathers, then leave) and
reshards the engine, whose in-flight requests replay their tokens through
the new cache or pool.  ``--degrade`` installs the degradation policy.

rwkv6-7b is refused (see ``_RWKV6_REFUSAL``): its prefill and decode
run through ``get_arch("rwkv6-7b").prefill_fn`` / ``decode_fn``.
zamba2-7b (Mamba-2 blocks, every 6 of them the shared attention block with
its group's LoRA) serves at ``--tp 1`` in every mode through the dense
engine, which zeroes a slot's SSM and conv states when a request takes it
(the bundle's ``reset_slot_fn``; the reference's engine resets only the
position, so there a reused slot starts from its last request's state),
and at any ``--tp`` dividing its Mamba heads and any ``--dp`` in bulk and
fused mode (its Mamba heads split over tp, its groups' KV caches by
sequence); ``--paged`` is refused, as the reference's launcher refuses it.

A dense model's FFN down projection runs the fused GEMV+AllReduce kernel;
an MoE model's experts run the dispatch-A2A kernel chained into the expert
FFN + combine-A2A kernel.  The dense configs are chatglm3-6b (the
default), phi3-medium-14b, gemma2-27b (its sliding window and softcaps in
the same decode and paged steps; 54.5 GB of bf16 weights, which fit one
card) and deepseek-67b (134 GB: not one card).  Full-width dbrx-132b (264
GB of bf16 weights) does not fit one card: ``--layers N`` cuts a model to
its first N layers at full width (``chip_smoke.py`` serves dbrx at 8).  At
``--tp N`` dbrx's experts are split over the ranks and decode runs them as
decode EP (``models/moe.py``); ``--paged`` with a MoE model at tp > 1 raises
(ROADMAP Queue 1 item 5).
deepseek-v3-671b (MLA with its latent cache, the MoE layer's shared expert,
a dense prefix of 3 layers whose FFN down runs the fused GEMV) serves at
any ``--tp`` / ``--dp`` in bulk and fused mode and at ``--tp 1`` in kernel
mode; ``--layers N`` keeps the 3 prefix layers whole and needs N > 3
(``chip_smoke.py`` serves it at 5); ``--paged`` refuses it, as the
reference's launcher does (MLA keeps the dense latent cache).
qwen2-vl-2b (M-RoPE, the stub vision front end) and musicgen-medium (the
stub audio front end) serve as the dense configs do, dense and ``--paged``,
at any ``--tp`` / ``--dp`` in bulk and fused mode and at ``--tp 1`` in every
mode.  Serving is the text phase, as the reference's launcher serves them:
the engines feed token ids, and M-RoPE rotates by three equal streams at
each slot's position.

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device the default raises.  Weights are random, drawn from a fixed seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.autotune import (add_granularity_cli_args, cache_info,
                                       load_cache_if_exists, save_cache)
from repro_torch.core.calibrate import add_calibration_cli_args, warmup_and_calibrate
from repro_torch.core.degrade import DegradationPolicy, set_degradation_policy
from repro_torch.kernels import load_library
from repro_torch.launch.distributed import (add_distributed_cli_args, build_liveness_from_args,
                                            join_world)
from repro_torch.launch.mesh import BACKENDS, close_world
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.runtime.chaos import add_chaos_cli_args, build_fault_plan
from repro_torch.runtime.elastic import reshard_tree, shrink_context
from repro_torch.runtime.multiprocess import exit_for_respawn
from repro_torch.runtime.watchdog import verdict_for
from repro_torch.serve.engine import (DecodeEngine, PagedDecodeEngine, Request, request_journal,
                                      resubmit_journal, serve_with_chaos)
from repro_torch.serve.kv_cache import dense_cache_hbm_bytes, pool_hbm_bytes


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
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers, widths kept (0: all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fusion", default="kernel", choices=["kernel", "fused", "bulk"])
    add_granularity_cli_args(ap)
    add_calibration_cli_args(ap)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (run under torch.distributed.run)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data replicas of the tp world (dp * tp processes)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="the world's backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache + chunked prefill (continuous batching "
                         "over a shared block pool)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged mode)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool blocks; 0 = half the dense B x S_max budget")
    ap.add_argument("--chunk", type=int, default=8,
                    help="prefill chunk width C (paged mode)")
    ap.add_argument("--journal", default=None,
                    help="request journal to resubmit (tokens intact) in place "
                         "of the seeded requests, if the file exists")
    add_chaos_cli_args(ap)
    add_distributed_cli_args(ap)
    args = ap.parse_args(argv)

    bundle = get_arch(args.arch)
    if bundle.family == "rwkv6":
        raise NotImplementedError(_RWKV6_REFUSAL)
    bundle.check_tp(args)   # a family that does not run at --tp / --dp raises before the world
    if args.paged and not bundle.supports_paged:
        raise SystemExit(f"--paged requires a GQA transformer ({args.arch} is "
                         f"{bundle.family}/{getattr(bundle.config, 'attn_type', '?')})")
    device = join_world(args)
    try:
        return _serve(args, bundle, device)
    finally:
        close_world()


def decision_lines() -> list[str]:
    """Every cached autotune decision as ``op shape -> (q, wire)``, sorted."""
    return sorted(f"{k.op} {k.shape} -> ({d.q}, {d.wire})" for k, d in cache_info().items())


def _serve(args, bundle, device):
    ctx = ParallelContext(device=device, tp=args.tp, dp=args.dp, fusion=FusionConfig(
        mode=args.fusion, granularity=args.granularity, wire=args.wire))
    world = ctx.tp * ctx.dp
    rank0 = ctx.tp_rank == 0 and ctx.dp_rank == 0
    loaded = load_cache_if_exists(args.tune_cache)
    if args.tune_cache and rank0:
        print(f"tune cache: {loaded} decisions loaded from {args.tune_cache}")
    if args.reduced:
        bundle = bundle.reduced()
    if args.layers:
        prefix = getattr(bundle.config, "dense_prefix", 0)
        if args.layers <= prefix:
            raise SystemExit(f"--layers {args.layers}: {args.arch} keeps its {prefix} "
                             f"dense-prefix layers whole, so N must exceed {prefix}")
        bundle = dataclasses.replace(bundle, config=dataclasses.replace(
            bundle.config, n_layers=args.layers))
    cfg = bundle.config
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = bundle.init_params(gen, ctx)
    steps = [0]      # model steps of the drain

    def counted(fn):
        def step(*a):
            steps[0] += 1
            return fn(*a)
        return step

    def step_fns(c, p):
        """The engine's step function and cache (or pool) factory over ``c``."""
        if args.paged:
            serve = bundle.serve_step_fn(c)
            return (counted(lambda t, pl, tb, pos, nn: serve(p, t, pl, tb, pos, nn)),
                    lambda nb, bs: bundle.init_paged_pool(nb, bs, c.device, c.tp))
        decode = bundle.decode_fn(c)
        return (counted(lambda t, cache, pos: decode(p, t, cache, pos)),
                lambda b: bundle.init_cache(b, c.device, c.tp, c.dp))
    if args.paged:
        # half the dense budget, rounded to a tp-divisible block count
        num_blocks = args.num_blocks or max(
            ctx.tp, args.batch * cfg.max_seq // 2 // args.block_size // ctx.tp * ctx.tp)
        engine = PagedDecodeEngine(
            *step_fns(ctx, params), args.batch,
            num_blocks=num_blocks, block_size=args.block_size, max_seq=cfg.max_seq,
            chunk=args.chunk, device=ctx.device, n_stripes=ctx.tp)
        paged_b = pool_hbm_bytes(engine.pool)
        dense_b = dense_cache_hbm_bytes(bundle.init_cache(args.batch, "meta", ctx.tp, ctx.dp))
        if rank0:
            stripe = f" a rank (its stripe of {num_blocks // ctx.tp})" if ctx.tp > 1 else ""
            print(f"paged pool: {num_blocks} x {args.block_size}-token blocks "
                  f"= {paged_b / 2**20:.1f} MiB{stripe} vs dense B x S_max "
                  f"{dense_b / 2**20:.1f} MiB")
    else:
        engine = DecodeEngine(*step_fns(ctx, params), args.batch, device=ctx.device,
                              max_seq=cfg.max_seq,
                              reset_slot_fn=bundle.reset_slot_fn(ctx, args.batch))
    if args.journal and os.path.exists(args.journal):
        with open(args.journal) as f:
            n = resubmit_journal(engine, json.load(f))
        if rank0:
            print(f"journal: resubmitted {n} unfinished requests (tokens intact) "
                  f"from {args.journal}")
    else:
        for r in make_requests(args.requests, cfg.vocab, args.max_new):
            engine.submit(r)
    submitted = list(engine.queue)

    where = "cpu"
    if ctx.device.type == "cuda":
        where = torch.cuda.get_device_name(ctx.device)
        if args.fusion == "kernel":
            load_library()   # build the kernels outside the timed drain
    if args.calibrate:
        # one decode step on a scratch cache records the hot keys; the
        # engine's cache and requests are untouched
        decode = bundle.decode_fn(ctx)
        tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=ctx.device)
        pos = torch.zeros(args.batch, dtype=torch.int32, device=ctx.device)
        warmup_and_calibrate(ctx, lambda c: decode(params, tok, c, pos),
                             bundle.init_cache(args.batch, ctx.device, ctx.tp, ctx.dp),
                             iters=args.calibrate_iters, granularity=args.granularity,
                             rank_tag=f" [rank {torch.distributed.get_rank()}]"
                             if world > 1 else "")
    max_steps = len(engine.queue) * (cfg.max_seq - 1)
    plan = build_fault_plan(args.chaos, num_steps=max_steps)
    if args.degrade:
        set_degradation_policy(DegradationPolicy())
    cur = {"ctx": ctx, "params": params}

    def reshard_fn(eng):
        # drain-reshard-resume: shrink the world, re-place the weights over
        # the survivors, replay the in-flight requests through the new
        # cache or pool (they keep their generated tokens)
        old = cur["ctx"]
        new = shrink_context(old)
        new_params, _ = reshard_tree(cur["params"], bundle.param_specs(cur["params"]), new,
                                     old_ctx=old)
        cur["ctx"], cur["params"] = new, new_params
        if not new.member:
            return False
        if args.paged:
            n = eng.reshard(*step_fns(new, new_params), args.batch, n_stripes=new.tp)
        else:
            n = eng.reshard(*step_fns(new, new_params), args.batch)
            # a replica's rows change with the world
            eng.reset_slot_fn = bundle.reset_slot_fn(new, args.batch)
        if new.world.tp_rank == 0:
            print(f"rank lost: world -> (dp, tp) = ({new.dp}, {new.tp}), {n} in-flight "
                  f"requests re-queued", flush=True)

    hb_writer, liveness = build_liveness_from_args(args)
    if liveness is not None:
        liveness.enabled = True     # serving has no start-length steps
        # each tick beats its count, so a driver can act "at tick k"
        engine.step = _beating(engine.step, hb_writer)
    t0 = time.perf_counter()
    try:
        if plan is not None:
            finished, stats = serve_with_chaos(engine, plan, reshard_fn=reshard_fn,
                                               max_steps=max_steps)
        else:
            finished = engine.run_until_drained(max_steps=max_steps, liveness=liveness)
    except Exception as e:
        verdict = None if liveness is None else verdict_for(liveness, e)
        if verdict is None:
            raise
        _leave_for_respawn(verdict, engine, submitted, args.journal, hb_writer, rank0)
    finally:
        if args.degrade:
            set_degradation_policy(None)
    if plan is not None and stats["left"]:
        print(f"rank {torch.distributed.get_rank()} left the world (not kept by the shrink)",
              flush=True)
        return finished
    ctx = cur["ctx"]
    world = ctx.world.tp
    rank0 = ctx.world.tp_rank == 0
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    dt = time.perf_counter() - t0
    decisions = decision_lines()
    if world > 1:
        # every rank took the same greedy tokens from the same gathered
        # logits, and the same autotune decisions
        streams, taken = [None] * world, [None] * world
        group = ctx.world.group
        torch.distributed.all_gather_object(streams, [(r.uid, r.tokens) for r in finished],
                                            group=group)
        torch.distributed.all_gather_object(taken, decisions, group=group)
        if any(s != streams[0] for s in streams):
            raise AssertionError(f"the ranks' token streams differ: {streams}")
        if any(t != taken[0] for t in taken):
            raise AssertionError(f"the ranks' autotune decisions differ: {taken}")
    if hb_writer is not None:
        hb_writer.stop()            # after the last collective
    if not rank0:
        return finished
    if args.tune_cache:
        print(f"tune cache: {save_cache(args.tune_cache)} decisions saved to {args.tune_cache}")
    if plan is not None:
        print(f"chaos: plan {plan.summary()}; ticks {stats['ticks']}, dropped "
              f"{stats['dropped']}, reshards {stats['reshards']}, drained {stats['drained']}")
    if not finished.drained:
        print("WARNING: stopped at max_steps before draining — results truncated")
    total_tokens = sum(len(r.tokens) for r in finished)
    where_world = (f", dp={ctx.dp}, tp={ctx.tp} ({ctx.backend}), granularity="
                   f"{args.granularity}, wire={args.wire}" if world > 1 else "")
    print(f"served {len(finished)} requests, {total_tokens} tokens in "
          f"{dt:.3f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"{steps[0]} steps, {dt / max(steps[0], 1) * 1e3:.2f} ms/step, "
          f"batch={args.batch}, fusion={args.fusion}, "
          f"{'paged' if args.paged else 'dense'}, device={where}{where_world})")
    if world > 1:
        print(f"all {world} ranks' token streams equal: True")
        print(f"all {world} ranks' autotune decisions equal: True")
    for line in decisions:
        print(f"decision: {line}")
    for r in finished:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.tokens}")
    return finished


def _beating(step, writer):
    """``step`` beating the count of ticks run after each one."""
    ticks = [0]

    def beat():
        out = step()
        ticks[0] += 1
        writer.beat(step=ticks[0])
        return out
    return beat


def _leave_for_respawn(exc, engine, submitted, journal, hb_writer, rank0):
    """The respawn protocol's exit: rank 0 writes the unfinished requests,
    tokens intact, to ``journal`` and prints the streams of those finished,
    then the process ends with 17 for a lost peer, 16 for a stall."""
    if rank0:
        live = request_journal(engine)
        if journal:
            tmp = f"{journal}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(live, f)
            os.replace(tmp, journal)
            print(f"journal: persisted {len(live)} unfinished requests to {journal}")
        for r in submitted:
            if r.done:
                print(f"  req {r.uid}: prompt {r.prompt} -> {r.tokens}")
    exit_for_respawn(exc, hb_writer)


if __name__ == "__main__":
    main()
