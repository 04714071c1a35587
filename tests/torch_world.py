"""A gloo world of spawned CPU processes for the port's tensor-parallel tests.

Not collected (no ``test_`` prefix).  It imports neither ``jax`` nor
``repro``: ``torch.multiprocessing``'s spawn imports the module that defines
the worker again in every rank, which must stay free of JAX.

One world of ``WORLD = 4`` ranks serves a test module.  A tp = 4 task runs
over all four ranks; a tp = 2 task over the pairs (0, 1) and (2, 3), each
pair on the same inputs.  With data replicas (``dp``, the layouts of
``LAYOUTS``): (dp, tp) = (2, 2) runs one world, the pairs its tp groups and
(0, 2), (1, 3) its data groups (global rank ``r`` is tp rank ``r % 2`` of
replica ``r // 2``); (2, 1) runs two worlds of two replicas on the pairs;
(4, 1) one world of four replicas.  A task is a function of ``TASKS``, called on every
rank as ``fn(ctx_factory, **inputs)`` with numpy inputs; ``World.run``
returns each rank's result in rank order and fails after a timeout, tearing
the world down (the next task starts a new one), so that a hang fails one
test and not the whole run.  A little before the timeout every rank
still in its task writes its threads' stacks to stderr (``faulthandler``),
so a hang names where each rank waits.
"""
from __future__ import annotations

import faulthandler
import queue
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT_S = 120
# the (dp, tp) layouts a task can run at
LAYOUTS = ((1, 2), (1, 4), (2, 1), (2, 2), (4, 1))
TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rank_main(rank, init_method, inbox, outbox):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    torch.set_num_threads(1)
    init_world(WORLD, "gloo", "cpu", rank=rank, init_method=init_method)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    cross = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    pair, across = pairs[rank // 2], cross[rank % 2]
    # (dp, tp) -> (tp group, data group)
    groups = {(1, WORLD): (None, None), (1, 2): (pair, None), (2, 2): (pair, across),
              (2, 1): (None, pair), (4, 1): (None, None)}
    outbox.put((rank, "ready", None))
    while True:
        item = inbox.get()
        if item is None:
            break
        name, (dp, tp), kwargs = item

        def ctx(mode="fused", hw=None, **fusion):
            """``hw``: the link constants as a dict (None: the world's class)."""
            from repro_torch.core.perfmodel import HardwareModel, MeshHardwareModel

            link = None if hw is None else MeshHardwareModel.uniform(HardwareModel(**hw))
            group, data_group = groups[(dp, tp)]
            return ParallelContext(device="cpu", tp=tp, dp=dp, group=group,
                                   data_group=data_group, hw=link,
                                   fusion=FusionConfig(mode=mode, **fusion))
        faulthandler.dump_traceback_later(TIMEOUT_S - 10)
        try:
            outbox.put((rank, "ok", TASKS[name](ctx, **kwargs)))
        except Exception:        # the test shows the rank's traceback
            outbox.put((rank, "err", traceback.format_exc()))
        finally:
            faulthandler.cancel_dump_traceback_later()
    dist.destroy_process_group()


class World:
    """Spawns the world on first use; ``close`` ends every rank."""

    def __init__(self, rdv_dir):
        self.rdv_dir = rdv_dir
        self.procs = None
        self.gen = 0

    def _start(self):
        spawn = mp.get_context("spawn")
        self.gen += 1
        init = f"file://{self.rdv_dir}/rdv{self.gen}"
        self.inboxes = [spawn.Queue() for _ in range(WORLD)]
        self.outbox = spawn.Queue()
        self.procs = [spawn.Process(target=_rank_main, daemon=True,
                                    args=(r, init, self.inboxes[r], self.outbox))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self._collect("ready")

    def _collect(self, what):
        got = {}
        while len(got) < WORLD:
            try:
                rank, status, value = self.outbox.get(timeout=TIMEOUT_S)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"the world did not answer {what} within {TIMEOUT_S} s")
            if status == "err":
                self.close()
                raise RuntimeError(f"{what} failed on rank {rank}:\n{value}")
            got[rank] = value
        return [got[r] for r in range(WORLD)]

    def run(self, name: str, tp: int, dp: int = 1, **inputs) -> list:
        """``TASKS[name]`` on every rank at (dp, tp); each rank's result."""
        if (dp, tp) not in LAYOUTS:
            raise ValueError(f"(dp, tp) must be one of {LAYOUTS}")
        if self.procs is None:
            self._start()
        for box in self.inboxes:
            box.put((name, (dp, tp), inputs))
        return self._collect(name)

    def close(self):
        if self.procs is None:
            return
        for box, p in zip(self.inboxes, self.procs):
            if p.is_alive():
                box.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = None


# ---------------------------------------------------------------------------
# tasks: every rank runs one on its shard of the inputs (rank d of a tp
# world takes block d, as the reference's shard_map hands it out)
# ---------------------------------------------------------------------------
def _block(a, c, axis):
    """Rank ``c.tp_rank``'s block of ``a`` split into ``c.tp`` along ``axis``."""
    n = a.shape[axis] // c.tp
    return t(np.take(a, np.arange(c.tp_rank * n, (c.tp_rank + 1) * n), axis=axis))


@task
def ring_permute_task(ctx, x, shift, payload="tensor"):
    from repro_torch.core import collectives as col

    c = ctx()
    xl = t(x[c.tp_rank])
    if payload == "fp8":       # a (values, scale) pair permutes leaf by leaf
        got = col.ring_permute(c, col.wire_cast(xl, "fp8"), shift)
        return col.wire_uncast(got, torch.float32).numpy()
    return col.ring_permute(c, xl, shift).numpy()


@task
def wire_fault_task(ctx, x):
    """ring_permute with a hook that doubles every payload leaf on the wire."""
    from repro_torch.core import collectives as col

    c = ctx()
    prev = col.set_wire_fault_hook(lambda leaf: leaf * 2)
    try:
        return col.ring_permute(c, t(x[c.tp_rank])).numpy()
    finally:
        col.set_wire_fault_hook(prev)


@task
def all_gather_wire_task(ctx, x, wire, axis):
    from repro_torch.core.collectives import all_gather_wire

    c = ctx()
    return all_gather_wire(c, t(x[c.tp_rank]), axis=axis, wire=wire).numpy()


@task
def ring_rs_task(ctx, x, schedule, q, wire, skews=(0, 1), dtype="float32"):
    """ring_reduce_scatter_compute over this rank's partials x[d][f]."""
    from repro_torch.core.collectives import ring_reduce_scatter_compute

    c = ctx()
    xl = t(x[c.tp_rank]).to(getattr(torch, dtype))
    return [ring_reduce_scatter_compute(c, lambda f: xl[f], schedule=schedule,
                                        chunks_per_rank=q, sub_axis=0, skew=s,
                                        wire=wire).float().numpy() for s in skews]


@task
def ring_ag_task(ctx, x, wire):
    from repro_torch.core.collectives import ring_all_gather_compute

    c = ctx()
    xl = t(x[c.tp_rank])

    def place(src, xs, acc):
        acc = acc.clone()
        acc[src] = xs
        return acc
    return ring_all_gather_compute(c, xl, place, out_init=torch.zeros((c.tp,) + xl.shape),
                                   wire=wire).numpy()


@task
def direct_a2a_task(ctx, x, schedule, q, wire, skews=(0, 1)):
    """direct_all_to_all_compute of this rank's fine chunks x[d][f]."""
    from repro_torch.core.collectives import direct_all_to_all_compute

    c = ctx()
    xl = t(x[c.tp_rank])
    shape = (q * xl.shape[1],) + tuple(xl.shape[2:])
    return [direct_all_to_all_compute(c, lambda f: xl[f], shape, schedule=schedule,
                                      chunks_per_rank=q, sub_axis=0, skew=s,
                                      wire=wire).numpy() for s in skews]


@task
def bulk_a2a_task(ctx, x):
    from repro_torch.core.collectives import bulk_all_to_all

    c = ctx()
    return bulk_all_to_all(c, t(x[c.tp_rank])).numpy()


@task
def merge_task(ctx, o, m, l):
    from repro_torch.core.collectives import attention_partial_merge

    c = ctx()
    d = c.tp_rank
    return attention_partial_merge(c, t(o[d]), t(m[d]), t(l[d])).numpy()


@task
def matmul_allreduce_task(ctx, x, w, mode, q=1, wire="f32", schedule="comm_aware", skew=0):
    """x [..., K] and w [K, N] whole; this rank takes its K slice."""
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    c = ctx(mode, granularity=q, wire=wire, schedule=schedule, skew=skew)
    return matmul_allreduce(c, _block(x, c, x.ndim - 1), _block(w, c, 0)).numpy()


@task
def sp_products_task(ctx, x, w, mode, q=1):
    """allgather_matmul of this rank's sequence chunk and w columns, and
    matmul_reducescatter of its K slice and w rows (x [B, S, K], w [K, K])."""
    from repro_torch.core.allgather_matmul import (allgather_matmul, allgather_seq,
                                                   matmul_reducescatter)

    c = ctx(mode, granularity=q)
    ag = allgather_matmul(c, _block(x, c, 1), _block(w, c, 1))
    rs = matmul_reducescatter(c, _block(x, c, 2), _block(w, c, 0))
    return ag.numpy(), rs.numpy(), allgather_seq(c, _block(x, c, 1)).numpy()


def _shard_tree(tree, c):
    from repro_torch.models.transformer import shard_params

    as_t = lambda v: {k: as_t(u) for k, u in v.items()} if isinstance(v, dict) else t(v)
    return shard_params(as_t(tree), c)


@task
def mlp_decode_task(ctx, params, x, mode, act="silu"):
    from repro_torch.models.layers import mlp_apply

    c = ctx(mode)
    return mlp_apply(c, _shard_tree(params, c), t(x), act=act, seq_sharded=False).numpy()


@task
def embedding_task(ctx, table, tokens, scale=None):
    from repro_torch.models.layers import embedding_lookup

    c = ctx()
    p = _shard_tree({"table": table}, c)
    return embedding_lookup(c, p, t(tokens), seq_shard=False, scale=scale).numpy()


@task
def cache_update_task(ctx, cache, new, pos):
    from repro_torch.models.attention import cache_update

    c = ctx()
    local = _block(cache, c, 1)
    return cache_update(c, local, t(new), t(pos)).numpy()


@task
def decode_attention_task(ctx, q, k, v, pos, window=None, softcap=None):
    from repro_torch.models.attention import decode_attention

    c = ctx()
    return decode_attention(c, t(q), _block(k, c, 1), _block(v, c, 1), t(pos),
                            window=window, softcap_val=softcap).numpy()


@task
def decode_steps_task(ctx, tree, mode, tokens, positions, q=1, wire="f32", arch="chatglm3-6b"):
    """The reduced ``arch`` from the JAX package's weights (numpy), its
    decode steps on the given tokens; each step's logits and the cache's
    tensors ({"k", "v"}, or MLA's {"c", "kr"})."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy

    c = ctx(mode, granularity=q, wire=wire)
    bundle = get_arch(arch).reduced()
    params = params_from_numpy(tree, "cpu", c)
    dec = bundle.decode_fn(c)
    cache = bundle.init_cache(tokens.shape[1], "cpu", c.tp, c.dp)
    logits = []
    for tok, pos in zip(tokens, positions):
        lg, cache = dec(params, t(tok), cache, t(pos))
        logits.append(lg.numpy())
    return (np.stack(logits), *(v.numpy() for v in cache.values()))


@task
def init_params_task(ctx):
    """This rank's shards of the reduced chatglm3-6b's seeded weights."""
    from repro_torch.configs.registry import get_arch

    c = ctx()
    p = get_arch("chatglm3-6b").reduced().init_params(torch.Generator().manual_seed(0), c)
    lp = p["layers"][-1]
    return {"table": p["embed"]["table"].numpy(), "w_qkv": lp["attn"]["w_qkv"].numpy(),
            "w_gate": lp["ffn"]["w_gate"].numpy(), "w_down": lp["ffn"]["w_down"].numpy(),
            "ln2": lp["ln2"].numpy()}


@task
def refusal_task(ctx, what):
    """The message a path that does not run at tp > 1 raises with."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    try:
        if what == "kernel":
            matmul_allreduce(ctx("kernel"), torch.ones(4, 8), torch.ones(8, 4))
        elif what == "moe":          # the MoE kernels over ranks (item 1's real peers)
            from repro_torch.models.moe import moe_apply

            cfg = get_arch("dbrx-132b").reduced().config
            p = get_arch("dbrx-132b").reduced().init_params(torch.Generator(), ctx())
            moe_apply(ctx("kernel"), p["layers"][0]["ffn"], torch.zeros(1, 4, cfg.d_model),
                      cfg.moe)
        elif what == "moe_train":
            b = get_arch("dbrx-132b").reduced()
            tok = torch.zeros(1, 8, dtype=torch.long)
            b.loss_fn(ctx("kernel"))(b.init_params(torch.Generator(), ctx()),
                                     {"tokens": tok, "labels": tok})
        elif what in ("mla_prefill", "mla_decode"):   # deepseek-v3 in kernel mode
            b = get_arch("deepseek-v3-671b").reduced()
            p = b.init_params(torch.Generator(), ctx())
            if what == "mla_prefill":
                b.prefill_fn(ctx("kernel"))(p, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
            else:
                b.decode_fn(ctx("kernel"))(p, torch.zeros(2, 1, dtype=torch.long),
                                           b.init_cache(2, "cpu", ctx().tp),
                                           torch.zeros(2, dtype=torch.int32))
        elif what == "moe_prefill":
            b = get_arch("dbrx-132b").reduced()
            b.prefill_fn(ctx("kernel"))(b.init_params(torch.Generator(), ctx()),
                                        {"tokens": torch.zeros(1, 8, dtype=torch.long)})
        elif what == "paged":      # a MoE model's paged serving over ranks (item 5)
            from repro_torch.models.transformer import serve_step

            cfg = get_arch("dbrx-132b").reduced().config
            serve_step(ctx("bulk"), {}, cfg, torch.zeros(1, 1, dtype=torch.long), {}, None, 0, 1)
        elif what in ("compression", "adafactor"):
            from repro_torch.train.grad_compression import CompressionConfig
            from repro_torch.train.optimizer import OptimizerConfig
            from repro_torch.train.step import TrainConfig, build_train_step

            tc = (TrainConfig(compression=CompressionConfig(scheme="int8"))
                  if what == "compression" else
                  TrainConfig(optimizer=OptimizerConfig(name="adafactor")))
            build_train_step(lambda p, b: None, tc, ctx=ctx("bulk"), param_specs={})
        elif what == "rwkv6":
            get_arch("rwkv6-7b").reduced().decode_fn(ctx())
        elif what in ("zamba2_prefill", "zamba2_train"):   # kernel mode over ranks (item 1)
            b = zamba2_bundle(128)
            tok = torch.zeros(1, 8, dtype=torch.long)
            p = b.init_params(torch.Generator(), ctx(), training=what == "zamba2_train")
            if what == "zamba2_prefill":
                b.prefill_fn(ctx("kernel"))(p, {"tokens": tok})
            else:
                b.loss_fn(ctx("kernel"))(p, {"tokens": tok, "labels": tok})
    except NotImplementedError as e:
        return str(e)
    return None


def _sends(fn):
    """``fn()`` and how many ring sends ``models/attention`` started in it
    (payloads and travelling accumulators)."""
    from repro_torch.models import attention

    names = ("ring_permute_start", "accumulator_permute_start")
    real, count = {n: getattr(attention, n) for n in names}, [0]

    def counted(name):
        def send(*a, **kw):
            count[0] += 1
            return real[name](*a, **kw)
        return send
    for n in names:
        setattr(attention, n, counted(n))
    try:
        return fn(), count[0]
    finally:
        for n in names:
            setattr(attention, n, real[n])


@task
def ring_attention_task(ctx, q, k, v, mode, causal=True, window=None, cap=None, qs=1,
                        wire="f32", skews=(0,)):
    """context_attention of this rank's sequence chunks of q, k and v (whole
    [B, S, H, d]) at blocks of 16, once a skew; each output, the sends the
    ring started and the flash op's calls (kernel mode's spans)."""
    from repro_torch.models.attention import context_attention

    outs, sends, calls = [], [], []
    for skew in skews:
        c = ctx(mode, granularity=qs, wire=wire, skew=skew)
        before = _plain_calls()
        out, n = _sends(lambda: context_attention(
            c, _block(q, c, 1), _block(k, c, 1), _block(v, c, 1), causal=causal, window=window,
            softcap_val=cap, q_block=16, kv_block=16))
        outs.append(out.numpy())
        sends.append(n)
        calls.append(_plain_calls() - before)
    return outs, sends, calls


_PLAIN = [0]


def _plain_calls():
    """How often the flash op ran its plain version (the CPU's kernel mode)."""
    from repro_torch.kernels.flash_attention import ops

    if not getattr(ops.flash_attention_plain, "counted", False):
        plain = ops.flash_attention_plain

        def counted(*a, **kw):
            _PLAIN[0] += 1
            return plain(*a, **kw)
        counted.counted = True
        ops.flash_attention_plain = counted
    return _PLAIN[0]


@task
def embedding_seq_task(ctx, table, tokens, schedule, scale=None):
    from repro_torch.models.layers import embedding_lookup

    c = ctx(schedule=schedule)
    p = _shard_tree({"table": table}, c)
    return embedding_lookup(c, p, t(tokens), seq_shard=True, scale=scale).numpy()


def _lm_batch(tokens, labels=None, extras=None):
    """A global LM batch of tensors: the tokens, the labels where given, and
    a front end's extras (numpy arrays by name)."""
    batch = {"tokens": t(tokens)}
    if labels is not None:
        batch["labels"] = t(labels)
    batch.update({k: t(v) for k, v in (extras or {}).items()})
    return batch


@task
def prefill_task(ctx, tree, tokens, mode, arch="chatglm3-6b", q=1, wire="f32", extras=None):
    """The reduced ``arch`` from the JAX package's weights (numpy): its
    prefill of the tokens (and a front end's ``extras``) through
    ``prefill_fn``; the logits and this rank's chunk of the cache ({"k",
    "v"}, or MLA's {"c", "kr"})."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy

    c = ctx(mode, granularity=q, wire=wire)
    logits, cache = get_arch(arch).reduced().prefill_fn(c)(params_from_numpy(tree, "cpu", c),
                                                           _lm_batch(tokens, extras=extras))
    return (logits.numpy(), *(v.numpy() for v in cache.values()))


@task
def calibrate_ring_task(ctx, q, k, v, window=None):
    """A fused-mode context_attention with 'auto' granularity and wire on a
    cleared tuner cache, then the measured pass over its ring_attention key
    (one iteration a candidate): this rank's decisions and report."""
    from repro_torch.core import autotune, calibrate
    from repro_torch.models.attention import context_attention

    c = ctx("fused", granularity="auto", wire="auto")
    autotune.clear_cache()
    context_attention(c, _block(q, c, 1), _block(k, c, 1), _block(v, c, 1), window=window)
    rep = calibrate.measured_calibration_pass(c, iters=1, warmup=0)
    return _decisions(), [(k_.op, tuple(r["model_q"]), tuple(r["measured_q"]),
                           sorted(tuple(d) for d in r["times"]), r["fallback"])
                          for k_, r in rep.items()]


def _decisions():
    """This rank's cached autotune decisions: (key JSON, q, wire), sorted."""
    import json

    from repro_torch.core import autotune

    return sorted((json.dumps(autotune._key_to_json(k), sort_keys=True), d.q, d.wire)
                  for k, d in autotune.cache_info().items())


@task
def auto_task(ctx, x, w, op, hw=None, q="auto", wire="f32"):
    """``op`` ("matmul_allreduce": x [..., K], w [K, N] split by K;
    "allgather_matmul": x [B, S, K] by S, w [K, N] by N) with the given
    choices on a cleared tuner cache under the link constants ``hw``; this
    rank's output and its decisions."""
    from repro_torch.core import autotune
    from repro_torch.core.allgather_matmul import allgather_matmul
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    c = ctx("fused", hw=hw, granularity=q, wire=wire)
    autotune.clear_cache()
    if op == "matmul_allreduce":
        y = matmul_allreduce(c, _block(x, c, x.ndim - 1), _block(w, c, 0))
    else:
        y = allgather_matmul(c, _block(x, c, 1), _block(w, c, 1))
    return y.numpy(), _decisions()


@task
def calibrate_task(ctx, x, w, hw=None, fail=None):
    """matmul_allreduce's 'auto' key re-scored by measured_calibration_pass
    (one iteration a candidate); ``fail`` names a wire whose candidates
    raise on rank 1 only.  This rank's decisions and the report."""
    from repro_torch.core import autotune, calibrate
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    c = ctx("fused", hw=hw, granularity="auto", wire="auto")
    autotune.clear_cache()
    matmul_allreduce(c, _block(x, c, x.ndim - 1), _block(w, c, 0))
    builder = calibrate._BUILDERS["matmul_allreduce"]
    if fail is not None:
        def failing(cx, key):
            build = builder(cx, key)

            def pick(dec):
                if dec.wire == fail and cx.tp_rank == 1:
                    raise RuntimeError(f"no {fail} wire on rank 1")
                return build(dec)
            return pick
        calibrate._BUILDERS["matmul_allreduce"] = failing
    try:
        rep = calibrate.measured_calibration_pass(c, iters=1, warmup=0)
    finally:
        calibrate._BUILDERS["matmul_allreduce"] = builder
    return _decisions(), [(tuple(r["model_q"]), tuple(r["measured_q"]),
                           sorted((tuple(d), t) for d, t in r["times"].items()),
                           sorted(tuple(d) for d in r["excluded"]))
                          for r in rep.values()]


@task
def link_task(ctx):
    """The link constants a context of this world takes by default."""
    import dataclasses

    return dataclasses.asdict(ctx().hw.default)


# ---------------------------------------------------------------------------
# training at tp > 1: each ring's backward (tests/test_torch_ring_train.py)
# ---------------------------------------------------------------------------
def _grads(loss, leaves):
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@task
def product_grads_task(ctx, x, w, co, op, mode, q=1):
    """``op`` on this rank's shards of x [B, S, K] and w [K, N] (the
    reference's specs), the loss sum(y * co) over this rank's part of y;
    (dx, dw) of this rank's shards."""
    from repro_torch.core.allgather_matmul import allgather_matmul, matmul_reducescatter
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    c = ctx(mode, granularity=q)
    if op == "allgather_matmul":
        xl, wl = _block(x, c, 1), _block(w, c, 1)
        col = _block(co, c, 2)
        fn = allgather_matmul
    elif op == "matmul_reducescatter":
        xl, wl = _block(x, c, 2), _block(w, c, 0)
        col = _block(co, c, 1)
        fn = matmul_reducescatter
    else:
        xl, wl = _block(x, c, 2), _block(w, c, 0)
        col = t(co)
        fn = matmul_allreduce
    xl.requires_grad_(True)
    wl.requires_grad_(True)
    return _grads((fn(c, xl, wl) * col).sum(), [xl, wl])


@task
def ring_attention_grads_task(ctx, q, k, v, do, mode, causal=True, window=None, cap=None, qs=1,
                              wire="f32", skews=(0,)):
    """context_attention of this rank's chunks at blocks of 16 and its
    gradient with this rank's chunk of ``do``, once a skew: (dq, dk, dv)
    a skew, the sends the ring started in the forward and in the backward,
    and the flash op's calls."""
    from repro_torch.models.attention import context_attention

    grads, sends, calls = [], [], []
    for skew in skews:
        c = ctx(mode, granularity=qs, wire=wire, skew=skew)
        leaves = [_block(a, c, 1).requires_grad_(True) for a in (q, k, v)]
        before = _plain_calls()
        out, n_fwd = _sends(lambda: context_attention(
            c, *leaves, causal=causal, window=window, softcap_val=cap, q_block=16, kv_block=16))
        g, n_bwd = _sends(lambda: [a.numpy() for a in
                                   torch.autograd.grad(out, leaves, _block(do, c, 1))])
        grads.append(g)
        sends.append((n_fwd, n_bwd))
        calls.append(_plain_calls() - before)
    return grads, sends, calls


@task
def embedding_grad_task(ctx, table, tokens, dy, schedule):
    """The sequence-sharded lookup's table gradient (this rank's rows) under
    the loss sum(x * dy) over this rank's chunk (the whole x where S does
    not split)."""
    from repro_torch.models.layers import embedding_lookup

    c = ctx(schedule=schedule)
    tb = _block(table, c, 0).requires_grad_(True)
    x = embedding_lookup(c, {"table": tb}, t(tokens), seq_shard=True, scale=2.0)
    split = tokens.shape[1] % c.tp == 0
    return _grads((x * (_block(dy, c, 1) if split else t(dy))).sum(), [tb])[0]


@task
def ce_grads_task(ctx, x, e, y, cap=None, q=1, wire="f32", skew=0):
    """sharded_cross_entropy on this rank's sequence chunk of x (the whole x
    where S does not split) and vocabulary rows of e: the loss and (dx,
    dE)."""
    from repro_torch.core.loss import sharded_cross_entropy

    c = ctx("fused", granularity=q, wire=wire, skew=skew)
    S = y.shape[1]
    seq = S % c.tp == 0 and S >= c.tp
    xl = (_block(x, c, 1) if seq else t(x)).requires_grad_(True)
    el = _block(e, c, 0).requires_grad_(True)
    loss = sharded_cross_entropy(c, xl, el, t(y), logit_softcap=cap)
    return loss.item(), _grads(loss, [xl, el])


def _params_from(tree, c, arch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.optimizer import tree_leaves

    bundle = get_arch(arch).reduced()
    params = params_from_numpy(tree, "cpu", c, training=True)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return bundle, params


@task
def loss_grads_task(ctx, tree, tokens, labels, mode, arch="chatglm3-6b", q=1, wire="f32",
                    extras=None):
    """The reduced ``arch`` from the JAX package's weights: ``loss_fn``'s loss
    on the tokens (and a front end's ``extras``) and this rank's gradients,
    the whole leaves' summed over the ranks (``all_reduce_grads``, as the
    train step does), in ``tree_leaves`` order."""
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.train.optimizer import spec_leaves, tree_leaves

    c = ctx(mode, granularity=q, wire=wire)
    bundle, params = _params_from(tree, c, arch)
    leaves = tree_leaves(params)
    loss = bundle.loss_fn(c)(params, _lm_batch(tokens, labels, extras))
    grads = list(torch.autograd.grad(loss, leaves))
    all_reduce_grads(c, grads, spec_leaves(bundle.param_specs(params)))
    return loss.item(), [g.numpy() for g in grads]


@task
def train_steps_task(ctx, tree, batches, mode, arch="chatglm3-6b", lr=3e-3, steps=6,
                     microbatches=1, optimizer="adamw"):
    """``build_train_step`` with ``optimizer`` (AdamW by default) from the
    JAX package's weights on the given batches: each step's loss and grad
    norm, then this rank's parameters."""
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    c = ctx(mode)
    bundle, params = _params_from(tree, c, arch)
    tc = TrainConfig(optimizer=OptimizerConfig(name=optimizer, lr=lr,
                                               warmup_steps=max(steps // 20, 5),
                                               total_steps=steps),
                     microbatches=microbatches,
                     layer_period=bundle.config.local_global_period or 1)
    step = build_train_step(bundle.loss_fn(c), tc, ctx=c,
                            param_specs=bundle.param_specs(params))
    state = init_train_state(tc, params)
    out = []
    for tok, lab in batches[:steps]:
        state, m = step(state, {"tokens": t(tok), "labels": t(lab)})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out, [p.detach().numpy() for p in tree_leaves(state["params"])]


@task
def calibrate_ce_task(ctx, x, e, y):
    """The CE with 'auto' granularity and wire on a cleared tuner cache, then
    the measured pass over its ce_ring key (one iteration a candidate):
    this rank's decisions and report."""
    from repro_torch.core import autotune, calibrate
    from repro_torch.core.loss import sharded_cross_entropy

    c = ctx("fused", granularity="auto", wire="auto")
    autotune.clear_cache()
    sharded_cross_entropy(c, _block(x, c, 1), _block(e, c, 0), t(y))
    rep = calibrate.measured_calibration_pass(c, iters=1, warmup=0)
    return _decisions(), [(k_.op, tuple(r["model_q"]), tuple(r["measured_q"]),
                           sorted(tuple(d) for d in r["times"]), r["fallback"])
                          for k_, r in rep.items()]


# ---------------------------------------------------------------------------
# paged serving at tp > 1 (tests/test_torch_paged_tp.py)
# ---------------------------------------------------------------------------
def _stripe_of(pool, c):
    """Rank ``c.tp_rank``'s stripe of a whole pool [.., NB, ...] (numpy,
    blocks on axis ``-4``) with its zeroed sink block appended."""
    nb = pool.shape[-4] // c.tp
    part = np.take(pool, np.arange(c.tp_rank * nb, (c.tp_rank + 1) * nb), axis=-4)
    sink = np.zeros_like(np.take(part, [0], axis=-4))
    return t(np.concatenate([part, sink], axis=-4))


@task
def paged_ops_task(ctx, pool_k, pool_v, new, tables, pos, valid, q, window=None, cap=None):
    """paged_cache_update of ``new`` into this rank's stripe of both pools
    (whole [NB, block, H, d]), then paged_attention of q over them: the
    stripes (the sink apart), the sinks and the output."""
    from repro_torch.models.attention import paged_attention, paged_cache_update

    c = ctx("bulk")
    pk, pv = _stripe_of(pool_k, c), _stripe_of(pool_v, c)
    for pl in (pk, pv):
        paged_cache_update(c, pl, t(new), t(tables), t(pos), t(valid))
    out = paged_attention(c, t(q), pk, pv, t(tables), t(pos), window=window, softcap_val=cap)
    return pk[:-1].numpy(), pv[:-1].numpy(), pk[-1].numpy(), out.numpy()


@task
def paged_serve_task(ctx, tree, arch, mode, steps, tables, nb, block):
    """``serve_step`` of the reduced ``arch`` from the JAX package's weights
    (serving shards) over this rank's stripe of an ``nb``-block pool: each
    step's logits, then the stripes (the sink apart)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy

    c = ctx(mode)
    bundle = get_arch(arch).reduced()
    params = params_from_numpy(tree, "cpu", c)
    pool = bundle.init_paged_pool(nb, block, "cpu", c.tp)
    serve = bundle.serve_step_fn(c)
    logits = []
    for tk, pos, nn in steps:
        lg, pool = serve(params, t(tk), pool, t(tables), t(pos), t(nn))
        logits.append(lg.numpy())
    return logits, pool["k"][:, :-1].numpy(), pool["v"][:, :-1].numpy()


@task
def paged_engine_task(ctx, tree, arch, mode, prompts, max_new, batch, num_blocks, block,
                      chunk):
    """The paged engine over this rank's stripes (``n_stripes`` = tp) on the
    given prompts: each request's tokens, the allocator's peak blocks, each
    stripe's peak of the blocks the step's tables name, and how often it
    deferred an admission and preempted a request."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve.engine import PagedDecodeEngine, Request

    c = ctx(mode)
    bundle = get_arch(arch).reduced()
    params = params_from_numpy(tree, "cpu", c)
    serve = bundle.serve_step_fn(c)
    peaks = [0] * c.tp

    def step(tk, pl, tb, pos, nn):
        """serve_step, noting the blocks each stripe holds in the tables."""
        held = np.unique(tb.numpy())
        for s_, n_ in enumerate(np.bincount(held[held >= 0] // (num_blocks // c.tp),
                                            minlength=c.tp)):
            peaks[s_] = max(peaks[s_], int(n_))
        return serve(params, tk, pl, tb, pos, nn)
    eng = PagedDecodeEngine(step,
                            lambda nb, bs: bundle.init_paged_pool(nb, bs, "cpu", c.tp), batch,
                            num_blocks=num_blocks, block_size=block,
                            max_seq=bundle.config.max_seq, chunk=chunk, device="cpu",
                            n_stripes=c.tp)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=list(p), max_new=max_new))
    done = eng.run_until_drained(max_steps=500)
    return (sorted((r.uid, r.tokens) for r in done), eng.kv.peak_blocks, peaks, eng.deferred,
            eng.preempted)


# ---------------------------------------------------------------------------
# the data axis (tests/test_torch_dp.py)
# ---------------------------------------------------------------------------
@task
def place_task(ctx, tree):
    """This rank's serving and training shards of a JAX-layout tree."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.optimizer import tree_leaves

    c = ctx()
    return [[a.numpy() for a in tree_leaves(params_from_numpy(tree, "cpu", c, training=tr))]
            for tr in (False, True)]


@task
def global_norm_task(ctx, grads, specs):
    """``global_norm`` of this rank's training shards of whole numpy leaves
    under their specs."""
    from repro_torch.parallel.sharding import shard_leaf
    from repro_torch.train.optimizer import global_norm

    c = ctx()
    leaves = [shard_leaf(t(g), tuple(sp), c, training=True) for g, sp in zip(grads, specs)]
    return global_norm(leaves, c, [tuple(sp) for sp in specs]).item()


@task
def compress_task(ctx, grads, residuals, specs, scheme, ratio=0.01, period=1, steps=1):
    """``compress_decompress`` of this rank's training shards of a tree of
    whole numpy gradients and residuals (``specs`` its logical specs),
    ``steps`` times on the same gradients: the gradients and residuals, this
    rank's shards, in tree order."""
    from repro_torch.parallel.sharding import shard_leaf
    from repro_torch.train.grad_compression import CompressionConfig, compress_decompress
    from repro_torch.train.optimizer import tree_leaves, tree_map

    c = ctx()
    # copies: the update is in place, and a whole leaf's tensor would share
    # the input array's memory
    cut = lambda tree: tree_map(lambda a, sp: shard_leaf(t(a).clone(), tuple(sp), c,
                                                         training=True), tree, specs)
    res = cut(residuals)
    cfg = CompressionConfig(scheme=scheme, topk_ratio=ratio)
    for _ in range(steps):
        g, res = compress_decompress(cfg, cut(grads), res, period, c, specs)
    return [x.numpy() for x in tree_leaves(g)], [x.numpy() for x in tree_leaves(res)]


@task
def train_state_task(ctx, state):
    """This rank's shards of a JAX train state (``train_state_from_numpy``):
    the params, mu and nu leaves."""
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.train.optimizer import tree_leaves

    c = ctx()
    st = train_state_from_numpy(state, "cpu", c)
    return [[a.detach().numpy() for a in tree_leaves(tr)]
            for tr in (st["params"], st["opt"]["mu"], st["opt"]["nu"])]


@task
def unmade_groups_task(ctx):
    """A (2, 2) context with no groups passed, in a world whose (2, 2)
    groups were never made: the error it raises (None if it raised none)."""
    from repro_torch.parallel.sharding import ParallelContext

    try:
        ParallelContext(device="cpu", tp=2, dp=2)
    except RuntimeError as e:
        return str(e)
    return None


@task
def data_collectives_task(ctx, x):
    """all_gather_data, reduce_scatter_data and data_mean (with its gradient)
    of this rank's x[dp_rank, tp_rank]."""
    from repro_torch.core.collectives import all_gather_data, data_mean, reduce_scatter_data

    c = ctx()
    xl = t(x[c.dp_rank, c.tp_rank]).requires_grad_(True)
    mean = data_mean(c, xl.sum())
    return (all_gather_data(c, xl.detach()).numpy(), reduce_scatter_data(c, xl.detach()).numpy(),
            mean.item(), torch.autograd.grad(mean, xl)[0].numpy())


# ---------------------------------------------------------------------------
# MoE over the (dp, tp) world (tests/test_torch_moe_tp.py)
# ---------------------------------------------------------------------------
def _rows(a, c, axis=0):
    """This rank's replica's rows of ``a`` (all of them where dp does not
    divide them)."""
    n = a.shape[axis]
    if c.dp == 1 or n % c.dp:
        return a
    return np.take(a, np.arange(c.dp_rank * n // c.dp, (c.dp_rank + 1) * n // c.dp), axis=axis)


@task
def moe_layer_task(ctx, params, x, cfg, mode, seq_sharded=True, q=1, wire="f32", skews=(0,),
                   co=None):
    """``moe_apply`` on this rank's experts (block tp_rank of the whole
    [E, ...] leaves; a shared expert whole) and its part of x [B, S, D]: its
    replica's rows, and
    with ``seq_sharded`` its tp block of S (else all of S, replicated).
    One output per skew; with a cotangent ``co`` (x's shape) also, per
    skew, the gradients of sum(y * co): x's part, then the router's (summed
    over the world, as a whole leaf's), w_gate's, w_up's and w_down's (this
    rank's experts)."""
    from repro_torch.core.collectives import all_reduce
    from repro_torch.models.moe import MoEConfig, moe_apply

    mcfg = MoEConfig(**cfg)
    B = x.shape[0]
    rows_split = ctx().dp > 1 and B % ctx().dp == 0
    outs, grads = [], []
    for skew in skews:
        c = ctx(mode, granularity=q, wire=wire, skew=skew)
        p = {k: (t(v) if k == "router" else {n: t(w) for n, w in v.items()} if k == "shared"
                 else _block(v, c, 0)) for k, v in params.items()}
        xl = t(_rows(x, c))
        if seq_sharded:
            xl = _block(xl.numpy(), c, 1)
        if co is not None:
            xl.requires_grad_(True)
            for v in p.values():
                v.requires_grad_(True)
        y = moe_apply(c, p, xl, mcfg, seq_sharded=seq_sharded, rows_split=rows_split)
        outs.append(y.detach().numpy())
        if co is not None:
            col = t(_rows(co, c))
            if seq_sharded:
                col = _block(col.numpy(), c, 1)
            leaves = [xl, p["router"], p["w_gate"], p["w_up"], p["w_down"]]
            g = list(torch.autograd.grad((y * col).sum(), leaves))
            g[1] = all_reduce(c, g[1])
            if c.dp > 1:
                g[1] = all_reduce(c.data, g[1])
            grads.append([a.numpy() for a in g])
    return outs, grads


@task
def moe_entries_task(ctx, x, w_up, w_gate, w_down, mode, q=1, wire="f32", skews=(0,)):
    """``moe_dispatch_all_to_all`` of this rank's part of the global
    dispatch buffer x [B, n_ep, E, C, D] (its replica's rows, its tp block
    of the expert dim), then ``fused_expert_ffn_combine`` of that output on
    its experts; each per skew."""
    from repro_torch.core.moe_all_to_all import (fused_expert_ffn_combine,
                                                 moe_dispatch_all_to_all)

    out = []
    for skew in skews:
        c = ctx(mode, granularity=q, wire=wire, skew=skew)
        xl = _block(_rows(x, c), c, 2)
        ws = [_block(w, c, 0) for w in (w_up, w_gate, w_down)]
        d = moe_dispatch_all_to_all(c, xl)
        out.append((d.numpy(), fused_expert_ffn_combine(c, d, *ws, act="silu").numpy()))
    return out


@task
def adafactor_task(ctx, state, grads, steps=2):
    """``adafactor_update`` over this rank's training shards of a JAX train
    state (``train_state_from_numpy``) and of whole gradients (a JAX-layout
    tree), ``steps`` times: the parameters, then the factored state, this
    rank's shards in tree order."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
    from repro_torch.train.optimizer import OptimizerConfig, adafactor_update, tree_leaves

    c = ctx()
    st = train_state_from_numpy(state, "cpu", c)
    g = params_from_numpy(grads, "cpu", c, training=True)
    specs = get_arch("dbrx-132b").param_specs(st["params"])
    cfg = OptimizerConfig(name="adafactor", lr=1e-2, warmup_steps=1)
    for _ in range(steps):
        adafactor_update(cfg, g, st["opt"], st["params"], 1, c, specs)
    return ([p.detach().numpy() for p in tree_leaves(st["params"])],
            [v.numpy() for v in tree_leaves(st["opt"]["v"])])


# ---------------------------------------------------------------------------
# DLRM over the flattened (dp, tp) world: world rank r = dp_rank * tp +
# tp_rank holds tables [r T / n, (r + 1) T / n) and runs rows [r B / n, ...)
# ---------------------------------------------------------------------------
def _dlrm_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@task
def dlrm_a2a_task(ctx, tables, indices, mode, cases, hw=None, skews=(0, 1)):
    """``embedding_all_to_all`` of this rank's world shard of whole numpy
    tables [T, V, D] and the global batch's indices on them, for each (q,
    wire) of ``cases`` at each of ``skews`` (``skew_world``) on a cleared
    tuner cache: each case's outputs, the pooling calls of the first run
    (rows, tables), and the tuner's decisions."""
    from repro_torch.core import autotune
    from repro_torch.core import embedding_all_to_all as emb
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models.dlrm import DLRM_PARAM_SPECS
    from repro_torch.parallel.sharding import shard_leaf

    autotune.clear_cache()
    calls, pool = [], emb.embedding_pool_tables

    def counted(tb, ix):
        calls.append((ix.shape[0], tb.shape[0]))
        return pool(tb, ix)
    emb.embedding_pool_tables = counted
    out = []
    try:
        for q, wire in cases:
            got, first = [], None
            for skew in skews:
                c = ctx(mode, hw=hw, granularity=q, wire=wire, skew_world=skew)
                tab = shard_leaf(t(tables), DLRM_PARAM_SPECS["tables"], c)
                idx = shard_batch({"indices": t(indices)}, c)["indices"]
                calls.clear()
                got.append(emb.embedding_all_to_all(c, idx, tab).numpy())
                first = list(calls) if first is None else first
            out.append((got, first))
    finally:
        emb.embedding_pool_tables = pool
    return out, _decisions()


def _dlrm_params(tree, c):
    from repro_torch.models.convert import dlrm_params_from_numpy
    from repro_torch.train.optimizer import tree_leaves

    params = dlrm_params_from_numpy(tree, "cpu", c)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


@task
def dlrm_loss_grads_task(ctx, tree, batch, mode, q=1, wire="f32", skew=0):
    """Reduced DLRM from the JAX package's weights, this rank's world shard
    of the tables: ``loss_fn``'s loss and this rank's gradients, the whole
    leaves' summed over the world (``all_reduce_grads``, as the train step
    does), in ``tree_leaves`` order.  In kernel mode: the error the backward
    raises, as a string."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.train.optimizer import spec_leaves, tree_leaves

    c = ctx(mode, granularity=q, wire=wire, skew_world=skew)
    bundle = get_arch("dlrm").reduced()
    params = _dlrm_params(tree, c)
    leaves = tree_leaves(params)
    loss = bundle.loss_fn(c)(params, _dlrm_batch(batch))
    if mode == "kernel":
        try:
            torch.autograd.grad(loss, leaves)
        except NotImplementedError as e:
            return str(e)
        return None
    grads = list(torch.autograd.grad(loss, leaves))
    all_reduce_grads(c, grads, spec_leaves(bundle.param_specs(params)))
    return loss.item(), [g.numpy() for g in grads]


@task
def dlrm_train_steps_task(ctx, tree, batches, mode, lr=3e-3):
    """AdamW steps through ``build_train_step`` from the JAX package's
    weights, one a batch: each step's loss and grad norm, then this rank's
    parameters (the tables its world shard) and its first moments."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    c = ctx(mode)
    bundle = get_arch("dlrm").reduced()
    params = _dlrm_params(tree, c)
    tc = TrainConfig(optimizer=OptimizerConfig(lr=lr, warmup_steps=5, total_steps=len(batches)))
    step = build_train_step(bundle.loss_fn(c), tc, ctx=c, param_specs=bundle.param_specs(params))
    state = init_train_state(tc, params)
    out = []
    for b in batches:
        state, m = step(state, _dlrm_batch(b))
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out, [p.detach().numpy() for p in tree_leaves(state["params"])], \
        [m.numpy() for m in tree_leaves(state["opt"]["mu"])]


@task
def world_a2a_task(ctx, x, xb, g, q, wire="f32", schedule="comm_aware", skew=0):
    """The all-to-alls over ``group="world"``: ``direct_all_to_all_compute``
    of this world rank's fine chunks x[r][f] (with autograd), its gradient
    for the cotangent g[r], ``direct_all_to_all_transpose`` of g[r], and
    ``bulk_all_to_all`` of xb[r]."""
    from repro_torch.core import collectives as col

    c = ctx()
    r = c.world.tp_rank
    xl = t(x[r]).requires_grad_(True)
    kw = dict(schedule=schedule, chunks_per_rank=q, sub_axis=0, skew=skew, wire=wire,
              group="world")
    out = col.direct_all_to_all_compute(c, lambda f: xl[f] * 1.0, (q * x.shape[2], x.shape[3]),
                                        **kw)
    (grad,) = torch.autograd.grad(out, xl, t(g[r]))
    back = col.direct_all_to_all_transpose(c, t(g[r]), **kw)
    bulk = col.bulk_all_to_all(c, t(xb[r]), group="world")
    return out.detach().numpy(), grad.numpy(), back.numpy(), bulk.numpy()


# ---------------------------------------------------------------------------
# the in-process runtime (tests/test_torch_runtime_world.py)
# ---------------------------------------------------------------------------
def toy_step(c, state, xg):
    """The chaos scenarios' step (tests/test_chaos.py's, in torch) over
    ``c``'s world: this rank's rows of the global batch ``xg`` [B, S, K]
    (its replica's ``B / dp``) and its ``K / tp`` columns; y = x w summed
    over tp (``matmul_allreduce``), g = x^T tanh(y) summed over the data
    ranks, w -= 0.01 g in place, the loss mean(y^2) over the world's rows.
    The step slices the batch by its own context, so a shrunk world's step
    takes the rows of its new replicas."""
    from repro_torch.core.collectives import all_reduce, data_mean
    from repro_torch.core.matmul_allreduce import matmul_allreduce

    rows = xg.shape[0] // c.dp
    cols = xg.shape[2] // c.tp
    x = xg[c.dp_rank * rows:(c.dp_rank + 1) * rows, :, c.tp_rank * cols:(c.tp_rank + 1) * cols]
    y = matmul_allreduce(c, x.contiguous(), state["w"])
    g = torch.einsum("bsk,bsn->kn", x, torch.tanh(y))
    if c.dp > 1:
        g = all_reduce(c.data, g)
    with torch.no_grad():
        state["w"].sub_(0.01 * g)
    return state, {"loss": data_mean(c, torch.mean(y * y))}


def _toy_supervisor(c, path, plan=None, **kw):
    import functools

    from repro_torch.checkpoint import Placement
    from repro_torch.runtime.fault_tolerance import SupervisorConfig, TrainSupervisor

    cfg = SupervisorConfig(checkpoint_dir=path, checkpoint_every=3, keep=3, max_restarts=8,
                           backoff_base_s=1e-4, backoff_max_s=1e-3)
    return TrainSupervisor(cfg, functools.partial(toy_step, c),
                           state_shardings=Placement(c, {"w": ("tp", None)}, training=True),
                           fault_plan=plan, sleep_fn=lambda s: None, **kw)


def _world_dir(path, c):
    """One directory a world: the two tp = 2 worlds run on the pairs."""
    import torch.distributed as dist

    return f"{path}/w{dist.get_rank() // (c.dp * c.tp)}"


@task
def toy_chaos_task(ctx, w, batches, path, plan=None, lose=False):
    """The toy step under the supervisor on this world (fused mode), from
    the whole ``w``; ``plan`` a list of (step, kind, rank, nth_send).  With
    ``lose`` a rank loss shrinks the world (``shrink_context``, every rank
    of the default group) and reshards the state (the lost ranks take part,
    then leave).  Returns this rank's w shard (None where it left), the
    step, the supervisor's counts and failures, the final world's (dp, tp)
    and ranks."""
    import functools

    from repro_torch.runtime.chaos import FaultEvent, FaultPlan
    from repro_torch.runtime.elastic import reshard_tree, shrink_context

    c = ctx("fused", granularity=2)
    cur = {"ctx": c}
    state = {"w": _block(w, c, 0).clone()}
    fp = None if plan is None else FaultPlan([FaultEvent(step=s, kind=k, rank=r, nth_send=n)
                                              for s, k, r, n in plan])

    def on_rank_loss(st, exc):
        old = cur["ctx"]
        cur["ctx"] = shrink_context(old)
        st, sup.state_shardings = reshard_tree(st, {"w": ("tp", None)}, cur["ctx"],
                                               old_ctx=old, training=True)
        return (None, None) if st is None else (st, functools.partial(toy_step, cur["ctx"]))

    sup = _toy_supervisor(c, _world_dir(path, c), fp,
                          on_rank_loss=on_rank_loss if lose else None)
    state, step = sup.run(state, [t(b) for b in batches], len(batches))
    n = cur["ctx"]
    return (None if state is None else state["w"].numpy().copy(), step,
            (sup.restarts, sup.faults_injected, sup.rank_losses, sup.left), sup.failures,
            (n.dp, n.tp, n.ranks, n.member))


def _state_tree(whole, fn, path=()):
    """``fn(path, numpy leaf)`` over a nested tree of dicts and lists."""
    if isinstance(whole, dict):
        return {k: _state_tree(v, fn, path + (k,)) for k, v in whole.items()}
    if isinstance(whole, list):
        return [_state_tree(v, fn, path + (i,)) for i, v in enumerate(whole)]
    return fn(path, whole)


def _as_state(path, a):
    """A leaf of a whole train state as a tensor: ``nu`` in bf16."""
    x = torch.from_numpy(np.array(a))
    return x.to(torch.bfloat16) if "nu" in path else x


def _host(x):
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


@task
def ckpt_state_task(ctx, whole, specs, path, mode):
    """Checkpoints of a train state over this world.  ``mode`` "save":
    this rank's shards of the whole tree (fsdp dims over data, ``nu`` in
    bf16) saved through an async manager (every rank gathers, world rank
    0 writes), then the whole tree restored at (1, 1) on every rank;
    "restore": this world's shards restored.  Returns the step and numpy
    trees (bf16 leaves as their int16 words)."""
    from repro_torch.checkpoint import CheckpointManager, Placement
    from repro_torch.checkpoint.checkpointer import world_barrier
    from repro_torch.parallel.sharding import ParallelContext, shard_leaf

    def spec_at(p):
        s = specs
        for k in p:
            s = s[k]
        return tuple(s)

    c = ctx()
    mine = _state_tree(whole, lambda p, a: shard_leaf(_as_state(p, a), spec_at(p), c,
                                                      training=True))
    zeros = lambda tree: _state_tree(tree, lambda p, x: torch.zeros_like(x))
    host = lambda tree: _state_tree(tree, lambda p, x: _host(x))
    mgr = CheckpointManager(path, keep=2, async_save=True)
    if mode == "save":
        mgr.save(4, mine, Placement(c, specs, training=True))
        mgr.wait()
        world_barrier(Placement(c, specs))      # the writer is done for every rank
        one = ParallelContext(device="cpu")
        out, step = mgr.restore_latest(zeros(_state_tree(whole, _as_state)),
                                       Placement(one, specs, training=True))
        return step, host(out)
    out, step = mgr.restore_latest(zeros(mine), Placement(c, specs, training=True))
    return step, host(out), host(mine)


@task
def telemetry_task(ctx, w, xg):
    """Each rank's own step time gathered over the world
    (``ProcessTelemetry``), the rotation the estimator makes of them, and
    the toy step built at that rotation beside the one at 0 (fused mode, 2
    sub-chunks, so the rotation reorders the sends)."""
    import dataclasses

    from repro_torch.runtime.straggler import (ProcessTelemetry, SkewEstimator, SkewScheduler,
                                               StragglerMonitor)

    c = ctx("fused", granularity=2)
    tel = ProcessTelemetry(StragglerMonitor(), c.dp * c.tp, ctx=c)
    gathered = tel(0.1 * (c.dp_rank * c.tp + c.tp_rank + 1))
    est = SkewEstimator({"data": c.dp, "model": c.tp}, alpha=1.0, min_obs=1, hysteresis=0.0)

    def build(skew):
        cs = c.with_fusion(dataclasses.replace(c.fusion, skew=skew))
        return lambda st, x: toy_step(cs, st, x)

    sched = SkewScheduler(build, est, axis="model")
    outs = []
    for bucket in (0, None):
        if bucket is None:
            sched.observe(gathered)
        state = {"w": _block(w, c, 0).clone()}
        _, m = sched.fn()(state, t(xg))
        outs.append((state["w"].numpy(), float(m["loss"])))
    return gathered, sched.bucket, sched.rebuilds, outs


@task
def serve_chaos_task(ctx, tree, requests, max_new, plan):
    """Reduced chatglm3-6b's dense engine drained clean, then under
    ``serve_with_chaos`` with ``plan`` (step, kind, rank) whose rank loss
    shrinks the world (the weights re-placed over the survivors, the lost
    ranks taking part, then leaving) and reshards the engine.  Returns both
    drains' tokens (the chaos one None where this rank left), the stats
    and the final world's (dp, tp, ranks)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.runtime.chaos import FaultEvent, FaultPlan
    from repro_torch.runtime.elastic import reshard_tree, shrink_context
    from repro_torch.serve.engine import DecodeEngine, Request, serve_with_chaos

    c = ctx("fused")
    bundle = get_arch("chatglm3-6b").reduced()
    params = params_from_numpy(tree, "cpu", c)

    def engine(cc, p):
        dec = bundle.decode_fn(cc)
        return DecodeEngine(lambda tk, cache, pos: dec(p, tk, cache, pos),
                            lambda b: bundle.init_cache(b, "cpu", cc.tp, cc.dp), 4,
                            device="cpu", max_seq=bundle.config.max_seq)

    def drain(eng, plan=None, reshard_fn=None):
        for i, p in enumerate(requests):
            eng.submit(Request(uid=i, prompt=list(p), max_new=max_new))
        if plan is None:
            return eng.run_until_drained(max_steps=200), None
        return serve_with_chaos(eng, plan, reshard_fn=reshard_fn, sleep_fn=lambda s: None,
                                max_steps=200)

    clean, _ = drain(engine(c, params))
    cur = {"ctx": c}

    def reshard_fn(eng):
        old = cur["ctx"]
        cur["ctx"] = new = shrink_context(old)
        p, _ = reshard_tree(params, bundle.param_specs(params), new, old_ctx=old)
        if not new.member:
            return False
        fresh = engine(new, p)
        eng.reshard(fresh.decode_fn, fresh.init_cache_fn)

    fp = FaultPlan([FaultEvent(step=s, kind=k, rank=r, delay_s=0.0) for s, k, r in plan])
    fin, stats = drain(engine(c, params), fp, reshard_fn)
    n = cur["ctx"]
    got = None if stats["left"] else sorted((r.uid, r.tokens) for r in fin)
    return sorted((r.uid, r.tokens) for r in clean), got, stats, (n.dp, n.tp, n.ranks)


# ---------------------------------------------------------------------------
# MLA over the world (deepseek-v3)
# ---------------------------------------------------------------------------
@task
def mla_attention_task(ctx, params, cfg, x, mode, x_dec, c_cache, kr_cache, pos):
    """``mla_context_attention`` on this rank's part of x [B, S, D] (its
    replica's rows, its tp block of S): the output, the latents and the
    shapes of the ring's payloads (a list per send); then
    ``mla_decode_attention`` of x_dec [B, 1, D] (the replica's rows) over
    this rank's rows of the caches [B, S_max, ...]."""
    from repro_torch.models import mla

    c = ctx(mode)
    mcfg = mla.MLAConfig(**cfg)
    p = {k: t(v) for k, v in params.items()}
    xl = _block(_rows(x, c), c, 1)
    real, sent = mla.ring_permute_start, []

    def counted(cc, payload, *a, **kw):
        sent.append([tuple(v.shape) for v in payload])
        return real(cc, payload, *a, **kw)
    mla.ring_permute_start = counted
    try:
        out, (lat_c, lat_kr) = mla.mla_context_attention(c, p, mcfg, xl)
    finally:
        mla.ring_permute_start = real
    dec = mla.mla_decode_attention(c, p, mcfg, t(_rows(x_dec, c)),
                                   _block(_rows(c_cache, c), c, 1),
                                   _block(_rows(kr_cache, c), c, 1), t(_rows(pos, c)))
    return out.numpy(), lat_c.numpy(), lat_kr.numpy(), sent, dec.numpy()


# ---------------------------------------------------------------------------
# zamba2 over the world: its Mamba heads split by heads, its shared block
# context-parallel (tests/test_torch_zamba2_world.py)
# ---------------------------------------------------------------------------
def zamba2_bundle(d_model):
    """The reduced zamba2-7b at ``d_model`` (128: 4 Mamba heads of 64)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch

    b = get_arch("zamba2-7b").reduced()
    return dataclasses.replace(b, config=dataclasses.replace(b.config, d_model=d_model))


def _leaves(cache):
    """(group, leaf) -> numpy array of a zamba2 cache."""
    return {(g, k): v.detach().numpy().copy() for g, sub in cache.items() if sub is not None
            for k, v in sub.items()}


@task
def zamba2_task(ctx, tree, d_model, tokens, labels, mode, steps, path):
    """The reduced zamba2-7b at ``d_model`` from the JAX package's weights on
    this world.  Its prefill of ``tokens`` (the logits, this rank's cache
    leaves, the fused rings it ran), then ``steps`` greedy decode steps
    from the prefill's state (the prompt's k and v gathered over tp and
    placed into this rank's rows of the decode cache): each step's logits
    and the final cache; ``loss_fn``'s loss on (tokens, labels) and this
    rank's gradients, summed over the ranks as the train step sums them,
    in ``tree_leaves`` order, and their global norm over the world (the
    clip's); and the training shards checkpointed to
    ``path`` (world rank 0 writes; the two tp = 2 worlds a directory each)
    and restored onto zeros."""
    from repro_torch.checkpoint import CheckpointManager, Placement
    from repro_torch.checkpoint.checkpointer import world_barrier
    from repro_torch.core import matmul_allreduce as mar
    from repro_torch.core.collectives import all_gather, all_reduce_grads
    from repro_torch.data.pipeline import batch_rows
    from repro_torch.models.convert import zamba2_params_from_numpy
    from repro_torch.train.optimizer import global_norm, spec_leaves, tree_leaves, tree_map

    c = ctx(mode)
    bundle = zamba2_bundle(d_model)
    cfg = bundle.config
    serve = zamba2_params_from_numpy(tree, "cpu", cfg, c)
    rings, real = [], mar._ring
    mar._ring = lambda *a, **kw: rings.append(1) or real(*a, **kw)
    try:
        with torch.no_grad():
            logits, cache = bundle.prefill_fn(c)(serve, _lm_batch(tokens))
    finally:
        mar._ring = real
    B, S = tokens.shape
    dc = bundle.init_cache(B, "cpu", c.tp, c.dp)
    for g in ("mamba", "tail"):
        for k in dc[g]:
            dc[g][k].copy_(cache[g][k])
    rows = cfg.max_seq // c.tp
    lo = c.tp_rank * rows
    for k in ("k", "v"):
        whole = all_gather(c, cache["attn"][k], axis=2)
        n = max(0, min(S, lo + rows) - lo)
        dc["attn"][k][:, :, :n] = whole[:, :, lo:lo + n]
    dec = bundle.decode_fn(c)
    tok, dec_logits = logits.argmax(-1).to(torch.int32), []
    with torch.no_grad():
        for s in range(steps):
            lg, dc = dec(serve, tok, dc, torch.full((B,), S + s, dtype=torch.int32))
            dec_logits.append(lg.numpy())
            tok = lg.argmax(-1).to(torch.int32)
    params = zamba2_params_from_numpy(tree, "cpu", cfg, c, training=True)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    specs = bundle.param_specs(params)
    loss = bundle.loss_fn(c)(params, _lm_batch(tokens, labels))
    grads = list(torch.autograd.grad(loss, leaves))
    all_reduce_grads(c, grads, spec_leaves(specs))
    it = iter(grads)
    norm = global_norm(tree_map(lambda _: next(it), params), c, specs).item()
    place = Placement(c, specs, training=True)
    mgr = CheckpointManager(_world_dir(path, c), keep=1, async_save=False)
    with torch.no_grad():
        mgr.save(1, params, place)
        world_barrier(place)
        back, _ = mgr.restore_latest(tree_map(torch.zeros_like, params), place)
    return (logits.numpy(), _leaves(cache), len(rings), np.stack(dec_logits), _leaves(dc),
            loss.item(), [g.numpy() for g in grads],
            [a.detach().numpy() for a in tree_leaves(back)], norm, batch_rows(c, B))
