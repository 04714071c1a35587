"""A gloo world of spawned CPU processes for the port's tensor-parallel tests.

Not collected (no ``test_`` prefix).  It imports neither ``jax`` nor
``repro``: ``torch.multiprocessing``'s spawn imports the module that defines
the worker again in every rank, which must stay free of JAX.

One world of ``WORLD = 4`` ranks serves a test module.  A tp = 4 task runs
over all four ranks; a tp = 2 task over the pairs (0, 1) and (2, 3), each
pair on the same inputs.  A task is a function of ``TASKS``, called on every
rank as ``fn(ctx_factory, **inputs)`` with numpy inputs; ``World.run``
returns each rank's result in rank order and fails after a timeout, tearing
the world down (the next task starts a new one), so that a hang fails one
test and not the whole run.
"""
from __future__ import annotations

import queue
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT_S = 120
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
    groups = {WORLD: None, 2: pairs[rank // 2]}
    outbox.put((rank, "ready", None))
    while True:
        item = inbox.get()
        if item is None:
            break
        name, tp, kwargs = item

        def ctx(mode="fused", hw=None, **fusion):
            """``hw``: the link constants as a dict (None: the world's class)."""
            from repro_torch.core.perfmodel import HardwareModel, MeshHardwareModel

            link = None if hw is None else MeshHardwareModel.uniform(HardwareModel(**hw))
            return ParallelContext(device="cpu", tp=tp, group=groups[tp], hw=link,
                                   fusion=FusionConfig(mode=mode, **fusion))
        try:
            outbox.put((rank, "ok", TASKS[name](ctx, **kwargs)))
        except Exception:        # the test shows the rank's traceback
            outbox.put((rank, "err", traceback.format_exc()))
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

    def run(self, name: str, tp: int, **inputs) -> list:
        """``TASKS[name]`` on every rank at ``tp``; each rank's result."""
        if tp not in (2, WORLD):
            raise ValueError(f"tp must be 2 or {WORLD}")
        if self.procs is None:
            self._start()
        for box in self.inboxes:
            box.put((name, tp, inputs))
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
    decode steps on the given tokens; each step's logits and the cache."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy

    c = ctx(mode, granularity=q, wire=wire)
    bundle = get_arch(arch).reduced()
    params = params_from_numpy(tree, "cpu", c)
    dec = bundle.decode_fn(c)
    cache = bundle.init_cache(tokens.shape[1], "cpu", c.tp)
    logits = []
    for tok, pos in zip(tokens, positions):
        lg, cache = dec(params, t(tok), cache, t(pos))
        logits.append(lg.numpy())
    return np.stack(logits), cache["k"].numpy(), cache["v"].numpy()


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
        elif what == "moe":
            get_arch("dbrx-132b").reduced().init_params(torch.Generator(), ctx())
        elif what == "paged":
            from repro_torch.models.transformer import serve_step

            cfg = get_arch("chatglm3-6b").reduced().config
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


@task
def prefill_task(ctx, tree, tokens, mode, arch="chatglm3-6b", q=1, wire="f32"):
    """The reduced ``arch`` from the JAX package's weights (numpy): its
    prefill of the tokens through ``prefill_fn``; the logits and this
    rank's chunk of the cache."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.convert import params_from_numpy

    c = ctx(mode, granularity=q, wire=wire)
    logits, cache = get_arch(arch).reduced().prefill_fn(c)(params_from_numpy(tree, "cpu", c),
                                                           {"tokens": t(tokens)})
    return logits.numpy(), cache["k"].numpy(), cache["v"].numpy()


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
    params = params_from_numpy(tree, "cpu", c)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return bundle, params


@task
def loss_grads_task(ctx, tree, tokens, labels, mode, arch="chatglm3-6b", q=1, wire="f32"):
    """The reduced ``arch`` from the JAX package's weights: ``loss_fn``'s loss
    and this rank's gradients, the whole leaves' summed over the ranks
    (``all_reduce_grads``, as the train step does), in ``tree_leaves``
    order."""
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.train.optimizer import spec_leaves, tree_leaves

    c = ctx(mode, granularity=q, wire=wire)
    bundle, params = _params_from(tree, c, arch)
    leaves = tree_leaves(params)
    loss = bundle.loss_fn(c)(params, {"tokens": t(tokens), "labels": t(labels)})
    grads = list(torch.autograd.grad(loss, leaves))
    all_reduce_grads(c, grads, spec_leaves(bundle.param_specs(params)))
    return loss.item(), [g.numpy() for g in grads]


@task
def train_steps_task(ctx, tree, batches, mode, arch="chatglm3-6b", lr=3e-3, steps=6,
                     microbatches=1):
    """``build_train_step`` with AdamW from the JAX package's weights on the
    given batches: each step's loss and grad norm, then this rank's
    parameters."""
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    c = ctx(mode)
    bundle, params = _params_from(tree, c, arch)
    tc = TrainConfig(optimizer=OptimizerConfig(lr=lr, warmup_steps=max(steps // 20, 5),
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
