"""Batched decode engines: continuous batching with per-slot positions.

A slot-based scheduler admits requests into a fixed decode batch, runs the
step function (whose FFN down projection is the fused GEMV+AllReduce),
samples greedily on the device (only the [B] token ids reach the host), and
retires finished sequences.  A slot is re-admitted the step after its
sequence finishes.

Every slot carries its own position: the engine feeds a ``pos [B]`` vector
to the model, so a request admitted into a freed slot starts at position 0
(fresh RoPE phases, fresh causal mask) while its neighbours keep counting.

Two backends:

:class:`DecodeEngine`
    Dense ``[L, B, S_max]`` cache, one token per slot per step.  The prompt
    is fed through the decode path one token per step.
:class:`PagedDecodeEngine`
    Paged KV (:mod:`repro_torch.serve.kv_cache` on the host,
    :func:`repro_torch.models.attention.paged_attention` on the device)
    with chunked prefill: prompts are fed ``chunk`` tokens per step through
    the same ``serve_step`` that decodes, so a step mixes prefill chunks
    and decode slots (``n_new`` per slot: 0 idle, 1 decode, >1 prefill).
    Steps come at two widths, C = chunk while some slot is mid-prefill and
    C = 1 otherwise.  Blocks are freed the moment a request retires; pool
    exhaustion defers admission or preempts a request back to the queue
    instead of corrupting a neighbour.

Over a tp world every rank runs the same engine on the same requests: the
step function's logits are gathered over the vocabulary on every rank, so
every rank's greedy tokens, slots and positions agree
(``launch/serve.py`` checks the streams and prints from rank 0 only).

Elastic serving: ``reshard`` swaps the step function and the cache (or
pool) mid-flight.  In-flight requests go back to the queue front with their
generated tokens; on re-admission the engine replays prompt + generated
tokens through the new cache and generation resumes where it stopped.
:func:`request_journal` / :func:`resubmit_journal` carry the unfinished
requests to a fresh engine.  :func:`serve_with_chaos` drains an engine
under a seeded fault plan (``runtime/chaos.py``): a failed collective drops
its tick, a lost rank drains, reshards and resumes the in-flight requests.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.runtime.chaos import RankLost
from repro_torch.serve.kv_cache import OutOfBlocks, PagedKVCache

log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list
    max_new: int = 32
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False   # retired at the cache bound, not eos/max_new
    # engine-managed: tokens to replay through the cache before sampling
    # resumes (the prompt, plus already-generated tokens after a reshard or
    # a preemption), and how many of them have been fed so far.
    prefix: list = dataclasses.field(default_factory=list)
    consumed: int = 0
    # engine-clock timestamps: submission, first generated token, retirement
    t_submit: float | None = None
    t_first: float | None = None
    t_done: float | None = None


class DrainResult(list):
    """Finished requests, plus whether the engine actually drained.

    ``drained`` is False when :meth:`_EngineBase.run_until_drained` stopped
    at ``max_steps`` with work still queued or in flight."""

    drained: bool = True


class _EngineBase:
    """Queue and slot bookkeeping shared by the dense and paged engines."""

    def __init__(self, batch_size: int, eos_id: int, bos_id: int, device,
                 time_fn: Callable[[], float]):
        self.batch = batch_size
        self.eos = eos_id
        self.bos = bos_id
        self.device = torch.device(device)
        self.time_fn = time_fn
        self.slots: list[Request | None] = [None] * batch_size
        self.queue: collections.deque = collections.deque()

    def submit(self, req: Request):
        if req.t_submit is None:
            req.t_submit = self.time_fn()
        self.queue.append(req)

    def _pending(self) -> bool:
        return any(s is not None for s in self.slots) or bool(self.queue)

    def _retire(self, i: int, req: Request, finished: list):
        req.done = True
        req.t_done = self.time_fn()
        self.slots[i] = None
        finished.append(req)

    def _pop_admittable(self, finished: list) -> Request | None:
        """Next queued request, retiring zero-budget ones on the spot: a
        ``max_new=0`` request finishes with zero tokens and never touches
        a slot or the cache."""
        while self.queue:
            req = self.queue.popleft()
            if req.max_new <= 0:
                req.done = True
                req.t_done = self.time_fn()
                finished.append(req)
                continue
            return req
        return None

    def _requeue_inflight(self) -> int:
        """Push the in-flight requests back to the queue front in slot order
        (admitted first, re-admitted first), tokens intact."""
        inflight = [r for r in self.slots if r is not None]
        for r in reversed(inflight):
            self.queue.appendleft(r)
        return len(inflight)

    def _greedy(self, logits) -> np.ndarray:
        """Greedy sampling on the device; only [B] int32 reaches the host."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def run_until_drained(self, max_steps: int = 10_000, liveness=None) -> DrainResult:
        """Drain the queue.  With ``liveness`` (a :class:`~repro_torch.
        runtime.watchdog.LivenessMonitor`) each tick first checks the peers'
        heartbeats and runs its step guarded: a peer process dying
        mid-decode raises :class:`~repro_torch.runtime.chaos.RankLost` from
        liveness instead of hanging.  The bookkeeping of the requests' tokens
        stays at the last whole tick, so :func:`request_journal` snapshots a
        consistent set of unfinished requests for the respawned engine."""
        finished = DrainResult()
        steps = 0
        while self._pending() and steps < max_steps:
            if liveness is not None:
                liveness.check()
                _, fin = liveness.guarded(self.step)
            else:
                _, fin = self.step()
            finished.extend(fin)
            steps += 1
        finished.drained = not self._pending()
        if not finished.drained:
            log.warning(
                "run_until_drained stopped at max_steps=%d with %d queued "
                "and %d in-flight requests — results are TRUNCATED",
                max_steps, len(self.queue),
                sum(s is not None for s in self.slots))
        return finished

    def step(self):  # pragma: no cover - abstract
        raise NotImplementedError


class DecodeEngine(_EngineBase):
    """Dense-cache engine (one token per slot per step, per-slot pos)."""

    def __init__(self, decode_fn: Callable, init_cache_fn: Callable,
                 batch_size: int, *, device="cuda", eos_id: int = -1,
                 bos_id: int = 0, max_seq: int | None = None,
                 reset_slot_fn: Callable | None = None,
                 time_fn: Callable[[], float] = time.monotonic):
        """decode_fn(tokens [B,1], cache, pos [B]) -> (logits [B,1,V], cache),
        on tensors on ``device``; init_cache_fn(batch_size) -> cache.  The
        engine never looks inside the cache: a GQA model's {"k", "v"} and
        MLA's latents {"c", "kr"} (deepseek-v3) pass through it alike, from
        a reshard's fresh cache through every admission.

        ``reset_slot_fn(cache, slot) -> cache`` runs whenever a request takes
        a slot (a first admission, a journal's or a reshard's re-admission):
        a recurrent model's state (zamba2's SSM and conv states) carries
        from step to step, so a reused slot must start from zeros, where the
        transformers' KV rows past the slot's position are masked and need
        nothing.  The reference's engine resets only the position.

        ``bos_id`` seeds the first decode step for empty-prompt requests.
        ``max_seq`` is the cache bound: a slot reaching it retires its
        request with ``truncated=True`` instead of writing past the end
        (pass the model's ``cfg.max_seq``; ``None`` disables the check for
        cacheless fakes)."""
        super().__init__(batch_size, eos_id, bos_id, device, time_fn)
        self.decode_fn = decode_fn
        self.init_cache_fn = init_cache_fn
        self.max_seq = max_seq
        self.reset_slot_fn = reset_slot_fn
        self.cache = init_cache_fn(batch_size)
        self.cur_tok = np.zeros((batch_size, 1), np.int32)
        self.pos = np.zeros(batch_size, np.int32)   # per-slot, not shared

    def _admit(self, finished: list):
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                req = self._pop_admittable(finished)
                if req is None:
                    return
                self.slots[i] = req
                self.pos[i] = 0
                if self.reset_slot_fn is not None:
                    self.cache = self.reset_slot_fn(self.cache, i)
                # the prompt (and, after a reshard, the generated tokens) is
                # fed one token per step through the decode path
                req.prefix = list(req.prompt) + list(req.tokens)
                if req.prefix:
                    self.cur_tok[i, 0] = req.prefix[0]
                    req.consumed = 1
                else:  # empty prompt: unconditional generation from BOS
                    self.cur_tok[i, 0] = self.bos
                    req.consumed = 0

    def _retire_at_bound(self, finished: list):
        """A slot about to write past the ``max_seq`` cache rows retires
        truncated instead of silently clobbering."""
        if self.max_seq is None:
            return
        for i, req in enumerate(self.slots):
            if req is not None and self.pos[i] >= self.max_seq:
                log.warning("request %d hit cache bound max_seq=%d after "
                            "%d generated tokens — retiring truncated",
                            req.uid, self.max_seq, len(req.tokens))
                req.truncated = True
                self._retire(i, req, finished)

    def step(self):
        finished: list[Request] = []
        self._retire_at_bound(finished)
        self._admit(finished)
        logits, self.cache = self.decode_fn(
            torch.tensor(self.cur_tok, device=self.device), self.cache,
            torch.tensor(self.pos, device=self.device))
        nxt = self._greedy(logits[:, 0])
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            if req.consumed < len(req.prefix):
                self.cur_tok[i, 0] = req.prefix[req.consumed]
                req.consumed += 1
                continue
            tok = int(nxt[i])
            if req.t_first is None:
                req.t_first = self.time_fn()
            req.tokens.append(tok)
            self.cur_tok[i, 0] = tok
            if tok == self.eos or len(req.tokens) >= req.max_new:
                self._retire(i, req, finished)
        return nxt, finished

    def reshard(self, decode_fn: Callable, init_cache_fn: Callable,
                batch_size: int | None = None) -> int:
        """Swap in a decode function and a fresh cache (for another world).

        In-flight requests go back to the queue front in slot order,
        keeping their generated tokens; re-admission replays them through
        the fresh cache.  Returns how many requests were re-queued."""
        n = self._requeue_inflight()
        if batch_size is not None:
            self.batch = batch_size
        self.decode_fn = decode_fn
        self.init_cache_fn = init_cache_fn
        self.cache = init_cache_fn(self.batch)
        self.slots = [None] * self.batch
        self.cur_tok = np.zeros((self.batch, 1), np.int32)
        self.pos = np.zeros(self.batch, np.int32)
        return n


class PagedDecodeEngine(_EngineBase):
    """Paged-KV engine with chunked prefill in a mixed schedule."""

    def __init__(self, serve_fn: Callable, init_pool_fn: Callable,
                 batch_size: int, *, num_blocks: int, block_size: int,
                 max_seq: int, chunk: int = 8, device="cuda", eos_id: int = -1,
                 bos_id: int = 0, n_stripes: int = 1,
                 time_fn: Callable[[], float] = time.monotonic):
        """serve_fn(tokens [B,C], pool, tables [B,MB], pos [B], n_new [B])
        -> (logits [B,V], pool), on tensors on ``device``;
        init_pool_fn(num_blocks, block_size) -> pool.  ``chunk`` is the
        prefill chunk width C (decode steps use C = 1).  ``max_seq`` bounds
        each request's block table; ``n_stripes`` is the tp size, so that
        allocation balances across rank stripes.

        ``deferred`` counts admissions put off because the pool was full,
        ``preempted`` the requests pushed back to the queue mid-flight."""
        super().__init__(batch_size, eos_id, bos_id, device, time_fn)
        self.chunk = max(1, chunk)
        self.max_seq = max_seq
        self.deferred = 0
        self.preempted = 0
        self._reset(serve_fn, init_pool_fn, num_blocks, block_size, n_stripes)

    def _reset(self, serve_fn, init_pool_fn, num_blocks, block_size, n_stripes):
        self.serve_fn = serve_fn
        self.init_pool_fn = init_pool_fn
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_stripes = n_stripes
        self.pool = init_pool_fn(num_blocks, block_size)
        self.kv = PagedKVCache(num_blocks, block_size,
                               max_blocks_per_request=-(-self.max_seq // block_size),
                               n_stripes=n_stripes)
        self.slots = [None] * self.batch
        self.cur_tok = np.zeros(self.batch, np.int32)
        self.pos = np.zeros(self.batch, np.int32)
        # feed list per slot: the prefix (or [bos] for an empty prompt) still
        # to be pushed through the prefill path; consumed indexes into it
        self._feed: list[list] = [[] for _ in range(self.batch)]

    # -- admission / preemption -------------------------------------------
    def _admit(self, finished: list):
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                req = self._pop_admittable(finished)
                if req is None:
                    return
                req.prefix = list(req.prompt) + list(req.tokens)
                feed = list(req.prefix) or [self.bos]
                try:
                    self.kv.register(req.uid)
                    self.kv.ensure(req.uid, min(len(feed), self.max_seq))
                except OutOfBlocks:
                    # pool full: defer admission, keep FIFO order
                    self.kv.release(req.uid)
                    self.queue.appendleft(req)
                    self.deferred += 1
                    return
                self.slots[i] = req
                self.pos[i] = 0
                req.consumed = 0
                self._feed[i] = feed

    def _preempt(self, i: int, req: Request):
        """Pool exhausted mid-flight: push the request back to the queue
        front (it keeps its admission-order priority) and free its blocks.
        Re-admission replays prompt + generated tokens through the
        chunked-prefill path."""
        log.warning("preempting request %d (pool exhausted): %d tokens "
                    "generated, will replay on re-admission",
                    req.uid, len(req.tokens))
        self.kv.release(req.uid)
        self.slots[i] = None
        self._feed[i] = []
        self.queue.appendleft(req)
        self.preempted += 1

    def _retire_at_bound(self, finished: list):
        for i, req in enumerate(self.slots):
            if req is not None and self.pos[i] >= self.max_seq:
                log.warning("request %d hit cache bound max_seq=%d after "
                            "%d generated tokens — retiring truncated",
                            req.uid, self.max_seq, len(req.tokens))
                req.truncated = True
                self.kv.release(req.uid)
                self._retire(i, req, finished)

    # -- the mixed prefill/decode step ------------------------------------
    def step(self):
        finished: list[Request] = []
        self._retire_at_bound(finished)
        self._admit(finished)
        # chunk width: the wide step only while some slot is mid-prefill
        remaining = [0 if r is None else len(self._feed[i]) - r.consumed
                     for i, r in enumerate(self.slots)]
        C = self.chunk if any(rem > 1 for rem in remaining) else 1

        tokens = np.zeros((self.batch, C), np.int32)
        n_new = np.zeros(self.batch, np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            rem = remaining[i]
            if rem > 0:
                n = min(rem, C, self.max_seq - int(self.pos[i]))
                tokens[i, :n] = self._feed[i][req.consumed:req.consumed + n]
            else:
                n = 1
                tokens[i, 0] = self.cur_tok[i]
            try:
                self.kv.ensure(req.uid, int(self.pos[i]) + n)
            except OutOfBlocks:
                self._preempt(i, req)
                continue
            n_new[i] = n
        tables = self.kv.tables_for(
            [r.uid if r is not None and n_new[i] > 0 else None
             for i, r in enumerate(self.slots)])

        if not n_new.any():
            return np.zeros(self.batch, np.int32), finished

        # one host-to-device copy for the step's four inputs
        B, MB = tables.shape
        flat = torch.from_numpy(np.concatenate(
            [tokens.ravel(), tables.ravel(), self.pos, n_new])).to(self.device)
        o1, o2 = B * C, B * C + B * MB
        logits, self.pool = self.serve_fn(
            flat[:o1].view(B, C), self.pool, flat[o1:o2].view(B, MB),
            flat[o2:o2 + B], flat[o2 + B:])
        nxt = self._greedy(logits)

        for i, req in enumerate(self.slots):
            if req is None or n_new[i] == 0:
                continue
            n = int(n_new[i])
            rem = remaining[i]
            self.pos[i] += n
            if rem > 0:
                req.consumed += n
                if req.consumed < len(self._feed[i]):
                    continue   # still prefilling: logits discarded
            # prefill just finished (its last valid logits predict the first
            # new token) or plain decode: sample greedily
            tok = int(nxt[i])
            if req.t_first is None:
                req.t_first = self.time_fn()
            req.tokens.append(tok)
            self.cur_tok[i] = tok
            if tok == self.eos or len(req.tokens) >= req.max_new:
                self.kv.release(req.uid)
                self._retire(i, req, finished)
        return nxt, finished

    # -- elasticity --------------------------------------------------------
    def reshard(self, serve_fn: Callable, init_pool_fn: Callable,
                batch_size: int | None = None,
                num_blocks: int | None = None,
                block_size: int | None = None,
                n_stripes: int | None = None) -> int:
        """Swap the serve function and pool (for another world), migrating
        requests.

        Block tables are host-side state, but the pool's contents belong to
        the old world: in-flight requests are re-queued (tokens intact) and
        rebuild their KV through the chunked-prefill path on the fresh
        pool, as the dense engine replays.  Returns how many requests were
        re-queued."""
        n = self._requeue_inflight()
        if batch_size is not None:
            self.batch = batch_size
        self._reset(serve_fn, init_pool_fn, num_blocks or self.num_blocks,
                    block_size or self.block_size, n_stripes or self.n_stripes)
        return n


def request_journal(engine) -> list[dict]:
    """JSON-serialisable snapshot of every unfinished request.

    In-flight slots first (admission order), then the queue: the order
    re-admission should honour.  Generated tokens ride along, so a fresh
    engine resubmits through :func:`resubmit_journal` and each request
    resumes where it stopped: the replay path rebuilds its cache from
    prompt + tokens, the mechanism ``reshard`` uses in-process."""
    live = [r for r in engine.slots if r is not None] + list(engine.queue)
    return [{"uid": r.uid, "prompt": list(r.prompt), "max_new": r.max_new,
             "tokens": list(r.tokens)} for r in live]


def resubmit_journal(engine, journal: list[dict]) -> int:
    """Re-admit journaled requests (tokens intact) into a fresh engine."""
    for e in journal:
        engine.submit(Request(uid=e["uid"], prompt=list(e["prompt"]),
                              max_new=e["max_new"], tokens=list(e["tokens"])))
    return len(journal)


def serve_with_chaos(engine, plan, *,
                     reshard_fn: Callable | None = None,
                     sleep_fn: Callable[[float], None] = time.sleep,
                     max_steps: int = 10_000):
    """Drain the engine under a :class:`~repro_torch.runtime.chaos.FaultPlan`.

    Per tick: ``slow_link`` sleeps its delay before stepping; ``timeout``
    / ``rank_fail`` / ``nan_wire`` drop the tick entirely (the collective
    failed, nothing was committed — the same decode step retries next
    tick); ``rank_loss`` calls ``reshard_fn(engine)`` — the drain-reshard-
    resume path — or raises :class:`~repro_torch.runtime.chaos.RankLost`
    if no handler is wired.  Every rank of a world holds the same plan, so
    every rank drops and reshards at the same tick.  ``reshard_fn``
    returns False on a rank the shrunk world does not keep: the loop stops
    there (``left`` True) with no further collective.

    Returns ``(finished, stats)`` where stats counts ticks, dropped
    ticks, and reshards, and carries ``drained`` — False when the loop
    stopped at ``max_steps`` with requests still queued or in flight.
    """
    finished = DrainResult()
    stats = {"ticks": 0, "dropped": 0, "reshards": 0, "drained": True, "left": False}
    tick = 0
    while engine._pending() and tick < max_steps:
        events = plan.at(tick) if plan is not None else ()
        tick += 1
        stats["ticks"] += 1
        dropped = False
        for ev in events:
            if ev.kind == "slow_link":
                sleep_fn(ev.delay_s)
            elif ev.kind == "rank_loss":
                if reshard_fn is None:
                    raise RankLost(ev.rank)
                stats["reshards"] += 1
                if reshard_fn(engine) is False:
                    stats["left"] = True
                    return finished, stats
            else:  # timeout / rank_fail / nan_wire: the tick is lost
                dropped = True
        if dropped:
            stats["dropped"] += 1
            continue
        _, fin = engine.step()
        finished.extend(fin)
    stats["drained"] = finished.drained = not engine._pending()
    if not stats["drained"]:
        log.warning(
            "serve_with_chaos stopped at max_steps=%d with %d queued and "
            "%d in-flight requests — results are TRUNCATED",
            max_steps, len(engine.queue),
            sum(s is not None for s in engine.slots))
    return finished, stats
