"""Batched decode engine: continuous batching with per-slot positions.

A slot-based scheduler admits requests into a fixed decode batch, runs the
step function (whose FFN down projection is the fused GEMV+AllReduce),
samples greedily on the device, and retires finished sequences.  A slot is
re-admitted the step after its sequence finishes.

Every slot carries its own position: the engine feeds a ``pos [B]`` vector
to the model, so a request admitted into a freed slot starts at position 0
(fresh RoPE phases, fresh causal mask) while its neighbours keep counting.
The prompt is fed through the decode path one token per step.

The paged engine, elastic resharding and chaos driving of the reference
(``repro.serve.engine``) come in later slices of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

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
    # starts, and how many of them have been fed so far.
    prefix: list = dataclasses.field(default_factory=list)
    consumed: int = 0
    # engine-clock timestamps: submission, first generated token, retirement
    t_submit: float | None = None
    t_first: float | None = None
    t_done: float | None = None


class DrainResult(list):
    """Finished requests, plus whether the engine actually drained.

    ``drained`` is False when :meth:`DecodeEngine.run_until_drained`
    stopped at ``max_steps`` with work still queued or in flight."""

    drained: bool = True


class DecodeEngine:
    """Dense-cache engine (one token per slot per step, per-slot pos)."""

    def __init__(self, decode_fn: Callable, init_cache_fn: Callable,
                 batch_size: int, *, device="cuda", eos_id: int = -1,
                 bos_id: int = 0, max_seq: int | None = None,
                 time_fn: Callable[[], float] = time.monotonic):
        """decode_fn(tokens [B,1], cache, pos [B]) -> (logits [B,1,V], cache),
        on tensors on ``device``; init_cache_fn(batch_size) -> cache.

        ``bos_id`` seeds the first decode step for empty-prompt requests.
        ``max_seq`` is the cache bound: a slot reaching it retires its
        request with ``truncated=True`` instead of writing past the end
        (pass the model's ``cfg.max_seq``; ``None`` disables the check for
        cacheless fakes)."""
        self.batch = batch_size
        self.eos = eos_id
        self.bos = bos_id
        self.time_fn = time_fn
        self.device = torch.device(device)
        self.slots: list[Request | None] = [None] * batch_size
        self.queue: collections.deque = collections.deque()
        self.decode_fn = decode_fn
        self.max_seq = max_seq
        self.cache = init_cache_fn(batch_size)
        self.cur_tok = np.zeros((batch_size, 1), np.int32)
        self.pos = np.zeros(batch_size, np.int32)   # per-slot, not shared

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

    def _admit(self, finished: list):
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                req = self._pop_admittable(finished)
                if req is None:
                    return
                self.slots[i] = req
                self.pos[i] = 0
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
        # greedy sampling on the device; only [B] int32 reaches the host
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
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

    def run_until_drained(self, max_steps: int = 10_000) -> DrainResult:
        finished = DrainResult()
        steps = 0
        while self._pending() and steps < max_steps:
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
