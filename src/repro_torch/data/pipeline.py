"""Input pipeline: batches to the device with the copies overlapped.

``prefetch`` keeps ``depth`` batches in flight: each host batch is pinned
and copied with ``non_blocking`` on a side stream, and the consumer's
stream waits on an event recorded after the copy, so host-to-device time
hides behind the previous step's compute (the JAX package gets the same
overlap from its asynchronous ``device_put``).

Over data replicas (dp > 1) every rank draws the same global batches from
the seed, and :func:`shard_batch` keeps a replica's rows, as the reference's
``"batch"`` spec places them; so the losses are dp = 1's.  A DLRM batch
splits over the flattened (dp, tp) world instead, as the reference's
``batch_struct`` places it: ``dense`` and ``labels`` by rows, ``indices`` by
tables.
"""
from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch


def to_device(batch, device, *, pin: bool = False):
    """A dict of numpy arrays -> a dict of tensors on ``device``; ``pin``
    copies through pinned host memory without blocking the host."""
    device = torch.device(device)
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = (t.pin_memory() if pin else t).to(device, non_blocking=pin)
        out[k] = t
    return out


def batch_rows(ctx, B: int) -> tuple[int, int] | None:
    """(first row, rows) of data replica ``ctx.dp_rank``'s part of a batch of
    ``B`` rows split over the replicas, or ``None`` where the batch stays
    whole on every replica: at dp = 1, and where dp does not divide B (the
    reference keeps such a batch whole, ``models/layers.py:82``)."""
    dp = getattr(ctx, "dp", 1)
    if dp == 1 or B % dp:
        return None
    return ctx.dp_rank * (B // dp), B // dp


def batch_size(batch: dict) -> int:
    """The batch's rows B: ``tokens``' where it has them, else its first
    array's leading dim."""
    return (batch["tokens"] if "tokens" in batch else next(iter(batch.values()))).shape[0]


def batch_row_slice(batch: dict, lo: int, n: int) -> dict:
    """Rows ``[lo, lo + n)`` of every array of a batch: on the batch axis,
    which is axis 0 but for M-RoPE's ``positions_thw`` [3, B, S] (axis 1);
    ``vision_mask`` [S] has none and stays whole."""
    def rows(k, v):
        if k == "vision_mask":
            return v
        return v[:, lo:lo + n] if k == "positions_thw" else v[lo:lo + n]
    return {k: rows(k, v) for k, v in batch.items()}


def shard_batch(batch: dict, ctx) -> dict:
    """Data replica ``ctx.dp_rank``'s rows of every array of a global batch
    (:func:`batch_size`, :func:`batch_rows`, :func:`batch_row_slice`): the
    dict itself where the batch stays whole.  A DLRM batch (it has
    ``indices``) splits over the world (:func:`shard_dlrm_batch`)."""
    if "indices" in batch:
        return shard_dlrm_batch(batch, ctx)
    rows = batch_rows(ctx, batch_size(batch))
    if rows is None:
        return batch
    return batch_row_slice(batch, *rows)


def shard_dlrm_batch(batch: dict, ctx) -> dict:
    """World rank r's part of a global DLRM batch (``r = dp_rank * tp +
    tp_rank`` of ``n = dp * tp``): rows ``[r B / n, (r + 1) B / n)`` of
    ``dense`` and ``labels``, the tables ``[r T / n, (r + 1) T / n)`` of
    ``indices`` [B, T, L] (a contiguous copy: the pooling kernel takes
    contiguous indices); the dict itself in a world of one rank."""
    tp, dp = ctx.tp, getattr(ctx, "dp", 1)
    n = tp * dp
    if n == 1:
        return batch
    r = getattr(ctx, "dp_rank", 0) * tp + ctx.tp_rank
    B, T = batch["indices"].shape[:2]
    if B % n or T % n:
        raise ValueError(f"a DLRM batch of {B} rows over {T} tables does not split over the "
                         f"world's {n} ranks")
    rows, tabs = B // n, T // n
    return {k: v[:, r * tabs:(r + 1) * tabs].contiguous() if k == "indices" else
            v[r * rows:(r + 1) * rows] for k, v in batch.items()}


def prefetch(it: Iterator, device, depth: int = 2):
    """Yield ``it``'s batches on ``device``, ``depth`` of them copied ahead.
    On a CUDA device the copies run on a side stream; each batch is handed
    over after the current stream waits on its copy's event."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in it:
            yield to_device(batch, device)
        return
    side = torch.cuda.Stream(device)
    buf = collections.deque()

    def enqueue(n):
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            with torch.cuda.stream(side):
                dev = to_device(batch, device, pin=True)
                done = torch.cuda.Event()
                done.record(side)
            buf.append((dev, done))

    enqueue(depth)
    while buf:
        dev, done = buf.popleft()
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in dev.values():
            t.record_stream(cur)   # allocated on the side stream, used on this one
        yield dev
        enqueue(1)


class ReplayBuffer:
    """Checkpoint-aligned batch replay for restart-on-failure training.

    A restored step must see the *same* batch it saw before the failure —
    a plain iterator cannot rewind, so restored runs silently skip ahead
    (different data, different final state).  This wrapper buffers every
    batch drawn since the last committed checkpoint; :meth:`rewind`
    re-serves from a restored step and :meth:`commit` (called when a
    checkpoint lands) drops batches that can never be replayed again, so
    memory is bounded by ``checkpoint_every`` batches.

    ``base_step`` anchors the first drawn batch to a step index (the
    supervisor's starting step) — in-process replay only; resuming a
    *fresh* process from a mid-run checkpoint needs a deterministic
    iterator re-seeded past the checkpoint, which is the data source's
    contract, not this buffer's.
    """

    def __init__(self, it: Iterator, base_step: int = 0):
        self._it = iter(it)
        self._buf: list = []        # batches for steps [base, base+len)
        self._base = int(base_step)
        self._cursor = 0            # next serve position, relative to base

    @property
    def step(self) -> int:
        """Step index the next :meth:`next_batch` call serves."""
        return self._base + self._cursor

    def next_batch(self):
        if self._cursor == len(self._buf):
            self._buf.append(next(self._it))  # StopIteration propagates
        b = self._buf[self._cursor]
        self._cursor += 1
        return b

    def rewind(self, step: int) -> None:
        """Re-serve from ``step`` (a restored checkpoint step)."""
        if not self._base <= step <= self._base + len(self._buf):
            raise ValueError(
                f"cannot rewind to step {step}: replay window is "
                f"[{self._base}, {self._base + len(self._buf)}] (batches "
                f"before the last committed checkpoint are dropped)")
        self._cursor = step - self._base

    def commit(self, step: int) -> None:
        """A checkpoint at ``step`` landed: batches for earlier steps can
        never be replayed again and are dropped."""
        drop = step - self._base
        if drop <= 0:
            return
        self._buf = self._buf[drop:]
        self._base = step
        self._cursor = max(0, self._cursor - drop)
