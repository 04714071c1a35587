"""Chaos engineering: seeded fault injection for the fused rings.

The port of the JAX package's ``runtime/chaos.py``.

The fused compute-collective kernels put communication on the critical
path of every step, so production failures surface *inside* the rings:
a slow link stalls every rank, a transient timeout kills the step, a
flipped wire bit poisons the reduction, and a lost rank takes the whole
ring down until the mesh is reshaped.  This module reproduces that fault
model deterministically so the recovery machinery
(:mod:`repro_torch.runtime.fault_tolerance`, :mod:`repro_torch.core.degrade`,
:mod:`repro_torch.runtime.elastic`) can be validated end to end:

  slow_link - a transient slow rank/link: the step stalls for ``delay_s``
              (the straggler telemetry sees it like any real straggler).
  timeout   - a transient collective timeout: the step raises
              :class:`CollectiveTimeout` (the NCCL-watchdog analogue);
              the supervisor restores and retries with backoff.
  rank_fail - a transient rank kill: same recovery surface as timeout
              (restart from checkpoint), logged as a distinct kind.
  nan_wire  - a corrupt wire payload: the ``nth_send``-th ring/A2A send
              of the step carries NaNs, injected at the
              :mod:`repro_torch.core.collectives` boundary through its
              wire-fault hook.  The reference reads the hook at trace
              time and bakes the fault into a fresh trace; the port is
              eager, so the hook is read at call time, as each payload
              goes on the wire, and the step itself runs poisoned inside
              :func:`wire_faults` with nothing rebuilt.  Disabled, the
              hook costs one ``None`` check a payload.  The kernels'
              in-kernel PUTs never pass the hook, as in the reference.
  rank_loss - a *permanent* rank loss: raises :class:`RankLost`.
              Recovery is not a restart but an elastic shrink
              (:func:`repro_torch.runtime.elastic.shrink_context`): the
              supervisor re-shards live state onto the surviving ranks
              and the serve engine drain-reshards its in-flight slots.

Everything is seeded: :meth:`FaultPlan.from_rate` draws its schedule
from ``numpy.random.default_rng(seed)``, so a chaos scenario replays
bit-identically: the same spec and seed give the same events as the
JAX package's, one for one (``tests/test_torch_runtime.py``).  Every rank
of a world builds the same plan, so every rank injects the same fault at
the same step and takes the same recovery path.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Sequence

import numpy as np

import torch

from repro_torch.core.collectives import set_wire_fault_hook

FAULT_KINDS = ("slow_link", "timeout", "rank_fail", "nan_wire", "rank_loss")
#: kinds the restart path recovers from (rank_loss needs an elastic shrink)
TRANSIENT_KINDS = ("slow_link", "timeout", "rank_fail", "nan_wire")


class CollectiveTimeout(RuntimeError):
    """A transient collective timeout (the NCCL-watchdog analogue)."""


class RankLost(RuntimeError):
    """A permanent rank loss; carries the lost flat rank index."""

    def __init__(self, rank: int, msg: str | None = None):
        super().__init__(msg or f"rank {rank} lost permanently")
        self.rank = int(rank)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``delay_s`` is the slow-link stall;
    ``nth_send`` picks which wire send of the step a ``nan_wire`` event
    corrupts (in send order across every ring hop / A2A send)."""

    step: int
    kind: str
    rank: int = 0
    delay_s: float = 0.0
    nth_send: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")


class FaultPlan:
    """A seeded, schedule-driven fault plan: ``at(step)`` returns the
    events scheduled for that step (possibly several).  Construct with
    explicit events for scenario tests, or :meth:`from_rate` for a
    Bernoulli fault process at a target per-step rate."""

    def __init__(self, events: Iterable[FaultEvent], seed: int = 0):
        self.seed = int(seed)
        self.events = tuple(sorted(events, key=lambda e: e.step))
        by_step: dict[int, list[FaultEvent]] = {}
        for e in self.events:
            by_step.setdefault(e.step, []).append(e)
        self._by_step = {s: tuple(v) for s, v in by_step.items()}

    @classmethod
    def from_rate(cls, seed: int, rate: float, num_steps: int, *,
                  kinds: Sequence[str] = ("timeout", "slow_link"),
                  world: int = 8, delay_s: float = 0.01,
                  nan_nth_send: int = 0) -> "FaultPlan":
        """Deterministic Bernoulli schedule: each step faults with
        probability ``rate``, the kind drawn uniformly from ``kinds``.
        ``rank_loss`` is deliberately not a default kind — a permanent
        loss needs an elastic-shrink handler, so callers opt in."""
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        rng = np.random.default_rng(seed)
        events = []
        for step in range(int(num_steps)):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            events.append(FaultEvent(
                step=step, kind=kind, rank=int(rng.integers(world)),
                delay_s=float(delay_s), nth_send=int(nan_nth_send)))
        return cls(events, seed=seed)

    def at(self, step: int) -> tuple[FaultEvent, ...]:
        return self._by_step.get(int(step), ())

    def __len__(self) -> int:
        return len(self.events)

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for e in self.events:
            counts[e.kind] = counts.get(e.kind, 0) + 1
        return {"seed": self.seed, "n_events": len(self.events),
                "by_kind": counts}


# ---------------------------------------------------------------------------
# wire-level fault injection (the collectives-boundary hook)
# ---------------------------------------------------------------------------
class WireFaultInjector:
    """Payload corruptor installed at the
    :func:`repro_torch.core.collectives.ring_permute_start` /
    :func:`~repro_torch.core.collectives.all_gather_wire` boundary.

    Counts float payload sends in send order and replaces the
    ``nth_send``-th with ``value`` (NaN by default): the repro of a
    corrupt link.  Integer payloads (routing ids) are never
    touched.  ``fired`` records whether the target send happened, so a
    scenario can assert its fault actually landed.
    """

    def __init__(self, nth_send: int = 0, value: float = float("nan")):
        self.nth = int(nth_send)
        self.value = float(value)
        self.count = 0
        self.fired = False

    def __call__(self, leaf):
        if not torch.is_floating_point(leaf):
            return leaf
        i = self.count
        self.count += 1
        if i != self.nth:
            return leaf
        self.fired = True
        return torch.full_like(leaf, self.value)


@contextlib.contextmanager
def wire_faults(nth_send: int = 0, value: float = float("nan")):
    """Install a :class:`WireFaultInjector` while the block runs.

    The port is eager: every payload sent inside the block passes the
    injector as it goes on the wire, so the step called inside the block
    runs poisoned (the reference's must be traced afresh inside it).
    Yields the injector so callers can assert ``fired``.
    """
    inj = WireFaultInjector(nth_send=nth_send, value=value)
    prev = set_wire_fault_hook(inj)
    try:
        yield inj
    finally:
        set_wire_fault_hook(prev)


# ---------------------------------------------------------------------------
# CLI plumbing (shared by launch/train.py and launch/serve.py)
# ---------------------------------------------------------------------------
def parse_chaos_spec(spec: str, *, num_steps: int) -> FaultPlan:
    """Parse the ``--chaos`` flag.

    Two forms:
      ``rate=0.05[,seed=0][,kinds=timeout+slow_link][,delay=0.01]``
          seeded Bernoulli schedule over ``num_steps``.
      ``at=7:timeout+20:nan_wire+40:rank_loss[,seed=0][,delay=0.01]``
          explicit ``step:kind`` events (the scenario form).
    """
    fields: dict[str, str] = {}
    for part in spec.split(","):
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --chaos field {part!r} (want key=value)")
        k, v = part.split("=", 1)
        fields[k.strip()] = v.strip()
    seed = int(fields.get("seed", 0))
    delay = float(fields.get("delay", 0.01))
    if "at" in fields:
        events = []
        for ev in fields["at"].split("+"):
            s, kind = ev.split(":")
            events.append(FaultEvent(step=int(s), kind=kind, delay_s=delay))
        return FaultPlan(events, seed=seed)
    if "rate" not in fields:
        raise ValueError("--chaos needs either rate=... or at=... "
                         f"(got {spec!r})")
    kinds = tuple(fields.get("kinds", "timeout+slow_link").split("+"))
    return FaultPlan.from_rate(seed, float(fields["rate"]), num_steps,
                               kinds=kinds, delay_s=delay)


def add_chaos_cli_args(ap) -> None:
    """Install the shared ``--chaos`` / ``--degrade`` flags."""
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="seeded fault injection: 'rate=0.05,seed=0,"
                         "kinds=timeout+slow_link+nan_wire' for a Bernoulli "
                         "schedule, or 'at=7:timeout+40:rank_loss' for "
                         "explicit step:kind events; transient faults "
                         "exercise the checkpoint/restart path, nan_wire "
                         "corrupts a real ring payload, rank_loss triggers "
                         "the elastic shrink")
    ap.add_argument("--degrade", action="store_true",
                    help="enable the degradation policy: repeated fused-"
                         "path failures or NaN losses quarantine the "
                         "offending (op, shape) decisions and fall back to "
                         "the bulk collectives, re-probing after a "
                         "cool-down")


def build_fault_plan(spec: str | None, *, num_steps: int) -> FaultPlan | None:
    return None if spec is None else parse_chaos_spec(spec,
                                                      num_steps=num_steps)
