"""Graceful degradation: quarantine fused decisions that keep failing.

The port of the JAX package's ``core/degrade.py``.  Failures are counted
per ``(op, shape)`` key, the granularity the autotuner memoizes under;
after ``max_failures`` strikes a key is *quarantined*, and every fused-op
call site, which consults :func:`degrade_mode` before its mode branch,
resolves it to ``"bulk"`` instead.  After ``cooldown`` healthy steps the
key is released on probation and the fused path is probed again; a failure
on probation re-quarantines it with the cool-down scaled by
``cooldown_backoff`` (capped).

The policy is opt-in and visible: nothing is demoted unless a policy is
installed (:func:`set_degradation_policy`) and fed through
``record_failure`` / ``record_healthy`` by its owner; every demotion is
counted (``demotions``), every quarantine and release logged, and
``summary()`` reports them.  Nothing in the port feeds it from an
``except`` around a kernel's build or launch: a kernel that fails raises.
In eager PyTorch a mode decision takes effect at the next call, so there
is nothing to re-trace; ``consume_dirty`` still tells an owner that the
quarantine set changed.  With no policy installed the hook is one ``None``
check.

A region run under ``torch.utils.checkpoint`` runs again in the backward,
and at tp > 1 every rank's recompute must post the sends and receives of
its first forward.  :class:`Pins` records the region's mode decisions
(:func:`degrade_mode`) and overlap decisions (``autotune.resolve_overlap``)
at its first forward and replays them in the recompute, so a demotion or a
new tuner decision between the two cannot change one rank's graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Callable, Sequence

log = logging.getLogger("repro_torch.core.degrade")

DegradeKey = tuple  # (op: str, shape: tuple[int, ...])


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    max_failures: int = 2          # strikes before quarantine
    cooldown: int = 50             # healthy steps before a re-probe
    cooldown_backoff: float = 2.0  # growth after a failed re-probe
    max_cooldown: int = 2000


class DegradationPolicy:
    """Per-(op, shape) failure ledger -> fused/bulk mode decisions."""

    def __init__(self, cfg: DegradeConfig | None = None):
        self.cfg = cfg or DegradeConfig()
        self._strikes: dict[DegradeKey, int] = {}
        self._quarantine: dict[DegradeKey, int] = {}  # key -> steps left
        self._sentences: dict[DegradeKey, int] = {}   # key -> times jailed
        self._active: set[DegradeKey] = set()         # keys seen since begin_trace
        self.demotions = 0       # fused -> bulk resolutions served
        self._dirty = False

    # -- call-site surface -------------------------------------------------
    def effective_mode(self, op: str, shape: Sequence[int], mode: str) -> str:
        key = (str(op), tuple(int(s) for s in shape))
        self._active.add(key)
        if mode != "bulk" and key in self._quarantine:
            self.demotions += 1
            return "bulk"
        return mode

    # -- owner surface -------------------------------------------------------
    def record_failure(self, key: DegradeKey | None = None) -> list[DegradeKey]:
        """One strike against ``key``, or with ``None`` against every key
        active since :meth:`begin_trace` (a NaN loss cannot name the ring
        that poisoned it).  Returns the keys newly quarantined."""
        keys = [key] if key is not None else sorted(self._active)
        jailed = []
        for k in keys:
            if k in self._quarantine:
                continue
            self._strikes[k] = self._strikes.get(k, 0) + 1
            if self._strikes[k] < self.cfg.max_failures:
                continue
            n = self._sentences.get(k, 0)
            cd = min(self.cfg.max_cooldown,
                     int(self.cfg.cooldown * self.cfg.cooldown_backoff ** n))
            self._quarantine[k] = cd
            self._sentences[k] = n + 1
            self._strikes[k] = 0
            self._dirty = True
            jailed.append(k)
            log.warning("quarantining fused decision %s for %d healthy steps "
                        "(sentence %d); falling back to bulk", k, cd, n + 1)
        return jailed

    def record_healthy(self) -> list[DegradeKey]:
        """One healthy step: every quarantined key cools down, and those
        whose sentence expired are released.  Returns the released keys."""
        released = []
        for k in list(self._quarantine):
            self._quarantine[k] -= 1
            if self._quarantine[k] <= 0:
                del self._quarantine[k]
                self._dirty = True
                released.append(k)
                log.info("releasing %s from quarantine; re-probing the fused path", k)
        return released

    def quarantined(self, op: str, shape: Sequence[int]) -> bool:
        return (str(op), tuple(int(s) for s in shape)) in self._quarantine

    def quarantined_keys(self) -> tuple[DegradeKey, ...]:
        """The jailed keys, sorted."""
        return tuple(sorted(self._quarantine))

    def consume_dirty(self) -> bool:
        """True exactly once after the quarantine set changed."""
        d, self._dirty = self._dirty, False
        return d

    def begin_trace(self) -> None:
        """Reset the active-key ledger (so ``record_failure(None)`` blames
        only keys seen since)."""
        self._active.clear()

    def summary(self) -> dict:
        return {
            "quarantined": {f"{op}{list(shape)}": left
                            for (op, shape), left in self._quarantine.items()},
            "strikes": {f"{op}{list(shape)}": n
                        for (op, shape), n in self._strikes.items() if n},
            "sentences": sum(self._sentences.values()),
            "demotions": self.demotions,
            "active_keys": len(self._active),
        }


# ---------------------------------------------------------------------------
# process-wide installation
# ---------------------------------------------------------------------------
_POLICY: DegradationPolicy | None = None


def set_degradation_policy(policy: DegradationPolicy | None):
    """Install (or clear) the process-wide policy; returns the previous one."""
    global _POLICY
    prev = _POLICY
    _POLICY = policy
    return prev


def get_degradation_policy() -> DegradationPolicy | None:
    return _POLICY


def is_quarantined(op: str, shape: Sequence[int]) -> bool:
    """Read-only probe (no active-key bookkeeping)."""
    return _POLICY is not None and _POLICY.quarantined(op, shape)


def degrade_mode(op: str, shape: Sequence[int], mode: str) -> str:
    """The fused-op call-site hook: ``"bulk"`` where the installed policy
    has quarantined this (op, shape) key, else ``mode`` (pinned inside a
    :func:`pinned` region)."""
    return pin(lambda: mode if _POLICY is None else _POLICY.effective_mode(op, shape, mode))


# ---------------------------------------------------------------------------
# decisions pinned across a checkpointed region's recompute
# ---------------------------------------------------------------------------
class Pins:
    """The decisions of one region, in call order: recorded on its first
    run, replayed on every later one."""

    def __init__(self):
        self.values: list = []
        self.recorded = False
        self.pos = 0

    def next(self, decide: Callable):
        if not self.recorded:
            self.values.append(decide())
            return self.values[-1]
        if self.pos >= len(self.values):
            raise RuntimeError("a pinned region made more decisions in its recompute than in "
                               "its first forward")
        self.pos += 1
        return self.values[self.pos - 1]


_PINS: Pins | None = None


@contextlib.contextmanager
def pinned(pins: Pins):
    """Run a region under ``pins``: its first run records, later runs replay."""
    global _PINS
    prev, _PINS = _PINS, pins
    pins.pos = 0
    try:
        yield pins
    finally:
        _PINS = prev
        pins.recorded = True


def pin(decide: Callable):
    """``decide()``, recorded or replayed inside a :func:`pinned` region."""
    return decide() if _PINS is None else _PINS.next(decide)
