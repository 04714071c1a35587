"""Alpha-beta overlap model shared by the autotuner and the launchers.

The port of the JAX package's ``core/perfmodel.py``: the same terms in the
same order, so a decision taken under the same constants is the same float
for float.

Terms:
  compute    = max(flops / peak_flops, hbm_bytes / hbm_bw)
  bulk       = compute + kernel-boundary sync + collective launch + wire
  fused      = first chunk's compute exposed, the remaining chunks' wire
               time hidden behind compute, the last chunk's wire exposed,
               plus a per-chunk issue overhead: the paper's Fig. 13 curve
               (finer slices hide more wire time until per-slice overhead
               wins).

Two link classes ship with the port, both **provisional**: ``--calibrate``
(``core/calibrate.py``) replaces their choices with measured ones.

* :data:`H100_NVLINK`, the default: compute and memory rates are datasheet
  figures for the NVIDIA H100 80GB HBM3 (SXM) at 700 W; the link rate is
  NVLink 4's per-direction rate.  ``ici_lat``, ``boundary`` and
  ``chunk_overhead`` are estimates that no H100 run has measured yet.
* :data:`GLOO_HOST`: a gloo world whose payloads are staged through host
  memory, the slow class a world picks by its backend (the role the
  reference's pod-crossing class plays).  Fitted to the all-reduce of a
  ``[4, 4096]`` bf16 payload (32 KiB) among 4 processes sharing one NVIDIA
  H100 80GB HBM3 (700.00 W), from host memory: 3.586–5.287 ms
  (``chip_smoke.py`` phase 29).  One payload size cannot separate the two
  terms: alpha is the fastest call, beta the payload over the spread, so
  that alpha + 32 KiB / beta is the slowest call.  Each further sub-chunk
  is one more such exchange, so its issue cost is alpha too.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

# H100 80GB HBM3 (SXM, 700 W) datasheet figures
_H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak
_H100_HBM_BW = 3.35e12          # HBM3 bytes/s
_NVLINK4_BW = 450e9             # NVLink 4: 900 GB/s a card, 450 GB/s each direction

# one card, 4 gloo processes, all-reduce of 32 KiB from host memory
# (chip_smoke.py phase 29): fastest and slowest call
_GLOO_AR_BYTES = 4 * 4096 * 2
_GLOO_AR_FAST_S = 3.586e-3
_GLOO_AR_SLOW_S = 5.287e-3


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Alpha-beta constants for one device and link class.  The defaults
    are :data:`H100_NVLINK`'s (see the module docstring for each figure's
    source)."""

    peak_flops: float = _H100_BF16_FLOPS   # datasheet
    hbm_bw: float = _H100_HBM_BW           # datasheet
    ici_bw: float = _NVLINK4_BW            # per-link bytes/s, datasheet
    ici_lat: float = 5e-6          # collective launch latency (alpha): estimate, not measured
    boundary: float = 4e-6         # kernel-boundary sync the fused form removes: estimate
    chunk_overhead: float = 1e-6   # per-chunk issue cost (a flag store and poll): estimate
    fp8_wire: bool = False         # links + copy engines accept fp8 payloads
    # ("auto" wire selection only considers fp8 where the link model
    # declares support; the H100 class keeps it off, as the reference's
    # default class does)

    def compute_time(self, flops: float, hbm_bytes: float) -> float:
        """Roofline compute time: tensor-core- or HBM-bound, whichever binds."""
        return max(flops / self.peak_flops, hbm_bytes / self.hbm_bw)


H100_NVLINK = HardwareModel()

GLOO_HOST = HardwareModel(
    ici_bw=_GLOO_AR_BYTES / (_GLOO_AR_SLOW_S - _GLOO_AR_FAST_S),
    ici_lat=_GLOO_AR_FAST_S,
    chunk_overhead=_GLOO_AR_FAST_S)


@dataclasses.dataclass(frozen=True)
class MeshHardwareModel:
    """Per-axis hardware models (hierarchical alpha-beta).  ``axes`` maps
    axis names to their link model; anything unlisted uses ``default``.
    Stored as a tuple of pairs so instances stay hashable."""

    axes: tuple = ()                       # ((axis_name, HardwareModel), ...)
    default: HardwareModel = H100_NVLINK

    @classmethod
    def uniform(cls, hw: HardwareModel = H100_NVLINK) -> "MeshHardwareModel":
        return cls(axes=(), default=hw)

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, HardwareModel],
                     default: HardwareModel = H100_NVLINK) -> "MeshHardwareModel":
        return cls(axes=tuple(sorted(mapping.items())), default=default)

    @classmethod
    def for_mesh_axes(cls, axis_names: Sequence[str], *,
                      ici: HardwareModel = H100_NVLINK,
                      dcn: HardwareModel = GLOO_HOST) -> "MeshHardwareModel":
        """The reference's launcher convention: a ``pod`` axis takes the
        slow class, every other axis the fast one."""
        return cls(axes=tuple((a, dcn) for a in axis_names if a == "pod"),
                   default=ici)

    def axis(self, name: str | None) -> HardwareModel:
        for a, hw in self.axes:
            if a == name:
                return hw
        return self.default

    def for_axes(self, names) -> HardwareModel:
        """Bottleneck composition for a ring spanning several axes: the
        slowest link class governs its wire time, the largest latency its
        alpha, and fp8 is only available if every crossed class takes it."""
        if names is None:
            return self.default
        if isinstance(names, str):
            return self.axis(names)
        hws = [self.axis(n) for n in names] or [self.default]
        slowest = min(hws, key=lambda h: h.ici_bw)
        return dataclasses.replace(
            slowest,
            ici_lat=max(h.ici_lat for h in hws),
            fp8_wire=all(h.fp8_wire for h in hws))


def resolve_hw(hw, axis=None) -> HardwareModel:
    """A flat :class:`HardwareModel`, or a :class:`MeshHardwareModel`
    resolved for ``axis`` (a name, a tuple of names, or None)."""
    if isinstance(hw, MeshHardwareModel):
        return hw.for_axes(axis)
    return hw


def model_bulk(flops, hbm_bytes, wire_bytes, *, bw=None,
               hw: HardwareModel | MeshHardwareModel = H100_NVLINK, axis=None):
    """Bulk-synchronous: full compute kernel, boundary sync, collective."""
    hw = resolve_hw(hw, axis)
    bw = hw.ici_bw if bw is None else bw
    return (hw.compute_time(flops, hbm_bytes) + hw.boundary + hw.ici_lat
            + wire_bytes / bw)


def model_fused(flops, hbm_bytes, wire_bytes, chunks, *, bw=None,
                zero_copy_saving=0.0,
                hw: HardwareModel | MeshHardwareModel = H100_NVLINK, axis=None):
    """Fused: chunk i's wire time hides behind chunks i+1..n's compute.

    total = first chunk compute + max(rest compute, rest wire) +
            last chunk wire + per-chunk issue overhead - zero-copy saving."""
    hw = resolve_hw(hw, axis)
    bw = hw.ici_bw if bw is None else bw
    c = hw.compute_time(flops, hbm_bytes)
    w = wire_bytes / bw + hw.ici_lat
    per_c, per_w = c / chunks, w / chunks
    overlapped = per_c + max(c - per_c, w - per_w) + per_w
    return max(overlapped + chunks * hw.chunk_overhead - zero_copy_saving, 0.0)


def model_pair(flops, hbm_bytes, wire_bytes, chunks, *, wire_factor=1.0,
               hw: HardwareModel | MeshHardwareModel = H100_NVLINK, axis=None):
    """(bulk, fused) modeled seconds for one site under one decision;
    ``wire_factor`` scales the fused wire bytes for a compressed payload
    (the bulk baseline always ships the compute dtype)."""
    return (model_bulk(flops, hbm_bytes, wire_bytes, hw=hw, axis=axis),
            model_fused(flops, hbm_bytes, wire_bytes * wire_factor, chunks,
                        hw=hw, axis=axis))


def pct_reduction(bulk: float, fused: float) -> float:
    return 100.0 * (bulk - fused) / bulk
