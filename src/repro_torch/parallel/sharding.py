"""Fusion settings and the parallel context threaded through the model code.

The model code is SPMD: every rank of a tensor-parallel (tp) world runs it
on its own shard, and the collectives of ``core/collectives.py`` run over
the tp process group the context holds.  Where the JAX package states a
parameter's layout as a logical spec (``("fsdp", "tp")`` and the like) and
lets GSPMD place it, the port slices the whole tensor to this rank's part
with :func:`shard_leaf`.

A world of ``dp * tp`` ranks is ``dp`` data replicas of a tp world, as the
reference's ``("data", "model")`` mesh: global rank ``r`` is tp rank ``r %
tp`` of replica ``r // tp``.  Its tp group holds the ranks of one replica,
its data group the ranks with the same tp rank (``make_world_groups``, which
every rank runs in the same order).  A world can also cover a subset of the
default group (``ParallelContext.ranks``, groups made by
``make_subworld_groups``): the survivors of an elastic shrink
(``runtime/elastic.shrink_context``), whose every group, its flattened
world's too, is a group of its own, never the default group, of which the
lost ranks are still members.  ``ParallelContext.data`` is the data
axis seen as a context of its own (its ``tp`` the data group's size), so the
collectives of ``core/collectives.py`` run over it unchanged; so is
``ParallelContext.world``, the flattened world of all ``dp * tp`` ranks in
world order ``d * tp + m`` (the reference's ``dp_axes + (tp_axis,)``),
which DLRM's tables and its embedding all-to-all run over.  Training
places the ``"fsdp"`` dims over the data ranks (``shard_leaf(...,
training=True)``); serving keeps them whole, as the reference's launchers do.
A ``"world"`` dim is split over the whole world in both.

A dim whose parts are not contiguous has a *segmented* axis
(:class:`HeadsAxis`): the dim is a concatenation of segments, each split
into tp equal blocks or whole on every rank, and rank r holds block r of
every split segment and every whole one, in the dim's order.  zamba2's
Mamba blocks lay their heads out so (``models/mamba2.py``): ``w_in``'s
columns ``[z, x, B, C, dt]`` split by heads with B and C whole.
:func:`shard_leaf`, ``core/collectives.gather_leaf`` and the checkpoint's
restore cut and join such a dim by its segments; :func:`split_dims` leaves
it out (its parts are no slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.perfmodel import GLOO_HOST, H100_NVLINK, MeshHardwareModel

# logical axes the reference's ``_resolve`` maps onto the tp axis
# (src/repro/parallel/sharding.py:171-183); "batch" and "fsdp" map onto the
# data axes, ``None`` and "none" onto no axis
_TP_AXES = ("tp", "model", "vocab", "seq", "heads", "expert")
_DATA_AXES = ("batch", "fsdp")
_WHOLE_AXES = (None, "none") + _DATA_AXES
# the flattened (data, model) world (src/repro/parallel/sharding.py:181):
# DLRM's tables and its embedding all-to-all; the reference's axis names,
# which the autotuner resolves a link model for
WORLD_AXIS = "world"
WORLD_AXES = ("data", "model")

# (dp, tp) -> (this rank's tp group, its data group), made by make_world_groups
_WORLD_GROUPS: dict = {}


def make_world_groups(dp: int, tp: int):
    """Make the tp groups and the data groups of a world of ``dp * tp`` ranks
    (``dist.new_group`` is collective: every rank makes every group, in the
    same order, tp groups first) and keep this rank's two; returns them.  A
    group that would be the whole world is ``None`` (the default group), one
    of one rank is never made."""
    if (dp, tp) in _WORLD_GROUPS:
        return _WORLD_GROUPS[(dp, tp)]
    rank = dist.get_rank()
    tp_group = data_group = None
    if dp > 1 and tp > 1:
        for i in range(dp):
            g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
            if rank // tp == i:
                tp_group = g
        for j in range(tp):
            g = dist.new_group(list(range(j, dp * tp, tp)))
            if rank % tp == j:
                data_group = g
    _WORLD_GROUPS[(dp, tp)] = (tp_group, data_group)
    return tp_group, data_group


def make_subworld_groups(dp: int, tp: int, ranks) -> tuple:
    """(tp group, data group, world group) of a world of ``dp * tp`` ranks
    over ``ranks``, the global ranks of the default group in world order
    (world rank ``i`` is global rank ``ranks[i]``: tp rank ``i % tp`` of
    replica ``i // tp``).

    ``dist.new_group`` is collective over the default group: every rank of
    it calls this with the same arguments, in the same order, the ranks
    outside ``ranks`` too (on those all three are ``None``).  Every group
    of more than one rank is made here, the one that spans the whole of
    ``ranks`` too; a group of one rank is ``None`` (a context never uses
    it)."""
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != dp * tp or list(ranks) != sorted(set(ranks)):
        # torch orders a group's ranks by global rank, so world order must be too
        raise ValueError(f"(dp, tp) = ({dp}, {tp}) needs {dp * tp} ranks in increasing order, "
                         f"got {ranks}")
    key = (dp, tp, ranks)
    if key in _WORLD_GROUPS:
        return _WORLD_GROUPS[key]
    me = dist.get_rank()
    made = []
    for members in ([ranks[i * tp:(i + 1) * tp] for i in range(dp)] if tp > 1 else []) + \
            ([ranks[j::tp] for j in range(tp)] if dp > 1 else []) + \
            ([ranks] if dp > 1 and tp > 1 else []):
        g = dist.new_group(list(members))
        made.append((members, g if me in members else None))
    mine = lambda sets: next((g for m, g in sets if g is not None), None)
    tp_sets = made[:dp] if tp > 1 else []
    data_sets = made[len(tp_sets):len(tp_sets) + (tp if dp > 1 else 0)]
    tp_group, data_group = mine(tp_sets), mine(data_sets)
    world_group = (made[-1][1] if dp > 1 and tp > 1 else tp_group if tp > 1 else data_group)
    _WORLD_GROUPS[key] = (tp_group, data_group, world_group)
    return _WORLD_GROUPS[key]


def world_groups(dp: int, tp: int):
    """This rank's (tp group, data group) of a (dp, tp) world, as
    :func:`make_world_groups` made them; raises where they were not made
    (making them here, on one rank's first context, would be a collective
    that the ranks might reach in different orders)."""
    if (dp, tp) not in _WORLD_GROUPS:
        raise RuntimeError(
            f"(dp, tp) = ({dp}, {tp}): no tp and data groups were made for this world; start "
            f"it with repro_torch.launch.mesh.init_world(tp, ..., dp=dp), or call "
            f"make_world_groups(dp, tp) on every rank, or pass group= and data_group=")
    return _WORLD_GROUPS[(dp, tp)]


def forget_world_groups():
    """Drop the groups :func:`make_world_groups` kept (the world is ending)."""
    _WORLD_GROUPS.clear()


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Controls how dependent compute+collective pairs execute.

    mode:
      "bulk"   - bulk-synchronous baseline: full compute kernel, then the
                 collective (what RCCL/NCCL-style libraries give you).
      "fused"  - the paper's technique, TPU-adapted: the op is decomposed
                 into chunks; each chunk's collective is issued as soon as
                 its compute finishes, so XLA's latency-hiding scheduler
                 overlaps wire time with the remaining chunks' compute.
      "kernel" - device-initiated kernels (remote PUTs from inside the
                 kernel).  In this port: the hand-written CUDA kernels,
                 which a CUDA tensor launches or raises; no fallback.
      "auto"   - trace-time graph mode: every call site emits the bulk
                 reference collectives, and the jaxpr comm-graph analyzer
                 (:mod:`repro.analysis`) rewrites the profitable matches
                 to the fused ops afterwards (``--auto-fuse`` on the
                 launchers).  Model code needs no fused-op calls at all.
    schedule:
      "comm_aware"  - remote-destined chunks are computed first, the
                      locally-consumed chunk last (paper Fig. 6b / 7b).
      "oblivious"   - chunks computed in natural order (paper's baseline
                      scheduling; exists to reproduce Fig. 14).
    granularity: sub-chunk factor ``chunks_per_rank`` — how many slices
      each ring step's payload is split into (paper Fig. 13 knob).  1 is
      the paper's slice-per-peer granularity (one chunk per ring rank);
      larger values put each sub-slice on the wire as soon as it is
      produced, hiding more wire time until per-slice overhead wins.
      "auto" defers to the shape-keyed alpha-beta autotuner
      (:mod:`repro_torch.core.autotune`) per fused-op call site.  Values that
      do not divide the chunked dimension are clamped per-op to the
      largest feasible factor.
    skew: measured straggler rotation (paper Fig. 14).  An integer bucket
      produced by :class:`repro_torch.runtime.straggler.SkewEstimator` from
      per-rank step-time telemetry; every fused op ringing over the *tp*
      axis rotates its static chunk schedule by it (the A2A family
      rotates the remote destination order, the ring-carry family the
      sub-chunk service order).  The ops read it at call time; a step is
      built over a context with its bucket, and
      :class:`repro_torch.runtime.straggler.SkewScheduler` keeps one build
      a bucket.  0 = no measured skew (the default schedules).
    skew_world: the same bucket for ops that ring over the flattened
      full-world axis (the DLRM embedding A2A).  A rotation is only
      meaningful for the ring it was estimated on, so the world-ring ops
      deliberately do not inherit the tp-ring ``skew``
      (``SkewEstimator`` reduces per axis; feed each ring its own
      bucket).
    wire: wire dtype of every ring/A2A payload.  ``"f32"`` keeps the
      compute dtype on the wire (exact — the pre-wire graphs,
      bit-identical); ``"bf16"``/``"fp8"`` compress payloads on the send
      side while all local accumulation stays f32 (fp8 ships a per-chunk
      max-abs scale alongside the payload); ``"auto"`` defers to the link
      class's alpha-beta model (:class:`~repro_torch.core.perfmodel.
      MeshHardwareModel` via ``ParallelContext.hw``) jointly with the
      granularity choice: a slow link picks a narrow wire, a fast one whose
      wire hides behind compute keeps f32.

    In this port ``"bulk"`` and ``"fused"`` run at any tp, ``"kernel"`` at
    tp = 1 (the real-peer kernels wait for a multi-card host), at any dp
    (DLRM's embedding all-to-all in kernel mode at any (dp, tp): its kernel
    pools a fragment on one rank, the fused loop sends it); the
    ``"auto"`` granularity and wire resolve at every fused-op call site.
    The ``"auto"`` mode (the comm-graph rewrite) waits for ROADMAP Queue 1
    item 7.
    """

    mode: str = "fused"
    schedule: str = "comm_aware"
    granularity: int | str = 1
    skew: int = 0
    skew_world: int = 0
    wire: str = "f32"
    fuse_ag_matmul: bool = True
    fuse_matmul_rs: bool = True
    fuse_moe_a2a: bool = True
    fuse_embed_a2a: bool = True
    fuse_kv_ag: bool = True

    def resolve(self, which: str) -> str:
        """Effective mode for one of the fused-op families."""
        if self.mode in ("bulk", "auto") or not getattr(self, f"fuse_{which}"):
            # "auto": trace bulk; the comm-graph analyzer rewrites after
            return "bulk"
        return self.mode


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """Device, fusion settings and the (dp, tp) world threaded through the
    model code.

    ``device`` defaults to ``"cuda"`` and a CUDA device that is not there
    raises: nothing falls back to the CPU unless the caller asks for it.
    ``tp`` is the tensor-parallel world's size, ``dp`` the number of data
    replicas.  At tp > 1 ``group`` is the tp process group, at dp > 1
    ``data_group`` the data group (``None``: the groups
    :func:`make_world_groups` made for this (dp, tp), or the default world
    where one axis is the whole world), started beforehand
    (``launch.mesh.init_world``); the context reads this rank's place in
    each (``tp_rank``, ``dp_rank``) and the world's backend (``"gloo"`` or
    ``"nccl"``).  ``data`` is the data axis as a context of its own, ``world``
the flattened world of all ``dp * tp`` ranks (its ``tp`` the world's size,
its ``tp_rank`` this rank's world rank ``dp_rank * tp + tp_rank``): the tp
world itself at dp = 1, ``data`` at tp = 1, else the default process group,
whose rank order is world order (``make_world_groups``).

    ``ranks`` names the world's global ranks in world order where it covers
    a subset of the default group (``None``: all of it, ranks ``0 ..
    dp * tp - 1``).  Such a world is given all its groups
    (:func:`make_subworld_groups`: ``group``, ``data_group`` and
    ``world_group``, its flattened world's); a rank outside ``ranks`` gets
    a context whose ``member`` is False, with no place in any group, which
    it must not compute with (it leaves the world).

    ``hw`` is the link model the autotuner decides under (a
    :class:`MeshHardwareModel`).  ``None`` takes it from the world: a gloo
    world of more than one rank stages its payloads through host memory
    (``GLOO_HOST``); an NCCL world, and one rank, take the H100 NVLink
    class (``H100_NVLINK``).  Both classes are provisional until
    ``--calibrate`` measures the choices."""

    device: torch.device | str = "cuda"
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    tp: int = 1
    dp: int = 1
    group: Any = None
    data_group: Any = None
    hw: MeshHardwareModel | None = None
    ranks: tuple | None = None
    world_group: Any = None
    member: bool = dataclasses.field(init=False, default=True)
    tp_rank: int = dataclasses.field(init=False, default=0)
    dp_rank: int = dataclasses.field(init=False, default=0)
    backend: str | None = dataclasses.field(init=False, default=None)
    data: Any = dataclasses.field(init=False, default=None, repr=False, compare=False)
    world: Any = dataclasses.field(init=False, default=None, repr=False, compare=False)

    def __post_init__(self):
        dev = torch.device(self.device)
        object.__setattr__(self, "device", dev)
        if self.tp < 1 or self.dp < 1:
            raise ValueError(f"tp and dp must be >= 1, got tp={self.tp}, dp={self.dp}")
        if self.tp > 1 or self.dp > 1 or self.ranks is not None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"(dp, tp) = ({self.dp}, {self.tp}) needs a torch.distributed world of "
                    f"{self.dp * self.tp} ranks: start one with "
                    f"repro_torch.launch.mesh.init_world")
            if self.ranks is not None and not self._subworld():
                return
            if self.tp > 1 and self.dp > 1 and self.ranks is None and \
                    (self.group is None or self.data_group is None):
                tp_group, data_group = world_groups(self.dp, self.tp)
                if self.group is None:
                    object.__setattr__(self, "group", tp_group)
                if self.data_group is None:
                    object.__setattr__(self, "data_group", data_group)
            object.__setattr__(self, "backend", str(dist.get_backend()))
        if self.tp > 1:
            object.__setattr__(self, "tp_rank", self._place(self.group, self.tp, "tp"))
        if self.dp > 1:
            object.__setattr__(self, "dp_rank", self._place(self.data_group, self.dp, "dp"))
            object.__setattr__(self, "data", ParallelContext(
                device=dev, fusion=self.fusion, tp=self.dp, group=self.data_group, hw=self.hw))
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available (pass device='cpu' to run on the CPU)")
        if self.hw is None:
            link = GLOO_HOST if self.tp > 1 and self.backend == "gloo" else H100_NVLINK
            object.__setattr__(self, "hw", MeshHardwareModel.uniform(link))
        object.__setattr__(self, "world", self._world())

    def _subworld(self) -> bool:
        """Check a world over ``ranks``; False on a rank outside it, whose
        context is then complete (``member`` False, no place, no world)."""
        ranks = tuple(int(r) for r in self.ranks)
        object.__setattr__(self, "ranks", ranks)
        if len(ranks) != self.dp * self.tp:
            raise ValueError(f"(dp, tp) = ({self.dp}, {self.tp}) over {len(ranks)} ranks {ranks}")
        object.__setattr__(self, "backend", str(dist.get_backend()))
        if dist.get_rank() not in ranks:
            object.__setattr__(self, "member", False)
            object.__setattr__(self, "hw", self.hw or MeshHardwareModel.uniform(H100_NVLINK))
            return False
        unmade = [name for name, g, n in (("group", self.group, self.tp),
                                          ("data_group", self.data_group, self.dp),
                                          ("world_group", self.world_group, self.tp * self.dp))
                  if n > 1 and g is None]
        if unmade:
            raise ValueError(f"a world over ranks {ranks} needs its own groups (the default "
                             f"group holds ranks outside it); {unmade} not given "
                             f"(make_subworld_groups)")
        return True

    def _world(self) -> "ParallelContext":
        """The flattened world as a context of its own (``world``)."""
        if self.dp == 1:
            return self
        if self.tp == 1:
            return self.data
        world = ParallelContext(device=self.device, fusion=self.fusion, tp=self.tp * self.dp,
                                group=self.world_group, hw=self.hw)
        if world.tp_rank != self.dp_rank * self.tp + self.tp_rank:
            raise ValueError(f"rank {world.tp_rank} of the world's group is tp rank "
                             f"{self.tp_rank} of replica {self.dp_rank}: the world's rank "
                             f"order must be replica major (make_world_groups)")
        return world

    @staticmethod
    def _place(group, size: int, axis: str) -> int:
        """This rank's place in ``group`` (``None``: the default world),
        which must be ``size`` ranks wide."""
        group = group if group is not None else dist.group.WORLD
        got = dist.get_world_size(group)
        if got != size:
            raise ValueError(f"{axis}={size} but the process group has {got} ranks")
        return dist.get_rank(group)

    def peer(self, tp_rank: int) -> int:
        """The global rank of tp rank ``tp_rank`` (what point-to-point calls take)."""
        if self.group is None:
            return tp_rank
        return dist.get_global_rank(self.group, tp_rank)

    def hw_for(self, axis):
        """The link model of ``axis`` (a name or a tuple of names)."""
        return self.hw.for_axes(axis)

    def with_fusion(self, fusion: FusionConfig) -> "ParallelContext":
        return dataclasses.replace(self, fusion=fusion)


class HeadsAxis(tuple):
    """A segmented tp axis: the dim is the concatenation of these ``(size,
    whole)`` segments; a segment split over the tp ranks gives rank r its
    block r, a ``whole`` one is on every rank in full."""

    def __new__(cls, *segments):
        return super().__new__(cls, segments)

    def __repr__(self):
        return f"HeadsAxis{tuple(self)}"

    def local(self, tp: int) -> list:
        """[(size on a rank, whole)] of each segment at tp ranks."""
        return [(size if whole else size // tp, whole) for size, whole in self]

    def index(self, tp: int, rank: int) -> torch.Tensor:
        """The indices, into the whole dim, of the entries tp rank ``rank``
        holds, in the dim's order (int64)."""
        out, off = [], 0
        for size, whole in self:
            if size % tp and not whole:
                raise ValueError(f"segment of {size} in {self} does not split over tp={tp}")
            lo, n = (off, size) if whole else (off + rank * (size // tp), size // tp)
            out.append(torch.arange(lo, lo + n))
            off += size
        return torch.cat(out)


def segmented_dims(spec, ctx) -> list:
    """[(dim, axis)] of each segmented dim of ``spec`` that ``ctx``'s tp
    ranks split (none at tp = 1)."""
    if ctx.tp == 1:
        return []
    return [(i, ax) for i, ax in enumerate(spec) if isinstance(ax, HeadsAxis)]


def unsegmented(spec) -> tuple:
    """``spec`` with each segmented axis as ``None``."""
    return tuple(None if isinstance(ax, HeadsAxis) else ax for ax in spec)


def splits_over_tp(spec) -> bool:
    """Whether a logical ``spec`` splits a dim over the tp ranks (a tp axis,
    a segmented one or ``"world"``; else the leaf is whole on every rank of
    a replica)."""
    return any(ax in _TP_AXES or ax == WORLD_AXIS or isinstance(ax, HeadsAxis) for ax in spec)


def splits_over_data(spec) -> bool:
    """Whether a logical ``spec`` splits a dim over the data ranks where it
    is placed for training (a ``"fsdp"``, ``"batch"`` or ``"world"`` dim);
    else the leaf is whole on every replica."""
    return any(ax in _DATA_AXES or ax == WORLD_AXIS for ax in spec)


def split_dims(spec, ctx, training: bool = False) -> list:
    """[(dim, ranks, rank)] of each dim ``spec`` splits in ``ctx``'s world:
    a tp axis over ``ctx.tp``, with ``training`` a data axis over ``ctx.dp``,
    a ``"world"`` dim over all ``dp * tp`` ranks at world rank ``dp_rank *
    tp + tp_rank`` (a dim split over one rank is left out).  A segmented
    dim is no slice and is left out too (:func:`segmented_dims`).  ``ctx``
    needs only ``tp``, ``tp_rank`` and, where dp > 1, ``dp`` and
    ``dp_rank``."""
    if any(isinstance(ax, HeadsAxis) for ax in spec) and \
            [ax for ax in spec if ax in _TP_AXES or ax == WORLD_AXIS]:
        raise ValueError(f"logical spec {spec}: a segmented axis is the leaf's one tp axis")
    spec = unsegmented(spec)
    unknown = [ax for ax in spec if ax not in _TP_AXES and ax not in _WHOLE_AXES
               and ax != WORLD_AXIS]
    tp_dims = [i for i, ax in enumerate(spec) if ax in _TP_AXES]
    data_dims = [i for i, ax in enumerate(spec) if ax in _DATA_AXES]
    world_dims = [i for i, ax in enumerate(spec) if ax == WORLD_AXIS]
    if unknown or len(tp_dims) > 1 or len(data_dims) > 1 or \
            (world_dims and (len(world_dims) > 1 or tp_dims or data_dims)):
        raise ValueError(f"logical spec {spec}: one tp axis of {_TP_AXES} and one data axis "
                         f"of {_DATA_AXES} at most, or one {WORLD_AXIS!r} axis alone")
    dp = getattr(ctx, "dp", 1)
    dp_rank = getattr(ctx, "dp_rank", 0)
    out = [(i, ctx.tp, ctx.tp_rank) for i in tp_dims if ctx.tp > 1]
    if training:
        out += [(i, dp, dp_rank) for i in data_dims if dp > 1]
    out += [(i, dp * ctx.tp, dp_rank * ctx.tp + ctx.tp_rank) for i in world_dims
            if dp * ctx.tp > 1]
    return sorted(out)


def split_contexts(spec, ctx: ParallelContext, training: bool = False) -> list:
    """[(dim, context)] of each dim ``spec`` splits in ``ctx``'s world (the
    dims of :func:`split_dims`), with the context whose ranks split it: a
    tp axis ``ctx`` itself, a data axis ``ctx.data``, a ``"world"`` dim
    ``ctx.world`` (each context's ``tp`` the dim's rank count)."""
    out = []
    for dim, _, _ in split_dims(spec, ctx, training):
        ax = spec[dim]
        out.append((dim, ctx if ax in _TP_AXES else ctx.data if ax in _DATA_AXES else ctx.world))
    return out


def shard_leaf(x: torch.Tensor, spec, ctx: ParallelContext, training: bool = False
               ) -> torch.Tensor:
    """This rank's part of the whole tensor ``x`` under the reference's
    logical ``spec`` (one entry per dim): a dim named ``"tp"``, ``"vocab"``,
    ``"seq"`` or ``"heads"`` is split into ``ctx.tp`` equal blocks and block
    ``ctx.tp_rank`` kept; with ``training`` a dim named ``"fsdp"`` is split
    into ``ctx.dp`` blocks and block ``ctx.dp_rank`` kept (the train state's
    placement); a ``"world"`` dim into ``dp * tp`` blocks in world order;
    ``None``, and ``"fsdp"`` in serving, keep the dim whole; a segmented
    dim (:class:`HeadsAxis`) keeps rank ``ctx.tp_rank``'s entries of it.
    The SPMD counterpart of the reference's ``param_sharding_rules``.  When
    no dim splits, ``x`` itself is returned; otherwise a compact copy, so
    the whole can be freed."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(x.shape)}")
    seg = segmented_dims(spec, ctx)
    for dim, ax in seg:
        if sum(size for size, _ in ax) != x.shape[dim]:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} is not the segments of {ax}")
        x = x.index_select(dim, ax.index(ctx.tp, ctx.tp_rank).to(x.device))
    splits = split_dims(spec, ctx, training)
    for dim, n, r in splits:
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split over {n} "
                             f"ranks (spec {spec})")
        size = x.shape[dim] // n
        x = x.narrow(dim, r * size, size)
    return x.clone() if splits else x
