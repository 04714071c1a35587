"""Optimizers: AdamW (dtype-configurable state) and Adafactor-lite.

Plain functions on trees of tensors (nested dicts and lists, the port's
parameter layout), after the JAX package's.  JAX returns new trees; the port
updates parameters and state in place, leaf by leaf, under
``torch.no_grad()``, so a full-width model never holds a second copy of its
weights or moments.  The f32 temporaries of an update never exceed two of
one leaf's size (chatglm3-6b's embedding table is 1.07 GB in f32), beside
an f32 copy of a moment kept in a narrower dtype.

The reference scans its layers, so its optimizer sees each layer leaf
stacked over the layers ([L, ...]): its weight decay ("matrices only")
reaches the layers' norm weights, and Adafactor factors a stacked norm over
the layer axis and clips each update by the RMS of the whole stack.  The
port keeps one dict per layer, and :func:`leaf_groups` hands the update the
same groups: a leaf outside ``params["layers"]`` alone, a layer leaf
together with its counterparts in every other layer at the same position of
the layer pattern (the reference scans a pattern of P layers as P stacks,
``l0`` .. ``l<P-1>``: gemma2's local and global layers are two).  The update
functions take that ``period``; ``train/step.py`` passes the model's.
AdamW's update is elementwise, so its state stays per layer; Adafactor
keeps the stacked factored state of the reference.

State dtype matters at scale: bf16 moments (or Adafactor) halve the
optimizer's memory.  Configs pick via ``state_dtype``.

At tp > 1 each rank updates its own shards (``models/transformer.py``
``PARAM_SPECS``): AdamW is elementwise, so a shard's update is the whole
rule on it, and a leaf whole on every rank gets the same gradient and so
the same bits everywhere (``train/step.py`` sums its partials over the
ranks first).  Over data replicas (dp > 1) the train state's fsdp dims are
split over the data ranks as well, and AdamW updates those shards the same
way, and DLRM's tables, split over the whole flattened world.
:func:`clip_by_global_norm` takes the world and the specs and sums
the squares of each leaf over the ranks it is split over (a ``"world"``
leaf over tp, then data: each table counted once);
:func:`optimizer_state_specs` gives the state the parameters' specs (the
moments inherit the fsdp split).  Adafactor's factored moments and its
update clip reduce over the leaf's axes, some of which a world splits: given
the world and the specs, each mean over a split dim is this rank's sum,
summed over the ranks that split it and divided by the global length, and
the clip's mean over the whole stacked leaf is summed over every rank that
holds a part of it (:func:`adafactor_update`), so every shard takes the
whole leaf's update.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import DTYPES


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"   # bf16 for the largest configs


# ---------------------------------------------------------------------------
# trees: nested dicts and lists with tensors at the leaves
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the matching subtrees of
    ``rest`` (which may hold more structure below a leaf of ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, path=()):
    """(path, leaf) pairs in ``tree_leaves`` order; a path holds dict keys
    and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def leaf_groups(tree, period: int = 1) -> list:
    """[(path, tensors, stacked)]: the leaves as the reference's optimizer
    sees them.  A leaf outside ``tree["layers"]`` and ``tree["groups"]`` is
    a group of one (``stacked`` False); each leaf of the per-layer dicts
    forms a group with the same leaf of every layer at the same position j
    of a layer pattern of ``period`` layers (layers j, j + period, ...;
    ``stacked`` True), as the reference's scan stacks them: path
    ``("layers", ...)`` for a pattern of one, ``("layers", "l<j>", ...)``
    for a longer one.  zamba2's ``tree["groups"]`` (one dict a group of
    Mamba blocks, which the reference builds with ``stacked_init``) stacks
    the same way with a pattern of one, path ``("groups", ...)``; its tail
    blocks are groups of one.  Trees of one structure (parameters,
    gradients, AdamW moments) give aligned groups."""
    groups = [(path, [leaf], False) for path, leaf in
              tree_paths({k: v for k, v in tree.items() if k not in ("layers", "groups")})]
    stack = tree.get("groups", [])
    groups += [(("groups",) + path, [get_path(gp, path) for gp in stack], True)
               for path, _ in (tree_paths(stack[0]) if stack else ())]
    layers = tree.get("layers", [])
    if len(layers) % period:
        raise ValueError(f"{len(layers)} layers are not whole patterns of {period}")
    for j in range(period if layers else 0):
        stack = layers[j::period]
        prefix = ("layers",) if period == 1 else ("layers", f"l{j}")
        groups += [(prefix + path, [get_path(lp, path) for lp in stack], True)
                   for path, _ in tree_paths(stack[0])]
    return groups


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(cfg: OptimizerConfig, step):
    """Linear warmup -> cosine decay to min_lr_ratio; an f32 scalar tensor
    (computed in f32 from the integer step, as the reference does)."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def spec_leaves(specs) -> list:
    """The logical specs of a spec tree (nested dicts and lists with a
    tuple at each leaf), in ``tree_leaves`` order of the matching tree."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [tuple(specs)]


@torch.no_grad()
def global_norm(tree, ctx=None, specs=None):
    """sqrt of the sum of every leaf's squares, summed in f32 leaf by leaf.
    Over a world (``ctx`` of more than one rank, ``specs`` the leaves'
    logical specs in their training placement): the squares of a leaf
    summed over the ranks it is split over (tp, data, or both), those of a
    leaf whole on every rank counted once; the same bits on every rank."""
    leaves = tree_leaves(tree)
    sq = lambda xs: sum(torch.sum(torch.square(x.float())) for x in xs)
    tp, dp = (1, 1) if ctx is None else (ctx.tp, ctx.dp)
    if tp == 1 and dp == 1:
        return torch.sqrt(sq(leaves))
    from repro_torch.core.collectives import _all_reduce
    from repro_torch.parallel.sharding import splits_over_data, splits_over_tp

    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    part = {k: zero for k in ((False, False), (True, False), (False, True), (True, True))}
    for x, sp in zip(leaves, spec_leaves(specs)):
        over_data = dp > 1 and splits_over_data(sp)
        for whole, piece in _tp_pieces(x, sp, ctx):
            kind = (tp > 1 and splits_over_tp(sp) and not whole, over_data)
            part[kind] = part[kind] + sq([piece])
    # [tp only, both] summed over tp; then [data only, both's tp sum] over data
    over_tp = torch.stack([part[(True, False)], part[(True, True)]])
    if tp > 1:
        over_tp = _all_reduce(ctx, over_tp)
    over_data = torch.stack([part[(False, True)], over_tp[1]])
    if dp > 1:
        over_data = _all_reduce(ctx.data, over_data)
    return torch.sqrt(part[(False, False)] + over_tp[0] + over_data[0] + over_data[1])


def _tp_pieces(x, spec, ctx) -> list:
    """[(whole over tp, piece)] of a leaf: the leaf itself, or for a
    segmented dim (``parallel.sharding.HeadsAxis``) its entries split over
    tp and those whole on every rank, so the norm counts the whole ones
    once."""
    from repro_torch.parallel.sharding import segmented_dims

    seg = segmented_dims(spec, ctx)
    if not seg:
        return [(False, x)]
    dim, ax = seg[0]
    out, off = [], 0
    for size, whole in ax.local(ctx.tp):
        out.append((whole, x.narrow(dim, off, size)))
        off += size
    return out


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, ctx=None, specs=None):
    """Scale every gradient by min(1, max_norm / norm) in place (in f32,
    rounded back to the leaf's dtype); returns (grads, norm).  ``ctx`` and
    ``specs`` give the world's norm (:func:`global_norm`).  Nothing reads
    the norm back to the host."""
    norm = global_norm(grads, ctx, specs)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in tree_leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


def _step_scalars(state):
    step = state["step"] + 1
    return step, _f32(step)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(cfg: OptimizerConfig, params, period: int = 1):
    dt = DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params, period: int = 1):
    """One AdamW step in place on ``params`` and ``state``; returns (params,
    state, lr).  Decoupled weight decay on matrices only.  ``period``: the
    model's layer pattern (:func:`leaf_groups`).  Elementwise, so a shard's
    update needs no world."""
    step, step_f = _step_scalars(state)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1, bc2 = 1 - _f32(b1) ** step_f, 1 - _f32(b2) ** step_f

    def upd(g, p, m, v, decay):
        buf = g.to(torch.float32, copy=True)
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(b1).add_(buf, alpha=1 - b1)
        v32.mul_(b2).addcmul_(buf, buf, value=1 - b2)
        den = torch.div(v32, bc2, out=buf).sqrt_().add_(cfg.eps)
        delta = torch.div(m32, bc1).div_(den)
        p32 = buf.copy_(p)
        if decay:
            delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(delta.mul_(lr)))
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)

    for (_, gs, stacked), (_, ps, _), (_, ms, _), (_, vs, _) in zip(
            *(leaf_groups(tr, period) for tr in (grads, params, state["mu"], state["nu"]))):
        for g, p, m, v in zip(gs, ps, ms, vs):
            # decoupled weight decay on matrices only, as the reference's
            # stacked leaves count their dimensions
            upd(g, p, m, v, p.dim() + stacked >= 2)
    state["step"] = step
    return params, state, lr


# ---------------------------------------------------------------------------
# Adafactor-lite (factored second moment; for the 100B+ configs)
# ---------------------------------------------------------------------------
def adafactor_init(cfg: OptimizerConfig, params, period: int = 1):
    """{"v": the factored second moments, laid out like ``params`` outside
    the layers and, under "layers", like one layer dict holding each
    group's stacked state (for a layer pattern of ``period`` > 1, one such
    dict per position, "l0", "l1", ..., as the reference keeps them);
    "step"}."""
    v = {}
    for path, ps, stacked in leaf_groups(params, period):
        shape = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
        f32 = dict(dtype=torch.float32, device=ps[0].device)
        if len(shape) >= 2:
            _set_path(v, path, {"vr": torch.zeros(shape[:-1], **f32),
                                "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)})
        else:
            _set_path(v, path, {"v": torch.zeros(shape, **f32)})
    return {"v": v, "step": torch.zeros((), dtype=torch.int32)}


class _Shards:
    """Where a world splits one leaf of logical ``spec`` (its training
    placement): the group and rank count of each split dim, for the means
    of Adafactor's update.  ``None`` or a world of one rank splits nothing,
    and every mean is the plain one."""

    def __init__(self, spec, ctx):
        from repro_torch.parallel.sharding import _DATA_AXES, _TP_AXES, WORLD_AXIS, HeadsAxis

        self.dims = {}
        if ctx is not None and ctx.tp > 1 and any(isinstance(ax, HeadsAxis) for ax in spec or ()):
            raise NotImplementedError(f"Adafactor over a segmented tp dim {spec}: its factored "
                                      f"means would need the segments (zamba2 trains with "
                                      f"AdamW)")
        for i, ax in enumerate(spec or ()):
            if ctx is not None and ax in _TP_AXES and ctx.tp > 1:
                self.dims[i] = (ctx, ctx.tp)
            elif ctx is not None and ax in _DATA_AXES and ctx.dp > 1:
                self.dims[i] = (ctx.data, ctx.dp)
            elif ctx is not None and ax == WORLD_AXIS and ctx.tp * ctx.dp > 1:
                self.dims[i] = (ctx.world, ctx.tp * ctx.dp)

    def mean(self, x, dim, leaf_dim, keepdim=False):
        """The mean of x over ``dim``, which is the leaf's dim ``leaf_dim``:
        over every rank's part where a world splits it."""
        split = self.dims.get(leaf_dim)
        if split is None:
            return x.mean(dim=dim, keepdim=keepdim)
        from repro_torch.core.collectives import _all_reduce

        group, ranks = split
        return _all_reduce(group, x.sum(dim=dim, keepdim=keepdim)) / (x.shape[dim] * ranks)

    def total(self, x):
        """x (this rank's partial sums) summed over every rank that holds a
        part of the leaf, and the number of such parts."""
        from repro_torch.core.collectives import _all_reduce

        parts = 1
        for group, ranks in self.dims.values():      # the leaf's dim order, on every rank
            x, parts = _all_reduce(group, x), parts * ranks
        return x, parts


def _adafactor_u(g, v, decay, shards: _Shards | None = None, lead: int = 0):
    """The reference's unclipped update of one (stacked) leaf, its factored
    state updated in place.  ``shards``: where a world splits the leaf, whose
    dims lie ``lead`` dims after g's (a layer of a stack)."""
    shards = shards or _Shards(None, None)
    nd = g.dim()
    if nd >= 2:
        g2 = g * g + 1e-30
        v["vr"].copy_(decay * v["vr"] + (1 - decay) * shards.mean(g2, -1, lead + nd - 1))
        v["vc"].copy_(decay * v["vc"] + (1 - decay) * shards.mean(g2, -2, lead + nd - 2))
        del g2
        return g / torch.sqrt(_adafactor_denom(v["vr"], v["vc"], shards, lead + nd - 2) + 1e-30)
    v["v"].copy_(decay * v["v"] + (1 - decay) * g * g)
    return g / torch.sqrt(v["v"] + 1e-30)


def _adafactor_denom(vr, vc, shards: _Shards | None = None, row_dim: int = -1):
    """vr vc^T over the mean of vr (over the leaf's dim ``row_dim``)."""
    mean = (vr.mean(dim=-1, keepdim=True) if shards is None else
            shards.mean(vr, -1, row_dim, keepdim=True))
    return (vr[..., None] * vc[..., None, :]) / torch.clamp_min(mean[..., None], 1e-30)


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, state, params, period: int = 1, ctx=None,
                     specs=None):
    """One Adafactor-lite step in place; returns (params, state, lr).  A
    stack of 1-D layer leaves (the norms) is updated stacked; a stack of
    matrices layer by layer, in two passes: the first updates the factored
    state and sums the squares of the update over the stack, the second
    applies it clipped by the stack's RMS (the reference's rule).

    Over a world (``ctx`` of more than one rank, ``specs`` the parameters'
    logical specs in their training placement) each rank updates its
    shards: a mean over a dim the world splits (the factors' ``vr`` and
    ``vc``, the denominator's mean of ``vr``) sums over the ranks that split
    it, and the clip's mean over the whole stacked leaf over every rank
    that holds a part of it.  The calls come in the same order on every
    rank (the leaves' order, the same specs)."""
    step, step_f = _step_scalars(state)
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (step_f + 1) ** -0.8
    world = ctx is not None and (ctx.tp > 1 or ctx.dp > 1)
    spec_groups = (leaf_groups(spec_tree(specs), period) if world else
                   [None] * len(leaf_groups(grads, period)))

    def apply(p, u, ndim):
        p32 = p.float()
        new_p = p32 - lr * u
        if ndim >= 2:
            new_p -= lr * cfg.weight_decay * p32
        p.copy_(new_p)

    for (path, gs, stacked), (_, ps, _), sg in zip(leaf_groups(grads, period),
                                                   leaf_groups(params, period), spec_groups):
        v = get_path(state["v"], path)
        spec = None if sg is None else ((None,) if stacked else ()) + sg[1][0].spec
        shards = _Shards(spec, ctx if world else None)
        if not stacked or ps[0].dim() == 1:
            g = torch.stack([x.float() for x in gs]) if stacked else gs[0].float()
            u = _adafactor_u(g, v, decay, shards)
            # update clipping (Adafactor RMS rule), over the whole leaf
            sq, parts = shards.total(torch.sum(u * u))
            u /= torch.clamp_min(torch.sqrt(sq / (u.numel() * parts) + 1e-30), 1.0)
            for i, p in enumerate(ps):
                apply(p, u[i] if stacked else u, g.dim())
            continue
        total = 0.0
        for i, g in enumerate(gs):
            u = _adafactor_u(g.float(), {"vr": v["vr"][i], "vc": v["vc"][i]}, decay, shards, 1)
            total = total + torch.sum(u * u)
        total, parts = shards.total(total)
        rms = torch.sqrt(total / (len(gs) * gs[0].numel() * parts) + 1e-30)
        for i, (g, p) in enumerate(zip(gs, ps)):
            den = _adafactor_denom(v["vr"][i], v["vc"][i], shards, g.dim() - 1)
            u = g.float() / torch.sqrt(den + 1e-30)
            apply(p, u / torch.clamp_min(rms, 1.0), p.dim() + 1)
    state["step"] = step
    return params, state, lr


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw_init, adamw_update
    if cfg.name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(cfg.name)


class _Spec:
    """A logical spec as a tree leaf (``tree_paths`` walks into tuples)."""

    def __init__(self, spec):
        self.spec = tuple(spec)


def spec_tree(specs):
    """A spec tree with each logical spec wrapped as one leaf (``_Spec``), so
    that ``leaf_groups`` groups it as it groups the parameters."""
    if isinstance(specs, dict):
        return {k: spec_tree(v) for k, v in specs.items()}
    return [spec_tree(v) for v in specs] if isinstance(specs, list) else _Spec(specs)


def optimizer_state_specs(cfg: OptimizerConfig, param_specs, period: int = 1):
    """The optimizer state's logical specs: each moment inherits its
    parameter's.  AdamW's moments are laid out as the parameters, so their
    specs are ``param_specs``; Adafactor's factored state (laid out as
    :func:`adafactor_init` keeps it, a layer leaf stacked over the layers
    with a leading unsharded layer axis) drops the last axis's spec for its
    row factor and the second-to-last's for its column factor, as the
    reference's does."""
    if cfg.name == "adamw":
        return {"mu": param_specs, "nu": param_specs, "step": ()}
    if cfg.name != "adafactor":
        raise ValueError(cfg.name)

    v = {}
    for path, leaves, stacked in leaf_groups(spec_tree(param_specs), period):
        s = ((None,) if stacked else ()) + leaves[0].spec
        _set_path(v, path, {"vr": s[:-1], "vc": s[:-2] + s[-1:]} if len(s) >= 2 else {"v": s})
    return {"v": v, "step": ()}
