"""train_step factory: loss -> grads -> (all-reduce) -> clip -> (compress)
-> optimizer.

After the JAX package's ``train/step.py``.  Gradients come from autograd
(``torch.autograd.grad`` over the parameter leaves); microbatch gradient
accumulation (for memory) sums them in f32 over slices of the batch, as the
reference's scan does.  The remat policy lives in the model configs.  The
returned step updates the state in place and returns it with the metrics.

At tp > 1 every rank runs the step on its shards.  A leaf whole on every
rank (its logical spec names no tp axis) gets only this rank's tokens'
part of its gradient: after the gradients (and the microbatch sum) one
all-reduce a dtype sums those over the ranks
(``collectives.all_reduce_grads``), the clip's norm is the world's, and
AdamW updates each shard in place, so a whole leaf leaves the step with the
same bits on every rank.

Over data replicas (dp > 1) the train state's fsdp dims are split over the
data ranks (``train_state_specs``; ``init_params(..., training=True)``
places them), each replica runs its rows of the batch, and the loss is the
global mean (``models/transformer.train_forward``); the gradients of the
leaves whole over data are summed over the data ranks
(``all_reduce_grads``), those of the fsdp shards come reduce-scattered from
their gathers' backward.  Gradient compression runs over the shards
(``compress_decompress`` with the world and the specs), and so does the
optimizer's update (Adafactor's means over split dims reduce over the
ranks that split them, ``optimizer.adafactor_update``).

DLRM at any (dp, tp): its tables are split over the flattened world
(``"world"``), so their gradients (each rank's shard, complete through the
exchange's backward) are not summed; its MLP leaves, whole on every rank,
are summed over tp, then over data, which is the whole world; the clip's
norm counts each table once, and AdamW updates the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.data.pipeline import batch_row_slice, batch_size
from repro_torch.train.grad_compression import (CompressionConfig, compress_decompress,
                                                init_residuals)
from repro_torch.core.collectives import all_reduce_grads
from repro_torch.train.optimizer import (OptimizerConfig, clip_by_global_norm, make_optimizer,
                                         optimizer_state_specs, spec_leaves, tree_leaves,
                                         tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)
    microbatches: int = 1
    # the model's layer pattern (gemma2: 2), whose positions the optimizer
    # and the compression stack apart, as the reference's scan does
    # (``optimizer.leaf_groups``); the reference reads it from its stacked tree
    layer_period: int = 1


def init_train_state(tc: TrainConfig, params):
    """{"params", "opt", ("residuals")}: every parameter leaf is marked as
    requiring a gradient."""
    opt_init, _ = make_optimizer(tc.optimizer)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt_init(tc.optimizer, params, tc.layer_period)}
    if tc.compression.scheme != "none":
        state["residuals"] = init_residuals(tc.compression, params)
    return state


def build_train_step(loss_fn: Callable, tc: TrainConfig, *, ctx=None, param_specs=None,
                     on_phase: Callable | None = None):
    """loss_fn(params, batch) -> scalar loss.  Returns ``train_step(state,
    batch) -> (state, metrics)`` with metrics {"loss", "grad_norm", "lr",
    "step"} as tensors (nothing is read back to the host).  ``ctx`` (the
    loss's context) and ``param_specs`` (the parameters' logical specs,
    ``ArchBundle.param_specs``) are needed at tp > 1.  ``on_phase``, if
    given, is called with "start", "forward", "backward", "allreduce" and
    "optimizer" as each part of a step has been enqueued (for timing).
    The loss reported is the global mean, the same on every rank."""
    _, opt_update = make_optimizer(tc.optimizer)
    mark = on_phase or (lambda name: None)
    tp, dp = (1, 1) if ctx is None else (ctx.tp, ctx.dp)
    world = tp > 1 or dp > 1
    if world:
        if param_specs is None:
            raise ValueError(f"build_train_step at (dp, tp) = ({dp}, {tp}) needs the "
                             f"parameters' specs")
    specs = spec_leaves(param_specs) if world else None

    def split_micro(batch, i):
        mb = batch_size(batch) // tc.microbatches
        return batch_row_slice(batch, i * mb, mb)

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        mark("start")
        if tc.microbatches == 1:
            loss = loss_fn(params, batch)
            mark("forward")
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            for i in range(tc.microbatches):
                li = loss_fn(params, split_micro(batch, i))
                mark("forward")
                for acc, g in zip(grads, torch.autograd.grad(li, leaves)):
                    acc += g.float()
                loss += li.detach()
            loss /= tc.microbatches
            for g in grads:
                g /= tc.microbatches
        mark("backward")
        if world:
            all_reduce_grads(ctx, grads, specs)
        mark("allreduce")
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        grads, gnorm = clip_by_global_norm(grads, tc.optimizer.grad_clip, ctx, param_specs)
        if tc.compression.scheme != "none":
            grads, state["residuals"] = compress_decompress(
                tc.compression, grads, state["residuals"], tc.layer_period, ctx,
                param_specs if world else None)
        # Adafactor's factored means reduce over the ranks that split a leaf;
        # AdamW is elementwise and takes no world
        over = ((ctx, param_specs if world else None) if tc.optimizer.name == "adafactor"
                else ())
        _, state["opt"], lr = opt_update(tc.optimizer, grads, state["opt"], params,
                                         tc.layer_period, *over)
        del grads
        mark("optimizer")
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "step": state["opt"]["step"]}
        return state, metrics

    return train_step


def train_state_specs(tc: TrainConfig, param_specs):
    """The train state's logical specs: the parameters', the optimizer
    state's (:func:`optimizer.optimizer_state_specs`) and the compression
    residuals' (the parameters').  Their ``"fsdp"`` dims are split over the
    data ranks (``parallel.sharding.shard_leaf(..., training=True)``), as
    the reference maps ``"fsdp"`` onto its data axes."""
    specs = {"params": param_specs,
             "opt": optimizer_state_specs(tc.optimizer, param_specs, tc.layer_period)}
    if tc.compression.scheme != "none":
        specs["residuals"] = param_specs
    return specs
