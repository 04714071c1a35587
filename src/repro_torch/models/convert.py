"""Parameters from the JAX package's layout into the port's."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import param_specs, shard_params
from repro_torch.parallel.sharding import shard_leaf
from repro_torch.train.optimizer import (OptimizerConfig, optimizer_state_specs, tree_leaves,
                                         tree_map)


def _tensor(a, device):
    a = np.array(a)   # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # an ml_dtypes bfloat16 array, which torch.from_numpy refuses
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _conv(tree, device, index=None):
    """Nested dicts and lists of arrays as tensors; with ``index``, the entry
    at that position of every array's leading (stacked-layer) axis."""
    if isinstance(tree, dict):
        return {k: _conv(v, device, index) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_conv(v, device, index) for v in tree]
    return _tensor(tree if index is None else np.asarray(tree)[index], device)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_numpy(tree, device="cpu", ctx=None, training: bool = False):
    """JAX transformer params as nested dicts of numpy arrays (``split_params``
    values through ``np.asarray``) -> the port's parameters.

    The reference stacks the scanned layers: ``tree["layers"]["l<j>"]``
    holds pattern position j of every group along a leading axis, so layer
    ``g * P + j`` is group g's entry j for a pattern of P layers.  The port
    keeps one dict per layer in ``params["layers"]``.  Every leaf is carried
    across as it is, the MoE FFN's too: ``router`` f32 [D, E], ``w_gate`` and
    ``w_up`` [E, D, F], ``w_down`` [E, F, D].  Any tree with the parameters'
    layout converts the same way, with more structure below a parameter's
    place (Adafactor's ``{"vr", "vc"}``).

    With a ``ctx`` at tp > 1 each leaf is sliced to this rank's shard by the
    reference's logical spec (``transformer.leaf_spec``: ``w_qkv`` and
    ``w_o`` whole, the MLP's ``w_gate`` and ``w_up`` by columns and its
    ``w_down`` by rows, a MoE FFN's experts by expert and its router whole,
    its shared expert whole, every MLA leaf whole, the embedding table by
    vocabulary rows); with ``training`` at dp > 1 also by its ``"fsdp"`` dim
    over the data ranks (the train state's placement; serving keeps those
    whole).

    The dense-prefix layers (``tree["prefix"]``: a list of ``{"l0": layer}``,
    unstacked) go to ``params["prefix"]``, one dict a layer; MLA's 3-D
    ``w_uk`` / ``w_uv`` [kv_lora, H, d] and a MoE FFN's ``"shared"`` dict
    are carried across as they are."""
    stacked = tree["layers"]
    period = len(stacked)
    groups = len(np.asarray(_first_leaf(stacked["l0"])))
    layers = [shard_params(_conv(stacked[f"l{j}"], device, g), ctx, training)
              for g in range(groups) for j in range(period)]
    params = {"embed": shard_params(_conv(tree["embed"], device), ctx, training),
              "final_norm": _conv(tree["final_norm"], device), "layers": layers}
    if "prefix" in tree:
        params["prefix"] = [shard_params(_conv(p["l0"], device), ctx, training)
                            for p in tree["prefix"]]
    return params


def dlrm_params_from_numpy(tree, device="cpu", ctx=None):
    """JAX DLRM params as nested numpy arrays (``split_params`` values
    through ``np.asarray``: ``tables`` [T, V, D], ``bottom`` and ``top``
    lists of ``{"w", "b"}``) -> the port's parameters, the same tree.  With
    a ``ctx`` of more than one rank, the tables are this rank's world shard
    (``dlrm.DLRM_PARAM_SPECS``); the MLP stays whole.  Any tree of that
    layout converts the same way (AdamW's moments)."""
    from repro_torch.models.dlrm import DLRM_PARAM_SPECS

    layers = lambda key: [{k: _tensor(v, device) for k, v in layer.items()}
                          for layer in tree[key]]
    tables = _tensor(tree["tables"], device)
    if ctx is not None:
        tables = shard_leaf(tables, DLRM_PARAM_SPECS["tables"], ctx)
    return {"tables": tables, "bottom": layers("bottom"), "top": layers("top")}


def rwkv6_params_from_numpy(tree, device="cpu"):
    """JAX rwkv6 params as nested numpy arrays (``split_params`` values
    through ``np.asarray``) -> the port's parameters.  The reference stacks
    its layers on a leading axis (``stacked_init``); the port keeps one dict
    per layer in ``params["layers"]``."""
    n_layers = len(np.asarray(tree["layers"]["ln1"]))
    return {"embed": _conv(tree["embed"], device),
            "final_norm": _conv(tree["final_norm"], device),
            "layers": [_conv(tree["layers"], device, i) for i in range(n_layers)]}


def zamba2_params_from_numpy(tree, device="cpu", cfg=None, ctx=None, training: bool = False):
    """JAX zamba2 params as nested numpy arrays (``split_params`` values
    through ``np.asarray``) -> the port's parameters.  The reference stacks
    its groups (``stacked_init``): every leaf of ``tree["groups"]``, the
    per-group list of ``attn_every`` Mamba blocks' leaves and the LoRA
    among them, carries the group on a leading axis.  The port keeps one
    dict per group in ``params["groups"]``, each with its list of Mamba
    blocks; the shared block and the tail's list are carried as they are.
    With a ``ctx`` of more than one rank (and the model's ``cfg``), this
    rank's shards (``models/zamba2.shard_params``: the Mamba heads by heads,
    ``training`` placing the fsdp dims over data)."""
    from repro_torch.models.zamba2 import param_specs, shard_params

    groups = tree["groups"]
    n_groups = len(np.asarray(groups["lora_a"]))
    params = {"embed": _conv(tree["embed"], device),
              "final_norm": _conv(tree["final_norm"], device),
              "shared": _conv(tree["shared"], device),
              "groups": [_conv(groups, device, g) for g in range(n_groups)],
              "tail": _conv(tree["tail"], device)}
    if ctx is None:
        return params
    if cfg is None:
        raise ValueError("zamba2_params_from_numpy over a world needs the config (the Mamba "
                         "blocks' segments)")
    return shard_params(params, param_specs(cfg, params), ctx, training)


def train_state_from_numpy(state, device="cpu", ctx=None, cfg=None):
    """A JAX transformer, zamba2 or DLRM train state (``init_train_state``'s tree through
    ``np.asarray``: ``params``, ``opt`` with AdamW's ``mu``/``nu``/``step``
    or Adafactor's ``v``/``step``, and the compression ``residuals`` if
    any) -> the port's state (``repro_torch.train.step``).  Parameters are
    marked as requiring a gradient, as ``init_train_state`` marks them.
    With a ``ctx`` of more than one rank, this rank's shards of the
    parameters, the optimizer state (AdamW's moments, or Adafactor's
    stacked factors by ``optimizer_state_specs``) and the residuals, in the
    training placement (``train_state_specs``); a DLRM state's tables and
    their moments by world rank.  A zamba2 state (its parameters' stacked
    ``"groups"``) converts as ``zamba2_params_from_numpy`` does, over a
    world with the model's ``cfg``; it trains with AdamW, and an Adafactor
    state of it raises."""
    if "tables" in state["params"]:
        conv = lambda t: dlrm_params_from_numpy(t, device, ctx)
    elif "groups" in state["params"]:
        if "v" in state["opt"]:
            raise ValueError("an Adafactor state of zamba2: the port trains zamba2 with AdamW, "
                             "as the reference's config does")
        conv = lambda t: zamba2_params_from_numpy(t, device, cfg, ctx, training=True)
    else:
        conv = lambda t: params_from_numpy(t, device, ctx, training=True)
    params = conv(state["params"])
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = state["opt"]
    if "v" in opt:
        # Adafactor keeps the reference's stacked state under "layers": the
        # one stack "l0" of a layer pattern of one as it is, a longer
        # pattern's stacks "l0", "l1", ... by name (optimizer.adafactor_init)
        v = opt["v"]
        layers = _conv(v["layers"], device)
        v = {**{k: _conv(t, device) for k, t in v.items() if k != "layers"},
             "layers": layers["l0"] if set(layers) == {"l0"} else layers}
        if ctx is not None:
            specs = optimizer_state_specs(OptimizerConfig(name="adafactor"),
                                          param_specs(params), len(layers))["v"]
            v = tree_map(lambda a, sp: shard_leaf(a, sp, ctx, training=True), v, specs)
        opt = {"v": v}
    else:
        opt = {k: conv(v) for k, v in opt.items() if k != "step"}
    opt["step"] = torch.tensor(int(np.asarray(state["opt"]["step"])), dtype=torch.int32)
    out = {"params": params, "opt": opt}
    if "residuals" in state:
        out["residuals"] = conv(state["residuals"])
    return out
