"""Parameters from the JAX package's layout into the port's."""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    a = np.array(a)   # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # an ml_dtypes bfloat16 array, which torch.from_numpy refuses
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _conv(tree, device, index=None):
    """A nested dict of arrays as tensors; with ``index``, the entry at that
    position of every array's leading (stacked-layer) axis."""
    if isinstance(tree, dict):
        return {k: _conv(v, device, index) for k, v in tree.items()}
    return _tensor(tree if index is None else np.asarray(tree)[index], device)


def params_from_numpy(tree, device="cpu"):
    """JAX transformer params as nested dicts of numpy arrays (``split_params``
    values through ``np.asarray``) -> the port's parameters.

    The reference stacks the scanned layers: ``tree["layers"]["l<j>"]``
    holds pattern position j of every group along a leading axis, so layer
    ``g * P + j`` is group g's entry j for a pattern of P layers.  The port
    keeps one dict per layer in ``params["layers"]``.  Every leaf is carried
    across as it is, the MoE FFN's too: ``router`` f32 [D, E], ``w_gate`` and
    ``w_up`` [E, D, F], ``w_down`` [E, F, D]."""
    if "prefix" in tree:
        raise NotImplementedError("dense-prefix layers: ROADMAP Queue 1 item 5")

    stacked = tree["layers"]
    period = len(stacked)
    groups = len(np.asarray(stacked["l0"]["ln1"]))
    layers = [_conv(stacked[f"l{j}"], device, g) for g in range(groups)
              for j in range(period)]
    return {"embed": _conv(tree["embed"], device),
            "final_norm": _conv(tree["final_norm"], device), "layers": layers}


def dlrm_params_from_numpy(tree, device="cpu"):
    """JAX DLRM params as nested numpy arrays (``split_params`` values
    through ``np.asarray``: ``tables`` [T, V, D], ``bottom`` and ``top``
    lists of ``{"w", "b"}``) -> the port's parameters, the same tree."""
    layers = lambda key: [{k: _tensor(v, device) for k, v in layer.items()}
                          for layer in tree[key]]
    return {"tables": _tensor(tree["tables"], device), "bottom": layers("bottom"),
            "top": layers("top")}


def rwkv6_params_from_numpy(tree, device="cpu"):
    """JAX rwkv6 params as nested numpy arrays (``split_params`` values
    through ``np.asarray``) -> the port's parameters.  The reference stacks
    its layers on a leading axis (``stacked_init``); the port keeps one dict
    per layer in ``params["layers"]``."""
    n_layers = len(np.asarray(tree["layers"]["ln1"]))
    return {"embed": _conv(tree["embed"], device),
            "final_norm": _conv(tree["final_norm"], device),
            "layers": [_conv(tree["layers"], device, i) for i in range(n_layers)]}
