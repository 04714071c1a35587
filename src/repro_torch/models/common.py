"""Parameter initialisers shared by the model code.

Parameters are plain dicts of tensors.  Every initialiser takes an
explicit ``torch.Generator`` and draws on the generator's device.  Each
tensor is drawn in f32 and cast at once, so a full-width bf16 model never
holds all its weights in f32.  The draws follow the JAX package's
distributions, not its bits: JAX and torch generators differ, so tests
hand both frameworks the same numpy arrays instead.
"""
from __future__ import annotations

import torch

# config dtype names -> torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``fan_in ** -0.5`` (or ``scale``)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    v = torch.empty(shape, dtype=torch.float32, device=gen.device)
    # trunc_normal_ takes absolute bounds: cut the unit normal, then scale
    torch.nn.init.trunc_normal_(v, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return v.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, std: float = 0.02):
    v = torch.randn(shape, dtype=torch.float32, device=gen.device,
                    generator=gen)
    return v.mul_(std).to(dtype)
