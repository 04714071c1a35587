"""Helpers shared by the port's autotune tests (not collected: no ``test_``
prefix): the JAX package's link constants carried into the port, and the
two packages' cached decisions compared key by key.

Both packages decide under the same constants only if the port's
``HardwareModel`` is built from ``dataclasses.asdict`` of the reference's
``V5E`` / ``DCN`` (or the reverse, for a port context's default class).
"""
import dataclasses

from repro.core import autotune as jtune
from repro.core import perfmodel as jperf
from repro_torch.core import autotune as ptune
from repro_torch.core import perfmodel as pperf
from repro_torch.parallel.sharding import FusionConfig, ParallelContext


def port_hw(jhw: jperf.HardwareModel) -> pperf.HardwareModel:
    return pperf.HardwareModel(**dataclasses.asdict(jhw))


def jax_hw(phw: pperf.HardwareModel) -> jperf.HardwareModel:
    return jperf.HardwareModel(**dataclasses.asdict(phw))


P_V5E, P_DCN = port_hw(jperf.V5E), port_hw(jperf.DCN)


def v5e_ctx(**fusion) -> ParallelContext:
    """A one-rank CPU context deciding under the reference's default class."""
    return ParallelContext(device="cpu", fusion=FusionConfig(**fusion),
                           hw=pperf.MeshHardwareModel.uniform(P_V5E))


def as_json(key) -> dict:
    """A TuneKey of either package as the JSON both caches write."""
    mod = jtune if isinstance(key, jtune.TuneKey) else ptune
    return mod._key_to_json(key)


def decisions(mod) -> dict:
    """``mod``'s cache as {key JSON (a sorted tuple of items): (q, wire)}."""
    return {_frozen(as_json(k)): tuple(d) for k, d in mod.cache_info().items()}


def _frozen(d):
    return tuple(sorted((k, _frozen(v) if isinstance(v, dict) else
                         tuple(v) if isinstance(v, list) else v) for k, v in d.items()))


def clear_both():
    jtune.clear_cache()
    ptune.clear_cache()


def same_decisions():
    """The two caches hold the same keys with the same decisions, and at
    least one; returns them."""
    j, p = decisions(jtune), decisions(ptune)
    assert p and p == j, (p, j)
    return p


def jax_decision(key):
    """The JAX package's decision for a port TuneKey: its own tune function
    for the key's op, called on the key's shape and requests under the
    key's link constants (a fresh reference cache)."""
    jtune.clear_cache()
    kw = dict(dtype_bytes=key.dtype_bytes, n_dev=key.n_dev, hw=jax_hw(key.hw), skew=key.skew,
              wire=key.wire, fixed_q=key.fixed_q)
    op, shape = key.op, key.shape
    if op in ("matmul_allreduce", "matmul_reducescatter"):
        dec = jtune.tune_matmul_allreduce(*shape, chunk_dim=key.divisor_of,
                                          divisor_ring=key.divisor_ring,
                                          allgather_phase=op == "matmul_allreduce", **kw)
    elif op == "allgather_matmul":
        dec = jtune.tune_allgather_matmul(*shape, **kw)
    elif op == "ce_ring":
        dec = jtune.tune_ce_ring(*shape, **kw)
    elif op == "ring_attention":
        *rest, hops = shape
        dec = jtune.tune_ring_attention(*rest, hops=hops, **kw)
    else:
        dec = jtune.tune_all_to_all(*shape, sub_dim=key.divisor_of,
                                    kernel=op == "all_to_all_kernel", **kw)
    (jkey,) = jtune.cache_info()
    assert as_json(jkey) == as_json(key), (as_json(jkey), as_json(key))
    return tuple(dec)
