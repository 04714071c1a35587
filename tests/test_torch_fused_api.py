"""The port's public API (``repro_torch.core.fused``) and the Fig. 14 skew
model it re-exports, against the JAX package's.

``__all__`` is the reference's but for the three names the port's module
says it substitutes; the skew model is pure arithmetic on Python floats, so
the port's results equal the reference's exactly, over worlds 2-8, both
schedules, every skew, seeded step times and a slow link.  CPU.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

from repro.core import fused as jfused
from repro.core import scheduling as jsched
from repro_torch.core import fused as pfused
from repro_torch.core import scheduling as psched

ROOT = Path(__file__).resolve().parents[1]
SUBSTITUTED = {"fused_moe_kernel": "fused_moe_chain", "V5E": "H100_NVLINK", "DCN": "GLOO_HOST"}


def test_all_is_the_references_with_the_named_substitutions():
    want = [SUBSTITUTED.get(n, n) for n in jfused.__all__]
    assert sorted(pfused.__all__) == sorted(want)
    assert len(pfused.__all__) == len(jfused.__all__) == 44
    for name in pfused.__all__:
        assert getattr(pfused, name) is not None, name
    # the module's docstring names each substitution and why
    doc = pfused.__doc__
    for old, new in SUBSTITUTED.items():
        assert old in doc and new in doc


@pytest.mark.parametrize("name", sorted(set(pfused.__all__) - set(SUBSTITUTED.values())))
def test_each_shared_name_is_the_ported_object(name):
    """A name both packages export resolves to the port's object of the
    same name in the module it was ported to."""
    obj = getattr(pfused, name)
    assert getattr(obj, "__name__", name) == name or not callable(obj)
    mod = getattr(obj, "__module__", "")
    assert mod.startswith("repro_torch."), (name, mod)


def test_fused_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "src/repro_torch/core/fused.py").read_text())
    mods = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    mods += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert mods and all(m.startswith("repro_torch.") for m in mods), mods


def _times(world, seed):
    rng = np.random.default_rng(seed)
    return [float(t) for t in 1.0 + rng.random(world)]


LINKS = {w: [1.0] * (w // 2) + [4.0] + [1.0] * (w - w // 2 - 1) for w in range(2, 9)}


@pytest.mark.parametrize("world", range(2, 9))
@pytest.mark.parametrize("schedule", ["comm_aware", "oblivious"])
def test_skew_model_equals_reference(world, schedule):
    cases = [[1.0] * world, _times(world, world), _times(world, 100 + world)]
    slow = [1.0] * world
    slow[world - 1] = 1.5
    cases.append(slow)
    for times in cases:
        for links in (None, LINKS[world]):
            for skew in range(world):
                kw = dict(link_scale=links)
                assert psched.modeled_finish_times(world, schedule, skew, times, **kw) == \
                    jsched.modeled_finish_times(world, schedule, skew, times, **kw)
                assert psched.modeled_execution_skew(world, schedule, skew, times, **kw) == \
                    jsched.modeled_execution_skew(world, schedule, skew, times, **kw)
            assert psched.best_skew_rotation(world, times, schedule=schedule, **kw) == \
                jsched.best_skew_rotation(world, times, schedule=schedule, **kw)
            kw2 = dict(compute=0.7, wire=0.9, link_scale=links)
            assert psched.modeled_finish_times(world, schedule, 1, times, **kw2) == \
                jsched.modeled_finish_times(world, schedule, 1, times, **kw2)
        assert psched.skew_statistic(times) == jsched.skew_statistic(times)


def test_skew_model_rejects_what_the_reference_rejects():
    for fn in (psched, jsched):
        with pytest.raises(ValueError):
            fn.modeled_finish_times(4, "comm_aware", 0, [1.0, 0.0, 1.0, 1.0])
        with pytest.raises(ValueError):
            fn.modeled_finish_times(4, "comm_aware", 0, [1.0] * 4, link_scale=[1.0] * 3)
        with pytest.raises(ValueError):
            fn.modeled_execution_skew(4, "zigzag", 0, [1.0] * 4)
    assert psched.skew_statistic([2.0]) == jsched.skew_statistic([2.0]) == 0.0
    assert psched.skew_statistic([0.0, 0.0, 1.0]) == jsched.skew_statistic([0.0, 0.0, 1.0])
