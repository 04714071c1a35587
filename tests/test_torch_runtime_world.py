"""The port's in-process runtime over a world of gloo CPU ranks
(``tests/torch_world.py``: one world of 4 for the module).

* A checkpoint of (2, 2) fsdp-sharded training state (reduced chatglm3-6b's
  parameters and AdamW moments, ``nu`` in bf16) restores at (1, 1) and at
  (1, 2) with every whole leaf bit-equal; the JAX package's reader loads
  its f32 and int leaves bit for bit.
* ``nan_wire`` in a tp = 2 fused ring: the poisoned step's loss is NaN
  (``NonFiniteLoss``), the run restores and ends on the clean run's bits;
  its counts are the JAX supervisor's on the same plan.
* ``rank_loss`` at (2, 2): the world shrinks to (1, 2) over ranks (0, 1),
  the state is resharded (the lost ranks take part, then leave), the result
  is allclose to the clean run and to JAX's, and the world still answers.
* ``ProcessTelemetry`` gathers each rank's own time in world order; the
  rotation the estimator makes of them is the reference's, and the step
  rebuilt at it keeps the step's bits (the port's rule that ``skew`` only
  reorders sends).
* ``serve_with_chaos`` with a rank loss that reshards reduced chatglm3-6b's
  dense engine from tp = 4 to tp = 2 gives the clean drain's tokens (as
  ``tests/test_chaos.py:298-331`` asserts for the reference).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs.registry import get_arch as jax_get_arch
from repro.core import scheduling as jsched
from repro.models.common import split_params
from repro.runtime import chaos as jchaos
from repro_torch.configs.registry import get_arch
from repro_torch.train.optimizer import tree_map
from repro_torch.train.step import TrainConfig, train_state_specs
from test_torch_runtime import _batches_np, _counts, _jax_chaos, _w0_np
from torch_world import World

pytestmark = pytest.mark.chaos
TOY = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def _whole_state():
    """Reduced chatglm3-6b's train state at one rank, whole, in numpy: the
    seeded parameters, random AdamW moments (``nu`` goes to bf16 on the
    ranks), the step count; and the state's logical specs."""
    bundle = get_arch("chatglm3-6b").reduced()
    params = bundle.init_params(torch.Generator().manual_seed(0))
    specs = train_state_specs(TrainConfig(), bundle.param_specs(params))
    rng = np.random.default_rng(0)
    rand = lambda x: rng.standard_normal(tuple(x.shape)).astype(np.float32)
    whole = {"params": tree_map(lambda x: x.detach().numpy(), params),
             "opt": {"mu": tree_map(rand, params), "nu": tree_map(rand, params),
                     "step": np.int32(3)}}
    return whole, specs


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in _leaves(v, path + (i,))]
    return [(path, np.asarray(tree))]


def _want(path, a):
    """A whole leaf as the ranks hold it (``nu`` as bf16 words)."""
    if "nu" in path:
        return torch.from_numpy(np.array(a)).to(torch.bfloat16).view(torch.int16).numpy()
    return np.asarray(a)


def test_checkpoint_of_22_fsdp_state_restores_at_11_and_12(world, tmp_path):
    whole, specs = _whole_state()
    path = str(tmp_path / "ck")
    saved = world.run("ckpt_state_task", 2, dp=2, whole=whole, specs=specs, path=path,
                      mode="save")
    want = _leaves(whole)
    for step, tree in saved:
        assert step == 4
        got = _leaves(tree)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, g), (_, w) in zip(got, want):
            w = _want(p, w)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), p
    assert os.listdir(path) == ["step_00000004"]       # one writer, no .tmp left
    # (1, 2): each pair restores its own shards (the fsdp dims whole again)
    for step, got, mine in world.run("ckpt_state_task", 2, whole=whole, specs=specs,
                                      path=path, mode="restore"):
        assert step == 4
        for (p, g), (_, m) in zip(_leaves(got), _leaves(mine)):
            assert g.tobytes() == m.tobytes() and g.shape == m.shape, p
    # the JAX package's reader loads the f32 and int leaves bit for bit
    target = {"params": whole["params"], "opt": {"mu": whole["opt"]["mu"],
                                                  "step": whole["opt"]["step"]}}
    restored, step = jckpt.restore_checkpoint(os.path.join(path, "step_00000004"), target)
    assert step == 4
    got = dict(_leaves(jax.tree.map(np.asarray, restored)))
    assert got.keys() == dict(_leaves(target)).keys()
    for p, w in _leaves(target):
        assert got[p].tobytes() == w.tobytes(), p


def _toy(world, tmp, name, tp, dp=1, plan=None, lose=False):
    return world.run("toy_chaos_task", tp, dp=dp, w=_w0_np(), batches=_batches_np(8),
                     path=str(tmp / name), plan=plan, lose=lose)


def _whole_w(results, tp):
    """The whole w from the first tp ranks' shards."""
    return np.concatenate([r[0] for r in results[:tp]], axis=0)


def test_nan_wire_in_a_tp2_ring_restores_to_the_clean_bits(world, tmp_path):
    clean = _toy(world, tmp_path, "clean", 2)
    chaos = _toy(world, tmp_path, "chaos", 2, plan=[(5, "nan_wire", 0, 0)])
    for c, g in zip(clean, chaos):
        assert g[1] == c[1] == 8
        np.testing.assert_array_equal(g[0], c[0])
        assert np.isfinite(g[0]).all()
        assert g[3] == [(5, "NonFiniteLoss")]           # the ring's payload was NaN
        assert g[2] == (1, 1, 0, False)
    w_j, step_j, sup_j = _jax_chaos(tmp_path / "jax", jchaos.FaultPlan(
        [jchaos.FaultEvent(step=5, kind="nan_wire", nth_send=0)]))
    assert step_j == 8 and _counts(sup_j)[0] == chaos[0][2][0]
    assert _counts(sup_j)[2:] == chaos[0][2][1:3]
    np.testing.assert_allclose(_whole_w(chaos, 2), w_j, **TOY)


def test_rank_loss_shrinks_22_to_12(world, tmp_path):
    clean = _toy(world, tmp_path, "clean", 2, dp=2)
    lost = _toy(world, tmp_path, "lost", 2, dp=2, plan=[(5, "rank_loss", 3, 0)], lose=True)
    # the survivors are the first two ranks, now a (1, 2) world of their own
    for r, (w, step, counts, failures, where) in enumerate(lost):
        if r < 2:
            assert step == 8 and counts == (0, 1, 1, False) and failures == []
            assert where == (1, 2, (0, 1), True)
        else:
            assert w is None and step == 5 and counts[-1] is True     # left
            assert where[:3] == (1, 2, (0, 1)) and where[3] is False
    np.testing.assert_allclose(_whole_w(lost, 2), _whole_w(clean, 2), **TOY)
    w_j, _, _ = _jax_chaos(tmp_path / "jax")
    np.testing.assert_allclose(_whole_w(lost, 2), w_j, **TOY)
    # nothing hangs: the whole world answers the next task
    again = _toy(world, tmp_path, "again", 2, dp=2)
    np.testing.assert_array_equal(_whole_w(again, 2), _whole_w(clean, 2))


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_process_telemetry_and_the_rebuilt_step(world, dp, tp):
    xg = _batches_np(1)[0]
    out = world.run("telemetry_task", tp, dp=dp, w=_w0_np(), xg=xg)
    times = [0.1 * (r + 1) for r in range(4)]
    want = jsched.best_skew_rotation(tp, [np.mean(times[m::tp]) for m in range(tp)])
    for gathered, bucket, rebuilds, ((w0, l0), (w1, l1)) in out:
        assert gathered == pytest.approx(times, rel=0, abs=0)
        assert bucket == want and (bucket != 0 or tp == 2)
        assert rebuilds == (2 if bucket else 1)
        np.testing.assert_array_equal(w1, w0)
        assert l1 == l0


def test_serve_with_chaos_reshards_tp4_to_tp2(world):
    jb = jax_get_arch("chatglm3-6b").reduced()
    tree = jax.tree.map(np.asarray, split_params(jb.init_params(jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 64, 3).tolist() for _ in range(4)]
    plan = [(1, "timeout", 0), (3, "rank_loss", 3), (5, "slow_link", 0)]
    out = world.run("serve_chaos_task", 4, tree=tree, requests=requests, max_new=5, plan=plan)
    clean = out[0][0]
    assert len(clean) == 4 and all(len(toks) == 5 for _, toks in clean)
    for r, (c, got, stats, where) in enumerate(out):
        assert c == clean and where == (1, 2, (0, 1))
        if r < 2:
            assert got == clean
            assert stats["reshards"] == 1 and stats["dropped"] == 1 and stats["drained"]
        else:
            assert got is None and stats["left"]
