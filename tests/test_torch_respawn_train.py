"""The respawn protocol end to end on the CPU: the train launcher as the
workers of ``MultiprocessDriver`` (``repro_torch.runtime.multiprocess``),
reduced chatglm3-6b at ``--dp 2`` over gloo, real faults delivered by
signal, detected by the heartbeat watchdog (the port of the reference's
``tests/multiprocess/test_multiprocess.py::test_sigkill_elastic_recovery``
and ``::test_sigstop_stall_restart``).

* SIGKILL of rank 1 at step 3: rank 0 exits 17 through liveness (no fault
  plan), the next generation is a world of one that resumes from the
  checkpoint at a step > 0 and ends on the bits of a fault-free world-1 run
  from a copy of the checkpoint directory taken at generation 0's end:
  every leaf of the final checkpoint and every step's loss.  That fault-free
  run's losses are the JAX train step's from the same checkpoint on the same
  batches (rtol 1e-4, ``tests/test_torch_train.py``'s bound for steps).
* SIGSTOP of rank 1 at step 3: rank 0 exits 16, the driver reaps the
  stopped rank, a world of two respawns from a step > 0 and completes.

Each rank runs one intra-op thread; each generation has its own timeout and
the driver reaps its workers on any failure.  Worker logs land under the
test's tmp dir as ``<run>/logs/g<gen>_r<rank>.log``.
"""
import functools
import json
import os
import re
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.data.synthetic import LMBatches as JaxLMBatches
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.runtime.multiprocess import (EXIT_OK, EXIT_RESHARD, EXIT_RESTART,
                                              MultiprocessDriver)

STEPS, B, S, LR = 6, 4, 32, 3e-3
GEN_TIMEOUT = 150
STEPS_TOL = dict(rtol=1e-4, atol=0)


def _argv(ckpt):
    return ["-m", "repro_torch.launch.train", "--reduced", "--device", "cpu", "--steps",
            str(STEPS), "--batch", str(B), "--seq", str(S), "--lr", str(LR), "--dp", "2",
            "--backend", "gloo", "--ckpt-dir", str(ckpt), "--ckpt-every", "2", "--log-every",
            "1", "--heartbeat-dir", "{heartbeat_dir}", "--heartbeat-interval", "0.1",
            "--stall-after", "3"]


def _driver(workdir, ckpt, hang_grace_s=5.0):
    return MultiprocessDriver(_argv(ckpt), 2, workdir=str(workdir),
                              env=dict(os.environ, OMP_NUM_THREADS="1"),
                              hang_grace_s=hang_grace_s)


def _log(driver, gen, rank):
    with open(os.path.join(driver.workdir, "logs", f"g{gen}_r{rank}.log")) as f:
        return f.read()


def _losses(log):
    return json.loads(re.search(r"^losses (\[.*\])$", log, re.M)[1])


def _resumed(log):
    return int(re.search(r"^resumed at step (\d+)$", log, re.M)[1])


def _checkpoint(path):
    """{leaf path: array} of one checkpoint directory."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return {e["path"]: np.load(os.path.join(path, e["file"])) for e in manifest["leaves"]}


def _jax_layout(tree):
    """The port's tree (a list of layers, as dicts keyed "0", "1", ...) in
    the JAX package's: the layers stacked as ``layers/l0``."""
    if not isinstance(tree, dict):
        return jnp.asarray(tree)
    out = {k: _jax_layout(v) for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        layers = [tree["layers"][str(i)] for i in range(len(tree["layers"]))]
        out["layers"] = {"l0": jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *layers)}
    return out


def _nest(flat):
    root = {}
    for path, a in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return root


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The JAX train step the launcher's defaults make (kernel mode's
    reference is its fused mode at tp = 1), jitted once for the module."""
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = JaxContext.from_mesh(mesh, fusion=JaxFusion(mode="fused"))
    tc = jstep.TrainConfig(optimizer=jopt.OptimizerConfig(
        lr=LR, warmup_steps=max(STEPS // 20, 5), total_steps=STEPS))
    loss = jax_get_arch("chatglm3-6b").reduced().loss_fn(ctx)
    return jax.jit(jstep.build_train_step(loss, tc))


def _jax_losses_from(ckpt_path, start):
    state = _jax_layout(_nest(_checkpoint(ckpt_path)))
    batches = JaxLMBatches(512, B, S, 0)
    for _ in range(start):
        next(batches)
    fn, out = _jax_step(), []
    for _ in range(start, STEPS):
        state, m = fn(state, next(batches))
        out.append(float(m["loss"]))
    return out


def test_sigkill_respawns_a_world_of_one_on_the_fault_free_bits(tmp_path):
    ck, ref = tmp_path / "ck", tmp_path / "ck_ref"
    driver = _driver(tmp_path / "run", ck)

    def snapshot(d, result):
        # the restore point the survivor will use, for the fault-free twin
        if result.generation == 0:
            shutil.copytree(ck, ref)

    report = driver.run_elastic(max_generations=3, gen_timeout_s=GEN_TIMEOUT,
                                # never rank 0: it holds the rendezvous store
                                faults={0: lambda d: d.kill_at_step(1, 3)},
                                on_generation_end=snapshot)
    logs = {(g, r): _log(driver, g, r) for g, r in ((0, 0), (0, 1), (1, 0))
            if os.path.exists(os.path.join(driver.workdir, "logs", f"g{g}_r{r}.log"))}
    assert report.completed, ([g.codes for g in report.generations], logs)
    g0, g1 = report.generations
    assert g0.codes == {0: EXIT_RESHARD, 1: -signal.SIGKILL}
    assert g1.world == 1 and g1.codes == {0: EXIT_OK}
    assert len(report.events("kill")) == 1 and not report.events("reap")
    log0, log1 = logs[(0, 0)], logs[(1, 0)]
    assert "RankLost from liveness" in log0 and "liveness:" in log0
    assert "injected" not in log0 and "exiting with respawn code 17" in log0
    assert "world size 1: (dp, tp) = (1, 1), shrunk from --dp 2 --tp 1" in log1
    start = _resumed(log1)
    assert start > 0
    losses = _losses(log1)
    assert len(losses) == STEPS - start and re.search(rf"done at step {STEPS};", log1)

    # the JAX step from the restore point, before the twin adds checkpoints
    jax_losses = _jax_losses_from(os.path.join(ref, f"step_{start:08d}"), start)

    # the fault-free world-1 run from the same restore point
    twin = _driver(tmp_path / "twin", ref)
    try:
        twin.launch_generation(0, 1)
        result = twin.wait_generation(timeout_s=GEN_TIMEOUT)
    finally:
        twin.close()
    tlog = _log(twin, 0, 0)
    assert result.codes == {0: EXIT_OK}, tlog
    assert _resumed(tlog) == start and _losses(tlog) == losses
    got, want = (_checkpoint(os.path.join(d, f"step_{STEPS:08d}")) for d in (ck, ref))
    assert sorted(got) == sorted(want) and len(got) > 10
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        assert got[path].tobytes() == want[path].tobytes(), \
            f"the recovered state differs from the fault-free run's at {path}"
    # and the fault-free run is the JAX step's
    np.testing.assert_allclose(losses, jax_losses, **STEPS_TOL)


def test_sigstop_restarts_a_world_of_two(tmp_path):
    driver = _driver(tmp_path / "run", tmp_path / "ck", hang_grace_s=3.0)
    report = driver.run_elastic(
        max_generations=3, gen_timeout_s=GEN_TIMEOUT,
        faults={0: lambda d: d.kill_at_step(1, 3, sig=signal.SIGSTOP)})
    assert report.completed, [g.codes for g in report.generations]
    g0, g1 = report.generations
    # the healthy rank saw a stall (pid alive, heartbeat stale): restart
    assert g0.codes == {0: EXIT_RESTART, 1: -signal.SIGKILL}
    assert len(report.events("reap")) >= 1        # the stopped rank never left
    log0 = _log(driver, 0, 0)
    assert "CollectiveTimeout from liveness" in log0 and "stalled" in log0
    assert g1.world == 2 and g1.codes == {0: EXIT_OK, 1: EXIT_OK}
    log1 = _log(driver, 1, 0)
    assert _resumed(log1) > 0 and "all 2 ranks' losses equal: True" in log1
    assert "shrunk" not in log1
