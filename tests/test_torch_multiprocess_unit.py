"""The port's multi-process runtime (``repro_torch.runtime.multiprocess``,
``repro_torch.launch.distributed``) against the JAX package's, at one
process or a spawned world of two.

* The reference's 13 unit tests (``tests/test_multiprocess_unit.py``): the
  worker environment's wire format (with torch's ``RANK``/``WORLD_SIZE``/
  ``MASTER_*`` beside the reference's keys), the respawn decision, the
  alpha-beta fit and the measured link model.
* ``next_generation_world`` equal to the reference's for every vector of
  exit codes of 1-4 ranks over {0, 16, 17, -9, -19, 1}; ``fit_alpha_beta``
  and ``measured_hardware_model`` on the same data (rtol 1e-12; the base
  link class is the port's ``GLOO_HOST`` where the reference's is ``DCN``).
* ``initialize_distributed``'s failure policy and idempotence, the
  launchers' new flags, the world-shrinking rule of a respawned generation.
* ``measure_ring`` and ``WorkerRuntime.host_gather`` on a world of 2 processes
  started by the driver.
"""
import itertools
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.perfmodel import DCN
from repro.runtime import multiprocess as jmp
from repro_torch.core.perfmodel import GLOO_HOST
from repro_torch.launch import distributed as pdist
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.runtime.multiprocess import (EXIT_OK, EXIT_RESHARD, EXIT_RESTART,
                                              MultiprocessDriver, WorkerEnv, current_generation,
                                              fit_alpha_beta, measured_hardware_model,
                                              next_generation_world, pick_free_port)

TORCH_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT")


def test_worker_env_roundtrip():
    cfg = WorkerEnv(rank=2, world=4, coordinator="127.0.0.1:12345", generation=1,
                    heartbeat_dir="/tmp/hb", extra={"steps": 8, "ckpt_dir": "/tmp/ck"})
    env = cfg.to_env()
    assert all(k.startswith("REPRO_MP_") for k in env if k not in TORCH_KEYS)
    assert {k: env[k] for k in TORCH_KEYS} == {
        "RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4",
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "12345"}
    assert WorkerEnv.from_env({**env, "UNRELATED": "x"}) == cfg
    # the reference reads the port's contract (its device count defaulted)
    back = jmp.WorkerEnv.from_env(env)
    assert (back.rank, back.world, back.coordinator, back.generation, back.heartbeat_dir,
            back.extra) == (2, 4, "127.0.0.1:12345", 1, "/tmp/hb", cfg.extra)


def test_worker_env_defaults(monkeypatch):
    cfg = WorkerEnv(rank=0, world=1, coordinator="h:1", generation=0, heartbeat_dir="/tmp/hb")
    assert WorkerEnv.from_env(cfg.to_env()).extra == {}
    monkeypatch.delenv("REPRO_MP_GEN", raising=False)
    assert current_generation() == 0
    monkeypatch.setenv("REPRO_MP_GEN", "3")
    assert current_generation() == 3


def test_pick_free_port_is_bindable():
    port = pick_free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


class TestNextGenerationWorld:
    def test_reshard_shrinks_to_survivors(self):
        # rank 1 SIGKILLed, the other two voted reshard: the survivors
        assert next_generation_world({0: EXIT_RESHARD, 1: -9, 2: EXIT_RESHARD}) == 2

    def test_restart_keeps_world_size(self):
        assert next_generation_world({0: EXIT_RESTART, 1: EXIT_RESTART}) == 2

    def test_reshard_wins_over_restart(self):
        assert next_generation_world({0: EXIT_RESHARD, 1: EXIT_RESTART, 2: -9}) == 2

    def test_all_ok_is_terminal(self):
        assert next_generation_world({0: EXIT_OK, 1: EXIT_OK}) is None

    def test_all_crashed_is_unrecoverable(self):
        assert next_generation_world({0: -9, 1: 1}) is None

    def test_clean_exits_count_as_survivors(self):
        assert next_generation_world({0: EXIT_RESHARD, 1: EXIT_OK, 2: -9}) == 2


def test_next_generation_world_is_the_references_for_every_code_vector():
    assert (EXIT_OK, EXIT_RESTART, EXIT_RESHARD) == (jmp.EXIT_OK, jmp.EXIT_RESTART,
                                                     jmp.EXIT_RESHARD)
    n = 0
    for ranks in range(1, 5):
        for codes in itertools.product((0, 16, 17, -9, -19, 1), repeat=ranks):
            vec = dict(enumerate(codes))
            assert next_generation_world(vec) == jmp.next_generation_world(vec), vec
            n += 1
    assert n == 6 + 36 + 216 + 1296


def test_fit_alpha_beta_recovers_synthetic_line():
    alpha, beta = 40e-6, 1.0 / 2e9
    sizes = [1 << 20, 4 << 20, 16 << 20]
    a, b = fit_alpha_beta(sizes, [alpha + beta * s for s in sizes])
    assert a == pytest.approx(alpha, rel=1e-6) and b == pytest.approx(beta, rel=1e-6)


def test_fit_alpha_beta_clamps_negative_intercept():
    a, b = fit_alpha_beta([1e6, 2e6], [1e-4, 3e-4])     # implies alpha < 0
    assert a >= 0.0 and b > 0.0


def test_measured_hardware_model_replaces_link_constants():
    sizes = [1 << 20, 8 << 20]
    beta = 1.0 / 1.5e9
    hw = measured_hardware_model(sizes, [1e-4 + beta * s for s in sizes])
    assert hw.ici_bw == pytest.approx(1.5e9, rel=1e-6)
    assert hw.ici_lat == pytest.approx(1e-4, rel=1e-6)
    # the compute constants are the base's (the host-staged gloo class)
    assert hw.hbm_bw == GLOO_HOST.hbm_bw and hw.peak_flops == GLOO_HOST.peak_flops


def test_measured_model_feeds_perf_predictions():
    sizes = [1 << 20, 8 << 20]
    fast = measured_hardware_model(sizes, [s / 10e9 + 1e-5 for s in sizes])
    slow = measured_hardware_model(sizes, [s / 1e9 + 1e-3 for s in sizes])
    nbytes = 4 << 20
    t_fast = nbytes / fast.ici_bw + fast.ici_lat
    t_slow = nbytes / slow.ici_bw + slow.ici_lat
    assert t_slow > t_fast and np.isfinite(t_slow)


@pytest.mark.parametrize("seed", range(4))
def test_fit_and_measured_model_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = sorted(rng.integers(1 << 10, 1 << 26, size=5).tolist())
    times = [float(rng.uniform(1e-5, 1e-3) + s / rng.uniform(1e8, 1e11)) for s in sizes]
    np.testing.assert_allclose(fit_alpha_beta(sizes, times), jmp.fit_alpha_beta(sizes, times),
                               rtol=1e-12)
    got, want = measured_hardware_model(sizes, times), jmp.measured_hardware_model(sizes, times)
    np.testing.assert_allclose([got.ici_bw, got.ici_lat], [want.ici_bw, want.ici_lat],
                               rtol=1e-12)
    # the link constants are measured; the rest is each package's base class
    assert got.hbm_bw == GLOO_HOST.hbm_bw and want.hbm_bw == DCN.hbm_bw


# ---------------------------------------------------------------------------
# launch/distributed.py
# ---------------------------------------------------------------------------
@pytest.fixture
def no_world_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()


def test_initialize_distributed_failure_policy(no_world_env, monkeypatch):
    # nothing configured: one process, no group
    assert pdist.initialize_distributed() is False and not dist.is_initialized()
    # a world of one from the environment is one process too
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert pdist.initialize_distributed() is False and not dist.is_initialized()
    # a coordinator without its partners is a misconfiguration
    for kw in (dict(), dict(num_processes=2), dict(process_id=0)):
        with pytest.raises(ValueError, match="num_processes/process_id"):
            pdist.initialize_distributed("127.0.0.1:1", **kw)
    # an explicit coordinator that fails propagates (no peer ever listens)
    with pytest.raises(dist.DistError):
        pdist.initialize_distributed(f"127.0.0.1:{pick_free_port()}", 2, 1,
                                     initialization_timeout=1)
    assert not dist.is_initialized()


def test_initialize_distributed_is_idempotent(no_world_env):
    try:
        assert pdist.initialize_distributed(f"127.0.0.1:{pick_free_port()}", 1, 0) is True
        group = dist.group.WORLD
        assert pdist.initialize_distributed(f"127.0.0.1:{pick_free_port()}", 4, 2) is True
        assert dist.group.WORLD is group and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("dp,tp,size,want", [
    (2, 1, 1, (1, 1)), (2, 2, 2, (1, 2)), (2, 2, 1, (1, 1)), (1, 4, 2, (1, 2)),
    (4, 1, 2, (2, 1)), (4, 2, 4, (2, 2)), (2, 2, 4, (2, 2))])
def test_fit_world_shrinks_data_first(dp, tp, size, want):
    assert pdist.fit_world(dp, tp, size) == want


def test_fit_world_refuses_what_no_halving_reaches():
    for dp, tp, size in ((2, 2, 3), (1, 3, 1), (3, 1, 2)):
        with pytest.raises(ValueError, match="does not shrink"):
            pdist.fit_world(dp, tp, size)


def test_build_liveness_at_one_process(tmp_path, no_world_env, monkeypatch):
    monkeypatch.setenv("REPRO_MP_GEN", "2")
    args = launch_train.build_parser().parse_args(
        ["--heartbeat-dir", str(tmp_path), "--heartbeat-interval", "0.05", "--stall-after",
         "4", "--step-deadline", "9"])
    writer, monitor = pdist.build_liveness_from_args(args)
    try:
        assert (monitor.rank, monitor.world, monitor.generation) == (0, 1, 2)
        assert (monitor.stall_after_s, monitor.step_deadline_s, monitor.enabled) == (4, 9, False)
        assert writer.interval_s == 0.05 and writer.generation == 2
    finally:
        writer.stop()
    hb = json.loads((tmp_path / "hb_0.json").read_text())
    assert hb["status"] == "leaving" and hb["generation"] == 2
    assert pdist.build_liveness_from_args(launch_train.build_parser().parse_args([])) == \
        (None, None)


LAUNCH = ["--reduced", "--device", "cpu", "--steps", "1"]


def test_launchers_take_the_seven_flags_and_refuse_their_misuse(tmp_path, no_world_env):
    """Both launchers parse the seven distributed/liveness flags; the train
    launcher's --heartbeat-dir needs --ckpt-dir (the supervisor restores
    from it), and a coordinator without --num-processes/--process-id raises
    as the reference's does."""
    flags = ["--coordinator", "h:1", "--num-processes", "2", "--process-id", "1",
             "--heartbeat-dir", "d", "--heartbeat-interval", "0.5", "--stall-after", "3",
             "--step-deadline", "7"]
    args = launch_train.build_parser().parse_args(flags)
    assert (args.coordinator, args.num_processes, args.process_id, args.heartbeat_dir,
            args.heartbeat_interval, args.stall_after, args.step_deadline) == \
        ("h:1", 2, 1, "d", 0.5, 3.0, 7.0)
    with pytest.raises(ValueError, match="--ckpt-dir"):
        launch_train.main(LAUNCH + ["--heartbeat-dir", str(tmp_path / "hb")])
    for main in (launch_train.main, launch_serve.main):
        for extra in (["--coordinator", "h:1"], ["--coordinator", "h:1", "--num-processes", "2"],
                      ["--coordinator", "h:1", "--process-id", "0"]):
            with pytest.raises(ValueError, match="num_processes/process_id"):
                main(LAUNCH[:3] + extra)
    for flag in ("--production-mesh", "--auto-fuse", "--explain-comm"):
        with pytest.raises(NotImplementedError, match="Queue 1 item"):
            launch_train.main(LAUNCH + [flag])


def test_launcher_with_liveness_at_one_process_beats_its_steps(tmp_path, no_world_env, capsys):
    hb = tmp_path / "hb"
    losses = launch_train.main(LAUNCH[:3] + ["--steps", "3", "--batch", "4", "--seq", "16",
                                             "--ckpt-dir", str(tmp_path / "ck"),
                                             "--heartbeat-dir", str(hb)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    beat = json.loads((hb / "hb_0.json").read_text())
    assert (beat["step"], beat["status"], beat["generation"]) == (3, "leaving", 0)
    assert f"losses {json.dumps(losses)}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# measure_ring on a world of two processes
# ---------------------------------------------------------------------------
RING_WORKER = """
import json
import torch
from repro_torch.checkpoint import Placement
from repro_torch.parallel.sharding import ParallelContext, make_world_groups
from repro_torch.runtime import multiprocess as mp

cfg = mp.WorkerEnv.from_env()
rt = mp.init_worker(cfg)
torch.set_num_threads(1)
times = mp.measure_ring(cfg.extra["sizes"], iters=5, warmup=2)
# host_gather: a leaf split over the world comes back whole on every rank
make_world_groups(1, 2)
ctx = ParallelContext(device="cpu", tp=2)
part = torch.arange(6.0).view(6, 1)[3 * cfg.rank:3 * (cfg.rank + 1)]
whole = rt.host_gather({"w": part, "n": 7}, Placement(ctx, {"w": ("world", None), "n": ()}))
rt.barrier()
with open(cfg.extra["out"] + str(cfg.rank), "w") as f:
    json.dump({"world": torch.distributed.get_world_size(), "times": times,
               "w": whole["w"].flatten().tolist(), "n": int(whole["n"])}, f)
rt.leave(mp.EXIT_OK)
"""


def test_measure_ring_and_host_gather_on_a_two_process_world(tmp_path):
    sizes = [1 << 12, 1 << 18, 1 << 22]
    out = tmp_path / "ring.json"
    driver = MultiprocessDriver(["-c", RING_WORKER], 2, workdir=str(tmp_path),
                                env=dict(os.environ, OMP_NUM_THREADS="1"),
                                extra={"sizes": sizes, "out": str(out)}, hang_grace_s=5)
    try:
        driver.launch_generation(0, 2)
        result = driver.wait_generation(timeout_s=120)
    finally:
        driver.close()
    logs = [open(p.log_path).read()[-2000:] for p in driver.procs]
    assert result.codes == {0: EXIT_OK, 1: EXIT_OK}, logs
    for rank in (0, 1):
        got = json.loads(open(f"{out}{rank}").read())
        assert (got["w"], got["n"]) == ([0.0, 1.0, 2.0, 3.0, 4.0, 5.0], 7)
    ring = json.loads(open(f"{out}0").read())
    assert ring["world"] == 2 and all(t > 0 for t in ring["times"])
    assert ring["times"][-1] > ring["times"][0]
    hw = measured_hardware_model(sizes, ring["times"])
    assert 1e6 < hw.ici_bw < 1e13 and hw.ici_lat >= 0
    # the workers left through the protocol with a final departure beat
    for rank in (0, 1):
        hb = json.loads(open(os.path.join(driver.heartbeat_dir, f"hb_{rank}.json")).read())
        assert hb["status"] == "leaving" and hb["generation"] == 0
    assert torch.distributed.is_initialized() is False
