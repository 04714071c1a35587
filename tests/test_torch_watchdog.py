"""The port's liveness layer (``repro_torch.runtime.watchdog``) against the
JAX package's (``repro.runtime.watchdog``), with no processes: the clock and
the pid prober are injected.

* The reference's 15 unit tests (``tests/test_watchdog.py``), on the port.
* The file format both ways: a heartbeat either package writes, the other
  reads back with the same fields.
* The classification of a peer over a grid of (heartbeat age, status,
  generation, pid alive, before or after the start grace) is the
  reference's, and ``check()`` raises the same exception class (or none)
  for every point of it.
* ``guarded`` runs its call under the caller's grad and inference mode;
  a raise from the watchdog is tagged as liveness's, and ``diagnose`` turns
  a transport error into the watchdog's verdict.

The drills with real processes are ``tests/test_torch_respawn_*.py``.
"""
import itertools
import threading
import time

import pytest
import torch

from repro.runtime import chaos as jchaos
from repro.runtime import watchdog as jwd
from repro_torch.runtime import watchdog as pwd
from repro_torch.runtime.chaos import CollectiveTimeout, RankLost
from repro_torch.runtime.watchdog import (ALIVE, DEAD, STALLED, STARTING, Heartbeat,
                                          HeartbeatWriter, LivenessMonitor, Watchdog,
                                          await_verdict, diagnose, from_liveness,
                                          heartbeat_path, read_heartbeat, write_heartbeat)


def test_heartbeat_roundtrip(tmp_path):
    hb = Heartbeat(rank=3, pid=4242, time=123.5, step=7, generation=2, status="up")
    write_heartbeat(str(tmp_path), hb)
    assert read_heartbeat(str(tmp_path), 3) == hb


def test_read_missing_and_garbled(tmp_path):
    assert read_heartbeat(str(tmp_path), 0) is None
    with open(heartbeat_path(str(tmp_path), 0), "w") as f:
        f.write("{not json")
    assert read_heartbeat(str(tmp_path), 0) is None
    with open(heartbeat_path(str(tmp_path), 0), "w") as f:
        f.write('{"unexpected": 1}')
    assert read_heartbeat(str(tmp_path), 0) is None


def test_atomic_write_leaves_no_tmp(tmp_path):
    write_heartbeat(str(tmp_path), Heartbeat(rank=0, pid=1, time=0.0))
    assert {p.name for p in tmp_path.iterdir()} == {"hb_0.json"}


def test_writer_beats_in_background(tmp_path):
    with HeartbeatWriter(str(tmp_path), 0, interval_s=0.02):
        time.sleep(0.1)
        hb1 = read_heartbeat(str(tmp_path), 0)
        time.sleep(0.1)
        hb2 = read_heartbeat(str(tmp_path), 0)
    assert hb1 is not None and hb2 is not None
    assert hb2.time > hb1.time
    # the final beat on stop carries the departure status
    assert read_heartbeat(str(tmp_path), 0).status == "leaving"


def _monitor(tmp_path, *, now, world=2, pid_alive=lambda pid: True, mod=None, **kw):
    cls = LivenessMonitor if mod is None else mod.LivenessMonitor
    return cls(str(tmp_path), 0, world, pid_alive=pid_alive, clock=lambda: now[0], **kw)


def test_classification_matrix(tmp_path):
    now = [1000.0]
    alive_pids = {1: True}
    mon = _monitor(tmp_path, now=now, stall_after_s=2.0, start_grace_s=30.0,
                   pid_alive=lambda pid: alive_pids.get(pid, False))
    assert mon.observe()[1].state == STARTING          # no heartbeat yet, in the grace
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=1, time=now[0]))
    assert mon.observe()[1].state == ALIVE
    now[0] += 5.0
    assert mon.observe()[1].state == STALLED           # stale, pid alive
    alive_pids[1] = False
    assert mon.observe()[1].state == DEAD              # stale, pid gone
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=1, time=now[0], status="leaving"))
    assert mon.observe()[1].state == DEAD              # departure status, even fresh


def test_no_heartbeat_past_grace_is_dead(tmp_path):
    now = [0.0]
    mon = _monitor(tmp_path, now=now, start_grace_s=10.0)
    assert mon.observe()[1].state == STARTING
    now[0] = 11.0
    assert mon.observe()[1].state == DEAD


def test_stale_generation_reads_as_not_started(tmp_path):
    # a generation-0 heartbeat left by the previous incarnation is not a
    # live generation-1 peer
    now = [0.0]
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=1, time=now[0], generation=0))
    mon = _monitor(tmp_path, now=now, generation=1, start_grace_s=10.0)
    assert mon.observe()[1].state == STARTING
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=1, time=now[0], generation=1))
    assert mon.observe()[1].state == ALIVE


def test_check_raises_rank_lost_for_dead_peer(tmp_path):
    now = [0.0]
    mon = _monitor(tmp_path, now=now, pid_alive=lambda pid: False)
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=0.0))
    now[0] = 10.0
    with pytest.raises(RankLost) as ei:
        mon.check()
    assert "liveness" in str(ei.value) and from_liveness(ei.value)


def test_check_raises_collective_timeout_for_stalled_peer(tmp_path):
    now = [0.0]
    mon = _monitor(tmp_path, now=now, pid_alive=lambda pid: True)
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=0.0))
    now[0] = 10.0
    with pytest.raises(CollectiveTimeout) as ei:
        mon.check()
    assert "stalled" in str(ei.value) and from_liveness(ei.value)


def test_dead_wins_over_stalled(tmp_path):
    # rank 1 stalled, rank 2 dead: the dead rank is the stronger diagnosis
    now = [0.0]
    mon = _monitor(tmp_path, now=now, world=3, pid_alive=lambda pid: pid == 1)
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=1, time=0.0))
    write_heartbeat(str(tmp_path), Heartbeat(rank=2, pid=2, time=0.0))
    now[0] = 10.0
    with pytest.raises(RankLost) as ei:
        mon.check()
    assert ei.value.rank == 2


def test_disarmed_monitor_never_raises(tmp_path):
    now = [0.0]
    mon = _monitor(tmp_path, now=now, pid_alive=lambda pid: False)
    mon.enabled = False
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=0.0))
    now[0] = 100.0
    mon.check()   # no raise while disarmed (the start's window)
    mon.enabled = True
    with pytest.raises(RankLost):
        mon.check()


def test_guarded_passes_through_result_and_exception(tmp_path):
    mon = LivenessMonitor(str(tmp_path), 0, 1)   # no peers: check does nothing
    assert mon.guarded(lambda a, b: a + b, 2, 3) == 5

    class Boom(RuntimeError):
        pass

    def boom():
        raise Boom("inner")

    with pytest.raises(Boom) as ei:
        mon.guarded(boom)
    assert not from_liveness(ei.value)


def test_guarded_raises_when_peer_dies_mid_step(tmp_path):
    now = [0.0]
    mon = _monitor(tmp_path, now=now, pid_alive=lambda pid: False)
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=0.0))
    release = threading.Event()

    def hang():
        now[0] = 10.0          # the peer goes stale while the step runs
        release.wait(5.0)

    with pytest.raises(RankLost):
        mon.guarded(hang, poll_s=0.01)
    release.set()


def test_guarded_step_deadline(tmp_path):
    # every peer healthy (a world of one) but the step wedges: the deadline
    # turns it into CollectiveTimeout
    mon = LivenessMonitor(str(tmp_path), 0, 1)
    release = threading.Event()
    with pytest.raises(CollectiveTimeout) as ei:
        mon.guarded(lambda: release.wait(5.0), deadline_s=0.05, poll_s=0.01)
    assert "deadline" in str(ei.value) and from_liveness(ei.value)
    release.set()


def test_watchdog_parks_and_reraises(tmp_path):
    now = [0.0]
    mon = _monitor(tmp_path, now=now, pid_alive=lambda pid: False)
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=0.0))
    wd = Watchdog(mon, poll_s=0.01)
    with wd:
        wd.maybe_raise()       # healthy so far
        now[0] = 10.0
        deadline = time.time() + 2.0
        while wd.failure is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RankLost):
            wd.maybe_raise()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heartbeat_files_read_across_packages(tmp_path, writer):
    """A heartbeat written by either package is read back by the other with
    the same fields, under the same file name."""
    fields = dict(rank=2, pid=31337, time=1234.25, step=9, generation=3, status="leaving")
    if writer == "port":
        write_heartbeat(str(tmp_path), Heartbeat(**fields))
        back = jwd.read_heartbeat(str(tmp_path), 2)
    else:
        jwd.write_heartbeat(str(tmp_path), jwd.Heartbeat(**fields))
        back = read_heartbeat(str(tmp_path), 2)
    assert back is not None and {k: getattr(back, k) for k in fields} == fields
    assert heartbeat_path(str(tmp_path), 2) == jwd.heartbeat_path(str(tmp_path), 2)
    assert {p.name for p in tmp_path.iterdir()} == {"hb_2.json"}


# (age of the heartbeat, its status, its generation, pid alive, seconds since
# the monitor started); a generation of None writes no heartbeat
GRID = list(itertools.product((0.0, 1.9, 2.1, 50.0), ("up", "leaving"), (None, 0, 1, 2),
                              (True, False), (5.0, 200.0)))


def _classify_and_check(mod, tmp, age, status, gen, alive, since):
    """(state, exception class name or None) of peer 1 for ``mod``'s
    monitor at generation 1, stall deadline 2 s, start grace 120 s."""
    t_hb = 1000.0
    if gen is not None:
        mod.write_heartbeat(str(tmp), mod.Heartbeat(rank=1, pid=7, time=t_hb, step=4,
                                                    generation=gen, status=status))
    now = [t_hb + age - since]
    mon = _monitor(tmp, now=now, mod=mod, generation=1, stall_after_s=2.0,
                   start_grace_s=120.0, pid_alive=lambda pid: alive)
    now[0] = t_hb + age
    state = mon.observe()[1].state
    try:
        mon.check()
        raised = None
    except (RankLost, CollectiveTimeout, jchaos.RankLost, jchaos.CollectiveTimeout) as e:
        raised = type(e).__name__
    return state, raised


def test_classification_and_raises_match_the_reference(tmp_path):
    states = set()
    for i, point in enumerate(GRID):
        port_dir, jax_dir = tmp_path / f"port{i}", tmp_path / f"jax{i}"
        port_dir.mkdir()
        jax_dir.mkdir()
        got = _classify_and_check(pwd, port_dir, *point)
        assert got == _classify_and_check(jwd, jax_dir, *point), point
        states.add(got[0])
    assert states == {ALIVE, STARTING, STALLED, DEAD}


def test_guarded_runs_under_the_callers_grad_and_inference_mode(tmp_path):
    mon = LivenessMonitor(str(tmp_path), 0, 1)
    modes = lambda: (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                     threading.current_thread().name)
    with torch.no_grad():
        grad, inf, where = mon.guarded(modes)
    assert (grad, inf, where) == (False, False, "guarded-step")
    with torch.inference_mode():
        assert mon.guarded(modes)[:2] == (False, True)
    assert mon.guarded(modes)[:2] == (True, False)
    # a step that builds a graph under grad mode gets one back
    w = torch.ones(3, requires_grad=True)
    assert mon.guarded(lambda: (w * 2).sum()).requires_grad


def test_diagnose_names_the_dead_peer_or_raises_the_error_again(tmp_path):
    """A transport error becomes the watchdog's verdict where a peer is
    dead within the wait; with every peer alive the error itself comes back."""
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=time.time() - 10.0))
    mon = LivenessMonitor(str(tmp_path), 0, 2, stall_after_s=0.05,
                          pid_alive=lambda pid: False)
    mon.enabled = False
    err = RuntimeError("Connection closed by peer")
    with pytest.raises(RankLost) as ei:
        diagnose(mon, err, extra_wait_s=0.1)
    assert ei.value.__cause__ is err and from_liveness(ei.value)
    assert mon.enabled is False                  # armed only for the wait
    write_heartbeat(str(tmp_path), Heartbeat(rank=1, pid=99, time=time.time() + 60.0))
    with pytest.raises(RuntimeError, match="closed by peer"):
        diagnose(mon, err, extra_wait_s=0.1)
    assert await_verdict(mon, extra_wait_s=0.05) is None
