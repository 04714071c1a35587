"""The serve launcher through the respawn protocol on the CPU (the port of
the reference's ``tests/multiprocess/test_multiprocess.py::
test_serve_drain_recovery``): reduced chatglm3-6b's dense engine at ``--dp
2`` over gloo as the workers of ``MultiprocessDriver``, rank 1 SIGKILLed at
tick 10.  Rank 0 journals a non-empty set of unfinished requests (tokens
intact) and exits 17; the world of one that follows resubmits the journal
and drains; every request finishes exactly once across the two
generations, and the merged token streams are those of an uninterrupted
drain at one rank.  Worker logs land under the test's tmp dir as
``run/logs/g<gen>_r<rank>.log``.
"""
import json
import os
import re
import signal

import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.runtime.multiprocess import EXIT_OK, EXIT_RESHARD, MultiprocessDriver

REQUESTS, BATCH, MAX_NEW = 8, 4, 32
SERVE = ["--reduced", "--device", "cpu", "--requests", str(REQUESTS), "--batch", str(BATCH),
         "--max-new", str(MAX_NEW), "--fusion", "kernel"]


def _streams(log):
    return {int(u): json.loads(t) for u, t in re.findall(r"req (\d+): prompt .* -> (\[.*\])",
                                                         log)}


def test_killed_serve_rank_journal_drains_every_request_once(tmp_path):
    journal = tmp_path / "journal.json"
    driver = MultiprocessDriver(
        ["-m", "repro_torch.launch.serve", *SERVE, "--dp", "2", "--backend", "gloo",
         "--journal", str(journal), "--heartbeat-dir", "{heartbeat_dir}",
         "--heartbeat-interval", "0.1", "--stall-after", "3"],
        2, workdir=str(tmp_path / "run"), env=dict(os.environ, OMP_NUM_THREADS="1"),
        hang_grace_s=5)
    report = driver.run_elastic(max_generations=3, gen_timeout_s=150,
                                faults={0: lambda d: d.kill_at_step(1, 10)})
    logs = {}
    for g, r in ((0, 0), (1, 0)):
        with open(os.path.join(driver.workdir, "logs", f"g{g}_r{r}.log")) as f:
            logs[g] = f.read()
    assert report.completed, ([g.codes for g in report.generations], logs)
    g0, g1 = report.generations
    assert g0.codes == {0: EXIT_RESHARD, 1: -signal.SIGKILL}
    assert g1.world == 1 and g1.codes == {0: EXIT_OK}
    assert "RankLost from liveness" in logs[0] and "exiting with respawn code 17" in logs[0]
    n = int(re.search(r"journal: persisted (\d+) unfinished requests", logs[0])[1])
    assert n > 0 and len(json.loads(journal.read_text())) == n
    assert f"journal: resubmitted {n} unfinished requests" in logs[1]
    # every request finished exactly once across the two generations
    before, after = _streams(logs[0]), _streams(logs[1])
    assert not set(before) & set(after) and len(after) == n
    merged = {**before, **after}
    assert sorted(merged) == list(range(REQUESTS))
    # the uninterrupted drain at one rank, in this process
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = {r.uid: r.tokens for r in launch_serve.main(SERVE)}
    finally:
        torch.set_num_threads(n_threads)
    assert merged == want
