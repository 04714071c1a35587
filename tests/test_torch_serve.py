"""The port's decode engine and launcher against the JAX package's.

Reduced chatglm3-6b (f32) with the JAX package's parameters converted to
the port: the two ``DecodeEngine``s must produce the same greedy token
streams.  Also the engine's slot semantics on a fake model, the launcher,
and the import boundary of the port (no jax, nothing of ``repro``).
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models.common import split_params
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import FusionConfig, ParallelContext
from repro_torch.serve.engine import DecodeEngine, Request

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]


def _prompts(n, vocab):
    return [r.prompt for r in launch_serve.make_requests(n, vocab, 1)]


@pytest.fixture(scope="module")
def models():
    jb = jax_get_arch("chatglm3-6b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    pb = get_arch("chatglm3-6b").reduced()
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jb, jparams, pb, pparams


def _port_engine(pb, pparams, mode, batch):
    ctx = ParallelContext(device="cpu", fusion=FusionConfig(mode=mode))
    decode = pb.decode_fn(ctx)
    return DecodeEngine(lambda tk, c, p: decode(pparams, tk, c, p),
                        lambda b: pb.init_cache(b, "cpu"), batch, device="cpu",
                        max_seq=pb.config.max_seq)


@pytest.mark.parametrize("n_req,batch", [(4, 4), (6, 4)])
def test_greedy_streams_match_jax_engine(ctx, models, n_req, batch):
    """4 requests x 8 greedy tokens (and 6 requests through 4 slots, which
    re-admits into freed slots) give the JAX engine's token streams."""
    jb, jparams, pb, pparams = models
    prompts = _prompts(n_req, pb.config.vocab)
    decode = jb.decode_fn(ctx)
    jeng = JaxDecodeEngine(jax.jit(lambda tk, c, p: decode(jparams, tk, c, p)),
                           jb.init_cache, batch, max_seq=jb.config.max_seq)
    peng = _port_engine(pb, pparams, "kernel", batch)
    for i, pr in enumerate(prompts):
        jeng.submit(JaxRequest(uid=i, prompt=pr, max_new=8))
        peng.submit(Request(uid=i, prompt=pr, max_new=8))
    jfin = {r.uid: r.tokens for r in jeng.run_until_drained(max_steps=200)}
    pfin = peng.run_until_drained(max_steps=200)
    assert pfin.drained and len(pfin) == n_req
    assert {r.uid: r.tokens for r in pfin} == jfin
    assert all(len(r.tokens) == 8 for r in pfin)


def test_kernel_and_bulk_modes_give_the_same_streams(models):
    _, _, pb, pparams = models
    streams = []
    for mode in ("kernel", "bulk"):
        eng = _port_engine(pb, pparams, mode, 2)
        for i, pr in enumerate(_prompts(3, pb.config.vocab)):
            eng.submit(Request(uid=i, prompt=pr, max_new=6))
        streams.append({r.uid: r.tokens for r in eng.run_until_drained(max_steps=100)})
    assert streams[0] == streams[1]


def _fake_decode(tok, cache, pos):
    """Deterministic model: argmax(logits) == (token + 1) % 16."""
    b = tok.shape[0]
    logits = torch.zeros(b, 1, 16)
    logits[torch.arange(b), 0, (tok[:, 0].long() + 1) % 16] = 1.0
    return logits, cache


def _fake_engine(batch, **kw):
    return DecodeEngine(_fake_decode, lambda b: None, batch, device="cpu", **kw)


def test_engine_empty_prompt_starts_from_bos():
    eng = _fake_engine(2, bos_id=5)
    eng.submit(Request(uid=0, prompt=[], max_new=4))
    eng.submit(Request(uid=1, prompt=[3], max_new=4))
    fin = {r.uid: r.tokens for r in eng.run_until_drained(max_steps=30)}
    assert fin == {0: [6, 7, 8, 9], 1: [4, 5, 6, 7]}


def test_engine_queue_is_fifo_and_zero_budget_retires_at_once():
    eng = _fake_engine(1)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=[i], max_new=2))
    eng.submit(Request(uid=9, prompt=[1], max_new=0))
    fin = eng.run_until_drained(max_steps=30)
    assert [r.uid for r in fin] == [0, 1, 2, 9]
    assert fin[-1].tokens == [] and fin[-1].done
    assert all(r.consumed == len(r.prefix) for r in fin)


def test_engine_retires_at_cache_bound_and_reports_truncation():
    eng = _fake_engine(1, max_seq=4)
    eng.submit(Request(uid=0, prompt=[1, 2], max_new=10))
    fin = eng.run_until_drained(max_steps=30)
    assert fin[0].truncated and len(fin[0].tokens) == 3    # positions 1..3
    eng = _fake_engine(1)
    eng.submit(Request(uid=0, prompt=[1], max_new=10))
    part = eng.run_until_drained(max_steps=3)
    assert not part.drained and part == []


def test_launcher_serves_reduced_model_on_cpu(capsys):
    fin = launch_serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                             "--batch", "2", "--max-new", "4"])
    assert sorted(r.uid for r in fin) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in fin)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_launcher_prompts_match_reference_launcher():
    """repro.launch.serve draws its prompts from default_rng(0) this way."""
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 512, size=rng.integers(2, 6)).tolist() for _ in range(5)]
    assert _prompts(5, 512) == want


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--reduced", "--requests", "1"])


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_port_never_imports_jax_or_the_jax_package():
    port = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    # the spawned ranks of the tp tests import tests/torch_world.py: no jax there either
    files = port + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_world.py"]
    assert len(files) > 15
    names = {f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in port}
    assert {"core/loss.py", "train/optimizer.py", "train/step.py", "train/grad_compression.py",
            "data/pipeline.py", "data/synthetic.py", "launch/train.py", "launch/mesh.py",
            "core/collectives.py", "core/scheduling.py"} <= names
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert bad == []
    assert _FORBIDDEN.search("from repro.core import x")
    assert not _FORBIDDEN.search("from repro_torch.core import x")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA device, or no repository around the script: a non-zero exit
    and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
