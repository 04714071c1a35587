"""The port's tensor-parallel decode slice against the JAX package, at tp = 2
and 4: ``matmul_allreduce`` (bulk, and fused by rows and by columns), the
sequence-parallel products, the decode layers, the reduced chatglm3-6b's
``decode_step`` in bulk and fused mode, and the launcher under
``torch.distributed.run``.

The same numpy inputs, made from a seed, go through each JAX function on a
(1, tp) data x model mesh of conftest's CPU devices (global arrays, sharded
by the reference's own specs) and through its port on a gloo world of tp
CPU processes (``tests/torch_world.py``), each rank on its shard.  f32
throughout: ``TOL["f32"]`` of tests/test_parity_matrix.py (rtol = atol =
3e-4, sums in another order); a compressed wire: its ``WIRE_TOL``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.compat import make_mesh
from repro.configs.registry import get_arch as jax_get_arch
from repro.core import allgather_matmul as jagmm
from repro.core import autotune as jtune
from repro.core import perfmodel as jperf
from repro.core.matmul_allreduce import matmul_allreduce as jax_matmul_allreduce
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.common import split_params
from repro.parallel.sharding import FusionConfig as JaxFusion
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.configs.registry import get_arch
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel.sharding import ParallelContext, shard_leaf
from torch_tune import as_json, clear_both
from torch_world import World

TOL = dict(rtol=3e-4, atol=3e-4)                 # TOL["f32"]
WIRE_TOL = {"f32": TOL, "bf16": dict(rtol=3e-2, atol=3e-2),
            "fp8": dict(rtol=2e-1, atol=2e-1)}   # WIRE_TOL of test_parity_matrix.py
TPS = [2, 4]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, tp, **inputs):
    """The task's per-rank results at tp (the tp = 2 pairs must agree)."""
    out = world.run(name, tp, **inputs)
    if tp == 2:
        flat = lambda r: (list(r.values()) if isinstance(r, dict) else
                          list(r) if isinstance(r, (list, tuple)) else [r])
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(flat(a), flat(b)):
                np.testing.assert_array_equal(u, v)
    return out[:tp]


def jctx(tp, mode="fused", **fusion):
    return JaxContext.from_mesh(make_mesh((1, tp), ("data", "model")),
                                fusion=JaxFusion(mode=mode, **fusion))


# ---------------------------------------------------------------------------
# the fused products
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,rows,q,wire", [
    ("bulk", 8, 1, "f32"), ("fused", 8, 1, "f32"), ("fused", 8, 2, "f32"),
    ("fused", 8, 2, "bf16"), ("fused", 8, 1, "fp8"), ("fused", 3, 1, "f32"),
    ("fused", 3, 2, "bf16")], ids=lambda v: str(v))
@pytest.mark.parametrize("tp", TPS)
def test_matmul_allreduce_matches_jax(world, rng, tp, mode, rows, q, wire):
    """Rows that split over the ring chunk by rows (8), others by columns (3)."""
    x = rng.standard_normal((rows, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, w: jax_matmul_allreduce(
        jctx(tp), x, w, mode=mode, chunks_per_rank=q, wire=wire))(x, w))
    for got in run(world, "matmul_allreduce_task", tp, x=x, w=w, mode=mode, q=q, wire=wire):
        assert got.shape == (rows, 1, 32)
        np.testing.assert_allclose(got, want, **WIRE_TOL[wire])


@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("tp", TPS)
def test_sequence_parallel_products_match_jax(world, rng, tp, mode):
    """allgather_matmul, matmul_reducescatter (granularity 2) and allgather_seq."""
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 32)).astype(np.float32)
    c = jctx(tp, mode, granularity=2)
    want_ag = np.asarray(jax.jit(lambda x, w: jagmm.allgather_matmul(c, x, w))(x, w))
    want_rs = np.asarray(jax.jit(lambda x, w: jagmm.matmul_reducescatter(c, x, w))(x, w))
    per_rank = run(world, "sp_products_task", tp, x=x, w=w, mode=mode, q=2)
    np.testing.assert_allclose(np.concatenate([r[0] for r in per_rank], axis=2), want_ag, **TOL)
    np.testing.assert_allclose(np.concatenate([r[1] for r in per_rank], axis=1), want_rs, **TOL)
    for r in per_rank:
        np.testing.assert_array_equal(r[2], x)


# ---------------------------------------------------------------------------
# the decode layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["bulk", "fused"])
@pytest.mark.parametrize("tp", TPS)
def test_mlp_apply_decode_matches_jax(world, rng, tp, mode):
    d, f = 32, 48
    p = {"w_gate": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
         "w_up": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
         "w_down": rng.standard_normal((f, d)).astype(np.float32) * f ** -0.5}
    x = rng.standard_normal((4, 1, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jlayers.mlp_apply(jctx(tp, mode), p, x,
                                                             seq_sharded=False))(p, x))
    for got in run(world, "mlp_decode_task", tp, params=p, x=x, mode=mode):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tp", TPS)
def test_embedding_lookup_vocab_sharded_matches_jax(world, rng, tp):
    table = rng.standard_normal((64, 16)).astype(np.float32)
    tokens = np.array([[0, 17, 63, -1, 64, 40]], np.int32)   # -1 and 64: outside, zeros
    for scale in (None, 2.0):
        want = np.asarray(jax.jit(lambda tb, tk: jlayers.embedding_lookup(
            jctx(tp), {"table": tb}, tk, seq_shard=False, scale=scale))(table, tokens))
        for got in run(world, "embedding_task", tp, table=table, tokens=tokens, scale=scale):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tp", TPS)
def test_cache_update_writes_only_the_owners_row(world, rng, tp):
    B, S = 4, 16
    cache = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    new = rng.standard_normal((B, 1, 2, 8)).astype(np.float32)
    pos = np.array([0, 5, 15, 16], np.int32)       # slot 3 is at S_max: dropped
    want = np.asarray(jax.jit(lambda c, n, p: jattn.cache_update(jctx(tp), c, n, p))(
        cache, new, pos))
    got = np.concatenate(run(world, "cache_update_task", tp, cache=cache, new=new, pos=pos),
                         axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], cache[3])


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 2.0)])
@pytest.mark.parametrize("tp", TPS)
def test_decode_attention_merges_partials_like_jax(world, rng, tp, window, softcap):
    B, S, Hq, Hkv, hd = 4, 16, 4, 2, 8
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    pos = np.array([0, 3, 15, 9], np.int32)        # slot 0 sees rank 0's rows only
    want = np.asarray(jax.jit(lambda q, k, v, p: jattn.decode_attention(
        jctx(tp), q, k, v, p, window=window, softcap_val=softcap))(q, k, v, pos))
    for got in run(world, "decode_attention_task", tp, q=q, k=k, v=v, pos=pos, window=window,
                   softcap=softcap):
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the slice: reduced chatglm3-6b decode at tp > 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_glm():
    jb = jax_get_arch("chatglm3-6b").reduced()
    jparams, _ = split_params(jb.init_params(jax.random.PRNGKey(0)))
    return jb, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("mode,q", [("bulk", 1), ("fused", 1), ("fused", 2)])
@pytest.mark.parametrize("tp", TPS)
def test_decode_steps_match_jax(world, rng, jax_glm, tp, mode, q):
    """4 decode steps of reduced chatglm3-6b (f32, per-slot positions): the
    logits and each rank's rows of the cache against the JAX decode step."""
    jb, jparams, tree = jax_glm
    B, steps = 4, 4
    tokens = rng.integers(0, jb.config.vocab, (steps, B, 1)).astype(np.int32)
    positions = np.stack([s * 5 + np.arange(B) for s in range(steps)]).astype(np.int32)
    c = jctx(tp, mode, granularity=q)
    jdec = jax.jit(lambda tk, cache, p: jb.decode_fn(c)(jparams, tk, cache, p))
    jcache, want = jb.init_cache(B), []
    for tok, pos in zip(tokens, positions):
        lg, jcache = jdec(tok, jcache, pos)
        want.append(np.asarray(lg))
    per_rank = run(world, "decode_steps_task", tp, tree=tree, mode=mode, tokens=tokens,
                   positions=positions, q=q)
    for logits, _, _ in per_rank:
        assert logits.shape == (steps, B, 1, jb.config.vocab)
        np.testing.assert_allclose(logits, np.stack(want), **TOL)
    for name, i in (("k", 1), ("v", 2)):      # rank d holds cache rows d * S / tp onwards
        got = np.concatenate([r[i] for r in per_rank], axis=2)
        np.testing.assert_allclose(got, np.asarray(jcache["scan"][name]), **TOL)


def _streams(out: str) -> dict:
    return {int(u): eval(toks) for u, toks in re.findall(r"req (\d+): prompt .* -> (\[.*\])", out)}


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_launcher_at_tp2_serves_the_tp1_streams(capsys, mode):
    """``torch.distributed.run`` of the launcher at --tp 2 (gloo, CPU) gives
    the greedy streams of --tp 1, every rank the same (the launcher checks
    and says so)."""
    argv = ["--reduced", "--device", "cpu", "--requests", "4", "--max-new", "8"]
    launch_serve.main(argv + ["--fusion", "bulk"])
    want = _streams(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", "--tp", "2", "--backend", "gloo", "--fusion", mode,
         *argv], cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "all 2 ranks' token streams equal: True" in proc.stdout
    assert f"fusion={mode}" in proc.stdout and "tp=2 (gloo)" in proc.stdout
    assert len(want) == 4 and _streams(proc.stdout) == want


# ---------------------------------------------------------------------------
# the weights over the world, and what does not run at tp > 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", TPS)
def test_sharded_init_is_the_tp1_weights_sliced(world, tp):
    full = get_arch("chatglm3-6b").reduced().init_params(torch.Generator().manual_seed(0))
    lp = full["layers"][-1]
    for d, got in enumerate(run(world, "init_params_task", tp)):
        rows = lambda a: np.split(a.numpy(), tp, axis=0)[d]
        np.testing.assert_array_equal(got["table"], rows(full["embed"]["table"]))
        np.testing.assert_array_equal(got["w_qkv"], lp["attn"]["w_qkv"].numpy())
        np.testing.assert_array_equal(got["w_gate"], np.split(lp["ffn"]["w_gate"].numpy(),
                                                              tp, axis=1)[d])
        np.testing.assert_array_equal(got["w_down"], rows(lp["ffn"]["w_down"]))
        np.testing.assert_array_equal(got["ln2"], lp["ln2"].numpy())


def test_shard_leaf_and_params_from_numpy_follow_the_reference_specs(jax_glm):
    _, _, tree = jax_glm
    whole = params_from_numpy(tree)
    for d in range(2):
        c = types.SimpleNamespace(tp=2, tp_rank=d)
        part = params_from_numpy(tree, "cpu", c)
        lw, lp = whole["layers"][1], part["layers"][1]
        assert torch.equal(lp["attn"]["w_o"], lw["attn"]["w_o"])
        assert torch.equal(lp["ffn"]["w_up"], lw["ffn"]["w_up"].chunk(2, 1)[d])
        assert torch.equal(lp["ffn"]["w_down"], lw["ffn"]["w_down"].chunk(2, 0)[d])
        assert torch.equal(part["embed"]["table"], whole["embed"]["table"].chunk(2, 0)[d])
        x = torch.arange(24.).reshape(4, 6)
        assert torch.equal(shard_leaf(x, (None, "vocab"), c), x.chunk(2, 1)[d])
        assert shard_leaf(x, ("fsdp", None), c) is x
        with pytest.raises(ValueError, match="one tp axis"):
            shard_leaf(x, ("tp", "heads"), c)


def test_auto_choices_resolve_at_tp2(world, rng):
    """'auto' granularity resolves at tp > 1 through the autotuner: every rank
    takes the JAX package's decision under the same link constants (V5E),
    and the product is the JAX package's."""
    x = rng.standard_normal((8, 1, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    clear_both()
    want = np.asarray(jax.jit(lambda x, w: jax_matmul_allreduce(
        jctx(2, granularity="auto"), x, w))(x, w))
    jdec = sorted((json.dumps(as_json(k), sort_keys=True), d.q, d.wire)
                  for k, d in jtune.cache_info().items())
    for got, dec in run(world, "auto_task", 2, x=x, w=w, op="matmul_allreduce",
                        hw=dataclasses.asdict(jperf.V5E)):
        assert dec == jdec
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("what,item", [
    ("kernel", "item 1 .*real-peer"), ("moe", "item 1 .*real-peer"),
    ("paged", "item 5"), ("rwkv6", "item 7")])
def test_paths_left_for_later_raise_at_tp2(world, what, item):
    """Kernel mode of the fused GEMV at tp > 1 raises (no fallback to fused
    mode), as does the MoE layer's in kernel mode (its kernels over ranks
    need real peers), a MoE model's paged serving and rwkv6."""
    for msg in run(world, "refusal_task", 2, what=what):
        assert msg is not None and re.search(f"ROADMAP Queue 1 {item}", msg), msg


@pytest.mark.parametrize("mode", ["bulk", "fused"])
def test_matmul_allreduce_grad_at_tp2(world, rng, mode):
    """matmul_allreduce under autograd at tp = 2: each rank's (dx, dw) of its
    K slice against the dense gradient of sum((x @ w) * co); bulk mode
    through the all-reduce's pass-through backward, fused mode through the
    ring's local one."""
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    co = rng.standard_normal((4, 8, 16)).astype(np.float32)
    dx, dw = np.einsum("bsn,kn->bsk", co, w), np.einsum("bsk,bsn->kn", x, co)
    for d, (gx, gw) in enumerate(run(world, "product_grads_task", 2, x=x, w=w, co=co,
                                     op="matmul_allreduce", mode=mode)):
        np.testing.assert_allclose(gx, dx[..., d * 16:(d + 1) * 16], **TOL)
        np.testing.assert_allclose(gw, dw[d * 16:(d + 1) * 16], **TOL)


def test_dp_above_one_and_world_starts_refuse_plainly(monkeypatch):
    with pytest.raises(RuntimeError, match="init_world"):     # dp > 1 needs a started world
        ParallelContext(device="cpu", dp=2)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert launch_mesh.init_world(1, None, "cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()         # a world of 1 needs no group
    with pytest.raises(ValueError, match="backend"):
        launch_mesh.init_world(2, "mpi", "cpu", rank=0)
    with pytest.raises(ValueError, match="nccl"):
        launch_mesh.world_device("nccl", "cpu", 0)
    with pytest.raises(ValueError, match="no rank"):
        launch_mesh.init_world(2, "gloo", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="--tp 2 is 2 ranks, in a world of 4"):
        launch_mesh.init_world(2, "gloo", "cpu")
    assert launch_mesh.default_backend("cpu") == "gloo"
    assert launch_mesh.default_backend("cuda") == "nccl"
