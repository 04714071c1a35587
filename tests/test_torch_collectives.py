"""The port's ring collectives (``repro_torch.core.collectives`` and
``core/scheduling.py``) against the JAX package's, at tp = 2 and 4.

The same numpy inputs, made from a seed, go through each JAX function inside
``shard_map`` on a (1, tp) data x model mesh of conftest's CPU devices, and
through its port on a gloo world of tp CPU processes (``tests/torch_world.py``:
one world of 4 ranks for the module; tp = 2 runs on its two pairs, which
must agree).  f32 payloads: ``TOL["f32"]`` of tests/test_parity_matrix.py
(rtol = atol = 3e-4: the same sums, maybe in another order); compressed
wires: its ``WIRE_TOL`` (bf16 3e-2, fp8 2e-1).  Inside torch the
reference's bit-exact invariants hold bit for bit: a skew only reorders,
the oblivious schedule adds the same values in the same order, and
``wire="f32"`` carries and adds partials at their own dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh, shard_map
from repro.core import collectives as jcol
from repro.core import scheduling as jsched
from repro_torch.core import collectives as col
from repro_torch.core import scheduling as sched
from repro_torch.parallel.sharding import ParallelContext
from torch_world import World

TOL = dict(rtol=3e-4, atol=3e-4)                 # TOL["f32"]
WIRE_TOL = {"f32": TOL, "bf16": dict(rtol=3e-2, atol=3e-2),
            "fp8": dict(rtol=2e-1, atol=2e-1)}   # WIRE_TOL of test_parity_matrix.py
TPS = [2, 4]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("rdv"))
    yield w
    w.close()


def run(world, name, tp, **inputs):
    """The task's per-rank results at tp; at tp = 2 both pairs must agree."""
    out = world.run(name, tp, **inputs)
    if tp == 2:
        for a, b in zip(out[:2], out[2:]):
            for u, v in zip(a if isinstance(a, (list, tuple)) else [a],
                            b if isinstance(b, (list, tuple)) else [b]):
                np.testing.assert_array_equal(u, v)
    return out[:tp]


def jax_spmd(tp, fn, *args, out_specs=P("model")):
    """fn over each rank's block of every arg (split on axis 0) on a (1, tp) mesh."""
    mesh = make_mesh((1, tp), ("data", "model"))
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=tuple(P("model") for _ in args),
                                        out_specs=out_specs))(*args))


# ---------------------------------------------------------------------------
# ring_permute, the wire casts, the all-gathers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", ["tensor", "fp8"])
@pytest.mark.parametrize("shift", [1, 2])
@pytest.mark.parametrize("tp", TPS)
def test_ring_permute_matches_jax(world, rng, tp, shift, payload):
    x = rng.standard_normal((tp, 3, 5)).astype(np.float32)

    def local(xl):
        if payload == "fp8":
            return jcol.wire_uncast(jcol.ring_permute(jcol.wire_cast(xl[0], "fp8"), "model",
                                                      tp, shift), jnp.float32)[None]
        return jcol.ring_permute(xl, "model", tp, shift)
    want = jax_spmd(tp, local, x)
    got = np.stack(run(world, "ring_permute_task", tp, x=x, shift=shift, payload=payload))
    np.testing.assert_allclose(got, want, **WIRE_TOL["f32" if payload == "tensor" else "fp8"])
    if payload == "tensor":     # the payload of rank d - shift, unchanged
        np.testing.assert_array_equal(got, np.roll(x, shift, axis=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["f32", "bf16", "fp8"])
def test_wire_cast_round_trip_matches_jax(rng, wire, dtype):
    x = (rng.standard_normal((6, 7)) * 3).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jcol.wire_uncast(jcol.wire_cast(jx, wire), jnp.float32))
    p = col.wire_cast(tx, wire)
    got = col.wire_uncast(p, torch.float32).numpy()
    np.testing.assert_allclose(got, want, **WIRE_TOL[wire])
    if wire == "fp8":
        q, scale = p
        assert q.dtype == torch.float8_e4m3fn and scale.shape == (1,)
        assert scale.item() == pytest.approx(np.abs(tx.float().numpy()).max() / col.FP8_MAX)
    narrows = wire != "f32" and col.wire_itemsize(wire, tx.element_size()) < tx.element_size()
    assert (p is tx) == (not narrows)      # f32, and bf16 on a bf16 tensor: passthrough
    assert col.wire_itemsize(wire, tx.element_size()) == jcol.wire_itemsize(
        wire, jnp.dtype(getattr(jnp, dtype)).itemsize)


@pytest.mark.parametrize("wire", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("tp", TPS)
def test_all_gather_wire_matches_jax(world, rng, tp, wire):
    x = rng.standard_normal((tp, 3, 4)).astype(np.float32)
    want = jax_spmd(tp, lambda xl: jcol.all_gather_wire(xl[0], "model", tp, axis=1,
                                                        wire=wire)[None], x)
    for got in run(world, "all_gather_wire_task", tp, x=x, wire=wire, axis=1):
        np.testing.assert_allclose(got, want[0], **WIRE_TOL[wire])
        if wire == "f32":
            np.testing.assert_array_equal(got, np.concatenate(list(x), axis=1))


# ---------------------------------------------------------------------------
# the fused rings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wire", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("schedule", ["comm_aware", "oblivious"])
@pytest.mark.parametrize("tp", TPS)
def test_ring_reduce_scatter_matches_jax(world, rng, tp, schedule, q, wire):
    """Rank d's partial of fine chunk f is x[d, f]; every rank gets its q
    reduced chunks, at skew 0 and 1 (bit-identical)."""
    x = rng.standard_normal((tp, tp * q, 3, 8)).astype(np.float32)

    def jax_ring(skew):
        def local(xl):
            return jcol.ring_reduce_scatter_compute(
                lambda f: lax.dynamic_index_in_dim(xl[0], f, 0, keepdims=False), "model",
                schedule=schedule, chunks_per_rank=q, sub_axis=0, skew=skew, wire=wire)
        return jax_spmd(tp, local, x)
    per_rank = run(world, "ring_rs_task", tp, x=x, schedule=schedule, q=q, wire=wire)
    for skew in (0, 1):
        got = np.concatenate([r[skew] for r in per_rank])
        np.testing.assert_allclose(got, jax_ring(skew), **WIRE_TOL[wire])
    exact = x.sum(0).reshape(tp * q * 3, 8)
    np.testing.assert_allclose(np.concatenate([r[0] for r in per_rank]), exact,
                               **WIRE_TOL[wire])
    for r in per_rank:
        np.testing.assert_array_equal(r[1], r[0])         # a skew only reorders


@pytest.mark.parametrize("tp", TPS)
def test_ring_schedules_and_f32_wire_are_bit_exact_in_torch(world, rng, tp):
    """bf16 partials on the f32 wire travel and add at bf16, in the ring's
    order: rank d's chunk is ((x[d+1] + x[d+2]) + ...) + x[d], the carry
    arriving first; both schedules give those bits."""
    x = rng.standard_normal((tp, tp, 2, 16)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    want = []
    for d in range(tp):
        acc = xb[(d + 1) % tp, d]
        for i in range(2, tp + 1):
            acc = acc + xb[(d + i) % tp, d]
        want.append(acc.float().numpy())
    for schedule in ("comm_aware", "oblivious"):
        got = run(world, "ring_rs_task", tp, x=x, schedule=schedule, q=1, wire="f32",
                  skews=(0,), dtype="bfloat16")
        for d in range(tp):
            np.testing.assert_array_equal(got[d][0], want[d])


@pytest.mark.parametrize("wire", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("tp", TPS)
def test_ring_all_gather_compute_matches_jax(world, rng, tp, wire):
    x = rng.standard_normal((tp, 3, 5)).astype(np.float32)

    def local(xl):
        place = lambda src, xs, acc: lax.dynamic_update_index_in_dim(acc, xs, src, 0)
        return jcol.ring_all_gather_compute(xl[0], place, "model",
                                            out_init=jnp.zeros((tp, 3, 5)), wire=wire)[None]
    want = jax_spmd(tp, local, x)
    got = np.stack(run(world, "ring_ag_task", tp, x=x, wire=wire))
    np.testing.assert_allclose(got, want, **WIRE_TOL[wire])
    for d in range(tp):      # the local shard is consumed uncompressed
        np.testing.assert_array_equal(got[d, d], x[d])


@pytest.mark.parametrize("wire", ["f32", "fp8"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("schedule", ["comm_aware", "oblivious"])
@pytest.mark.parametrize("tp", TPS)
def test_direct_all_to_all_matches_jax(world, rng, tp, schedule, q, wire):
    """Rank d owes rank dest the q fine chunks x[d, dest * q + s]; the result
    is stacked by source, at skew 0 and 1 (bit-identical)."""
    x = rng.standard_normal((tp, tp * q, 2, 6)).astype(np.float32)

    def local(xl):
        return jcol.direct_all_to_all_compute(
            lambda f: lax.dynamic_index_in_dim(xl[0], f, 0, keepdims=False),
            jax.ShapeDtypeStruct((q * 2, 6), jnp.float32), "model", schedule=schedule,
            chunks_per_rank=q, sub_axis=0, wire=wire)[None]
    want = jax_spmd(tp, local, x)
    per_rank = run(world, "direct_a2a_task", tp, x=x, schedule=schedule, q=q, wire=wire)
    np.testing.assert_allclose(np.stack([r[0] for r in per_rank]), want, **WIRE_TOL[wire])
    for d, r in enumerate(per_rank):
        np.testing.assert_array_equal(r[1], r[0])
        np.testing.assert_array_equal(r[0][d], x[d, d * q:(d + 1) * q].reshape(q * 2, 6))


@pytest.mark.parametrize("tp", TPS)
def test_bulk_all_to_all_matches_jax(world, rng, tp):
    x = rng.standard_normal((tp, tp, 3)).astype(np.float32)
    want = jax_spmd(tp, lambda xl: jcol.bulk_all_to_all(xl[0], "model")[None], x)
    got = np.stack(run(world, "bulk_a2a_task", tp, x=x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.transpose(1, 0, 2))


@pytest.mark.parametrize("tp", TPS)
def test_attention_partial_merge_matches_jax(world, rng, tp):
    o = rng.standard_normal((tp, 2, 3, 8)).astype(np.float32)
    m = rng.standard_normal((tp, 2, 3)).astype(np.float32) * 4
    m[0, 0, 0] = -1e30            # a rank whose rows were all masked
    l = rng.uniform(0.5, 3.0, (tp, 2, 3)).astype(np.float32)
    want = jax_spmd(tp, lambda ol, ml, ll: jcol.attention_partial_merge(
        ol[0], ml[0], ll[0], "model")[None], o, m, l)
    for got in run(world, "merge_task", tp, o=o, m=m, l=l):
        np.testing.assert_allclose(got, want[0], **TOL)


# ---------------------------------------------------------------------------
# scheduling, the wire-fault hook, the staging rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("helper", ["sub_chunk_send_events", "expected_send_cover",
                                    "sub_chunk_service_order", "reduce_ring_chunk_order",
                                    "ring_offsets"])
def test_scheduling_helpers_match_jax(helper):
    for world_ in range(1, 6):
        for q in (1, 2, 3):
            for skew in range(4):
                for schedule in ("comm_aware", "oblivious"):
                    args = {"sub_chunk_send_events": (world_, q, schedule, skew),
                            "expected_send_cover": (world_, q),
                            "sub_chunk_service_order": (q, skew),
                            "reduce_ring_chunk_order": (world_, schedule),
                            "ring_offsets": (world_, schedule, skew)}[helper]
                    assert getattr(sched, helper)(*args) == getattr(jsched, helper)(*args)
    # the send schedule is a permutation covering every fine chunk once
    for r, events in enumerate(sched.sub_chunk_send_events(4, 2, "comm_aware", 1)):
        assert sorted(events) == sorted(sched.expected_send_cover(4, 2))


@pytest.mark.parametrize("n_sub,axis", [(1, 1), (2, 1), (4, 0), (3, 1)])
def test_split_ring_payload_matches_jax(rng, n_sub, axis):
    a = rng.standard_normal((4, 6)).astype(np.float32)
    if a.shape[axis] % n_sub:
        for split in (col.split_ring_payload, jcol.split_ring_payload):
            with pytest.raises(ValueError, match="feasible_chunks_per_rank"):
                split(torch.from_numpy(a) if split is col.split_ring_payload else a, n_sub, axis)
        return
    want = jcol.split_ring_payload(jnp.asarray(a), n_sub, axis)
    got = col.split_ring_payload(torch.from_numpy(a), n_sub, axis)
    assert len(got) == len(want) == n_sub
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tp", TPS)
def test_wire_fault_hook_corrupts_ring_payloads_like_jax(world, rng, tp):
    """A hook that doubles each payload leaf on the wire doubles what a ring
    hop delivers, in both packages; a one-rank world puts nothing on it."""
    x = rng.standard_normal((tp, 3, 5)).astype(np.float32)
    prev = jcol.set_wire_fault_hook(lambda leaf: leaf * 2)
    try:
        want = jax_spmd(tp, lambda xl: jcol.ring_permute(xl, "model", tp, 1), x)
    finally:
        jcol.set_wire_fault_hook(prev)
    got = np.stack(run(world, "wire_fault_task", tp, x=x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 2 * np.roll(x, 1, axis=0))
    seen = []
    prev = col.set_wire_fault_hook(lambda leaf: seen.append(leaf) or leaf)
    try:
        one = torch.ones(2, 3)
        assert col.all_gather_wire(ParallelContext(device="cpu"), one) is one
    finally:
        col.set_wire_fault_hook(prev)
    assert seen == []


def test_staging_is_decided_by_backend_and_device():
    """A gloo world handed CUDA tensors stages them through host memory; an
    NCCL world never stages, and neither does a CPU tensor."""
    assert col.wire_staged("gloo", "cuda")
    assert col.wire_staged("gloo", torch.device("cuda", 3))
    assert not col.wire_staged("gloo", "cpu")
    assert not col.wire_staged("nccl", "cuda")
    assert not col.wire_staged(None, "cuda")      # a one-rank world has no backend


def test_one_rank_world_makes_no_collective_call(rng, monkeypatch):
    """At tp = 1 every collective is the identity (or a local merge) and
    torch.distributed is never called."""
    for name in ("all_reduce", "all_gather", "batch_isend_irecv", "all_to_all_single"):
        monkeypatch.setattr(col.dist, name, lambda *a, **k: pytest.fail("called"))
    c = ParallelContext(device="cpu")
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    assert col.all_reduce(c, x) is x and col.all_gather(c, x) is x
    assert col.bulk_all_to_all(c, x) is x
    assert torch.equal(col.ring_reduce_scatter_compute(c, lambda f: x[2 * f:2 * f + 2],
                                                       chunks_per_rank=2), x)
    assert torch.equal(col.all_gather_wire(c, x, wire="bf16"), x.bfloat16().float())
