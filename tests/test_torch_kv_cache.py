"""The port's paged KV allocator against the JAX package's.

The reference's allocator behaviours (``tests/test_kv_cache.py``) run on the
port's ``PagedKVCache``, and one seeded random sequence of
register/ensure/release/tables_for calls goes through both classes, which
must give identical tables, free counts and peaks and raise at the same
calls.  Both are numpy on the host; no device is involved.
"""
import numpy as np
import pytest
import torch

from repro.serve import kv_cache as jkv
from repro_torch.serve import kv_cache as pkv


def _stripes_round_robin(kv):
    kv.ensure(0, 16)   # 4 blocks
    # one block from each rank stripe: balanced memory and attention load
    assert sorted(b // 2 for b in kv.blocks_for(0)) == [0, 1, 2, 3]


def _incremental_and_idempotent(kv):
    kv.ensure(1, 3)
    assert len(kv.blocks_for(1)) == 1 and kv.capacity(1) == 4
    kv.ensure(1, 4)    # still fits the first block
    assert len(kv.blocks_for(1)) == 1
    kv.ensure(1, 5)
    assert len(kv.blocks_for(1)) == 2
    assert kv.used_blocks == 2


def _release_and_reuse(kv):
    kv.ensure(1, 16)
    with pytest.raises(pkv.OutOfBlocks):
        kv.ensure(2, 4)
    kv.release(1)
    assert kv.free_blocks == 4
    kv.ensure(2, 16)   # the freed blocks are reusable at once
    assert kv.used_blocks == 4 and kv.peak_blocks == 4


def _rolls_back_partial_growth(kv):
    kv.ensure(1, 12)   # 3 of 4 blocks
    with pytest.raises(pkv.OutOfBlocks):
        kv.ensure(2, 8)  # needs 2, only 1 free
    assert kv.blocks_for(2) == [] and kv.free_blocks == 1
    kv.ensure(2, 4)      # a single block still fits
    assert len(kv.blocks_for(2)) == 1


def _table_bound_raises(kv):
    with pytest.raises(ValueError):
        kv.ensure(0, 9)  # 3 blocks > MB = 2


def _tables_pad_with_sentinel(kv):
    kv.ensure(7, 5)
    t = kv.tables_for([7, None])
    assert t.shape == (2, 3) and t.dtype == np.int32
    assert (t[1] == pkv.FREE_BLOCK).all()          # empty slot: all sentinel
    assert (t[0][2:] == pkv.FREE_BLOCK).all()      # unused tail: sentinel
    assert sorted(t[0][:2]) == sorted(kv.blocks_for(7))


@pytest.mark.parametrize("args,check", [
    ((8, 4, 4, 4), _stripes_round_robin),
    ((16, 4, 8, 1), _incremental_and_idempotent),
    ((4, 4, 4, 1), _release_and_reuse),
    ((4, 4, 4, 1), _rolls_back_partial_growth),
    ((16, 4, 2, 1), _table_bound_raises),
    ((8, 4, 3, 1), _tables_pad_with_sentinel),
], ids=["stripes", "incremental", "release", "rollback", "bound", "sentinel"])
def test_allocator_behaviours(args, check):
    check(pkv.PagedKVCache(*args))


def test_num_blocks_must_divide_stripes():
    with pytest.raises(ValueError):
        pkv.PagedKVCache(6, 4, max_blocks_per_request=2, n_stripes=4)


def _apply(kv, ops):
    """Run ``ops`` on ``kv``; returns what each call gave (or raised)."""
    out = []
    for op, uid, arg in ops:
        try:
            if op == "register":
                kv.register(uid)
            elif op == "ensure":
                kv.ensure(uid, arg)
            elif op == "release":
                kv.release(uid)
            else:
                out.append(kv.tables_for(arg).tolist())
            out.append((op, kv.free_blocks, kv.used_blocks, kv.peak_blocks,
                        kv.blocks_for(uid), kv.capacity(uid)))
        except (jkv.OutOfBlocks, pkv.OutOfBlocks):
            out.append((op, "OutOfBlocks", kv.free_blocks, kv.blocks_for(uid)))
        except ValueError:
            out.append((op, "ValueError", kv.free_blocks, kv.blocks_for(uid)))
    out.append(kv.stats().__dict__)
    return out


@pytest.mark.parametrize("n_stripes", [1, 4])
def test_random_sequence_matches_jax_allocator(n_stripes):
    rng = np.random.default_rng(7 + n_stripes)
    nb, bs, mb = 24, 4, 8
    ops = []
    for _ in range(400):
        uid = int(rng.integers(0, 6))
        r = rng.random()
        if r < 0.15:
            ops.append(("register", uid, None))
        elif r < 0.7:
            ops.append(("ensure", uid, int(rng.integers(0, mb * bs + 6))))
        elif r < 0.85:
            ops.append(("release", uid, None))
        else:
            slots = [None if rng.random() < 0.3 else int(rng.integers(0, 6)) for _ in range(4)]
            ops.append(("tables_for", uid, slots))
    want = _apply(jkv.PagedKVCache(nb, bs, mb, n_stripes), ops)
    got = _apply(pkv.PagedKVCache(nb, bs, mb, n_stripes), ops)
    assert got == want
    kinds = {e[1] for e in want if isinstance(e, tuple) and isinstance(e[1], str)}
    assert kinds == {"OutOfBlocks", "ValueError"}      # both failures were reached


def test_pool_and_dense_bytes_count_tensors_without_allocating():
    pool = {"k": torch.zeros(2, 9, 4, 2, 8), "v": torch.zeros(2, 9, 4, 2, 8, dtype=torch.bfloat16)}
    assert pkv.pool_hbm_bytes(pool) == 2 * 9 * 4 * 2 * 8 * (4 + 2)
    meta = {"k": torch.zeros(3, 4, 64, 2, 16, device="meta", dtype=torch.bfloat16)}
    assert pkv.dense_cache_hbm_bytes(meta) == 3 * 4 * 64 * 2 * 16 * 2
