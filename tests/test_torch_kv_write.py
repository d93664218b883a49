"""Fixed-shape KV writes on the CPU: the port's dense cache and paged pool
write every lane of a batch (dropped lanes on a spare storage row), and
come out bit-equal to the JAX package's caches, which drop such lanes
with scatter mode="drop"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.kv.paged import PagedKVCache as JPagedKVCache
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.kv.paged import PagedKVCache
from torch_threads import one_torch_thread  # noqa: F401

L, S, T, HKV, D, PAGE, P = 2, 3, 16, 2, 8, 4, 7
NAMES = ("k", "v", "k_scale", "v_scale", "mask", "pos")


def _kv_pair(rng, tq):
    k = rng.standard_normal((S, tq, HKV, D)).astype(np.float32)
    v = rng.standard_normal((S, tq, HKV, D)).astype(np.float32)
    k[0, 0, 1] = 0.0  # an all-zero head quantizes with scale 0
    return k, v


def _write_both(jkv, kv, pos, seed):
    """The same float K/V through both caches' writes, then advance."""
    rng = np.random.default_rng(seed)
    index = kv.write_index(torch.from_numpy(pos).long())
    for layer in range(L):
        k, v = _kv_pair(rng, pos.shape[1])
        jkv = jkv.append(layer, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos))
        kv.write(layer, torch.from_numpy(k), torch.from_numpy(v), index)
    jkv = jkv.advance(jnp.asarray(pos))
    kv.advance(torch.from_numpy(pos).long())
    return jkv


def _assert_same(jkv, kv, names=NAMES):
    for name in names:
        np.testing.assert_array_equal(getattr(kv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)


# batches of [S, Tq] positions, T = 16
DENSE_CASES = {
    # -1 padding after a chunk that starts at 0: a clamp of -1 to 0 would
    # land on lane 0's row
    "clamp_collision": [[[0, 1, 2, 3, -1, -1], [4, 5, -1, -1, -1, -1],
                         [0, -1, -1, -1, -1, -1]]],
    # lanes at and past max_seq: a clamp to T - 1 would land on a real
    # lane's row
    "past_max_seq": [[[0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5],
                      [0, 1, 2, 3, 4, 5]],
                     [[13, 14, 15, 16, 17, 40], [15, 16, 17, 18, 19, 20],
                      [6, 7, 8, 9, 10, 11]]],
    # a batch that writes nothing real at all (inactive slots)
    "all_dropped": [[[-1] * 4, [16] * 4, [-1, 16, 99, -7]]],
    # decode-sized: one lane per slot, one slot inactive
    "decode": [[[0], [0], [0]], [[1], [-1], [1]], [[2], [1], [15]]],
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_writes_match_jax_bit_for_bit(case):
    jkv = JKVCache.create(L, S, T, HKV, D)
    kv = KVCache.create(L, S, T, HKV, D, device="cpu")
    for seed, batch in enumerate(DENSE_CASES[case]):
        jkv = _write_both(jkv, kv, np.asarray(batch, np.int32), seed)
        _assert_same(jkv, kv)
    spare = [f[-1] for f in kv.storage]
    # the views end where the spare row begins
    for f, t in zip(kv.storage, (kv.k, kv.k_scale, kv.v, kv.v_scale)):
        assert t.data_ptr() == f.data_ptr() and t.is_contiguous()
        assert f.shape[0] == t.numel() // (D if t.dim() == 5 else 1) + 1
    if case == "all_dropped":
        assert all(not t.any() for t in (kv.k, kv.v, kv.k_scale,
                                         kv.v_scale))
        assert all(s.abs().sum() > 0 for s in spare)


def _pool_pair():
    """The port's and the JAX pool with the same scrambled table: slot 0
    owns 3 pages, slot 1 owns 1, slot 2 none (T = 16: 4 pages a slot)."""
    table = np.full((S, T // PAGE), P, np.int32)
    perm = np.random.default_rng(7).permutation(P)
    table[0, :3] = perm[:3]
    table[1, :1] = perm[3:4]
    jkv = JPagedKVCache.create(L, S, T, HKV, D, n_pages=P,
                               page_size=PAGE).assign_pages(table)
    kv = PagedKVCache.create(L, S, T, HKV, D, "cpu", n_pages=P,
                             page_size=PAGE)
    kv.assign_pages(table)
    return jkv, kv


PAGED_CASES = {
    # -1 padding and lanes on an unallocated page (slot 1 past its one
    # page, slot 2 with none) in one prefill chunk
    "unallocated_page": [[[0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5],
                          [0, 1, 2, 3, 4, 5]]],
    "clamp_collision": [[[0, 1, 2, -1, -1, -1], [0, 1, -1, -1, -1, -1],
                         [-1] * 6]],
    "past_max_seq": [[[9, 10, 11, 12, 16, 17], [3, 4, 16, 30, -1, -1],
                      [15, 16, -1, -1, -1, -1]]],
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_pool_writes_match_jax_bit_for_bit(case):
    jkv, kv = _pool_pair()
    for seed, batch in enumerate(PAGED_CASES[case]):
        jkv = _write_both(jkv, kv, np.asarray(batch, np.int32), seed)
        _assert_same(jkv, kv, NAMES + ("page_table",))
    assert kv.n_pages == P and kv.k.shape[1] == P


def test_deferred_commit_matches_jax_bit_for_bit():
    """One commit of every layer's quantized blocks stores what JAX's
    per-layer appends of the same K/V store, dropped lanes included."""
    jkv, kv = _pool_pair()
    jkv = _write_both(jkv, kv, np.tile(np.arange(6, dtype=np.int32),
                                       (S, 1)), seed=0)
    pos = np.array([[6, 7, 8, 9, 10], [4, 5, 6, -1, -1], [0, 1, 2, 3, 4]],
                   np.int32)
    rng = np.random.default_rng(1)
    blocks = []
    for layer in range(L):
        k, v = _kv_pair(rng, pos.shape[1])
        jkv = jkv.append(layer, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos))
        blocks.append(kv.quantize_kv(torch.from_numpy(k))
                      + kv.quantize_kv(torch.from_numpy(v)))
    kv.commit(blocks, kv.write_index(torch.from_numpy(pos).long()))
    _assert_same(jkv, kv, ("k", "v", "k_scale", "v_scale"))


@pytest.mark.parametrize("n", [5, 11])
def test_restore_slot_prefix_matches_jax_bit_for_bit(n):
    """A prefix of n positions restored into slot 1, whose one page
    covers 4: the rest is dropped as JAX drops it."""
    jkv, kv = _pool_pair()
    jkv = _write_both(jkv, kv, np.tile(np.arange(12, dtype=np.int32),
                                       (S, 1)), seed=2)
    saved = kv.save_slot_prefix(0, n)
    jsaved = jkv.save_slot_prefix(0, n)
    jkv = jkv.restore_slot_prefix(1, jsaved)
    kv.restore_slot_prefix(1, saved)
    _assert_same(jkv, kv)


@pytest.mark.parametrize("paged", [False, True])
def test_write_index_shape_depends_on_positions_shape_only(paged):
    """However many lanes are real, write_index gives one storage row per
    (layer, slot, lane, head): nothing is sized by the data."""
    if paged:
        _, kv = _pool_pair()
    else:
        kv = KVCache.create(L, S, T, HKV, D, device="cpu")
    spare = kv.storage[1].shape[0] - 1
    for pos in (torch.full((S, 5), -1), torch.arange(5).expand(S, 5),
                torch.tensor([[0, 1, 2, 3, 4], [16, 17, -1, 2, 3],
                              [-1, 0, 99, 1, -5]])):
        index = kv.write_index(pos)
        assert index.shape == (L, S, 5, HKV)
        dropped = (pos < 0) | (pos >= T)
        if paged:
            dropped = dropped | (kv.locate(pos)[0] == P)
        assert torch.equal(index == spare,
                           dropped[None, :, :, None].expand_as(index))


@pytest.mark.parametrize("paged", [False, True])
def test_create_allocates_the_cache_once(paged, monkeypatch):
    """create() allocates the flat storages (spare row included), the mask,
    pos and page table once, and the public views lie on those storages:
    no second copy of the cache, however briefly. clone() copies each once
    into storages of its own."""
    made = []
    for name in ("zeros", "full", "empty", "ones"):
        real = getattr(torch, name)

        def factory(*a, _real=real, **kw):
            made.append(_real(*a, **kw))
            return made[-1]
        monkeypatch.setattr(torch, name, factory)
    if paged:
        kv = PagedKVCache.create(L, S, T, HKV, D, "cpu", n_pages=P,
                                 page_size=PAGE)
        own = [kv.page_table]
    else:
        kv = KVCache.create(L, S, T, HKV, D, device="cpu")
        own = []
    monkeypatch.undo()
    own += [*kv.storage, kv.mask, kv.pos]

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    assert nbytes(made) == nbytes(own)
    rows = L * (P if paged else S) * HKV * (PAGE if paged else T)
    assert [f.shape[0] for f in kv.storage] == [rows + 1] * 4
    for f, t in zip(kv.storage, (kv.k, kv.k_scale, kv.v, kv.v_scale)):
        assert t.untyped_storage().data_ptr() == f.untyped_storage().data_ptr()
    c = kv.clone()
    assert type(c) is type(kv)
    for name in NAMES + (("page_table",) if paged else ()):
        a, b = getattr(kv, name), getattr(c, name)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(kv.storage, c.storage))
