"""The paged int8 KV pool on the CPU: the port's PagedKVCache and PagePool
against the JAX package's, the paged flash-decode twin against the JAX
Pallas kernel (interpret mode), and the paged forward against the dense
forward in the port and against the JAX paged forward."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.kv.paged import PagedKVCache as JPagedKVCache
from powerserve_tpu.kv.paged import PagePool as JPagePool
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.ops.attention import (
    build_visibility as jbuild_visibility)
from powerserve_tpu.ops.flash_decode import (
    flash_decode_paged as jflash_decode_paged)
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.kv.paged import PagedKVCache, PagePool
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.ops.flash_decode import flash_decode_paged
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

L, S, T, HKV, D, PAGE, P = 2, 3, 40, 2, 8, 8, 12


def _pair():
    """The port's and the JAX pool with the same scrambled table: slot 0
    owns 5 pages, slot 1 owns 2, slot 2 none."""
    table = np.full((S, -(-T // PAGE)), P, np.int32)
    perm = np.random.default_rng(7).permutation(P)
    table[0, :5] = perm[:5]
    table[1, :2] = perm[5:7]
    jkv = JPagedKVCache.create(L, S, T, HKV, D, n_pages=P,
                               page_size=PAGE).assign_pages(table)
    kv = PagedKVCache.create(L, S, T, HKV, D, "cpu", n_pages=P,
                             page_size=PAGE)
    kv.assign_pages(table)
    return jkv, kv


def _write(jkv, kv, pos, seed):
    """The same float K/V through both pools' writes, then advance."""
    rng = np.random.default_rng(seed)
    for layer in range(L):
        k = rng.standard_normal((S, pos.shape[1], HKV, D)).astype(np.float32)
        v = rng.standard_normal((S, pos.shape[1], HKV, D)).astype(np.float32)
        jkv = jkv.append(layer, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos))
        kv.write(layer, torch.from_numpy(k), torch.from_numpy(v),
                 kv.write_index(torch.from_numpy(pos).long()))
    jkv = jkv.advance(jnp.asarray(pos))
    kv.advance(torch.from_numpy(pos).long())
    return jkv


def _assert_same(jkv, kv):
    for name in ("k", "v", "k_scale", "v_scale", "page_table", "mask", "pos"):
        np.testing.assert_array_equal(getattr(kv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)


def test_pool_writes_match_jax_bit_for_bit():
    """Writes through the table, with positions past the slot's pages,
    past T and -1 dropped (never wrapping into the last page)."""
    jkv, kv = _pair()
    pos = np.array([[0, 1, 2, 3, 4, 5], [10, 11, 15, 16, 17, -1],
                    [0, 1, 2, 3, -1, -1]], np.int32)
    jkv = _write(jkv, kv, pos, seed=1)
    pos = np.array([[36, 37, 38, 39, 40, 41], [-1] * 6, [5, 6, 7, 8, 9, 10]],
                   np.int32)
    jkv = _write(jkv, kv, pos, seed=2)
    _assert_same(jkv, kv)
    for layer in range(L):
        for name in ("k", "k_scale", "v", "v_scale"):
            np.testing.assert_array_equal(
                kv.gather_slab(getattr(kv, name)[layer]).numpy(),
                np.asarray(jkv.gather_slab(getattr(jkv, name)[layer])))
    jkv = jkv.rollback(2)
    kv.rollback(2)
    jkv = jkv.truncate(3, active=jnp.asarray([False, True, True]))
    kv.truncate(3, active=torch.tensor([False, True, True]))
    jkv = jkv.reset_slot(2)
    kv.reset_slot(2)
    _assert_same(jkv, kv)


def test_prefix_snapshots_match_jax_and_are_copies():
    jkv, kv = _pair()
    pos = np.tile(np.arange(20, dtype=np.int32), (S, 1))
    jkv = _write(jkv, kv, pos, seed=3)
    saved = kv.save_slot_prefix(0, 13)
    jsaved = jkv.save_slot_prefix(0, 13)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(saved[name].numpy(),
                                      np.asarray(jsaved[name]), name)
    # overwrite the slot after saving: the snapshot keeps its contents
    before = {k: v.clone() for k, v in saved.items() if k != "n"}
    jkv = _write(jkv, kv, pos, seed=4)
    for name, t in before.items():
        assert torch.equal(saved[name], t), name
    # restore into slot 1 (its 2 pages cover 13 positions of 16)
    jkv = jkv.restore_slot_prefix(1, jsaved)
    kv.restore_slot_prefix(1, saved)
    np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    back = kv.save_slot_prefix(1, 13)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(back[name], saved[name]), name


def test_dense_prefix_snapshot_is_a_copy():
    """KVCache.save_slot_prefix clones: a torch slice would be a view, and
    the next request's writes into the slot would change the cached
    prefix."""
    kv = KVCache.create(L, 2, 16, HKV, D, device="cpu")
    rng = np.random.default_rng(5)
    pos = torch.arange(10).expand(2, 10)
    for layer in range(L):
        k = torch.from_numpy(rng.standard_normal((2, 10, HKV, D))).float()
        kv.write(layer, k, -k, kv.write_index(pos))
    kv.advance(pos)
    saved = kv.save_slot_prefix(0, 8)
    want = {k: v.clone() for k, v in saved.items() if k != "n"}
    for layer in range(L):
        k = torch.ones(2, 10, HKV, D)
        kv.write(layer, k, k, kv.write_index(pos))
    for name, t in want.items():
        assert torch.equal(saved[name], t), name
    kv.reset_slot(1)
    kv.restore_slot_prefix(1, saved)
    assert torch.equal(kv.k[:, 1, :, :8], want["k"])
    assert torch.equal(kv.v_scale[:, 1, :, :8], want["v_scale"])
    assert kv.pos.tolist()[1] == 8 and kv.mask[1].sum().item() == 8


def test_page_pool_matches_jax():
    ours, theirs = PagePool(10, 3, 4, 8), JPagePool(10, 3, 4, 8)
    ops = [("ensure", 0, 9), ("ensure", 1, 25), ("ensure", 2, 17),
           ("ensure", 0, 30), ("release", 1), ("ensure", 2, 32),
           ("ensure", 0, 33), ("release", 0), ("ensure", 1, 8)]
    for op in ops:
        got = getattr(ours, op[0])(*op[1:])
        want = getattr(theirs, op[0])(*op[1:])
        assert got == want, op
        np.testing.assert_array_equal(ours.table, theirs.table)
        assert ours.owned == theirs.owned and ours.n_free == theirs.n_free
    kv = PagedKVCache.create(1, 3, 32, 1, 8, "cpu", n_pages=10, page_size=8)
    ours.flush(kv)
    np.testing.assert_array_equal(kv.page_table.numpy(), theirs.table)
    assert not ours.dirty


@pytest.mark.parametrize("page", [8, 16])
def test_twin_matches_jax_paged_kernel(page):
    rng = np.random.default_rng(page)
    Sq, Tq, H, Hkv, Dh, MP, Pp = 2, 1, 8, 2, 32, 96 // page, 20
    q = rng.standard_normal((Sq, Tq, H, Dh)).astype(np.float32)
    kp = rng.integers(-127, 128, (Pp, Hkv, page, Dh)).astype(np.int8)
    vp = rng.integers(-127, 128, (Pp, Hkv, page, Dh)).astype(np.int8)
    ksp = (rng.random((Pp, Hkv, page)) * 0.05).astype(np.float32)
    vsp = (rng.random((Pp, Hkv, page)) * 0.05).astype(np.float32)
    table = np.full((Sq, MP), Pp, np.int32)
    perm = rng.permutation(Pp)
    table[0] = perm[:MP]
    table[1, :3] = perm[MP:MP + 3]
    mask = np.zeros((Sq, MP * page), bool)
    mask[0, :69] = True
    mask[1, :3 * page - 6] = True
    pos = np.array([[69], [3 * page - 6]], np.int32)  # the new rows
    vis = np.asarray(jbuild_visibility(jnp.asarray(mask), jnp.asarray(pos),
                                       None))
    scale = 1.0 / np.sqrt(Dh)
    want = np.asarray(jflash_decode_paged(
        *(jnp.asarray(a) for a in (q, kp, ksp, vp, vsp, table, vis)),
        scale, page_size=page, interpret=True))
    targs = [torch.from_numpy(np.array(a))
             for a in (q, kp, ksp, vp, vsp, table, mask, pos)]
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_paged_reference)
    got = flash_decode_paged_reference(*targs, scale, chunk=page,
                                       split=MP * page).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    # one chunk per page, as the JAX kernel walks them: only the order of
    # the f32 dot sums differs
    assert rel < 1e-5
    # the kernel's own 16-token steps in its splits round p * vs to bf16
    # at other running maxima (2^-9 relative per probability)
    port = flash_decode_paged(*targs, scale).numpy()
    assert np.abs(port - want).max() / np.abs(want).max() < 3e-3


SEQ = 64


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    ws = make_synthetic_gguf(tmp_path_factory.mktemp("paged"), "tiny",
                             GGMLType.Q8_0, seed=0, seq_len=SEQ)
    return jload(ws / "model"), load_gguf_model(ws / "model", device="cpu")


def _steps():
    """A 24-row prefill chunk (slot 1 padded at the end) then two decode
    steps with slot 1 inactive in the last."""
    rng = np.random.default_rng(3)
    toks1 = rng.integers(3, 250, (2, 24)).astype(np.int32)
    pos1 = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    pos1[1, 18:] = -1
    return [(toks1, pos1, None, "all"),
            (np.array([[5], [9]], np.int32), np.array([[24], [18]], np.int32),
             None, "last"),
            (np.array([[7], [1]], np.int32), np.array([[25], [-1]], np.int32),
             np.array([True, False]), "last")]


def test_paged_forward_matches_dense_and_jax(tiny):
    (jcfg, jparams), (cfg, model) = tiny
    llm = cfg.llm
    page, n_pages = 8, 16
    table = np.full((2, SEQ // page), n_pages, np.int32)
    perm = np.random.default_rng(1).permutation(n_pages)
    table[0, :5] = perm[:5]  # 40 positions each: enough for 26
    table[1, :5] = perm[5:10]
    dense = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                           llm.head_size, device="cpu")
    paged = PagedKVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                                llm.head_size, "cpu", n_pages=n_pages,
                                page_size=page)
    paged.assign_pages(table)
    jpaged = JPagedKVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                                  llm.head_size, n_pages=n_pages,
                                  page_size=page).assign_pages(table)
    for toks, pos, active, mode in _steps():
        act = None if active is None else torch.from_numpy(active)
        args = (torch.from_numpy(toks), torch.from_numpy(pos).long())
        got_d = model(dense, *args, active=act, logits_mode=mode).numpy()
        got_p = model(paged, *args, active=act, logits_mode=mode).numpy()
        fwd = jax.jit(functools.partial(jforward, logits_mode=mode,
                                        backend="xla"), static_argnums=(1,))
        want, jpaged = fwd(jparams, jcfg.llm, jpaged, jnp.asarray(toks),
                           jnp.asarray(pos),
                           active=None if active is None
                           else jnp.asarray(active))
        want = np.asarray(want)
        # padded lanes (-1) and inactive slots give rows nothing reads
        rows = (pos >= 0 if mode == "all" else
                np.flatnonzero(pos[:, 0] >= 0 if active is None else active))
        # the pool holds the dense cache's values at every visible
        # position and hidden ones add nothing: the same logits
        np.testing.assert_allclose(got_p[rows], got_d[rows], rtol=1e-6,
                                   atol=1e-6)
        # against JAX's XLA route (bf16 dequant, f32 attention on the CPU):
        # ~2% of the logit range on 2-layer models (tests/test_torch_model.py)
        assert (np.abs(got_p[rows] - want[rows]).max()
                / np.abs(want[rows]).max()) < 3e-2
        np.testing.assert_array_equal(paged.mask.numpy(),
                                      np.asarray(jpaged.mask))
        np.testing.assert_array_equal(paged.pos.numpy(),
                                      np.asarray(jpaged.pos))
    for layer in range(llm.n_layers):
        for name in ("k_scale", "v_scale"):
            assert torch.equal(
                paged.gather_slab(getattr(paged, name)[layer])[:, :, :26]
                != 0, getattr(dense, name)[layer][:, :, :26] != 0)


@pytest.mark.parametrize("pages", [6, 40])
def test_fast_path_grants_cover_every_tick(tiny, pages):
    """A paged scheduler driven by step() (6 pages of 8: preemption and
    slow ticks; 40: mostly fast ticks), greedy and seeded sampled
    requests: after every step the host mirror is kv.pos, every known
    drained position (the fast path's) is at most one tick (the one in
    flight) behind kv.pos, and each resident slot's pages cover its
    position. /metrics reports paged_slow_ticks."""
    _, (cfg, model) = tiny
    from powerserve_tpu_torch.core.config import HyperParams
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request

    sched = BatchScheduler(model, cfg, HyperParams(
        max_slots=3, batch_size=8, max_seq_len=64, decode_horizon=2,
        paged_pages=pages, page_size=8), "cpu")
    done = []
    for n, p in enumerate([[3, 4, 5], list(range(10, 30)), [7, 7], [9, 1]]):
        sched.submit(Request(prompt_ids=p, max_tokens=14,
                             temperature=0.8 if n % 2 else 0.0, seed=n,
                             sink=lambda t: done.append(1) if t is None
                             else None))
    steps = 0
    while len(done) < 4:
        sched.step()
        steps += 1
        assert steps < 500
        pos = sched.kv.pos.tolist()
        assert sched.pos_host == pos
        for i in sched._pos_known:
            assert sched._pos_drained[i] + 2 >= pos[i]
        for i, s in enumerate(sched.slots):
            if s.req is not None:
                assert len(sched.pool.owned[i]) * 8 >= pos[i]
    m = sched.metrics()
    assert m["generated_tokens_total"] == 4 * 14
    if pages == 6:  # pool pressure: slow ticks, and preemption
        assert m["paged_slow_ticks"] > 0
        assert m["paged_preemptions_total"] > 0
    else:  # every tick double-buffered
        assert m["paged_slow_ticks"] == 0
