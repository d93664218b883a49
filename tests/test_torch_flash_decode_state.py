"""The state mode of paged flash-decode and the deferred in-flight merge
on the CPU: the port's plain twins against the JAX package's
flash_decode_paged(state=True) and flash_decode_paged_deferred (Pallas,
interpret mode) and its XLA gqa_attention_quant_deferred, on the same
numpy inputs, the empty-cache case included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.kv.paged import PagedKVCache as JPagedKVCache
from powerserve_tpu.ops.attention import (
    gqa_attention_quant_deferred as jdeferred_xla)
from powerserve_tpu.ops.flash_decode import (
    flash_decode_paged as jflash_decode_paged,
    flash_decode_paged_deferred as jdeferred)
from powerserve_tpu_torch.ops.attention import NEG_INF
from powerserve_tpu_torch.ops.flash_decode import (
    flash_decode_paged, flash_decode_paged_deferred,
    flash_decode_paged_reference)
from torch_threads import one_torch_thread  # noqa: F401

H, HKV, D, SCALE = 4, 2, 128, 0.088


def _pool(rng, P, page):
    kp = rng.integers(-127, 128, (P, HKV, page, D)).astype(np.int8)
    vp = rng.integers(-127, 128, (P, HKV, page, D)).astype(np.int8)
    ksp = rng.uniform(0.005, 0.02, (P, HKV, page)).astype(np.float32)
    vsp = rng.uniform(0.005, 0.02, (P, HKV, page)).astype(np.float32)
    return kp, ksp, vp, vsp


def _inflight(rng, S, Tq):
    knq = rng.integers(-127, 128, (S, HKV, Tq, D)).astype(np.int8)
    vnq = rng.integers(-127, 128, (S, HKV, Tq, D)).astype(np.int8)
    kns = rng.uniform(0.005, 0.02, (S, HKV, Tq)).astype(np.float32)
    vns = rng.uniform(0.005, 0.02, (S, HKV, Tq)).astype(np.float32)
    return knq, kns, vnq, vns


def _scrambled(rng, S, MP, P, filled, page):
    """A page table with each slot's pages drawn from a permutation of the
    pool, unallocated (= P) past its filled positions, and the mask."""
    table = np.full((S, MP), P, np.int32)
    perm = rng.permutation(P)
    used = 0
    for s, f in enumerate(filled):
        n = -(-f // page)
        table[s, :n] = perm[used:used + n]
        used += n
    mask = np.arange(MP * page)[None, :] < np.asarray(filled)[:, None]
    return table, mask


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("S,Tq,filled", [(2, 1, [100, 75]),
                                         (3, 5, [120, 1, 64])])
def test_state_mode_matches_jax_kernel(S, Tq, filled):
    rng = np.random.default_rng(sum(filled))
    page, MP = 16, 8
    P = S * MP
    kp, ksp, vp, vsp = _pool(rng, P, page)
    table, mask = _scrambled(rng, S, MP, P, filled, page)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    vis = np.broadcast_to(mask[:, None, :], (S, Tq, MP * page)).copy()
    jargs = (q, kp, ksp, vp, vsp, table, vis)
    args = (q, kp, ksp, vp, vsp, table, mask)
    jo, jm, jl = (np.asarray(a) for a in jflash_decode_paged(
        *(jnp.asarray(a) for a in jargs), SCALE, page_size=page,
        interpret=True, state=True))
    # the JAX kernel's own page-sized chunks in one sequence: the same
    # online-softmax roundings but for the f32 dot order; then the port's
    # 16-token steps in the kernel's splits (p * vs rounded to bf16 at
    # other running maxima, ~2^-9 relative per probability)
    for chunk, split, rel in ((page, MP * page, 1e-5), (16, None, 3e-3)):
        o, m, l = flash_decode_paged_reference(
            *(_t(a) for a in args), None, SCALE, chunk=chunk, split=split,
            state=True)
        assert o.shape == (S, H * Tq, D) and m.shape == l.shape == (S, H * Tq)
        np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(l.numpy(), jl, rtol=rel, atol=0)
        assert np.abs(o.numpy() - jo).max() <= rel * np.abs(jo).max()
    # the wrapper on CPU tensors is the twin with the kernel's chunks
    got = flash_decode_paged(*(_t(a) for a in args), None, SCALE,
                             state=True)
    ref = flash_decode_paged_reference(*(_t(a) for a in args), None, SCALE,
                                       state=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_state_rows_are_tq_minor():
    """Row (h, g, tq) of the state is query head h * G + g at batch
    column tq: normalizing it gives the normalized mode's output."""
    rng = np.random.default_rng(4)
    S, Tq, page, MP = 2, 3, 16, 4
    P = S * MP
    kp, ksp, vp, vsp = _pool(rng, P, page)
    table, mask = _scrambled(rng, S, MP, P, [50, 33], page)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    args = [_t(a) for a in (q, kp, ksp, vp, vsp, table, mask)]
    o, m, l = flash_decode_paged(*args, None, SCALE, state=True)
    out = flash_decode_paged(*args, None, SCALE)
    norm = (o / l[..., None]).reshape(S, HKV, H // HKV, Tq, D)
    norm = norm.permute(0, 3, 1, 2, 4).reshape(S, Tq, H * D)
    assert torch.allclose(norm, out, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("Tq", [1, 5])
def test_deferred_matches_jax(Tq):
    rng = np.random.default_rng(11 + Tq)
    S, page, MP = 2, 16, 8
    P = 2 * MP + 3
    kp, ksp, vp, vsp = _pool(rng, P, page)
    table, mask = _scrambled(rng, S, MP, P - 3, [100, 5 * page - 7], page)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    knq, kns, vnq, vns = _inflight(rng, S, Tq)
    intra = np.broadcast_to(np.tril(np.ones((Tq, Tq), bool)), (S, Tq, Tq))
    intra = intra.copy()
    intra[1, :, Tq - 1] = False  # an out-of-range lane nobody sees
    vis_c = np.broadcast_to(mask[:, None, :], (S, Tq, MP * page)).copy()
    inflight = (knq, kns, vnq, vns, intra)
    args = (q, kp, ksp, vp, vsp, table, vis_c) + inflight
    want = np.asarray(jdeferred(*(jnp.asarray(a) for a in args), SCALE,
                                page_size=page, interpret=True))
    got = flash_decode_paged_deferred(
        *(_t(a) for a in (q, kp, ksp, vp, vsp, table, mask) + inflight),
        SCALE).numpy()
    # the committed partition through the kernel's 16-token steps (see
    # above); the in-flight one is the same arithmetic
    assert np.abs(got - want).max() <= 3e-3 * np.abs(want).max()
    jp = JPagedKVCache(k=jnp.asarray(kp)[None], v=jnp.asarray(vp)[None],
                       k_scale=jnp.asarray(ksp)[None],
                       v_scale=jnp.asarray(vsp)[None],
                       page_table=jnp.asarray(table),
                       mask=jnp.asarray(mask), pos=jnp.zeros(S, jnp.int32),
                       page_size=page)
    ref = np.asarray(jdeferred_xla(
        jnp.asarray(q), *(jp.gather_slab(jnp.asarray(t))
                          for t in (kp, ksp, vp, vsp)),
        jnp.asarray(mask), *(jnp.asarray(a) for a in
                             (knq, kns, vnq, vns, intra)), SCALE))
    # the XLA reference runs f32 operands; the port rounds q and p * vs
    # to bf16 as the TPU kernel does
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3)


def test_deferred_empty_cache():
    """A slot with no committed position (nothing allocated): the state
    leaves m at or below -1e30 / 2, the merge weighs it 0, and the result
    is attention over the in-flight block alone."""
    rng = np.random.default_rng(12)
    S, Tq, page, MP, P = 1, 2, 16, 4, 6
    kp = np.zeros((P, HKV, page, D), np.int8)
    ksp = np.zeros((P, HKV, page), np.float32)
    table = np.full((S, MP), P, np.int32)
    mask = np.zeros((S, MP * page), bool)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    knq, kns, vnq, vns = _inflight(rng, S, Tq)
    intra = np.tril(np.ones((Tq, Tq), bool))[None].copy()
    vis_c = np.broadcast_to(mask[:, None, :], (S, Tq, MP * page)).copy()
    _, m, _ = flash_decode_paged(*(_t(a) for a in (q, kp, ksp, kp, ksp,
                                                   table, mask)),
                                 None, SCALE, state=True)
    assert (m <= NEG_INF / 2).all()
    inflight = (knq, kns, vnq, vns, intra)
    args = (q, kp, ksp, kp, ksp, table, vis_c) + inflight
    want = np.asarray(jdeferred(*(jnp.asarray(a) for a in args), SCALE,
                                page_size=page, interpret=True))
    got = flash_decode_paged_deferred(
        *(_t(a) for a in (q, kp, ksp, kp, ksp, table, mask) + inflight),
        SCALE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jdeferred_xla(
        jnp.asarray(q), jnp.zeros((S, HKV, MP * page, D), jnp.int8),
        jnp.zeros((S, HKV, MP * page), jnp.float32),
        jnp.zeros((S, HKV, MP * page, D), jnp.int8),
        jnp.zeros((S, HKV, MP * page), jnp.float32), jnp.asarray(mask),
        *(jnp.asarray(a) for a in (knq, kns, vnq, vns, intra)), SCALE))
    # f32 operands there, bf16-rounded q and p * vs here
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
