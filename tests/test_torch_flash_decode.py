"""Flash-decode parity on the CPU: the port's plain twin of the kernel
against the JAX package's flash_decode_quant (Pallas, interpret mode) and
its XLA gqa_attention_quant, on the same numpy inputs: a cache mask and
the new rows' positions, from which the port forms the visibility that
the JAX functions get from its build_visibility."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.ops.attention import (
    build_visibility as jbuild_visibility,
    gqa_attention_quant as jgqa_attention_quant)
from powerserve_tpu.ops.flash_decode import (
    flash_decode_quant as jflash_decode_quant)
from powerserve_tpu_torch.ops.attention import (build_visibility,
                                                gqa_attention_quant)
from powerserve_tpu_torch.ops.flash_decode import (
    flash_decode_paged_reference, flash_decode_quant,
    flash_decode_quant_reference, flash_decode_visibility_reference,
    gather_pages, kernel_walk)
from torch_threads import one_torch_thread  # noqa: F401

H, HKV, D = 8, 2, 32


def _mask_positions(rng, S, Tq, T, p_visible=0.8):
    """A random cache mask [S, T] and positions [S, Tq]: in range, -1,
    past T, and repeats."""
    mask = rng.random((S, T)) < p_visible
    pos = rng.integers(0, T, (S, Tq)).astype(np.int32)
    if Tq > 1:
        pos[0, -1] = -1
        pos[-1, 0] = T + 3
        pos[-1, -1] = pos[-1, Tq // 2]
    return mask, pos


def _inputs(S, Tq, T, seed, p_visible=0.8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (S, HKV, T, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (S, HKV, T, D)).astype(np.int8)
    ks = (rng.random((S, HKV, T)) * 0.05).astype(np.float32)
    vs = (rng.random((S, HKV, T)) * 0.05).astype(np.float32)
    mask, pos = _mask_positions(rng, S, Tq, T, p_visible)
    return q, kq, ks, vq, vs, mask, pos


def _jax(args):
    """The JAX functions' operands: the visibility in place of mask and
    positions."""
    *head, mask, pos = args
    vis = jbuild_visibility(jnp.asarray(mask), jnp.asarray(pos), None)
    return [jnp.asarray(a) for a in head] + [vis]


def _port(args, scale, chunk=16, split=None):
    return flash_decode_quant(*(torch.from_numpy(np.array(a)) for a in args),
                              scale, chunk=chunk, split=split).numpy()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("S,Tq,T", [(1, 1, 1024), (2, 1, 700), (2, 3, 600)])
def test_matches_jax_flash_kernel(S, Tq, T):
    args = _inputs(S, Tq, T, seed=T)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jflash_decode_quant(*_jax(args), scale,
                                          interpret=True))
    # the same 512-token chunks in one sequence as the JAX kernel: the
    # same online-softmax roundings, only the order of the f32 dot sums
    # differs (which can move a bf16-rounded probability by one last bit)
    assert _rel(_port(args, scale, chunk=512, split=T), want) < 1e-5
    # the kernel's own 16-token steps in its per-warp splits round p * vs
    # to bf16 at other running maxima (2^-9 relative per probability)
    assert _rel(_port(args, scale), want) < 3e-3


@pytest.mark.parametrize("Tq", [1, 2])
def test_matches_jax_xla_attention(Tq):
    args = _inputs(2, Tq, 300, seed=11)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jgqa_attention_quant(*_jax(args), scale,
                                           backend="xla"))
    # the XLA path runs f32 operands on the CPU; the port rounds q and
    # p * vs to bf16 (the TPU numerics): ~2^-9 relative per operand
    assert _rel(_port(args, scale), want) < 1e-2
    tensors = [torch.from_numpy(np.array(a)) for a in args]
    vis = build_visibility(tensors[5], tensors[6].long())
    got = gqa_attention_quant(*tensors[:5], vis, scale).numpy()
    assert _rel(got, want) < 1e-2


def test_fully_masked_rows_are_finite():
    """A row that sees nothing averages V over the T positions, like the
    JAX XLA reference (its Pallas kernel averages over T padded to 512,
    so the two JAX paths differ there; at T % 512 == 0 all three agree).
    Slot 0 has an empty mask and positions -1 and past T: both its rows
    see nothing."""
    scale = 1.0 / np.sqrt(D)
    for T in (300, 512):
        args = list(_inputs(2, 2, T, seed=T))
        args[5] = args[5].copy()
        args[5][0] = False
        args[6] = args[6].copy()
        args[6][0] = [-1, T]
        got = _port(args, scale)
        assert np.isfinite(got).all()
        want = np.asarray(jgqa_attention_quant(*_jax(args), scale,
                                               backend="xla"))
        assert _rel(got[0, 1], want[0, 1]) < 1e-2
        if T % 512 == 0:
            wk = np.asarray(jflash_decode_quant(*_jax(args), scale,
                                                interpret=True))
            assert _rel(got[0, 1], wk[0, 1]) < 1e-2


def test_build_visibility_matches_jax():
    rng = np.random.default_rng(2)
    mask = rng.random((3, 40)) < 0.5
    pos = np.array([[5, 6, 7], [-1, -1, -1], [38, 39, 40]], np.int32)
    want = np.asarray(jbuild_visibility(jnp.asarray(mask), jnp.asarray(pos),
                                        None))
    got = build_visibility(torch.from_numpy(mask),
                           torch.from_numpy(pos).long()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Tq", [1, 5, 16])
def test_mask_positions_twin_is_the_visibility_twin(Tq):
    """The (mask, positions) twins equal today's visibility twin fed the
    JAX package's build_visibility of the same mask and positions (-1,
    past T and repeated positions included), dense and paged, at the
    kernel's chunk and split and at the JAX kernel's."""
    rng = np.random.default_rng(100 + Tq)
    S, T, page = 3, 160, 16
    q, kq, ks, vq, vs, mask, pos = _inputs(S, Tq, T, seed=Tq)
    vis = np.asarray(jbuild_visibility(jnp.asarray(mask), jnp.asarray(pos),
                                       None))
    t = [torch.from_numpy(np.array(a)) for a in (q, kq, ks, vq, vs, mask,
                                                  pos, vis)]
    scale = 1.0 / np.sqrt(D)
    end, split = kernel_walk(t[7], HKV, H // HKV)
    assert (split % 16 == 0).all() and (end <= T).all()
    for chunk, split_, end_ in ((16, None, end), (512, T, None)):
        want = flash_decode_visibility_reference(
            *t[:5], t[7], scale, chunk, split if split_ is None else split_,
            end_)
        got = flash_decode_quant_reference(*t[:7], scale, chunk, split_)
        assert torch.equal(got, want)
    # the same cache as a scrambled pool of pages
    MP = T // page
    P = S * MP + 2
    perm = torch.from_numpy(rng.permutation(P)[:S * MP].astype(np.int32))
    table = perm.reshape(S, MP)
    pools = [torch.zeros((P, HKV, page) + tuple(x.shape[3:]), dtype=x.dtype)
             for x in t[1:5]]
    for pool, x in zip(pools, t[1:5]):
        pool[table.long()] = x.reshape(
            (S, HKV, MP, page) + tuple(x.shape[3:])).movedim(1, 2)
    for pool, x in zip(pools, t[1:5]):
        assert torch.equal(gather_pages(pool, table), x)
    got = flash_decode_paged_reference(t[0], *pools, table, t[5], t[6],
                                       scale)
    assert torch.equal(got, flash_decode_visibility_reference(
        *t[:5], t[7], scale, 16, split, end))
