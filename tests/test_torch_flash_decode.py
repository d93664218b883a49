"""Flash-decode parity on the CPU: the port's plain twin of the kernel
against the JAX package's flash_decode_quant (Pallas, interpret mode) and
its XLA gqa_attention_quant, on the same numpy inputs."""

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
from powerserve_tpu_torch.ops.flash_decode import flash_decode_quant

H, HKV, D = 8, 2, 32


def _inputs(S, Tq, T, seed, p_visible=0.8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (S, HKV, T, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (S, HKV, T, D)).astype(np.int8)
    ks = (rng.random((S, HKV, T)) * 0.05).astype(np.float32)
    vs = (rng.random((S, HKV, T)) * 0.05).astype(np.float32)
    vis = rng.random((S, Tq, T)) < p_visible
    return q, kq, ks, vq, vs, vis


def _port(args, scale, chunk=64, split=256):
    return flash_decode_quant(*(torch.from_numpy(np.array(a)) for a in args),
                              scale, chunk=chunk, split=split).numpy()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("S,Tq,T", [(1, 1, 1024), (2, 1, 700), (2, 3, 600)])
def test_matches_jax_flash_kernel(S, Tq, T):
    args = _inputs(S, Tq, T, seed=T)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jflash_decode_quant(
        *(jnp.asarray(a) for a in args), scale, interpret=True))
    # the same 512-token chunks in one sequence as the JAX kernel: the
    # same online-softmax roundings, only the order of the f32 dot sums
    # differs (which can move a bf16-rounded probability by one last bit)
    assert _rel(_port(args, scale, chunk=512, split=None), want) < 1e-5
    # the kernel's own 64-token chunks in 256-token splits round p * vs
    # to bf16 at other running maxima (2^-9 relative per probability)
    assert _rel(_port(args, scale), want) < 3e-3


@pytest.mark.parametrize("Tq", [1, 2])
def test_matches_jax_xla_attention(Tq):
    args = _inputs(2, Tq, 300, seed=11)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jgqa_attention_quant(*(jnp.asarray(a) for a in args),
                                           scale, backend="xla"))
    # the XLA path runs f32 operands on the CPU; the port rounds q and
    # p * vs to bf16 (the TPU numerics): ~2^-9 relative per operand
    assert _rel(_port(args, scale), want) < 1e-2
    got = gqa_attention_quant(*(torch.from_numpy(np.array(a)) for a in args),
                              scale).numpy()
    assert _rel(got, want) < 1e-2


def test_fully_masked_rows_are_finite():
    """A row that sees nothing averages V over the T positions, like the
    JAX XLA reference (its Pallas kernel averages over T padded to 512,
    so the two JAX paths differ there; at T % 512 == 0 all three agree)."""
    scale = 1.0 / np.sqrt(D)
    for T in (300, 512):
        args = list(_inputs(1, 2, T, seed=T))
        args[5] = args[5].copy()
        args[5][0, 1] = False
        got = _port(args, scale)
        assert np.isfinite(got).all()
        want = np.asarray(jgqa_attention_quant(
            *(jnp.asarray(a) for a in args), scale, backend="xla"))
        assert _rel(got[0, 1], want[0, 1]) < 1e-2
        if T % 512 == 0:
            wk = np.asarray(jflash_decode_quant(
                *(jnp.asarray(a) for a in args), scale, interpret=True))
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
