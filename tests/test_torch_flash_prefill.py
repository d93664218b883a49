"""Flash-prefill parity on the CPU: the port's plain twin of the kernel
against the JAX package's flash_prefill_quant (Pallas, interpret mode, at
the same chunking) and against the port's own gqa_attention_quant on the
visibility that build_visibility gives for a contiguous batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.ops.flash_prefill import (
    flash_prefill_quant as jflash_prefill_quant)
from powerserve_tpu_torch.ops.attention import (build_visibility,
                                                gqa_attention_quant)
from powerserve_tpu_torch.ops.flash_prefill import (
    flash_prefill_quant, flash_prefill_quant_reference, prefill_visibility)

D = 32


def _inputs(S, Tq, H, Hkv, T, starts, committed, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (S, Hkv, T, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (S, Hkv, T, D)).astype(np.int8)
    ks = (rng.random((S, Hkv, T)) * 0.05).astype(np.float32)
    vs = (rng.random((S, Hkv, T)) * 0.05).astype(np.float32)
    # a committed prefix of committed[s] positions, plus scattered bits
    mask = np.arange(T)[None, :] < np.asarray(committed)[:, None]
    mask[0] |= rng.random(T) < 0.05
    start = np.asarray(starts, np.int32)
    return q, kq, ks, vq, vs, mask, start


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _sees(mask, start, Tq, T):
    """[S, Tq] rows that see at least one position."""
    return prefill_visibility(torch.from_numpy(mask), torch.from_numpy(start),
                              Tq)[..., :T].any(dim=-1).numpy()


# starts of -1 (inactive slot), 0 and n > 0 (a prefix-cache hit: the first
# n positions committed), ragged T, GQA groups 1 and 4
CASES = {
    "starts": dict(S=3, Tq=64, H=8, Hkv=2, T=256, starts=[-1, 0, 40],
                   committed=[0, 0, 40]),
    "ragged": dict(S=2, Tq=48, H=4, Hkv=4, T=300, starts=[0, 100],
                   committed=[0, 100]),
    "late": dict(S=2, Tq=40, H=8, Hkv=2, T=200, starts=[170, 5],
                 committed=[170, 0]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_kernel(name):
    c = CASES[name]
    args = _inputs(c["S"], c["Tq"], c["H"], c["Hkv"], c["T"], c["starts"],
                   c["committed"], seed=len(name))
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jflash_prefill_quant(
        *(jnp.asarray(a) for a in args), scale, qb=32, chunk=128,
        interpret=True))
    got = flash_prefill_quant_reference(*_torch(args), scale, qb=32,
                                        chunk=128).numpy()
    # the same 128-token chunks as the JAX kernel: the same online-softmax
    # roundings, only the order of the f32 dot sums differs. A row that
    # sees nothing averages V over T (JAX: over T padded to its chunk), so
    # only rows that see something are compared where T % 128 != 0.
    sees = _sees(args[5], args[6], c["Tq"], c["T"])
    if c["T"] % 128 == 0:
        sees[:] = True
    assert _rel(got[sees], want[sees]) < 1e-5
    # the kernel's own 64-token chunks round p * vs to bf16 at other
    # running maxima (2^-9 relative per probability)
    port = flash_prefill_quant(*_torch(args), scale).numpy()
    assert _rel(port[sees], want[sees]) < 3e-3


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_gqa_attention_on_build_visibility(name):
    """The in-kernel visibility of a contiguous batch (real lanes at
    start + i, padding -1 at the end) is what build_visibility gives."""
    c = CASES[name]
    q, kq, ks, vq, vs, mask, start = _inputs(
        c["S"], c["Tq"], c["H"], c["Hkv"], c["T"], c["starts"],
        c["committed"], seed=7)
    Tq, T = c["Tq"], c["T"]
    positions = start[:, None] + np.arange(Tq)[None, :]
    positions[start < 0] = -1
    positions[-1, Tq - 5:] = -1  # padded lanes at the end of the batch
    tq, tkq, tks, tvq, tvs, tmask, tstart = _torch(
        (q, kq, ks, vq, vs, mask, start))
    tpos = torch.from_numpy(positions).long()
    vis = build_visibility(tmask, tpos)
    real = (tpos >= 0) & (tpos < T)
    kern_vis = prefill_visibility(tmask, tstart, Tq)
    assert torch.equal(vis[real], kern_vis[real])
    scale = 1.0 / np.sqrt(D)
    got = flash_prefill_quant(tq, tkq, tks, tvq, tvs, tmask, tstart,
                              scale).numpy()
    want = gqa_attention_quant(tq, tkq, tks, tvq, tvs, vis, scale).numpy()
    rows = real.numpy() & vis.any(dim=-1).numpy()
    # one softmax over T against an online one over 64-token chunks: the
    # bf16 roundings of p * vs happen at other maxima (2^-9 relative per
    # probability; rows with few positions carry probabilities near 1)
    assert rows.any()
    assert _rel(got[rows], want[rows]) < 1e-2


def test_rows_that_see_nothing_average_v():
    S, Tq, H, Hkv, T = 1, 6, 4, 2, 70
    q, kq, ks, vq, vs, mask, start = _inputs(S, Tq, H, Hkv, T, [-1], [0], 3)
    mask[:] = False
    got = flash_prefill_quant(*_torch((q, kq, ks, vq, vs, mask, start)),
                              0.25).numpy()
    mean_v = (torch.from_numpy(vs).to(torch.bfloat16).float()[..., None]
              * torch.from_numpy(vq).float()).mean(dim=2).numpy()
    row0 = got[0, 0].reshape(Hkv, H // Hkv, D)
    np.testing.assert_allclose(row0, np.broadcast_to(mean_v[0, :, None],
                                                     row0.shape), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(got).all()
