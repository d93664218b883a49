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
from torch_threads import one_torch_thread  # noqa: F401

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


# the kernel's own walk (kernel_query_block, kernel_walk): a long
# committed prefix beside short slots (units that stop early beside one
# that walks far), start = -1 with nothing committed (its first row sees
# nothing: that unit walks all of T), a ragged T
WALK_CASES = {
    "long_prefix": dict(S=4, Tq=32, H=8, Hkv=2, T=512,
                        starts=[440, 0, 12, 100], committed=[440, 0, 12, 100]),
    "start_minus_one": dict(S=3, Tq=24, H=4, Hkv=1, T=256,
                            starts=[-1, -1, 200], committed=[0, 90, 200]),
    "ragged": dict(S=2, Tq=40, H=8, Hkv=4, T=333, starts=[290, 3],
                   committed=[290, 0]),
}


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_kernel_walk_matches_jax_kernel(name):
    """The twin in the kernel's walk order against the JAX Pallas kernel
    (interpret mode): bf16(p * vs) rounds at other running maxima (2^-9
    relative per probability), so 3e-3 of the largest output, on the rows
    that see something (a row that sees nothing averages V over T, JAX
    over T padded to its chunk)."""
    from powerserve_tpu_torch.ops.flash_prefill import (kernel_query_block,
                                                        kernel_walk)
    c = WALK_CASES[name]
    args = _inputs(c["S"], c["Tq"], c["H"], c["Hkv"], c["T"], c["starts"],
                   c["committed"], seed=11 + len(name))
    scale = 1.0 / np.sqrt(D)
    targs = _torch(args)
    bq = kernel_query_block(c["Tq"], c["H"] // c["Hkv"])
    n_end = kernel_walk(targs[5], targs[6], c["Tq"], bq)
    # the walk really stops early: some unit ends before the last chunk
    assert bool((n_end < -(-c["T"] // 64)).any())
    want = np.asarray(jflash_prefill_quant(
        *(jnp.asarray(a) for a in args), scale, qb=32, chunk=128,
        interpret=True))
    got = flash_prefill_quant_reference(*targs, scale).numpy()
    sees = _sees(args[5], args[6], c["Tq"], c["T"])
    assert sees.any()
    assert _rel(got[sees], want[sees]) < 3e-3


def test_kernel_walk_spans():
    """n_end: 1 + the last visible position in chunks (all of T where the
    unit's first row sees nothing)."""
    from powerserve_tpu_torch.ops.flash_prefill import kernel_walk
    T, Tq, bq = 300, 40, 16
    mask = torch.zeros(3, T, dtype=torch.bool)
    mask[0, :200] = True
    mask[2, 7] = True  # a scattered committed bit
    start = torch.tensor([200, -1, 250])
    n_end = kernel_walk(mask, start, Tq, bq, chunk=64)
    # slot 0: rows 0-15 reach 215, 16-31 231, 32-39 239: chunk 4 (256..)
    # never; slot 1: its first block's row 0 sees nothing -> all 5 chunks,
    # the later blocks reach 30 and 38; slot 2: 265, 281, 289 (<= T - 1)
    assert n_end.tolist() == [[4, 4, 4], [5, 1, 1], [5, 5, 5]]


def test_rows_that_see_nothing_average_v_over_splits():
    """A unit whose first row sees nothing walks all of a ragged T (six
    64-token chunks, the last one short); its state still averages V over
    the T positions for that row."""
    from powerserve_tpu_torch.ops.flash_prefill import (kernel_query_block,
                                                        kernel_walk)
    S, Tq, H, Hkv, T = 1, 6, 4, 2, 333
    q, kq, ks, vq, vs, mask, start = _inputs(S, Tq, H, Hkv, T, [-1], [0], 5)
    mask[:] = False
    targs = _torch((q, kq, ks, vq, vs, mask, start))
    bq = kernel_query_block(Tq, H // Hkv)
    assert kernel_walk(targs[5], targs[6], Tq, bq).tolist() == [[6]]
    got = flash_prefill_quant_reference(*targs, 0.25).numpy()
    mean_v = (torch.from_numpy(vs).to(torch.bfloat16).float()[..., None]
              * torch.from_numpy(vq).float()).mean(dim=2).numpy()
    row0 = got[0, 0].reshape(Hkv, H // Hkv, D)
    np.testing.assert_allclose(row0, np.broadcast_to(mean_v[0, :, None],
                                                     row0.shape), rtol=1e-5,
                               atol=1e-6)
    # the later rows see start + i: finite, and not the mean
    assert np.isfinite(got).all()
