"""Fused decode head parity on the CPU: the port's plain twin of the
norm-prologue (+ argmax) kernel against the JAX package's fused_linear
run as its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.ops.fused import fused_linear as jfused_linear
from powerserve_tpu.ops.qmatmul import QLinear as JQLinear
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.ops.fused import (fused_linear,
                                            fused_linear_reference,
                                            norm_rounding_slack)
from powerserve_tpu_torch.ops.qmatmul import QLinear

# f32 sums in another order, relative to the largest logit; on top of it
# norm_rounding_slack: both round the normalized rows to bf16, and a
# last-bit difference between the two f32 norms may round an element
# that lies next to a bf16 rounding midpoint the other way
REL = 2e-5


def _pair(fmt, k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    return (JQLinear.from_float(w, fmt),
            QLinear.from_float(w, fmt, device="cpu"), rng)


@pytest.mark.parametrize("fmt,k", [(GGMLType.Q4_K, 512), (GGMLType.Q4_0, 256),
                                   (GGMLType.Q8_0, 128)])
@pytest.mark.parametrize("m", [1, 5])
def test_norm_head_matches_jax_kernel(fmt, k, m):
    jl, tl, rng = _pair(fmt, k, 384, seed=k + m)
    x = rng.standard_normal((m, k)).astype(np.float32) * 2
    nw = (rng.standard_normal(k) * 0.1 + 1).astype(np.float32)
    want = np.asarray(jfused_linear(jl, norm=(jnp.asarray(x), jnp.asarray(nw)),
                                    backend="pallas_interpret"))
    got = fused_linear(tl, norm=(torch.from_numpy(x), torch.from_numpy(nw)))
    got = got.numpy()
    tol = REL * np.abs(want).max() + norm_rounding_slack(
        tl, torch.from_numpy(x), torch.from_numpy(nw)).numpy()
    assert (np.abs(got - want) <= tol).all()
    tok = fused_linear(tl, norm=(torch.from_numpy(x), torch.from_numpy(nw)),
                       argmax=True).numpy()
    jtok = np.asarray(jfused_linear(
        jl, norm=(jnp.asarray(x), jnp.asarray(nw)), argmax=True,
        backend="pallas_interpret"))
    assert tok.dtype == np.int32
    for r in range(m):  # equal unless the JAX top-2 gap is a near-tie
        if tok[r] != jtok[r]:
            top2 = np.sort(want[r])[-2:]
            assert top2[1] - top2[0] <= 2 * tol[r].max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_norm_rounding_slack_bounds_last_bit_norms(seed):
    """Moving the f32 norm by a few ulps (eps nudged, as another order of
    the mean square would) moves each logit by no more than the slack."""
    rng = np.random.default_rng(seed)
    k, n, m = 1024, 200, 16
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    lin = QLinear.from_float(w, GGMLType.Q4_K, device="cpu")
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * 3)
    nw = torch.from_numpy(rng.random(k).astype(np.float32) + 0.5)
    ref = fused_linear_reference(lin, x, nw)
    tol = REL * ref.abs().max() + norm_rounding_slack(lin, x, nw)
    moved = 0.0
    for eps in (0.0, 4e-5):  # rstd off by ~5-30 f32 ulps at var ~9
        err = (fused_linear_reference(lin, x, nw, eps=eps) - ref).abs()
        assert (err <= tol).all()
        moved = max(moved, err.max().item())
    assert moved > REL * ref.abs().max()  # some element did round the other way


def test_argmax_tie_first_occurrence():
    n = 512
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, n)).astype(np.float32)
    w[:, 300] = w[:, 10]
    big = np.abs(w).max() + 1.0
    w[:, 10] = big
    w[:, 300] = big
    jl = JQLinear.from_float(w, GGMLType.Q8_0)
    tl = QLinear.from_float(w, GGMLType.Q8_0, device="cpu")
    x = np.ones((1, 64), np.float32)
    nw = np.ones(64, np.float32)
    tok = fused_linear(tl, norm=(torch.from_numpy(x), torch.from_numpy(nw)),
                       argmax=True)
    jtok = jfused_linear(jl, norm=(jnp.asarray(x), jnp.asarray(nw)),
                         argmax=True, backend="pallas_interpret")
    assert tok.tolist() == np.asarray(jtok).tolist() == [10]
