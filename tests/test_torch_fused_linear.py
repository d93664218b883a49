"""Fused linear parity on the CPU: the port's plain twin of every
prologue and epilogue of csrc/fused_linear.cu against the JAX package's
fused_linear run as its Pallas kernel in interpret mode, for Q4_K, Q4_0
and Q8_0 weights and M in {1, 5, 16}."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.ops.fused import fused_linear as jfused_linear
from powerserve_tpu.ops.qmatmul import QLinear as JQLinear
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.ops.fused import (fused_linear,
                                            fused_linear_reference,
                                            glu_rounding_slack,
                                            launch_name, norm_rounding_slack)
from powerserve_tpu_torch.ops.qmatmul import QLinear
from torch_threads import one_torch_thread  # noqa: F401

# f32 sums in another order (the JAX kernel folds a packed format's
# zero point through block sums of its bf16 input; the port dequantizes
# each element), relative to the largest output. On top of it the
# rounding slacks: both round the norm or glu prologue to bf16, and a
# last-bit difference of the f32 value before it (the mean square's
# summation order; exp on each side) may round an element that lies next
# to a bf16 rounding midpoint the other way.
REL = 2e-5
N = 384
FORMATS = {"q4_k": (GGMLType.Q4_K, 512), "q4_0": (GGMLType.Q4_0, 256),
           "q8_0": (GGMLType.Q8_0, 128)}
# prologue, number of norm operands, bias, residuals, argmax
CASES = {
    "x": ("x", 0, False, 0, False),
    "x+argmax": ("x", 0, False, 0, True),
    "norm+bias": ("norm", 1, True, 0, False),
    "norm(x+attn)": ("norm", 2, False, 0, False),
    "norm3+resid": ("norm", 3, False, 1, False),
    "glu+2resids": ("glu", 0, False, 2, False),
    "concat2+bias+resid": ("concat2", 0, True, 1, False),
}


def _operands(rng, case, m, k):
    """numpy kwargs of one case, and the port's launch name for it."""
    pro, n_norm, bias, n_res, argmax = CASES[case]
    x = lambda w: rng.standard_normal((m, w)).astype(np.float32)  # noqa: E731
    kw = {}
    if pro == "x":
        kw["x"] = x(k)
    elif pro == "norm":
        ops = [x(k) * 2 for _ in range(n_norm)]
        kw["norm"] = (*ops, (rng.standard_normal(k) * 0.1 + 1
                             ).astype(np.float32))
    elif pro == "glu":
        kw["glu"] = x(2 * k) * 2
    else:
        kw["parts"] = (x(k // 4), x(k - k // 4))
    if bias:
        kw["bias"] = rng.standard_normal(N).astype(np.float32)
    kw["resids"] = tuple(x(N) * 4 for _ in range(n_res))
    kw["argmax"] = argmax
    name = launch_name(pro, max(n_norm, 1), kw.get("bias"), kw["resids"],
                       argmax)
    return kw, name


def _conv(kw, to):
    out = {}
    for key, v in kw.items():
        if key in ("norm", "parts", "resids"):
            out[key] = tuple(to(a) for a in v)
        elif key in ("x", "glu", "bias"):
            out[key] = to(v)
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_kernel(case, m, fmt):
    gtype, k = FORMATS[fmt]
    rng = np.random.default_rng(hash((case, m, fmt)) % 2**32)
    w = rng.standard_normal((k, N)).astype(np.float32) * 0.1
    jl = JQLinear.from_float(w, gtype)
    tl = QLinear.from_float(w, gtype, device="cpu")
    kw, _ = _operands(rng, case, m, k)
    tkw = _conv(kw, torch.from_numpy)
    jkw = _conv(kw, jnp.asarray)
    argmax = kw.pop("argmax")
    tkw.pop("argmax"), jkw.pop("argmax")
    want = np.asarray(jfused_linear(jl, backend="pallas_interpret", **jkw))
    got = fused_linear(tl, **tkw).numpy()
    assert got.shape == want.shape == (m, N)
    tol = REL * np.abs(want).max()
    if "norm" in kw:
        tol = tol + norm_rounding_slack(tl, *tkw["norm"]).numpy()
    if "glu" in kw:
        tol = tol + glu_rounding_slack(tl, tkw["glu"]).numpy()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    if argmax:
        tok = fused_linear(tl, argmax=True, **tkw).numpy()
        jtok = np.asarray(jfused_linear(jl, argmax=True,
                                        backend="pallas_interpret", **jkw))
        assert tok.dtype == np.int32 and tok.shape == (m,)
        for r in range(m):  # equal unless the JAX top-2 gap is a near-tie
            if tok[r] != jtok[r]:
                top2 = np.sort(want[r])[-2:]
                assert top2[1] - top2[0] <= 2 * np.max(tol)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_is_the_dispatch_on_cpu(case):
    """fused_linear on CPU tensors is its plain twin, for every mode, and
    each mode counts under its own launch name."""
    rng = np.random.default_rng(3)
    gtype, k = FORMATS["q4_k"]
    tl = QLinear.from_float(rng.standard_normal((k, N)).astype(np.float32)
                            * 0.1, gtype, device="cpu")
    kw, name = _operands(rng, case, 3, k)
    tkw = _conv(kw, torch.from_numpy)
    assert torch.equal(fused_linear(tl, **tkw),
                       fused_linear_reference(tl, **tkw))
    assert name in ("fused_x", "fused_x_argmax", "fused_head", "fused_norm",
                    "fused_glu", "fused_concat2")


def test_glu_rounding_slack_bounds_last_bit_exp():
    """Moving silu(g) * u by a few f32 ulps (as exp on another device
    may) moves each output by no more than the slack."""
    rng = np.random.default_rng(5)
    k, m = 512, 16
    tl = QLinear.from_float(rng.standard_normal((k, 200)).astype(np.float32)
                            * 0.05, GGMLType.Q4_K, device="cpu")
    gu = torch.from_numpy(rng.standard_normal((m, 2 * k)).astype(np.float32)
                          * 3)
    ref = fused_linear_reference(tl, glu=gu)
    tol = REL * ref.abs().max() + glu_rounding_slack(tl, gu)
    g, u = gu[:, :k], gu[:, k:]
    for ulps in (1, 3):
        nudged = torch.cat([g, u * (1 + ulps * 2.0 ** -23)], dim=1)
        err = (fused_linear_reference(tl, glu=nudged) - ref).abs()
        assert (err <= tol).all()


def test_argmax_tie_first_occurrence_behind_x():
    n = 512
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, n)).astype(np.float32)
    big = np.abs(w).max() + 1.0
    w[:, 10] = big
    w[:, 300] = big
    jl = JQLinear.from_float(w, GGMLType.Q8_0)
    tl = QLinear.from_float(w, GGMLType.Q8_0, device="cpu")
    x = np.ones((2, 64), np.float32)
    tok = fused_linear(tl, x=torch.from_numpy(x), argmax=True)
    jtok = jfused_linear(jl, x=jnp.asarray(x), argmax=True,
                         backend="pallas_interpret")
    assert tok.tolist() == np.asarray(jtok).tolist() == [10, 10]
