"""qmatmul parity on the CPU: the port's QLinear layout and plain twin
against the JAX package's QLinear, its Pallas kernel (interpret mode) and
its XLA path, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core import quant as jquant
from powerserve_tpu.ops.qmatmul import QLinear as JQLinear
from powerserve_tpu.ops.qmatmul import qmatmul as jqmatmul
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.quant import quantize, repack_gguf_tensor
from powerserve_tpu_torch.ops.qmatmul import QLinear, dequant, qmatmul
from torch_threads import one_torch_thread  # noqa: F401

N = 256


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 (the kernels' activation type), kept as f32."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


CASES = [(GGMLType.Q4_0, 512, True), (GGMLType.Q4_K, 512, True),
         (GGMLType.Q8_0, 512, True), (GGMLType.Q4_0, 96, True),
         (GGMLType.Q8_0, 96, True), (GGMLType.Q4_K, 256, False)]


@pytest.mark.parametrize("fmt,k,pack", CASES)
@pytest.mark.parametrize("m", [1, 7, 40])
def test_qmatmul_matches_jax(fmt, k, pack, m):
    rng = np.random.default_rng(k + m)
    w = rng.standard_normal((k, N)).astype(np.float32) * 0.1
    x = _bf16(rng.standard_normal((m, k)).astype(np.float32))
    jl = JQLinear.from_float(w, fmt, pack=pack)
    tl = QLinear.from_float(w, fmt, pack=pack, device="cpu")
    # same storage: packed iff 4-bit with K % 128 == 0, same nibble order
    assert (tl.packed, tl.unsigned, tl.pack_group) == (
        jl.packed, jl.unsigned, jl.pack_group)
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    np.testing.assert_array_equal(tl.scales.numpy(), np.asarray(jl.scales))
    y = qmatmul(torch.from_numpy(x), tl).numpy()
    if m <= 16:
        # decode rows: the JAX kernel's f32 dots, f32 dequant (K=96 has no
        # kernel tiling and runs XLA in f32); only the sum order differs
        y_kernel = np.asarray(jqmatmul(jnp.asarray(x), jl,
                                       backend="pallas_interpret",
                                       compute_dtype=jnp.float32))
        assert _rel(y, y_kernel) < 1e-5
    else:
        # prefill rows: weights rounded to bf16 after an f32 dequant, as
        # the JAX kernel's bf16 dots; its packed kernel instead rounds
        # nibble * scale and folds the zero point through a bf16 block-sum
        # dot, and K=96 runs XLA's bf16 dequant: 2^-9 per weight apart
        y_kernel = np.asarray(jqmatmul(jnp.asarray(x), jl,
                                       backend="pallas_interpret",
                                       compute_dtype=jnp.bfloat16))
        same_rounding = not jl.packed and k % 64 == 0
        assert _rel(y, y_kernel) < (1e-5 if same_rounding else 1e-2)
    # the XLA path dequantizes in bf16 (each weight off by up to 2^-9)
    y_xla = np.asarray(jqmatmul(jnp.asarray(x), jl, backend="xla"))
    assert _rel(y, y_xla) < 1e-2


def test_qmatmul_3d_input():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    tl = QLinear.from_float(w, GGMLType.Q8_0, device="cpu")
    y = qmatmul(torch.ones(2, 3, 64), tl)
    assert y.shape == (2, 3, 32) and y.dtype == torch.float32


@pytest.mark.parametrize("fmt", [GGMLType.Q5_K, GGMLType.Q6_K])
def test_requant_to_q8_0_matches_jax(fmt):
    """GGUF types without a kernel are requantized to Q8_0 at load by the
    port's own copy of repack_gguf_tensor, exactly as the JAX package
    does."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((128, 256)).astype(np.float32) * 0.1  # [N, K]
    payload = quantize(w, fmt)
    qt = repack_gguf_tensor(payload, fmt, w.shape)
    jqt = jquant.repack_gguf_tensor(payload, fmt, w.shape)
    assert qt.ggml_type == jqt.ggml_type == GGMLType.Q8_0
    np.testing.assert_array_equal(qt.q, jqt.q)
    np.testing.assert_array_equal(qt.scales, jqt.scales)
    tl = QLinear.from_quantized(qt, device="cpu")
    jl = JQLinear.from_quantized(jqt)
    np.testing.assert_allclose(dequant(tl).numpy(), qt.dequant(), rtol=0,
                               atol=0)
    x = _bf16(rng.standard_normal((3, 256)).astype(np.float32))
    y = qmatmul(torch.from_numpy(x), tl).numpy()
    y_j = np.asarray(jqmatmul(jnp.asarray(x), jl, backend="pallas_interpret",
                              compute_dtype=jnp.float32))
    assert _rel(y, y_j) < 1e-5
