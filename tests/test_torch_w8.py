"""W8 weight format parity on the CPU: requantization, activation
quantization and the W8 matmul twin against the JAX package's
requantize_w8, _quantize_activations and _qmatmul_pallas_mxu8 (a8, in
interpret mode), and a whole tiny-k model loaded with mxu=True by both
packages.

Tolerances: requantization and the int8 activations are bit-equal. Each
128-deep int8 dot is exact in both (integers below 2^24), so the W8
matmul differs from the Pallas kernel only in the order of its f32 sum
over blocks. The port runs the int8-activation (a8) kernel at every
shape, as the JAX kernel does; the JAX package's default CPU route sends
layers narrower than 512 or N % 128 != 0 to XLA, which dequantizes to
bf16 and keeps the activations in bf16, so at tiny widths the port
carries the a8 rounding of the activations against that route (a known
difference, ROADMAP.md section 3; at full width both run a8).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core import quant as jquant
from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.ops.qmatmul import QLinear as JQLinear
from powerserve_tpu.ops.qmatmul import _qmatmul_pallas_mxu8
from powerserve_tpu.ops.qmatmul import _quantize_activations
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.quant import (MXU_GROUP, quantize,
                                             repack_gguf_tensor,
                                             requantize_w8)
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.loader import (load_gguf_model,
                                                params_from_numpy)
from powerserve_tpu_torch.ops.fused import fused_linear
from powerserve_tpu_torch.ops.elementwise import rms_norm
from powerserve_tpu_torch.ops.qmatmul import (QLinear, qmatmul,
                                              quantize_activations)
from powerserve_tpu_torch.tools.bench_params import make_device_params
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 64
NEAR_TIE = 0.5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _qt(fmt, k, n, seed):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05
         ).astype(np.float32)
    return repack_gguf_tensor(quantize(w, fmt), fmt, (n, k))


@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q8_0,
                                 GGMLType.Q4_0])
def test_requantize_w8_matches_jax(fmt):
    qt = _qt(fmt, 512, 96, seed=int(fmt))
    q8, s = requantize_w8(qt)
    jq8, js = jquant.requantize_w8(jquant.QuantizedTensor(
        qt.q, qt.scales, qt.bias, qt.ggml_type))
    np.testing.assert_array_equal(q8, jq8)
    np.testing.assert_array_equal(s, js)
    assert q8.dtype == np.int8 and s.shape == (512 // MXU_GROUP, 96)
    tl = QLinear.from_quantized(qt, device="cpu", mxu=True)
    jl = JQLinear.from_quantized(jquant.QuantizedTensor(
        qt.q, qt.scales, qt.bias, qt.ggml_type), mxu=True)
    assert (tl.w8, tl.scale_group, tl.packed, tl.bias) == (
        True, jl.scale_group, jl.packed, None)
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    # K % 128 != 0 keeps the GGUF format, as the JAX loader does
    assert not QLinear.from_quantized(_qt(GGMLType.Q8_0, 96, 32, 1),
                                      device="cpu", mxu=True).w8


def test_quantize_activations_matches_jax():
    rng = np.random.default_rng(2)
    x = _bf16(rng.standard_normal((7, 256)).astype(np.float32) * 3)
    x[3] = 0.0  # an all-zero row: scale 0, int8 zeros
    x8, sx = quantize_activations(torch.from_numpy(x))
    jx8, jsx = _quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


def _a8_edge(case: str) -> np.ndarray:
    """Rows [3, 256] at bf16 values that reach the int8 quantization's
    edges (what the card's quantize pass must reproduce bit for bit)."""
    rng = np.random.default_rng(7)
    x = np.zeros((3, 256), np.float32)
    if case == "halves_to_even":  # absmax 127: scale 1, 1 / scale 1
        x[:, :8] = [127.0, 0.5, -0.5, 2.5, -3.5, 1.5, -1.5, 126.5]
    elif case == "clamp":  # the row's extremes land on +-127
        x[:] = np.clip(rng.standard_normal((3, 256)) * 5, -8.0, 8.0)
        x[:, 0], x[:, 1] = 9.0, -9.0
    elif case == "one_nonzero":
        x[:, 17] = [-7.25, 1e-3, 300.0]
    elif case == "large":  # near the top of the bf16 range
        x[:] = rng.standard_normal((3, 256)) * np.float32([1e30, 3e37, 1e38])[
            :, None]
    return _bf16(x)


@pytest.mark.parametrize("case", ["halves_to_even", "clamp", "zero_row",
                                  "one_nonzero", "large"])
def test_quantize_activations_edges_match_jax(case):
    x = _a8_edge(case)
    x8, sx = quantize_activations(torch.from_numpy(x))
    jx8, jsx = _quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    codes = x8.numpy()
    if case == "halves_to_even":
        assert codes[0, :8].tolist() == [127, 0, 0, 2, -4, 2, -2, 126]
    elif case == "clamp":
        assert (codes[:, 0] == 127).all() and (codes[:, 1] == -127).all()
    elif case == "zero_row":
        assert not codes.any() and not sx.numpy().any()
    elif case == "one_nonzero":
        assert codes[:, 17].tolist() == [-127, 127, 127]
        assert np.count_nonzero(codes) == 3
    else:
        assert np.isfinite(sx.numpy()).all() and np.abs(codes).max() == 127


@pytest.mark.parametrize("m", [1, 48])
def test_w8_twin_matches_pallas_interpret(m):
    k, n = 1024, 256
    qt = _qt(GGMLType.Q4_K, k, n, seed=m)
    jl = JQLinear.from_quantized(jquant.QuantizedTensor(
        qt.q, qt.scales, qt.bias, qt.ggml_type), mxu=True)
    tl = QLinear.from_quantized(qt, device="cpu", mxu=True)
    x = _bf16(np.random.default_rng(m + 1).standard_normal((m, k))
              .astype(np.float32))
    got = qmatmul(torch.from_numpy(x), tl).numpy()
    want = np.asarray(_qmatmul_pallas_mxu8(jnp.asarray(x, jnp.bfloat16), jl,
                                           a8=True, interpret=True))
    # exact int32 block dots on both sides: only the f32 sum over the 8
    # blocks and the row scale are rounded, in another order
    assert _rel(got, want) < 1e-6


def test_w8_lm_head_composes_norm_and_w8_matmul():
    """A W8 lm_head takes rms-norm, the W8 matmul and argmax (not the
    fused head kernel's format), on every device."""
    qt = _qt(GGMLType.Q8_0, 256, 300, seed=4)
    lin = QLinear.from_quantized(qt, device="cpu", mxu=True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    nw = torch.from_numpy(rng.random(256).astype(np.float32) + 0.5)
    logits = fused_linear(lin, norm=(x, nw))
    want = qmatmul(rms_norm(x, nw).to(torch.bfloat16), lin)
    assert torch.equal(logits, want)
    tok = fused_linear(lin, norm=(x, nw), argmax=True)
    assert torch.equal(tok, want.argmax(dim=-1).to(torch.int32))


@pytest.fixture(scope="module")
def w8_models(tmp_path_factory):
    ws = make_synthetic_gguf(tmp_path_factory.mktemp("w8"), "tiny-k",
                             GGMLType.Q4_K, seed=0, seq_len=SEQ)
    return (ws, jload(ws / "model", mxu=True),
            load_gguf_model(ws / "model", device="cpu", mxu=True))


def test_w8_model_loads_as_jax(w8_models):
    _, (jcfg, jparams), (cfg, model) = w8_models
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert model.lm_head.w8 and model.layers[0].wqkv.w8
    assert model.layers[1].w_down.scale_group == MXU_GROUP
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jparams))
    carried = params_from_numpy(tree, cfg, device="cpu")
    own, other = model.state_dict(), carried.state_dict()
    assert own.keys() == other.keys()
    for key in own:
        assert torch.equal(own[key], other[key]), key


# the interpret route runs the a8 kernel everywhere, as the port does, yet
# the two packages' attention and norm roundings reach each projection's
# input, and its int8 quantization turns a last-bit difference next to a
# rounding midpoint into 1/127 of the row's largest value (measured 1.4%
# over the prefill, 1.7% on the decode step); XLA keeps bf16 activations
# and dequantizes in bf16, which adds the a8 rounding itself (measured
# 1.8% and 2.2%)
W8_LOGIT_REL = {"pallas_interpret": 3e-2, "xla": 4e-2}


def test_w8_forward_matches_jax(w8_models):
    _, (jcfg, jparams), (cfg, model) = w8_models
    llm = cfg.llm
    toks = np.arange(24, dtype=np.int32).reshape(2, 12) * 7 % 500 + 3
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    kv = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    got = model(kv, torch.from_numpy(toks), torch.from_numpy(
        np.ascontiguousarray(pos)).long(), logits_mode="all").numpy()
    step = model(kv, torch.tensor([[17], [23]]), torch.tensor([[12], [12]]),
                 logits_mode="last").numpy()
    for backend, rel in W8_LOGIT_REL.items():
        fwd = jax.jit(functools.partial(jforward, backend=backend),
                      static_argnums=(1,), static_argnames=("logits_mode",))
        jkv = JKVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                              llm.head_size)
        want, jkv = fwd(jparams, jcfg.llm, jkv, jnp.asarray(toks),
                        jnp.asarray(pos), logits_mode="all")
        assert _rel(got, want) < rel, backend
        want, _ = fwd(jparams, jcfg.llm, jkv, jnp.asarray([[17], [23]]),
                      jnp.asarray([[12], [12]]), logits_mode="last")
        assert _rel(step, want) < rel, backend


def test_w8_greedy_generate_matches_jax(w8_models):
    _, (jcfg, jparams), (cfg, model) = w8_models
    kw = dict(max_slots=1, batch_size=4, max_seq_len=SEQ)
    jhp, hp = JHyperParams(**kw), HyperParams(**kw)
    jhp.sampler.temperature = hp.sampler.temperature = 0.0
    jeng = JEngine(jparams, jcfg, jhp, backend="pallas_interpret")
    eng = InferenceEngine(model, cfg, hp, device="cpu")
    prompt = [1, 5, 9, 12, 3, 7, 40, 41, 2, 8]
    want = list(jeng.generate(prompt, 8))
    got = list(eng.generate(prompt, 8))
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert got == want
    else:
        jeng.reset()
        top2 = np.sort(np.asarray(jeng.prefill(prompt + want[:i])))[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, got, want)


def test_w8_device_params():
    cfg, model = make_device_params("tiny-k", "w8", device="cpu")
    lin = model.layers[0].wgu
    assert lin.w8 and lin.q.dtype == torch.int8
    assert lin.scales.dtype == torch.float32
    assert lin.scales.shape == (cfg.llm.dim // MXU_GROUP, 2 * cfg.llm.hidden_dim)
    assert 0.001 <= float(lin.scales.min()) and float(lin.scales.max()) < 0.021
    assert model.lm_head.w8
    kv = KVCache.create(cfg.llm.n_layers, 1, 16, cfg.llm.n_kv_heads,
                        cfg.llm.head_size, device="cpu")
    out = model(kv, torch.tensor([[3, 4, 5]]), torch.arange(3)[None],
                logits_mode="argmax")
    assert out.shape == (1,) and 0 <= int(out) < cfg.llm.vocab_size
