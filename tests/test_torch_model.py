"""Whole-slice parity on the CPU: the port's loader, carry-over, forward,
KV cache and greedy engine against the JAX package on synthetic GGUF
workspaces (tiny Q8_0, tiny-k Q4_K, a qwen2 QKV-bias override) and a
qwen3-style QK-norm model built from the same weights.

The JAX forward runs with its Pallas kernels in interpret mode (which
round dequantized weights to bf16 before the MXU dot) and on its default
CPU route, XLA (which dequantizes in bf16, where a Q4_K nibble * scale
and its minimum cancel, and runs attention in f32). The port's plain path
dequantizes in f32 and rounds attention operands to bf16 as the TPU and
the CUDA kernels do. The two JAX routes differ from each other by up to
~2% of the logit range on these 2-layer models, so logits agree to that
level, not to the last bit, and greedy tokens may differ only at a
near-tie (the JAX top-2 logit gap < 0.5, the reference's own rule).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.loader import (load_gguf_model,
                                                params_from_numpy)
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

SEQ = 64
# bf16-vs-f32 dequant and attention roundings over 2 layers: measured
# 0.5-0.9% against the interpret-mode kernels, 0.8-2.1% against XLA
LOGIT_REL = {"pallas_interpret": 1.5e-2, "xla": 3e-2}
NEAR_TIE = 0.5

WORKSPACES = {
    "tiny-q8_0": dict(preset="tiny", quant=GGMLType.Q8_0),
    "tiny-k-q4_k": dict(preset="tiny-k", quant=GGMLType.Q4_K),
    "qwen2-bias": dict(preset="tiny", quant=GGMLType.Q8_0, arch="qwen2",
                       bias=True),
}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """name -> (workspace, JAX (cfg, params), port (cfg, model))."""
    out = {}
    for name, kw in WORKSPACES.items():
        kw = dict(kw)
        ws = make_synthetic_gguf(tmp_path_factory.mktemp(name),
                                 kw.pop("preset"), kw.pop("quant"), seed=0,
                                 seq_len=SEQ, **kw)
        out[name] = (ws, jload(ws / "model"),
                     load_gguf_model(ws / "model", device="cpu"))
    return out


def _tree(params) -> dict:
    """JAX LlamaParams -> nested dicts of numpy arrays + QLinear metadata."""
    return dataclasses.asdict(jax.tree_util.tree_map(np.asarray, params))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("name", list(WORKSPACES))
def test_load_and_carry_over_reproduce_jax_params(loaded, name):
    _, (jcfg, jparams), (cfg, model) = loaded[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = _tree(jparams)
    carried = params_from_numpy(tree, cfg, device="cpu")
    own, other = model.state_dict(), carried.state_dict()
    assert own.keys() == other.keys()
    for k in own:
        assert torch.equal(own[k], other[k]), k
    # spot-check against the JAX leaves directly
    lw = tree["layers"]
    for i, layer in enumerate(model.layers):
        np.testing.assert_array_equal(layer.wqkv.q.numpy(),
                                      lw["wqkv"]["q"][i])
        np.testing.assert_array_equal(layer.wgu.scales.numpy(),
                                      lw["wgu"]["scales"][i])
        if lw["bqkv"] is not None:
            np.testing.assert_array_equal(layer.bqkv.numpy(), lw["bqkv"][i])
    np.testing.assert_array_equal(model.embed.q.numpy(), tree["embed"]["q"])
    np.testing.assert_array_equal(model.lm_head.q.numpy(),
                                  tree["lm_head"]["q"])


def _with_qk_norm(jcfg, jparams):
    """The tiny model with qwen3-style QK-norm weights added."""
    llm = jcfg.llm
    rng = np.random.default_rng(9)
    shape = (llm.n_layers, llm.head_size)
    qn = (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    kn = (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    return dataclasses.replace(jparams, layers=dataclasses.replace(
        jparams.layers, q_norm=jnp.asarray(qn), k_norm=jnp.asarray(kn)))


def _steps():
    """Two forward calls over S=2 slots: a prefill chunk (slot 1 runs off
    the cache end, so positions >= max_seq are dropped), then a decode
    step with slot 1 inactive (position -1)."""
    toks1 = np.arange(12, dtype=np.int32).reshape(2, 6) * 7 % 200 + 3
    pos1 = np.stack([np.arange(6), np.arange(SEQ - 3, SEQ + 3)]).astype(
        np.int32)
    toks2 = np.array([[17], [23]], np.int32)
    pos2 = np.array([[6], [-1]], np.int32)
    active2 = np.array([True, False])
    return (toks1, pos1, None, "all"), (toks2, pos2, active2, "last")


@pytest.mark.parametrize("name", list(WORKSPACES) + ["qwen3-qknorm"])
def test_forward_and_kv_match_jax(loaded, name):
    ws_name = "tiny-q8_0" if name == "qwen3-qknorm" else name
    _, (jcfg, jparams), (cfg, model) = loaded[ws_name]
    if name == "qwen3-qknorm":
        jparams = _with_qk_norm(jcfg, jparams)
        model = params_from_numpy(_tree(jparams), cfg, device="cpu")
        assert model.layers[0].q_norm is not None
    llm = cfg.llm
    jkv = JKVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                          llm.head_size)
    kv = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    jkv_xla = jkv
    for toks, pos, active, mode in _steps():
        jact = None if active is None else jnp.asarray(active)
        got = model(kv, torch.from_numpy(toks), torch.from_numpy(pos).long(),
                    active=None if active is None else torch.from_numpy(active),
                    logits_mode=mode).numpy()
        for backend, rel in LOGIT_REL.items():
            fwd = jax.jit(functools.partial(jforward, logits_mode=mode,
                                            backend=backend),
                          static_argnums=(1,))
            cache = jkv if backend == "pallas_interpret" else jkv_xla
            want, cache = fwd(jparams, jcfg.llm, cache, jnp.asarray(toks),
                              jnp.asarray(pos), active=jact)
            if backend == "pallas_interpret":
                jkv = cache
            else:
                jkv_xla = cache
            want = np.asarray(want)
            assert got.shape == want.shape
            # slot 1 is inactive in the decode step: its row is not compared
            rows = slice(0, 1) if mode == "last" else slice(None)
            assert _rel(got[rows], want[rows]) < rel, backend
        np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))
        np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    # the same entries are written (dropped lanes stay empty in both) ...
    written = np.asarray(jkv.k_scale) != 0
    np.testing.assert_array_equal(kv.k_scale.numpy() != 0, written)
    assert not written[:, 1, :, :SEQ - 3].any()  # slot 1 wrote only 61..63
    assert written[:, 0, :, :7].all() and not written[:, 0, :, 7:].any()
    # ... with the same dequantized values up to the upstream roundings
    # (identical float K/V give identical bits: the test below)
    for q, s, jq, js in ((kv.k, kv.k_scale, jkv.k, jkv.k_scale),
                         (kv.v, kv.v_scale, jkv.v, jkv.v_scale)):
        ours = q.numpy() * s.numpy()[..., None]
        theirs = np.asarray(jq, np.float32) * np.asarray(js)[..., None]
        assert _rel(ours, theirs) < LOGIT_REL["pallas_interpret"]


def test_kv_cache_writes_match_jax_exactly():
    """Identical float K/V -> identical int8 cache, scales, mask and pos,
    with inactive (-1) and out-of-range positions dropped."""
    rng = np.random.default_rng(4)
    L, S, T, Hkv, D = 2, 3, 16, 2, 8
    jkv = JKVCache.create(L, S, T, Hkv, D)
    kv = KVCache.create(L, S, T, Hkv, D, device="cpu")
    pos = np.array([[0, 1, 2, 3], [-1, -1, -1, -1], [13, 14, 15, 16]],
                   np.int32)
    for layer in range(L):
        k = rng.standard_normal((S, 4, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((S, 4, Hkv, D)).astype(np.float32)
        k[0, 1] = 0.0  # an all-zero row quantizes with scale 0
        jkv = jkv.append(layer, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos))
        kv.write(layer, torch.from_numpy(k), torch.from_numpy(v),
                 kv.write_index(torch.from_numpy(pos).long()))
    active = np.array([True, True, False])
    jkv = jkv.advance(jnp.asarray(pos), active=jnp.asarray(active))
    kv.advance(torch.from_numpy(pos).long(), active=torch.from_numpy(active))
    for ours, theirs in ((kv.k, jkv.k), (kv.v, jkv.v),
                         (kv.k_scale, jkv.k_scale), (kv.v_scale, jkv.v_scale),
                         (kv.mask, jkv.mask), (kv.pos, jkv.pos)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    jkv = jkv.rollback(2)
    kv.rollback(2)
    np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    jkv = jkv.truncate(1, active=jnp.asarray([False, True, True]))
    kv.truncate(1, active=torch.tensor([False, True, True]))
    np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))


def _engines(loaded, name):
    _, (jcfg, jparams), (cfg, model) = loaded[name]
    kw = dict(max_slots=2, batch_size=4, max_seq_len=SEQ)
    jhp, hp = JHyperParams(**kw), HyperParams(**kw)
    jhp.sampler.temperature = hp.sampler.temperature = 0.0
    return (JEngine(jparams, jcfg, jhp, backend="xla"),
            InferenceEngine(model, cfg, hp, device="cpu"))


@pytest.mark.parametrize("name", ["tiny-q8_0", "tiny-k-q4_k"])
def test_greedy_generate_matches_jax(loaded, name):
    jeng, eng = _engines(loaded, name)
    prompt = [1, 5, 9, 12, 3, 7, 40, 41, 2, 8]
    want = list(jeng.generate(prompt, 10))
    got = list(eng.generate(prompt, 10))
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is not None:
        jeng.reset()
        logits = np.asarray(jeng.prefill(prompt + want[:i]))
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, got, want)
    else:
        assert got == want
    # a stop mid-block rolls back the unconsumed decode steps alike
    jeng.reset()
    eng.reset()
    stop_at = want[2]
    want_s = list(jeng.generate(prompt, 10, stop_fn=lambda t: t == stop_at))
    got_s = list(eng.generate(prompt, 10, stop_fn=lambda t: t == stop_at))
    if i is None or i > 2:
        assert got_s == want_s
        assert int(eng.kv.pos[0]) == int(np.asarray(jeng.kv.pos)[0])
        np.testing.assert_array_equal(eng.kv.mask.numpy(),
                                      np.asarray(jeng.kv.mask))
        np.testing.assert_array_equal(eng.penalty.recent.numpy(),
                                      np.asarray(jeng.penalty.recent))
