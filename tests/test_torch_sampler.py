"""Sampler chain parity on the CPU: the port's repeat-penalty ring,
top-k / top-p filters and greedy pick against the JAX package's on the
same logits and token history."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from powerserve_tpu.core.config import SamplerConfig as JSamplerConfig
from powerserve_tpu.sampling import sampler as js
from powerserve_tpu_torch.core.config import SamplerConfig
from powerserve_tpu_torch.sampling import sampler as ts

S, V, P = 3, 50, 8


def _history():
    """Two penalty states fed the same pushes (the ring wraps)."""
    jstate = js.PenaltyState.create(S, P)
    tstate = ts.PenaltyState.create(S, P)
    rng = np.random.default_rng(1)
    active = np.array([True, True, False])
    for _ in range(11):
        tok = rng.integers(0, V, S).astype(np.int32)
        jstate = jstate.push(jnp.asarray(tok), jnp.asarray(active))
        tstate.push(torch.from_numpy(tok), torch.from_numpy(active))
    jstate = jstate.seed_slot(1, [4, 5, 6])
    tstate.seed_slot(1, [4, 5, 6])
    return jstate, tstate


def test_penalty_ring_and_penalized_logits_match_jax():
    jstate, tstate = _history()
    np.testing.assert_array_equal(tstate.recent.numpy(),
                                  np.asarray(jstate.recent))
    np.testing.assert_array_equal(tstate.count.numpy(),
                                  np.asarray(jstate.count))
    kw = dict(penalty_last_n=5, penalty_repeat=1.3, penalty_freq=0.2,
              penalty_present=0.1, ignore_eos=True)
    logits = np.random.default_rng(2).standard_normal((S, V)).astype(
        np.float32)
    want = js.apply_repeat_penalty(jnp.asarray(logits), jstate,
                                   JSamplerConfig(**kw), eos_id=2, nl_id=7)
    got = ts.apply_repeat_penalty(torch.from_numpy(logits), tstate,
                                  SamplerConfig(**kw), eos_id=2, nl_id=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_top_k_top_p_and_greedy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((S, V)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        ts.apply_top_k(torch.from_numpy(logits), 7).numpy(),
        np.asarray(js.apply_top_k(jnp.asarray(logits), 7)))
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_array_equal(
        ts.apply_top_p(torch.from_numpy(probs), 0.8).numpy() > 0,
        np.asarray(js.apply_top_p(jnp.asarray(probs), 0.8)) > 0)
    cfg = SamplerConfig(temperature=0.0)
    jcfg = JSamplerConfig(temperature=0.0)
    padded = np.concatenate([logits, np.full((S, 6), 99.0, np.float32)], 1)
    want = js.sample_logits(jax.random.PRNGKey(0), jnp.asarray(padded), jcfg,
                            vocab_size=V)
    got = ts.sample_logits(torch.from_numpy(padded), cfg, vocab_size=V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_draws_stay_in_the_nucleus():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((S, V)).astype(np.float32))
    cfg = SamplerConfig(temperature=0.7, top_k=5, top_p=0.9)
    allowed = torch.topk(logits, 5, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    draws = [ts.sample_logits(logits, cfg, generator=g) for _ in range(20)]
    for d in draws:
        assert all(int(d[r]) in allowed[r].tolist() for r in range(S))
    g2 = torch.Generator().manual_seed(0)
    again = [ts.sample_logits(logits, cfg, generator=g2) for _ in range(20)]
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
