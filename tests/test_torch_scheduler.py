"""The port's continuous-batching scheduler and batched sampler on the CPU,
against the JAX package's on a tiny synthetic model (max_slots=2,
batch_size=8, as tests/test_scheduler.py runs it).

Greedy tokens must equal the JAX scheduler's, or first differ where the
JAX top-2 logit gap is < 0.5 (the reference's near-tie rule: the JAX CPU
route dequantizes in bf16, the port in f32). A seeded sampled reply
reproduces within the port; it is not expected to equal JAX's, whose
jax.random draws differ from torch.Generator's for the same seed.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.engine.scheduler import BatchScheduler as JScheduler
from powerserve_tpu.engine.scheduler import Request as JRequest
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.sampling.sampler import PenaltyState as JPenaltyState
from powerserve_tpu.sampling.sampler import (
    sample_dist_batched as jsample_dist_batched)
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.sampling.sampler import (DrawState, PenaltyState,
                                                   sample_dist_batched,
                                                   sample_logits_batched)
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
NEAR_TIE = 0.5
PROMPTS = [[1, 4, 9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13], [5, 5, 5],
           [7, 8], list(range(3, 40))]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ws = make_synthetic_gguf(tmp_path_factory.mktemp("sched"), "tiny",
                             GGMLType.Q8_0, seed=0, seq_len=SEQ)
    jcfg, jparams = jload(ws / "model")
    cfg, model = load_gguf_model(ws / "model", device="cpu")
    jhp = JHyperParams(max_slots=2, batch_size=8)
    jhp.sampler.temperature = 0.0
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, model=model,
                jengine=JEngine(jparams, jcfg, jhp, backend="xla"))


def _run(sched, prompts, max_tokens=10, **kw):
    """Submit every prompt at once; (finish reason, tokens) per request."""
    outs = []
    for p in prompts:
        done, ids = threading.Event(), []

        def sink(t, ids=ids, done=done):
            done.set() if t is None else ids.append(t)

        cls = Request if isinstance(sched, BatchScheduler) else JRequest
        req = cls(prompt_ids=list(p), max_tokens=max_tokens, sink=sink,
                  **{"temperature": 0.0, **kw})
        sched.submit(req)
        outs.append((req, ids, done))
    for _, _, done in outs:
        assert done.wait(timeout=300), "request did not finish"
    return [(r.finish_reason, ids) for r, ids, _ in outs]


def _port(models, **hp):
    s = BatchScheduler(models["model"], models["cfg"],
                       HyperParams(max_slots=2, batch_size=8, **hp),
                       device="cpu")
    s.start()
    return s


def _near_tie(got, want, prompt, jengine):
    """got equals want, or first differs at a JAX top-2 gap < NEAR_TIE."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert len(got) == len(want), (got, want)
        return
    jengine.reset()
    logits = np.sort(np.asarray(jengine.prefill(list(prompt) + want[:i])))
    assert logits[-1] - logits[-2] < NEAR_TIE, (i, got, want)


@pytest.fixture(scope="module")
def jax_results(models):
    """The JAX scheduler's greedy replies (built once: it compiles)."""
    jsched = JScheduler(models["jparams"], models["jcfg"],
                        JHyperParams(max_slots=2, batch_size=8),
                        backend="xla")
    jsched.start()
    try:
        long_prompt = list(range(3, 3 + SEQ + 20))
        return dict(plain=_run(jsched, PROMPTS),
                    truncated=_run(jsched, [long_prompt], max_tokens=6),
                    long_prompt=long_prompt)
    finally:
        jsched.stop()


def test_greedy_replies_match_jax_scheduler(models, jax_results):
    """Five requests on two slots: three queue behind the first two."""
    sched = _port(models)
    try:
        got = _run(sched, PROMPTS)
    finally:
        sched.stop()
    for p, (fr, ids), (jfr, jids) in zip(PROMPTS, got, jax_results["plain"]):
        assert fr == "length" and len(ids) == 10
        _near_tie(ids, jids, p, models["jengine"])
    m = sched.metrics()
    assert m["requests_total"] == 5 and m["generated_tokens_total"] == 50


def test_truncated_prompt_matches_jax(models, jax_results):
    """A prompt longer than the cache keeps its tail (max_seq -
    max_tokens - 1 tokens), as the JAX scheduler truncates it, and the
    reply ends for capacity where the JAX one does (its check reads the
    positions after the tick's decode_horizon steps)."""
    sched = _port(models)
    try:
        (fr, ids), = _run(sched, [jax_results["long_prompt"]], max_tokens=6)
    finally:
        sched.stop()
    (jfr, jids), = jax_results["truncated"]
    assert fr == jfr == "length" and len(ids) == len(jids) == 3
    kept = jax_results["long_prompt"][-(SEQ - 6 - 1):]
    _near_tie(ids, jids, kept, models["jengine"])


def test_replies_match_lone_generate(models):
    hp = HyperParams(max_slots=2, batch_size=8)
    hp.sampler.temperature = 0.0
    engine = InferenceEngine(models["model"], models["cfg"], hp, device="cpu")
    sched = _port(models)
    try:
        got = _run(sched, PROMPTS)
    finally:
        sched.stop()
    for p, (_, ids) in zip(PROMPTS, got):
        engine.reset()
        assert ids == list(engine.generate(p, 10)), p


def test_prefix_cache_hit_gives_the_same_tokens(models):
    sched = _port(models)
    try:
        prompt = list(range(3, 30))
        first = _run(sched, [prompt])
        assert sched.metrics()["prefix_cache_hits"] == 0
        again = _run(sched, [prompt])  # the whole prefix is cached
        longer = _run(sched, [prompt + [7, 9, 11]])  # a cached prefix of it
        assert sched.metrics()["prefix_cache_hits"] == 2
    finally:
        sched.stop()
    fresh = _port(models, prefix_cache=0)
    try:
        miss = _run(fresh, [prompt + [7, 9, 11]])
    finally:
        fresh.stop()
    assert again == first
    assert longer == miss


def test_paged_pool_preempts_and_keeps_the_tokens(models):
    """A pool of 4 pages of 8 tokens cannot hold the requests at once:
    the youngest is preempted and recomputed, and every reply equals the
    dense cache's (prefill and decode kernels round alike on the CPU)."""
    dense = _port(models)
    paged = _port(models, paged_pages=4, page_size=8)
    try:
        want = _run(dense, PROMPTS[:4], max_tokens=12)
        got = _run(paged, PROMPTS[:4], max_tokens=12)
        m = paged.metrics()
    finally:
        dense.stop()
        paged.stop()
    assert m["paged_preemptions_total"] > 0
    assert m["paged_pages_total"] == 4 and m["paged_pages_free"] == 4
    assert got == want


def test_seeded_samples_reproduce(models):
    sched = _port(models)
    try:
        kw = dict(temperature=0.9, top_k=20, top_p=0.9, seed=1234)
        a = _run(sched, PROMPTS[:3], **kw)
        b = _run(sched, PROMPTS[2:3] + PROMPTS[:2], **kw)
    finally:
        sched.stop()
    assert [a[2], a[0], a[1]] == b
    assert all(fr == "length" for fr, _ in a)


def test_step_failure_ends_requests_in_error_and_keeps_serving(models):
    sched = _port(models)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sched, "_prefill_tick",
                       lambda: (_ for _ in ()).throw(RuntimeError("boom")))
            (fr, ids), = _run(sched, [[1, 2, 3]])
        assert fr == "error" and ids == []
        (fr, ids), = _run(sched, [[1, 2, 3]])
        assert fr == "length" and len(ids) == 10
    finally:
        sched.stop()


def _sampler_inputs(seed):
    rng = np.random.default_rng(seed)
    S, V = 5, 300
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    recent = rng.integers(-1, 256, (S, 16)).astype(np.int32)
    return dict(
        logits=logits, recent=recent,
        temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.5], np.float32),
        top_k=np.array([40, 0, 5, 64, 1], np.int32),
        top_p=np.array([0.95, 0.9, 1.0, 0.5, 0.95], np.float32),
        pen_rep=np.array([1.0, 1.3, 1.1, 1.0, 0.8], np.float32),
        pen_freq=np.array([0.0, 0.2, 0.0, 0.5, 0.1], np.float32),
        pen_pres=np.array([0.0, 0.1, 0.3, 0.0, 0.2], np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_sampler_matches_jax(seed):
    d = _sampler_inputs(seed)
    S = d["logits"].shape[0]
    jstate = JPenaltyState(jnp.asarray(d["recent"]),
                           jnp.full(S, 16, jnp.int32))
    want = np.asarray(jsample_dist_batched(
        jnp.asarray(d["logits"]), jnp.asarray(d["temperature"]),
        jnp.asarray(d["top_k"]), jnp.asarray(d["top_p"]), state=jstate,
        penalty_repeat=jnp.asarray(d["pen_rep"]),
        penalty_freq=jnp.asarray(d["pen_freq"]),
        penalty_present=jnp.asarray(d["pen_pres"]), vocab_size=290))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    state = PenaltyState(t["recent"], torch.full((S,), 16, dtype=torch.int32))
    got = sample_dist_batched(t["logits"], t["temperature"], t["top_k"],
                              t["top_p"], state, t["pen_rep"], t["pen_freq"],
                              t["pen_pres"], vocab_size=290).numpy()
    # the same f32 chain; softmax and cumulative sums in another order
    np.testing.assert_allclose(got, want, atol=1e-6)
    # greedy rows draw their argmax (a one-hot distribution); sampled
    # rows draw from their own stream, reproducibly
    gens = DrawState.create(S, "cpu", range(S))
    a = sample_logits_batched(t["logits"], t["temperature"], t["top_k"],
                              t["top_p"], gens, state, t["pen_rep"],
                              t["pen_freq"], t["pen_pres"], vocab_size=290)
    gens = DrawState.create(S, "cpu", range(S))
    b = sample_logits_batched(t["logits"], t["temperature"], t["top_k"],
                              t["top_p"], gens, state, t["pen_rep"],
                              t["pen_freq"], t["pen_pres"], vocab_size=290)
    assert torch.equal(a, b)
    assert int(a[0]) == int(np.argmax(want[0]))
    assert all(want[i, int(a[i])] > 0 for i in range(S))


def _stepped(sched, prompts, max_tokens=12, **kw):
    """Submit every prompt, then drive step() until all finish (the same
    trace for either package); (finish reason, tokens) per request."""
    outs = []
    for p in prompts:
        ids, done = [], []
        cls = Request if isinstance(sched, BatchScheduler) else JRequest
        req = cls(prompt_ids=list(p), max_tokens=max_tokens,
                  sink=lambda t, ids=ids, done=done: done.append(1)
                  if t is None else ids.append(t),
                  **{"temperature": 0.0, **kw})
        sched.submit(req)
        outs.append((req, ids, done))
    for _ in range(3000):
        if all(done for _, _, done in outs):
            break
        sched.step()
    assert all(done for _, _, done in outs), "requests did not finish"
    return [(r.finish_reason, ids) for r, ids, _ in outs]


POOLS = {"dense": {}, "paged": dict(paged_pages=4, page_size=8)}


@pytest.fixture(scope="module")
def jax_stepped(models):
    """A JAX scheduler a cache kind (built once: it compiles), no prefix
    cache, so runs after the first keep its timing."""
    return {kind: JScheduler(models["jparams"], models["jcfg"], JHyperParams(
        max_slots=2, batch_size=8, prefix_cache=0, **pool), backend="xla")
        for kind, pool in POOLS.items()}


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_double_buffered_ticks_match_jax(models, jax_stepped, kind,
                                         double_buffer):
    """The port's double-buffered plain ticks, driven by step(), against
    the JAX scheduler's with double_buffer off and on: the same greedy
    replies (near-tie rule) on the dense cache and on a pool of 4 pages
    that preempts; with JAX's default (on), the same paged_slow_ticks."""
    sched = BatchScheduler(models["model"], models["cfg"], HyperParams(
        max_slots=2, batch_size=8, prefix_cache=0, **POOLS[kind]), "cpu")
    got = _stepped(sched, PROMPTS[:4])
    jsched = jax_stepped[kind]
    jsched.double_buffer = double_buffer
    slow0 = jsched.n_pool_slow_ticks
    want = _stepped(jsched, PROMPTS[:4])
    for p, (fr, ids), (jfr, jids) in zip(PROMPTS, got, want):
        assert fr == jfr == "length" and len(ids) == 12
        _near_tie(ids, jids, p, models["jengine"])
    if kind == "paged":
        m = sched.metrics()
        assert m["paged_preemptions_total"] > 0
        if double_buffer:
            assert (m["paged_slow_ticks"]
                    == jsched.n_pool_slow_ticks - slow0 > 0)


def test_reused_slot_gets_none_of_the_old_tokens(models):
    """A request that finishes in tick N frees its slot while tick N + 1,
    dispatched before N's drain, still runs it; the next request takes
    the slot before N + 1's drain. Its reply is its reply alone (a lone
    scheduler's), and the old request gets no token past its end."""
    first, second = [1, 4, 9], [7, 8, 2, 6]
    lone = BatchScheduler(models["model"], models["cfg"], HyperParams(
        max_slots=1, batch_size=8, decode_horizon=2), "cpu")
    (_, want), = _stepped(lone, [second], max_tokens=6)
    sched = BatchScheduler(models["model"], models["cfg"], HyperParams(
        max_slots=1, batch_size=8, decode_horizon=2), "cpu")
    seen, outs = [], []
    for p, n in ((first, 4), (second, 6)):
        ids = []
        req = Request(prompt_ids=p, max_tokens=n, temperature=0.0,
                      sink=lambda t, ids=ids: ids.append(t))
        sched.submit(req)
        outs.append((req, ids))
    while any(ids[-1:] != [None] for _, ids in outs):
        sched.step()
        inflight = sched._inflight
        if inflight is not None and outs[0][0] in inflight[2]:
            seen.append(outs[0][0].finish_reason)
    assert "length" in seen  # N + 1 ran the finished request
    (r1, ids1), (r2, ids2) = outs
    assert ids1[:-1] == [t for t in ids1 if t is not None]
    assert len(ids1) == 5 and r1.finish_reason == "length"
    assert ids2[:-1] == want
