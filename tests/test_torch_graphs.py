"""The replayed decode steps (engine/graphs.py) on the CPU, where the
runner runs every step's body eagerly and never builds a graph.

Each path that replays a step on the card runs its body here through the
runner, and is held
  - against the JAX package on a tiny synthetic workspace: decode_scan
    against JAX engine/loops.py::decode_scan, greedy generate against the
    JAX engine's, chain_spec_scan against JAX's (greedy tokens equal, or
    first differing where the JAX top-2 logit gap is < 0.5, the
    reference's near-tie rule: the JAX CPU route dequantizes in bf16,
    the port in f32);
  - against its eager twin, the Python loop over eager forwards the port
    ran before (decode_scan_eager; the loops of the engine's block, the
    scheduler's tick and the chain step below): the same tokens,
    logprobs and draws, and the cache (k, v, scales, mask, pos) and the
    penalty window bit for bit.
The runner's own logic (a capture error propagates, the launch-count
bookkeeping) runs here with torch.cuda's graph calls stubbed.
"""

import contextlib
import gc
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.engine.loops import decode_scan as jdecode_scan
from powerserve_tpu.engine.loops import prefill_step as jprefill_step
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.speculative.chain import ChainSpecEngine as JChainEngine
from powerserve_tpu.speculative.chain import (
    chain_spec_scan as jchain_spec_scan)
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.graphs import StepGraph, graphs_of
from powerserve_tpu_torch.engine.loops import decode_scan, decode_scan_eager
from powerserve_tpu_torch.engine.scheduler import (N_TOP, BatchScheduler,
                                                   Request)
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.ops import cuda_lib
from powerserve_tpu_torch.sampling.sampler import (sample_logits,
                                                   sample_logits_batched)
from powerserve_tpu_torch.speculative.chain import (ChainSpecEngine,
                                                    chain_spec_sample_scan,
                                                    chain_spec_scan,
                                                    draft_fuse,
                                                    self_draft_model)
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
NEAR_TIE = 0.5
PROMPT = [3, 17, 5, 9, 44, 12]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tiny Q8_0 workspace: JAX (cfg, params), port (cfg, model)."""
    d = make_synthetic_gguf(tmp_path_factory.mktemp("graphs"), "tiny",
                            GGMLType.Q8_0, seed=0, seq_len=SEQ)
    return jload(d / "model"), load_gguf_model(d / "model", device="cpu")


def _jengine(ws):
    jcfg, jparams = ws[0]
    jhp = JHyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    jhp.sampler.temperature = 0.0
    return JEngine(jparams, jcfg, jhp, backend="xla")


def _near_tie(got, want, prompt, jengine):
    """got equals want where both have tokens, or first differs where
    the JAX engine's teacher-forced top-2 logit gap is < NEAR_TIE."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return
    jengine.reset()
    logits = np.sort(np.asarray(jengine.prefill(list(prompt) + want[:i])))
    assert logits[-1] - logits[-2] < NEAR_TIE, (i, got, want)


def _same_cache(a: KVCache, b: KVCache) -> None:
    for name in ("k", "v", "k_scale", "v_scale", "mask", "pos"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _prefilled(model, S, lengths):
    """A cache of S slots, slot s prefilled with the first lengths[s]
    tokens of a fixed sequence (the rest of its lanes at -1)."""
    llm = model.llm
    kv = KVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size,
                        "cpu")
    T = max(lengths)
    toks = torch.arange(S * T).reshape(S, T) * 7 % 200 + 3
    pos = torch.arange(T).expand(S, T).clone()
    pos[pos >= torch.tensor(lengths)[:, None]] = -1
    model(kv, toks, pos, logits_mode="none")
    return kv, toks[:, 0] + 1


# -- decode_scan ---------------------------------------------------------------


def test_decode_scan_matches_jax(ws):
    (jcfg, jparams), (cfg, model) = ws
    llm = cfg.llm
    jkv = JKVCache.create(llm.n_layers, 1, SEQ, llm.n_kv_heads,
                          llm.head_size)
    _, jkv = jprefill_step(
        jparams, jnp.asarray([PROMPT[:-1]], jnp.int32),
        jnp.arange(len(PROMPT) - 1, dtype=jnp.int32)[None], jkv, llm, "xla")
    want, _ = jdecode_scan(jparams, jnp.asarray(PROMPT[-1:], jnp.int32), jkv,
                           llm, 10, "xla")
    kv = KVCache.create(llm.n_layers, 1, SEQ, llm.n_kv_heads, llm.head_size,
                        "cpu")
    model(kv, torch.tensor([PROMPT[:-1]]),
          torch.arange(len(PROMPT) - 1)[None], logits_mode="none")
    got = decode_scan(model, torch.tensor(PROMPT[-1:]), kv, 10)
    assert got.shape == (1, 10) and got.dtype == torch.int32
    _near_tie(got[0].tolist(), np.asarray(want)[0].tolist(), PROMPT,
              _jengine(ws))


@pytest.mark.parametrize("n_steps", [1, 6])
def test_decode_scan_matches_eager_twin(ws, n_steps):
    """Three slots at different positions: the same tokens, and the
    cache bit for bit; a second call within the step capacity reuses the
    graph entry."""
    _, (cfg, model) = ws
    a, tok = _prefilled(model, 3, [5, 9, 2])
    b = a.clone()
    got = decode_scan(model, tok, a, n_steps)
    want = decode_scan_eager(model, tok, b, n_steps)
    assert torch.equal(got, want)
    _same_cache(a, b)
    entries = dict(graphs_of(a).graphs)
    assert len(entries) == 1
    n2 = max(n_steps - 1, 1)  # the same power-of-two capacity
    got2 = decode_scan(model, got[:, -1], a, n2)
    assert torch.equal(got2, decode_scan_eager(model, want[:, -1], b, n2))
    _same_cache(a, b)
    assert graphs_of(a).graphs == entries


# -- the engine's decode block -------------------------------------------------


def _eager_block(eng, cur, slot):
    """InferenceEngine._decode_block's twin: the Python loop of eager
    steps the port ran before."""
    S = eng.n_slots
    scfg = eng.hp.sampler
    active = torch.zeros(S, dtype=torch.bool)
    active[slot] = True
    tok = torch.full((S,), cur, dtype=torch.int64)
    out = []
    for _ in range(eng.horizon):
        pos = torch.where(active, eng.kv.pos.to(torch.int64), -1)
        logits = eng.model(eng.kv, tok[:, None], pos[:, None],
                           active=active, logits_mode="last")
        tok = sample_logits(
            logits, scfg, eng.penalty, vocab_size=eng.cfg.llm.vocab_size,
            eos_id=eng.eos_id if eng.eos_id >= 0 else None,
            nl_id=eng.nl_id if eng.nl_id >= 0 else None,
            draws=eng.draws)
        eng.penalty.push(tok, active)
        out.append(tok)
    return torch.stack(out, dim=1)[slot].tolist()


def _engine(model, cfg, temperature, **sampler):
    hp = HyperParams(max_slots=2, batch_size=4, max_seq_len=SEQ,
                     decode_horizon=4)
    hp.sampler.temperature = temperature
    for key, val in sampler.items():
        setattr(hp.sampler, key, val)
    return InferenceEngine(model, cfg, hp, eos_id=2, nl_id=10, device="cpu")


@pytest.mark.parametrize("temperature,sampler", [
    (0.0, {}), (0.0, dict(penalty_repeat=1.3, penalty_freq=0.2)),
    (0.9, dict(seed=5, top_k=20, penalty_present=0.5))])
def test_generate_matches_eager_twin(ws, monkeypatch, temperature, sampler):
    """generate on slot 1 through the runner against the eager block, a
    stop mid-block included: the same tokens, draws, cache and penalty
    window."""
    _, (cfg, model) = ws
    got, want = _engine(model, cfg, temperature, **sampler), \
        _engine(model, cfg, temperature, **sampler)
    stop = lambda t: t == 2  # noqa: E731
    ids = list(got.generate(PROMPT, 11, stop_fn=stop, slot=1))
    with monkeypatch.context() as m:
        m.setattr(want, "_decode_block",
                  lambda cur, slot: _eager_block(want, cur, slot))
        twin = list(want.generate(PROMPT, 11, stop_fn=stop, slot=1))
    assert ids == twin and len(ids) >= 1
    _same_cache(got.kv, want.kv)
    assert torch.equal(got.penalty.recent, want.penalty.recent)
    assert torch.equal(got.penalty.count, want.penalty.count)


def test_generate_greedy_matches_jax(ws):
    _, (cfg, model) = ws
    prompt = [1, 5, 9, 12, 3, 7, 40, 41, 2, 8]
    jeng = _jengine(ws)
    want = list(jeng.generate(prompt, 10))
    got = list(_engine(model, cfg, 0.0).generate(prompt, 10))
    assert len(got) == 10
    _near_tie(got, want, prompt, jeng)


# -- the chain step ------------------------------------------------------------


def _eager_chain(target, draft, t_kv, d_kv, root, n_steps, k):
    """chain_spec_scan's twin: the Python loop the port ran before."""
    lanes = torch.arange(k + 1)
    tokens, counts = [], []
    for _ in range(n_steps):
        c = t_kv.pos.long()
        fed, tok = [root], root
        for j in range(k + 1):
            nxt = draft(d_kv, tok[:, None], d_kv.pos.long()[:, None],
                        logits_mode="argmax",
                        fuse_layers=draft_fuse(draft.llm)).long()
            if j < k:
                fed.append(nxt)
                tok = nxt
        fed = torch.stack(fed, dim=1)
        sampled = target(t_kv, fed, c[:, None] + lanes[None, :],
                         logits_mode="argmax_all").long()
        match = (sampled[:, :k] == fed[:, 1:]).long()
        n_acc = match.cumprod(dim=1).sum(dim=1)
        root = sampled.gather(1, n_acc[:, None])[:, 0]
        d_kv.rollback(k - n_acc)
        t_kv.rollback(k - n_acc)
        tokens.append(sampled)
        counts.append(n_acc + 1)
    return torch.stack(tokens), torch.stack(counts), root


def test_chain_spec_scan_matches_eager_twin(ws):
    """Two slots, a 1-layer self-draft, k = 3: the same tokens, counts
    and root, and both caches bit for bit."""
    _, (cfg, model) = ws
    draft = self_draft_model(model, 1)
    t1, root = _prefilled(model, 2, [6, 3])
    d1, _ = _prefilled(draft, 2, [6, 3])
    t2, d2 = t1.clone(), d1.clone()
    got = chain_spec_scan(model, draft, t1, d1, root, 5, 3)
    want = _eager_chain(model, draft, t2, d2, root, 5, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _same_cache(t1, t2)
    _same_cache(d1, d2)


def test_chain_spec_scan_matches_jax(ws):
    """The emitted stream of 6 chain steps (1-layer self-draft, k = 3)
    against JAX chain_spec_scan's from the same prefill."""
    (jcfg, jparams), (cfg, model) = ws
    jeng = JChainEngine(jparams, jcfg, self_draft_layers=1, k=3,
                        block_steps=6, max_seq=SEQ, backend="xla")
    jeng.prefill(PROMPT)
    jt, jc, *_ = jchain_spec_scan(jparams, jparams, jeng.t_kv, jeng.d_kv,
                                  jeng._root, jeng.t_llm, jeng.d_llm, 6, 3,
                                  "xla")
    jt, jc = np.asarray(jt), np.asarray(jc)
    want = [int(t) for i in range(6) for t in jt[i, :jc[i]]]
    eng = ChainSpecEngine(model, cfg, self_draft_layers=1, k=3,
                          block_steps=6, max_seq=SEQ, device="cpu")
    eng.prefill(PROMPT)
    toks, counts, _ = chain_spec_scan(eng.target, eng.draft, eng.t_kv,
                                      eng.d_kv, eng._root, 6, 3)
    got = [int(t) for i in range(6) for t in toks[i, 0, :counts[i, 0]]]
    assert len(got) >= 6
    _near_tie(got, want, PROMPT, _jengine(ws))


# -- the scheduler's tick ------------------------------------------------------


def _eager_tick(s):
    """BatchScheduler's decode tick's twin: the Python loop of eager
    steps the port ran before, over the same slot inputs. Returns the
    tick's (tokens, logprobs, top ids, top logprobs)."""
    decoding = [i for i, sl in enumerate(s.slots)
                if sl.req is not None and not sl.prefilling]
    decoding, _ = s._plain_grants(decoding)  # the tick's page grants
    greedy = s._slot_settings(decoding)
    b = {k: v.clone() for k, v in s.bufs.items()}
    tok, active, vocab = b["tok"], b["active"], s.cfg.llm.vocab_size
    outs = [], [], [], []
    for _ in range(s.horizon):
        positions = torch.where(active, s.kv.pos.long(), -1)[:, None]
        logits = s.model(s.kv, tok[:, None], positions, active=active,
                         logits_mode="last")
        tok = sample_logits_batched(
            logits, b["temp"], b["top_k"], b["top_p"],
            None if greedy else s.draws,
            state=s.penalty, penalty_repeat=b["pen"],
            penalty_freq=b["pfreq"], penalty_present=b["ppres"],
            vocab_size=vocab)
        s.penalty.push(tok, active)
        lf = logits.float()[:, :vocab]
        lse = torch.logsumexp(lf, dim=-1)
        tv, ti = torch.topk(lf, N_TOP, dim=-1)
        for o, t in zip(outs, (tok, lf.gather(1, tok[:, None])[:, 0] - lse,
                               ti, tv - lse[:, None])):
            o.append(t)
    # the tick's one fetch refreshes the scheduler's host mirror of the
    # positions, which the next tick's page grants read
    s.pos_host = s.kv.pos.tolist()
    return [torch.stack(o, dim=1) for o in outs]


REQUESTS = [dict(prompt_ids=[1, 4, 9, 11], temperature=0.0, logprobs=3),
            dict(prompt_ids=list(range(3, 20)), temperature=0.0,
                 penalty_repeat=1.4, penalty_freq=0.3),
            dict(prompt_ids=[5, 5, 5, 6], temperature=0.8, top_k=12,
                 seed=11, logprobs=2),
            dict(prompt_ids=[7, 8], temperature=0.0)]


def _decoding_scheduler(model, cfg, reqs, paged):
    hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=SEQ,
                     decode_horizon=3, paged_pages=24 if paged else 0,
                     page_size=8)
    s = BatchScheduler(model, cfg, hp, device="cpu")
    for r in reqs:
        s.submit(Request(max_tokens=40, **r))
    s._admit()
    while s._prefill_tick():
        pass
    return s


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mix", ["greedy", "sampled"])
def test_scheduler_tick_matches_eager_tick(ws, paged, mix):
    """Two ticks through the runner against the eager tick on the same
    slots (greedy, penalized, logprobs; "sampled" adds a slot that
    draws from its seeded stream): tokens, logprobs, top logprobs,
    the cache and the penalty window bit for bit."""
    _, (cfg, model) = ws
    reqs = [r for r in REQUESTS if mix == "sampled" or not r["temperature"]]
    got = _decoding_scheduler(model, cfg, reqs, paged)
    want = _decoding_scheduler(model, cfg, reqs, paged)
    for _ in range(2):
        ref = _eager_tick(want)
        got._decode_tick()
        got._drain()  # its results now: no next tick is dispatched here
        b = got.bufs
        for name, r in zip(("out_tok", "out_lp", "out_ti", "out_tlp"), ref):
            assert torch.equal(b[name], r), name
        # the eager twin delivers nothing: feed both the same next tokens
        for i, sl in enumerate(want.slots):
            if sl.req is not None:
                sl.cur_token = got.slots[i].cur_token
        _same_cache(got.kv, want.kv)
        assert torch.equal(got.penalty.recent, want.penalty.recent)
        busy = [i for i, sl in enumerate(got.slots) if sl.req is not None]
        assert [got.slots[i].cur_token for i in busy] == \
            [int(ref[0][i, -1]) for i in busy]


def _eager_spec_tick(s):
    """The greedy spec tick's twin: chain_spec_sample_scan's eager steps
    over the same slot inputs. Returns (emitted, counts, next root)."""
    decoding = [i for i, sl in enumerate(s.slots)
                if sl.req is not None and not sl.prefilling]
    H, k = s.spec_horizon, s.spec_k
    if s.pool is not None:
        decoding = s._ensure_decode_pages(decoding, H * (k + 1) + k + 1)
    greedy = s._slot_settings(decoding)
    b = s.bufs
    return chain_spec_sample_scan(s.model, s.draft, s.kv, s.d_kv,
                                  b["tok"].clone(), H, k, b["active"],
                                  None if greedy else s.draws,
                                  b["temp"], b["top_k"], b["top_p"])


@pytest.mark.parametrize("paged", [False, True])
def test_spec_tick_matches_eager_tick(ws, paged):
    """Greedy spec ticks of a 1-layer self-draft (k = 3, two steps a tick)
    through the runner against chain_spec_sample_scan's eager steps: the
    same emitted tokens, counts and roots, both caches bit for bit."""
    _, (cfg, model) = ws
    reqs = [r for r in REQUESTS if not r["temperature"]]

    def sched():
        hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=SEQ,
                         spec_k=3, spec_horizon=2,
                         paged_pages=40 if paged else 0, page_size=8)
        s = BatchScheduler(model, cfg, hp, device="cpu",
                           draft=self_draft_model(model, 1))
        for r in reqs:
            s.submit(Request(max_tokens=60, **r))
        s._admit()
        while s._prefill_tick():
            pass
        return s

    got, want = sched(), sched()
    for _ in range(2):
        emitted, counts, root = _eager_spec_tick(want)
        got._decode_tick()
        got._drain()  # its results now: no next tick is dispatched here
        b = got.bufs
        assert torch.equal(b["spec_emitted"], emitted)
        assert torch.equal(b["spec_counts"], counts)
        assert torch.equal(b["root"], root)
        for i, sl in enumerate(want.slots):
            if sl.req is not None:
                sl.cur_token = got.slots[i].cur_token
        _same_cache(got.kv, want.kv)
        _same_cache(got.d_kv, want.d_kv)
    assert got.n_spec_steps == 2 * 2 * len(reqs)
    assert len(got.graphs.graphs) == 1


def test_scheduler_serves_through_the_runner(ws):
    """Requests through the scheduler's thread (runner ticks): each
    finishes with the tokens of a lone greedy generate."""
    _, (cfg, model) = ws
    hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ,
                     decode_horizon=4)
    s = BatchScheduler(model, cfg, hp, device="cpu")
    s.start()
    try:
        outs = []
        for p in ([1, 4, 9], [5, 6, 7, 8, 9]):
            done, ids = threading.Event(), []
            s.submit(Request(prompt_ids=p, max_tokens=9, temperature=0.0,
                             sink=lambda t, ids=ids, done=done:
                             done.set() if t is None else ids.append(t)))
            outs.append((p, ids, done))
        for p, ids, done in outs:
            assert done.wait(timeout=120)
            want = list(_engine(model, cfg, 0.0).generate(p, 9))
            assert ids == want
    finally:
        s.stop()


# -- the runner itself ---------------------------------------------------------


def _no_cuda_graph(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA graph call on the CPU")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_runner_builds_no_cuda_graph_on_cpu(ws, monkeypatch):
    """Every replayed path runs on the CPU without a CUDA graph call."""
    _no_cuda_graph(monkeypatch)
    _, (cfg, model) = ws
    kv, tok = _prefilled(model, 2, [4, 4])
    for _ in range(3):
        decode_scan(model, tok, kv, 3)
    eng = _engine(model, cfg, 0.0)
    assert len(list(eng.generate(PROMPT, 9))) == 9
    s = _decoding_scheduler(model, cfg, REQUESTS, paged=True)
    for _ in range(3):
        s._decode_tick()
    spec = ChainSpecEngine(model, cfg, self_draft_layers=1, k=2,
                           block_steps=3, max_seq=SEQ, device="cpu")
    assert len(list(spec.generate(PROMPT, 8))) == 8
    assert len(list(spec.generate(PROMPT, 8))) == 8
    for g in (eng.graphs, s.graphs, graphs_of(kv), graphs_of(spec.t_kv)):
        assert g.pool is None and g.stream is None
        assert all(sg.graph is None for sg in g.graphs.values())


class _FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(monkeypatch, state):
    """torch.cuda's capture calls stubbed: `state["capturing"]` is True
    inside a capture."""
    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


def test_capture_error_propagates(monkeypatch):
    """A body that fails while captured raises out of the call: the step
    is not run eagerly instead, and no graph is kept."""
    state = {"capturing": False, "runs": 0}
    _fake_capture(monkeypatch, state)

    def body():
        state["runs"] += 1
        if state["capturing"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    g = StepGraph(body, {}, torch.device("cuda"), None, None, ())
    g()  # eager
    with pytest.raises(RuntimeError, match="capturing"):
        g()
    assert state["runs"] == 2 and g.graph is None


@pytest.mark.parametrize("fails", [False, True])
def test_capture_holds_off_garbage_collection(monkeypatch, fails):
    """No automatic garbage collection runs inside a capture (it could
    destroy a graph left in a reference cycle, which invalidates the
    capture); it is back on after the capture, a failed one too."""
    state = {"capturing": False, "enabled": []}
    _fake_capture(monkeypatch, state)

    def body():
        state["enabled"].append(gc.isenabled())
        if state["capturing"] and fails:
            raise RuntimeError("the capture failed")

    g = StepGraph(body, {}, torch.device("cuda"), None, None, ())
    assert gc.isenabled()
    g()  # eager
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            g()
    else:
        g()
        g()  # replayed: the body does not run
    assert state["enabled"] == [True, False]
    assert gc.isenabled()


def test_launch_counts_come_with_replays(monkeypatch):
    """The capture adds no launch; each replay adds the counts the
    capture recorded, so the counts read as the eager path's."""
    state = {"capturing": False, "runs": 0}
    _fake_capture(monkeypatch, state)
    monkeypatch.setattr(cuda_lib, "LAUNCHES", dict(cuda_lib.LAUNCHES))
    cuda_lib.reset_launch_counts()

    def body():
        state["runs"] += 1
        cuda_lib.LAUNCHES["qmatmul"] += 3
        cuda_lib.LAUNCHES["flash_decode"] += 1
        return "out"

    g = StepGraph(body, {}, torch.device("cuda"), None, None, ())
    for n in range(1, 5):
        assert g() == "out"
        counts = cuda_lib.launch_counts()
        assert (counts["qmatmul"], counts["flash_decode"]) == (3 * n, n)
        assert sum(counts.values()) == 4 * n
    assert state["runs"] == 2  # eager, then the capture
    assert g.graph.replays == 3
    assert g.counts == {"qmatmul": 3, "flash_decode": 1}
    assert g.capture_s > 0


def test_graphs_go_with_their_owner(ws):
    """An engine's, a scheduler's and a cache's step graphs are freed
    with their owner (no reference cycle keeps them)."""
    _, (cfg, model) = ws
    kv, tok = _prefilled(model, 1, [4])
    decode_scan(model, tok, kv, 2)
    refs = [weakref.ref(graphs_of(kv))]
    eng = _engine(model, cfg, 0.0)
    list(eng.generate(PROMPT, 5))
    refs.append(weakref.ref(eng.graphs))
    s = _decoding_scheduler(model, cfg, REQUESTS[:2], paged=False)
    s._decode_tick()
    refs.append(weakref.ref(s.graphs))
    spec = ChainSpecEngine(model, cfg, self_draft_layers=1, k=2,
                           block_steps=3, max_seq=SEQ, device="cpu")
    list(spec.generate(PROMPT, 4))
    refs.append(weakref.ref(graphs_of(spec.t_kv)))
    assert all(r() is not None for r in refs)
    del kv, eng, s, spec
    assert [r() for r in refs] == [None] * 4
