"""EAGLE speculation behind the port's scheduler and server on the CPU:
the scheduler's EAGLE ticks (a chain of spec_k or a token tree, on the
dense cache and on a paged pool that preempts, WOR too) against the
plain scheduler, the prefix cache carrying the feature, seeded sampled
ticks, and "model+<eagle dir>" through the HTTP server, as
tests/test_eagle.py and tests/test_server.py hold the JAX package's.

Greedy speculation emits the plain greedy tokens; a verify of several
rows and a decode step of one round apart, so two streams may part only
where the plain engine's teacher-forced top-2 logit gap is < 0.5 (the
reference's near-tie rule).
"""

import http.client
import json
import queue
import threading

import pytest

from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.models.loader import load_eagle_gguf, load_gguf_model
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.eagle import EagleHead
from powerserve_tpu_torch.tokenizer import Tokenizer
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: F401

NEAR_TIE = 0.5
PROMPTS = [[3, 17, 5, 9], [1, 2, 3, 4, 5, 6, 7],
           [9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12, 13]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A model root: "model" (tiny Q8_0) and "eagle" (a random EAGLE-1
    head at its widths)."""
    r = tmp_path_factory.mktemp("eagle_serve")
    make_synthetic_gguf(r, "tiny", GGMLType.Q8_0, seed=0, seq_len=128)
    make_eagle_gguf(r / "eagle", "tiny", seed=9)
    return r


@pytest.fixture(scope="module")
def tiny(root):
    cfg, model = load_gguf_model(root / "model", device="cpu")
    _, head = load_eagle_gguf(root / "eagle", model, cfg.llm, device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    return cfg, model, head, InferenceEngine(model, cfg, hp, device="cpu")


def _agree(got, want, prompt, engine):
    """got equals want, or first differs at a near-tie of the plain
    engine's teacher-forced logits."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert len(got) == len(want), (got, want)
        return
    engine.reset()
    top2 = engine.prefill(list(prompt) + want[:i]).topk(2).values
    assert float(top2[0] - top2[1]) < NEAR_TIE, (i, got, want)


def _stepwise(sched, prompts, max_tokens=10, temperature=0.0, seed=None):
    """Submit every prompt, step the scheduler until all finish."""
    outs, dones = [], []
    for p in prompts:
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=temperature, seed=seed, sink=sink))
        outs.append(out)
        dones.append(done)
    for _ in range(1000):
        if all(not d.empty() for d in dones):
            break
        sched.step()
    assert all(not d.empty() for d in dones), "requests did not finish"
    return outs


def _eagle(tiny, **hp):
    cfg, model, head, _ = tiny
    return BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=128, **hp), "cpu",
        eagle_head=head)


@pytest.mark.parametrize("hp", [
    dict(spec_k=3), dict(spec_k=3, paged_pages=6, page_size=8),
    dict(spec_tree="2,1"), dict(spec_tree="2,1", paged_pages=6, page_size=8),
    dict(spec_tree="2,1", spec_wor=True)],
    ids=["chain", "chain-paged", "tree", "tree-paged", "tree-wor"])
def test_eagle_ticks_serve_the_plain_replies(tiny, hp):
    """Three requests on two slots through the EAGLE tick (greedy: each
    step a replayed graph on the card): every reply the plain
    scheduler's (near ties aside); the paged pool of 6 pages of 8
    preempts, and a preempted slot rebuilds both caches and its
    feature."""
    cfg, model, _, engine = tiny
    plain = BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=128), "cpu")
    want = _stepwise(plain, PROMPTS)
    sched = _eagle(tiny, **hp)
    got = _stepwise(sched, PROMPTS)
    for p, g, w in zip(PROMPTS, got, want):
        _agree(g, w, p, engine)
    m = sched.metrics()
    assert sched.is_eagle and m["spec_steps_total"] >= 1
    assert m["generated_tokens_total"] == 10 * len(PROMPTS)
    if "paged_pages" in hp:
        assert sched.n_preemptions >= 1
        assert m["paged_pages_free"] == hp["paged_pages"]


def test_eagle_prefix_cache_carries_the_feature(tiny):
    """A second identical request restores both prefixes and the carried
    feature from the prefix cache and emits the same tokens; an entry
    without a feature (a draft model's) is no hit for an EAGLE
    scheduler."""
    prompt = list(range(3, 43))  # 39 prefilled positions >= min 16
    sched = _eagle(tiny, spec_k=2, prefix_cache=4, prefix_cache_min=16)
    first = _stepwise(sched, [prompt], 6)[0]
    assert sched.prefix_cache.hits == 0
    entry = next(iter(sched.prefix_cache.entries.values()))
    assert set(entry) >= {"draft", "feat"}
    second = _stepwise(sched, [prompt], 6)[0]
    assert sched.prefix_cache.hits == 1 and second == first
    # the same prefix without its feature: prefilled again, not restored
    for e in sched.prefix_cache.entries.values():
        del e["feat"]
    third = _stepwise(sched, [prompt], 6)[0]
    assert third == first


@pytest.mark.parametrize("hp", [dict(spec_k=3), dict(spec_tree="2,1"),
                                dict(spec_tree="2,1", spec_wor=True)],
                         ids=["chain", "tree", "tree-wor"])
def test_eagle_sampled_tick_reproduces(tiny, hp):
    """A seeded request at temperature 0.8 next to a greedy one (the
    sampled tick's graph, each slot drawing from its own stream): the
    same seed gives the same tokens, and the greedy neighbour keeps its
    plain reply."""
    cfg, model, _, engine = tiny
    runs = []
    for _ in range(2):
        sched = _eagle(tiny, **hp)
        outs = [[], []]
        dones = [queue.Queue(), queue.Queue()]
        for i, temp in enumerate((0.8, 0.0)):
            sched.submit(Request(
                prompt_ids=PROMPTS[i], max_tokens=10, temperature=temp,
                seed=11, sink=lambda t, o=outs[i], d=dones[i]: (
                    d.put(True) if t is None else o.append(t))))
        for _ in range(1000):
            if all(not d.empty() for d in dones):
                break
            sched.step()
        runs.append(outs)
    assert runs[0] == runs[1] and len(runs[0][0]) == 10
    plain = BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=128), "cpu")
    _agree(runs[0][1], _stepwise(plain, [PROMPTS[1]])[0], PROMPTS[1], engine)


@pytest.mark.parametrize("hp", [dict(spec_k=3), dict(spec_tree="2,1")],
                         ids=["chain", "tree"])
def test_eagle_seeded_request_alone_equals_beside_seven(tiny, hp):
    """A seeded request at temperature 0.8 on an 8-slot EAGLE scheduler
    gives the same reply alone and beside seven others, greedy and
    sampled, admitted last into the last slot."""
    cfg, model, head, _ = tiny
    prompt = [6, 1, 8, 3, 4]
    seeded = dict(temperature=0.8, seed=1234)
    others = [([3, 17, 5], 0.0, None), ([8, 1, 1, 4, 6], 0.8, 5),
              ([2, 2], 1.1, None), (list(range(10, 31)), 0.0, None),
              ([9, 8, 7], 0.6, 77), ([40], 0.0, None),
              ([12, 13, 14, 15], 0.9, None)]

    def serve(reqs):
        sched = BatchScheduler(model, cfg, HyperParams(
            max_slots=8, batch_size=8, max_seq_len=128, **hp), "cpu",
            eagle_head=head)
        outs = [[] for _ in reqs]
        done = []
        for out, (p, temp, seed) in zip(outs, reqs):
            sched.submit(Request(
                prompt_ids=p, max_tokens=10, temperature=temp, seed=seed,
                sink=lambda t, o=out: done.append(1) if t is None
                else o.append(t)))
        for _ in range(1000):
            if len(done) == len(reqs):
                break
            sched.step()
        assert len(done) == len(reqs)
        return outs

    alone = serve([(prompt, *seeded.values())])[0]
    assert serve(others + [(prompt, *seeded.values())])[-1] == alone
    assert len(alone) == 10


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("spec", [dict(spec_k=3),
                                  dict(spec_tree="2,1", paged_pages=8,
                                       page_size=8, draft_head_rank=32)],
                         ids=["chain", "tree-paged-rank"])
def test_server_serves_model_plus_eagle(root, tiny, spec):
    """"model+eagle" (a dir holding an EAGLE head): the plain model's
    greedy replies, through a speculating scheduler on main's own
    weights whose head shares main's embedding and lm_head; logprobs
    there are a 400."""
    _, _, _, engine = tiny
    ctx = ServerContext(root, "model", HyperParams(max_slots=2, batch_size=8,
                                                   **spec), device="cpu")
    srv = make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        tok = Tokenizer.from_model_dir(root / "model")
        for p in ("hello", "the fox"):
            body = {"prompt": p, "max_tokens": 8, "temperature": 0.0}
            status, base = _post(port, {**body, "model": "model"})
            assert status == 200
            status, raw = _post(port, {**body, "model": "model+eagle"})
            assert status == 200, raw
            got, want = (json.loads(r)["choices"][0]["text"]
                         for r in (raw, base))
            if got != want:
                _agree(tok.tokenize(got, add_bos=False),
                       tok.tokenize(want, add_bos=False), tok.tokenize(p),
                       engine)
        sched = ctx.models["model+eagle"].scheduler
        head = sched.draft
        assert isinstance(head, EagleHead) and sched.is_eagle
        assert sched.model is ctx.models["model"].scheduler.model
        assert head.embed is sched.model.embed
        assert head.lm_head is sched.model.lm_head
        assert (head.lm_head_lr is not None) == ("draft_head_rank" in spec)
        assert sched.n_spec_steps > 0
        status, raw = _post(port, {"model": "model+eagle", "prompt": "hi",
                                   "max_tokens": 4, "logprobs": 2})
        assert status == 400 and b"logprobs" in raw
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.close()
