"""Chain speculation behind the port's scheduler, server and `run` CLI on
the CPU: the speculative paths against the plain ones on tiny synthetic
workspaces, as tests/test_paged_scheduler.py, tests/test_server.py and
tests/test_engine.py hold the JAX package's.

Greedy speculation emits the plain greedy tokens; a verify of k + 1 rows
and a decode step of one round differently, so two streams may part only
where the plain engine's teacher-forced top-2 logit gap is < 0.5 (the
reference's near-tie rule). The double-buffered chain tick is held
against the JAX scheduler's with its double_buffer off and on, and a
seeded sampled request gives the same reply alone and beside seven
others (its slot's Philox stream depends on its seed and its own draws
alone).
"""

import http.client
import json
import queue
import shutil
import threading

import pytest

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.scheduler import BatchScheduler as JScheduler
from powerserve_tpu.engine.scheduler import Request as JRequest
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.speculative.chain import (
    self_draft_config as jself_draft_config)
from powerserve_tpu_torch import run
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.tokenizer import Tokenizer
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: F401

NEAR_TIE = 0.5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A model root: "model" (tiny Q8_0), "draft" (another seed), "wide"
    (tiny-k, another vocab) and "eagle" (a random EAGLE head)."""
    r = tmp_path_factory.mktemp("spec")
    make_synthetic_gguf(r, "tiny", GGMLType.Q8_0, seed=0, seq_len=128)
    for name, preset, quant, seed in (("draft", "tiny", GGMLType.Q8_0, 7),
                                      ("wide", "tiny-k", GGMLType.Q4_K, 0)):
        w = make_synthetic_gguf(tmp_path_factory.mktemp(name), preset, quant,
                                seed=seed, seq_len=128)
        shutil.copytree(w / "model", r / name)
    make_eagle_gguf(r / "eagle", "tiny", seed=9)
    return r


@pytest.fixture(scope="module")
def tiny(root):
    cfg, model = load_gguf_model(root / "model", device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    return cfg, model, InferenceEngine(model, cfg, hp, device="cpu")


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


def _stepwise(sched, prompts, max_tokens=8, kws=None):
    """Submit every prompt (kws: each request's other fields; default
    greedy), step the scheduler until all finish."""
    outs, dones = [], []
    cls = Request if isinstance(sched, BatchScheduler) else JRequest
    for n, p in enumerate(prompts):
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        kw = kws[n] if kws else dict(temperature=0.0)
        sched.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                         sink=sink, **kw))
        outs.append(out)
        dones.append(done)
    for _ in range(1000):
        if all(not d.empty() for d in dones):
            break
        sched.step()
    assert all(not d.empty() for d in dones), "requests did not finish"
    return outs


def _plain(tiny, prompts, max_tokens=8):
    cfg, model, _ = tiny
    return _stepwise(BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=128), "cpu"), prompts,
        max_tokens)


def _spec(tiny, draft_layers=None, **hp):
    cfg, model, _ = tiny
    n = draft_layers or cfg.llm.n_layers
    return BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=128, spec_k=3, **hp), "cpu",
        draft=self_draft_model(model, n))


@pytest.mark.parametrize("pool", [{}, dict(paged_pages=16, page_size=16)])
def test_spec_matches_plain(tiny, pool):
    """Batched chain speculation (full-depth self-draft) gives the plain
    scheduler's greedy tokens, on the dense cache and on the pool."""
    prompt = [3, 17, 5, 9]
    want = _plain(tiny, [prompt])[0]
    sched = _spec(tiny, **pool)
    got = _stepwise(sched, [prompt])[0]
    _agree(got, want, prompt, tiny[2])
    m = sched.metrics()
    assert m["spec_steps_total"] >= 1
    assert m["spec_drafted_total"] == 3 * m["spec_steps_total"]
    assert m["generated_tokens_total"] == 8


CHAIN_POOLS = {"dense": {}, "paged": dict(paged_pages=16, page_size=16)}
CHAIN_PROMPTS = [[3, 17, 5, 9], [8, 1, 1, 4, 6, 2, 9, 30, 31, 7], [5, 6]]


@pytest.fixture(scope="module")
def jax_chain(root):
    """The JAX package's chain scheduler (a 1-layer self-draft, k = 3) a
    cache kind, built once: it compiles."""
    jcfg, jparams = jload(root / "model")
    return {kind: JScheduler(
        jparams, jcfg, JHyperParams(max_slots=2, batch_size=8,
                                    max_seq_len=128, prefix_cache=0, **pool),
        backend="xla", draft_params=jparams,
        draft_llm=jself_draft_config(jcfg.llm, 1), spec_k=3)
        for kind, pool in CHAIN_POOLS.items()}


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_double_buffered_chain_ticks_match_jax(tiny, jax_chain, kind,
                                               double_buffer):
    """Three requests on two slots through the port's chain tick (double-
    buffered on the dense cache, single-buffered on the pool), driven by
    step(), against the JAX scheduler's with double_buffer off and on:
    the same greedy replies (near-tie rule)."""
    cfg, model, engine = tiny
    sched = BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=128, spec_k=3, prefix_cache=0,
        **CHAIN_POOLS[kind]), "cpu", draft=self_draft_model(model, 1))
    got = _stepwise(sched, CHAIN_PROMPTS)
    jsched = jax_chain[kind]
    jsched.double_buffer = double_buffer
    want = _stepwise(jsched, CHAIN_PROMPTS)
    for p, a, b in zip(CHAIN_PROMPTS, got, want):
        assert len(a) == len(b) == 8
        _agree(a, b, p, engine)
    # the tick dispatched before the last drain ran finished slots only:
    # the next step drains it, and nothing is left in flight
    sched.step()
    assert sched._inflight is None and sched.n_active == 0


SEEDED = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1234)
OTHERS = [([3, 17, 5, 9], dict(temperature=0.0)),
          ([8, 1, 1, 4, 6], dict(temperature=0.8, seed=5)),
          ([2, 2], dict(temperature=1.1, top_k=5)),
          (list(range(10, 31)), dict(temperature=0.0)),
          ([9, 8, 7], dict(temperature=0.6, top_p=0.5, seed=77)),
          ([40], dict(temperature=0.0)),
          ([12, 13, 14, 15], dict(temperature=0.9))]


@pytest.mark.parametrize("spec", [{}, dict(spec_k=3), dict(spec_tree="2,1"),
                                  dict(spec_tree="2,1", spec_wor=True)],
                         ids=["plain", "chain", "tree", "tree-wor"])
def test_seeded_request_alone_equals_beside_seven(tiny, spec):
    """A seeded request at temperature 0.8 on an 8-slot scheduler gives
    the same reply alone and beside seven others (greedy and sampled, of
    other lengths), admitted last into the last slot: plain ticks, chain,
    tree and WOR-tree speculation (a 1-layer self-draft)."""
    cfg, model, _ = tiny
    prompt = [6, 1, 8, 3, 4]

    def serve(reqs):
        sched = BatchScheduler(model, cfg, HyperParams(
            max_slots=8, batch_size=8, max_seq_len=128, **spec), "cpu",
            draft=self_draft_model(model, 1) if spec else None)
        return _stepwise(sched, [p for p, _ in reqs], 10,
                         [kw for _, kw in reqs])

    alone = serve([(prompt, SEEDED)])[0]
    beside = serve(OTHERS + [(prompt, SEEDED)])
    assert beside[-1] == alone and len(alone) == 10
    assert serve([(prompt, dict(SEEDED, seed=1235))])[0] != alone


def test_spec_preemption(tiny):
    """A spec tick that the pool cannot hold preempts (5 pages of 8: each
    admission takes 2 pages, a tick needs pos + 2 * (k + 1) + k + 1 = 20
    positions): the outputs still match, the preemption happened and the
    pages all come back."""
    p1, p2 = list(range(3, 11)), list(range(40, 48))
    w1, w2 = _plain(tiny, [p1], 10)[0], _plain(tiny, [p2], 10)[0]
    sched = _spec(tiny, paged_pages=5, page_size=8)
    g1, g2 = _stepwise(sched, [p1, p2], 10)
    _agree(g1, w1, p1, tiny[2])
    _agree(g2, w2, p2, tiny[2])
    assert sched.n_preemptions >= 1
    assert sched.metrics()["paged_pages_free"] == 5


@pytest.mark.parametrize("pool", [{}, dict(paged_pages=16, page_size=8)])
def test_spec_prefix_cache_hit(tiny, pool):
    """The prefix cache of a speculating scheduler carries both caches'
    prefixes; the second request restores both and still emits the plain
    tokens."""
    prefix = list(range(3, 21))
    p1, p2 = prefix + [30, 31], prefix + [30, 41, 42]
    want = _plain(tiny, [p1, p2])
    sched = _spec(tiny, draft_layers=1, prefix_cache=4, prefix_cache_min=16,
                  **pool)
    g1 = _stepwise(sched, [p1])[0]
    g2 = _stepwise(sched, [p2])[0]
    _agree(g1, want[0], p1, tiny[2])
    _agree(g2, want[1], p2, tiny[2])
    assert sched.prefix_cache.hits >= 1
    assert all("draft" in e for e in sched.prefix_cache.entries.values())


@pytest.fixture(scope="module")
def server(root):
    ctxs, servers = [], []

    def start(**hp):
        ctx = ServerContext(root, "model", HyperParams(max_slots=2,
                                                       batch_size=8, **hp),
                            device="cpu")
        srv = make_server(ctx, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        ctxs.append(ctx)
        servers.append(srv)
        return srv.server_address[1], ctx

    yield start
    for srv, ctx in zip(servers, ctxs):
        srv.shutdown()
        srv.server_close()
        ctx.close()


def _post(port, body, path="/v1/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _texts(port, model, prompts, n=6):
    out = [None] * len(prompts)

    def one(i, p):
        status, raw = _post(port, {"model": model, "prompt": p,
                                   "max_tokens": n, "temperature": 0.0})
        assert status == 200, raw
        out[i] = json.loads(raw)["choices"][0]
    threads = [threading.Thread(target=one, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


PROMPTS = ["hello", "the fox", "a b c", "zzz"]


@pytest.mark.parametrize("pool", [{}, dict(paged_pages=4, page_size=8)])
def test_spec_models_serve_the_plain_replies(server, tiny, pool):
    """"model+self:N" (full depth and 1 layer) and "model+draft": four
    concurrent greedy requests each, every reply the plain model's (near
    ties aside), on the dense cache and on a pool small enough to
    preempt."""
    port, ctx = server(**pool)
    base = _texts(port, "model", PROMPTS)
    n = ctx.models["model"].scheduler.cfg.llm.n_layers
    tok = Tokenizer.from_model_dir(ctx.root / "model")
    for name in (f"model+self:{n}", "model+self:1", "model+draft"):
        got = _texts(port, name, PROMPTS)
        for p, g, b in zip(PROMPTS, got, base):
            assert g["finish_reason"] == b["finish_reason"]
            if g["text"] != b["text"]:
                ids = tok.tokenize(p)
                _agree(tok.tokenize(g["text"], add_bos=False),
                       tok.tokenize(b["text"], add_bos=False), ids, tiny[2])
        sched = ctx.models[name].scheduler
        assert sched.draft is not None
        assert sched.model is ctx.models["model"].scheduler.model
    if pool:
        preempted = sum(ctx.models[m].scheduler.n_preemptions
                        for m in ctx.models)
        assert preempted >= 1


def test_spec_model_rejects_logprobs_penalties_and_unported(server, root):
    port, _ = server()
    body = {"model": "model+self:1", "prompt": "hi", "max_tokens": 4,
            "temperature": 0.0}
    assert _post(port, {**body, "logprobs": 2})[0] == 400
    assert _post(port, {**body, "presence_penalty": 0.5})[0] == 400
    assert _post(port, {**body, "repeat_penalty": 1.2})[0] == 400
    # zero-valued penalty fields stay accepted
    assert _post(port, {**body, "frequency_penalty": 0.0})[0] == 200
    status, raw = _post(port, {**body, "model": "model+wide"})
    assert status == 400 and b"vocab" in raw
    # an EAGLE head is served, and refuses logprobs as the others do
    assert _post(port, {**body, "model": "model+eagle"})[0] == 200
    status, raw = _post(port, {**body, "model": "model+eagle",
                               "logprobs": 2})
    assert status == 400 and b"logprobs" in raw
    # speculation trees are served (their replies: test_tree_spec_models_
    # serve_the_plain_replies), and keep refusing logprobs; a tree the
    # verify cannot take is a 400 naming the limit
    tree_port, _ = server(spec_tree="2,1")
    assert _post(tree_port, body)[0] == 200
    assert _post(tree_port, {**body, "logprobs": 2})[0] == 400
    big_port, _ = server(spec_tree="3,2,2")
    status, raw = _post(big_port, body)
    assert status == 400 and b"16" in raw
    # the plain name keeps logprobs
    assert _post(port, {**body, "model": "model", "logprobs": 2})[0] == 200


@pytest.mark.parametrize("pool,wor", [({}, False),
                                      (dict(paged_pages=12, page_size=8),
                                       False), ({}, True)])
def test_tree_spec_models_serve_the_plain_replies(server, tiny, pool, wor):
    """`serve --spec-tree 2,1 [--spec-wor]`: "model+self:1" and
    "model+draft" answer four concurrent greedy requests with the plain
    model's replies (near ties aside), on the dense cache and on a pool
    small enough to preempt."""
    port, ctx = server(spec_tree="2,1", spec_wor=wor, **pool)
    base = _texts(port, "model", PROMPTS)
    tok = Tokenizer.from_model_dir(ctx.root / "model")
    for name in ("model+self:1", "model+draft"):
        got = _texts(port, name, PROMPTS)
        for p, g, b in zip(PROMPTS, got, base):
            assert g["finish_reason"] == b["finish_reason"]
            if g["text"] != b["text"]:
                _agree(tok.tokenize(g["text"], add_bos=False),
                       tok.tokenize(b["text"], add_bos=False),
                       tok.tokenize(p), tiny[2])
        sched = ctx.models[name].scheduler
        assert sched.spec_template.n_nodes == 5 and sched.n_spec_steps > 0


@pytest.mark.parametrize("draft", ["self", "separate", "workspace"])
def test_cli_speculation_equals_run(root, tiny, draft):
    base = ["-d", str(root / "model"), "-p", "hello", "-n", "12",
            "--temperature", "0", "--no-progress", "--device", "cpu"]
    plain = run.run_prompt(run.parse_args(base))
    extra = (["--self-draft-layers", "1"] if draft == "self"
             else ["--draft", str(root / "draft")])
    if draft == "workspace":  # a workspace dir resolves to its model
        extra = ["--draft", str(root)]
    spec = run.run_prompt(run.parse_args(base + extra + ["--spec-k", "3"]))
    _agree(spec.ids, plain.ids, plain.prompt_ids, tiny[2])
    assert spec.spec.emitted == len(spec.ids) == 12
    # an EAGLE head's dir selects the EAGLE chain: the plain tokens too
    eagle = run.run_prompt(run.parse_args(base + ["--draft",
                                                  str(root / "eagle")]))
    _agree(eagle.ids, plain.ids, plain.prompt_ids, tiny[2])
    with pytest.raises(SystemExit):
        run.run_prompt(run.parse_args(base + extra + ["--spec-engine",
                                                      "eagle"]))
