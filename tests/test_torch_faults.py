"""Two faults of the port's serving path, on the CPU (tiny synthetic
models; no JAX: the JAX package has the same eviction rule and grants
pages from its own host mirror, so neither fault has a JAX counterpart).

- Eviction against a request in flight: a context is busy from the
  handler's ServerContext.use to the end of its response, so evicting
  the VLM context between its request's get and its image encode takes
  another context, and the request answers; BatchScheduler.call refuses
  on a stopped or released scheduler instead of queueing a job nothing
  runs.
- The paged tick's positions: the scheduler's host mirror (pos_host)
  equals kv.pos after every step through preemption, prefix hits and a
  session load, plain and speculative, so the pool grants pages without
  reading the card; the replies are the dense cache's.
"""

import base64
import http.client
import json
import queue
import threading

import numpy as np
import pytest

from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.image import encode_png
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.persist import load_session, save_session
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.tools.synthetic import (make_synthetic_gguf,
                                                  make_vlm_workspace)
from torch_threads import one_torch_thread  # noqa: F401

RAW_TEMPLATE = "{% for m in messages %}{{ m['content'] }}{% endfor %}"


def _chat(port, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _image_chat(text, stream=False):
    img = np.random.default_rng(0).integers(0, 256, (60, 100, 3),
                                            dtype=np.uint8)
    url = ("data:image/png;base64,"
           + base64.b64encode(encode_png(img, (1, 4))).decode())
    return {"model": "vlm/model", "max_tokens": 4, "temperature": 0,
            "stream": stream, "messages": [{"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": url}},
                {"type": "text", "text": text}]}]}


def test_eviction_spares_a_request_in_flight(tmp_path):
    """max_models=2 with a VLM and two text dirs: while the VLM request
    sits between its context's get and its image encode, two text models
    load; the eviction takes the idle text context, not the VLM's, and
    the request answers (before the fix the VLM context went, and its
    encode waited forever on the stopped scheduler). Every response path
    lowers the count again: answered, streamed and a 400."""
    root = tmp_path / "root"
    make_vlm_workspace(root / "vlm", "tiny-vlm", GGMLType.Q8_0, seed=0,
                       seq_len=128, chat_template=RAW_TEMPLATE)
    for name, seed in (("a", 1), ("b", 2)):
        make_synthetic_gguf(root / name, "tiny", GGMLType.Q8_0, seed=seed,
                            seq_len=64)
    hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=128)
    ctx = ServerContext(root, "vlm/model", hp, device="cpu", max_models=2)
    server = make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        inside, go = threading.Event(), threading.Event()
        vlm_prompt = ctx.vlm_prompt

        def held_vlm_prompt(mctx, ids, images):
            inside.set()
            assert go.wait(60)
            return vlm_prompt(mctx, ids, images)

        ctx.vlm_prompt = held_vlm_prompt
        got = queue.Queue()
        req = threading.Thread(target=lambda: got.put(
            _chat(port, _image_chat("what is it"))), daemon=True)
        req.start()
        assert inside.wait(120)
        vlm_sched = ctx.models["vlm/model"].scheduler
        ctx.get("a/model")
        ctx.get("b/model")  # past the budget: "a" goes, the VLM is busy
        go.set()
        req.join(150)
        assert not req.is_alive(), "the request hung"
        status, raw = got.get_nowait()
        assert status == 200, raw
        assert json.loads(raw)["choices"][0]["message"]["content"]
        assert set(ctx.models) == {"vlm/model", "b/model"}
        assert vlm_sched.kv is not None and vlm_sched._thread is not None
        ctx.vlm_prompt = vlm_prompt
        # a prompt that ends in the image token: a 400
        for body, want in ((_image_chat("again", stream=True), 200),
                           (_image_chat("describe <IMG_CONTEXT>"), 400)):
            assert _chat(port, body)[0] == want
        assert ctx.models["vlm/model"].in_flight == 0
        assert ctx.models["b/model"].in_flight == 0
    finally:
        server.shutdown()
        server.server_close()
        ctx.close()


def test_call_refuses_on_a_stopped_or_released_scheduler(tmp_path):
    ws = make_synthetic_gguf(tmp_path, "tiny", GGMLType.Q8_0, seed=0,
                             seq_len=64)
    cfg, model = load_gguf_model(ws / "model", device="cpu")
    sched = BatchScheduler(model, cfg, HyperParams(max_slots=1,
                                                   max_seq_len=64), "cpu")
    sched.start()
    assert sched.call(lambda: 7).result(timeout=30) == 7
    sched.stop()
    with pytest.raises(RuntimeError, match="released"):
        sched.call(lambda: 7)
    sched.start()
    assert sched.call(lambda: 8).result(timeout=30) == 8
    sched.release()
    with pytest.raises(RuntimeError, match="released"):
        sched.call(lambda: 7)
    with pytest.raises(RuntimeError, match="released"):
        sched.submit(Request(prompt_ids=[1, 2]))


BASE = list(range(3, 23))  # a 20-token preamble every request shares
PROMPTS = [BASE + [40, 41, 42, 43], BASE + [50, 51],
           BASE + [60, 61, 62, 63, 64, 65], [7, 8, 9, 10, 11, 12, 13],
           BASE + [70], [5, 6, 7, 8, 9]]


def _serve(sched, prompts, max_tokens=12, check=None):
    """Every prompt submitted at once, greedy; steps until all finish,
    calling check() after each step. Returns the replies."""
    outs, done = [[] for _ in prompts], []
    for out, p in zip(outs, prompts):
        sched.submit(Request(
            prompt_ids=list(p), max_tokens=max_tokens, temperature=0.0,
            sink=lambda t, out=out: done.append(1) if t is None
            else out.append(t)))
    for _ in range(2000):
        if len(done) == len(prompts):
            break
        sched.step()
        if check is not None:
            check()
    assert len(done) == len(prompts), "requests did not finish"
    return outs


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "chain"])
def test_paged_host_mirror_equals_kv_pos_after_every_tick(tmp_path, spec):
    """A paged pool too small for its slots (preemption), a prefix cache
    (hits on the shared preamble) and a session file loaded into it:
    after every step the host mirror is kv.pos, and the replies are a
    dense cache's without a prefix cache."""
    ws = make_synthetic_gguf(tmp_path, "tiny", GGMLType.Q8_0, seed=0,
                             seq_len=128)
    cfg, model = load_gguf_model(ws / "model", device="cpu")
    extra = dict(draft=self_draft_model(model, 1)) if spec else {}
    common = dict(max_slots=3, batch_size=8, max_seq_len=64,
                  decode_horizon=2, spec_k=2 if spec else 4)

    def make(**kw):
        return BatchScheduler(model, cfg, HyperParams(**common, **kw), "cpu",
                              **extra)

    want = _serve(make(prefix_cache=0), PROMPTS)
    # the session: the preamble pinned by a priming request, saved, loaded
    first = make(prefix_cache=4, prefix_cache_min=8)
    first.pin_prefix(BASE)
    _serve(first, [BASE + [BASE[-1]]], max_tokens=1)
    save_session(tmp_path / "s.npz", BASE, first.export_prefix(BASE))
    ids, groups = load_session(tmp_path / "s.npz")

    sched = make(prefix_cache=4, prefix_cache_min=8, paged_pages=10,
                 page_size=8)
    sched.insert_prefix(ids, groups)
    checks = []

    def check():
        assert sched.pos_host == sched.kv.pos.tolist()
        checks.append(1)

    assert _serve(sched, PROMPTS, check=check) == want
    assert sched.n_preemptions > 0 and sched.prefix_cache.hits > 0
    assert len(checks) > 10
