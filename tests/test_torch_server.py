"""The port's OpenAI-compatible server (standard-library HTTP, on
127.0.0.1:0) against the JAX package's aiohttp server (through aiohttp's
TestClient, as tests/test_server.py drives it), both on the CPU over the
same tiny synthetic workspace, plus the port's LocalServer.

Greedy replies must be equal body for body, except the ids and the
timestamps; on these prompts the two models' greedy tokens meet no near
tie (the JAX CPU route dequantizes in bf16, the port in f32).
"""

import asyncio
import http.client
import json
import threading

import pytest

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from powerserve_tpu.core.config import HyperParams as JHyperParams  # noqa: E402
from powerserve_tpu.serving.server import ServerContext as JServerContext  # noqa: E402
from powerserve_tpu.serving.server import build_app  # noqa: E402
from powerserve_tpu_torch.core.config import HyperParams  # noqa: E402
from powerserve_tpu_torch.core.gguf import GGMLType  # noqa: E402
from powerserve_tpu_torch.serving.local import LocalServer  # noqa: E402
from powerserve_tpu_torch.serving.server import (ServerContext,  # noqa: E402
                                                 StopMatcher, make_server)
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# logprobs of the raw logits: the two routes' logits differ by ~2% of
# their range on these 2-layer models (tests/test_torch_model.py)
LOGPROB_ATOL = 0.05


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    ws = make_synthetic_gguf(tmp_path_factory.mktemp("srv"), "tiny",
                             GGMLType.Q8_0, seed=0, seq_len=128)
    jctx = JServerContext(ws, "model", JHyperParams(max_slots=2, batch_size=8),
                          backend="xla")
    ctx = ServerContext(ws, "model", HyperParams(max_slots=2, batch_size=8),
                        device="cpu")
    server = make_server(ctx, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield dict(ws=ws, jctx=jctx, port=server.server_address[1])
    server.shutdown()
    server.server_close()
    ctx.close()
    for m in jctx.models.values():
        m.scheduler.stop()


def _jax(servers, method, path, body=None):
    """(status, raw body) from the JAX server."""
    async def go():
        client = TestClient(TestServer(build_app(servers["jctx"])))
        await client.start_server()
        try:
            resp = await client.request(method, path, json=body)
            return resp.status, await resp.read()
        finally:
            await client.close()

    return asyncio.run(go())


def _port(servers, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", servers["port"],
                                      timeout=300)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _both(servers, method, path, body=None):
    (js, jb), (ps, pb) = (_jax(servers, method, path, body),
                          _port(servers, method, path, body))
    assert js == ps, (jb, pb)
    return jb, pb


def _strip(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("id", "created")}


def _events(raw: bytes) -> list:
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


COMPLETIONS = [dict(prompt="hello", max_tokens=8),
               dict(prompt="The quick brown fox", max_tokens=6),
               dict(prompt=["a b", " c"], max_tokens=5, n_predict=3)]


@pytest.mark.parametrize("i", range(len(COMPLETIONS)))
def test_greedy_completion_bodies_match_jax(servers, i):
    body = {"model": "model", "temperature": 0, **COMPLETIONS[i]}
    jb, pb = _both(servers, "POST", "/v1/completions", body)
    assert _strip(json.loads(pb)) == _strip(json.loads(jb))


def test_chat_bodies_and_streams_match_jax(servers):
    body = {"model": "model", "temperature": 0, "max_tokens": 8,
            "messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hi"}]}
    jb, pb = _both(servers, "POST", "/v1/chat/completions", body)
    plain = json.loads(pb)
    assert _strip(plain) == _strip(json.loads(jb))
    jb, pb = _both(servers, "POST", "/v1/chat/completions",
                   {**body, "stream": True})
    assert pb.decode().endswith("data: [DONE]\n\n")
    ours, theirs = _events(pb), _events(jb)
    assert [_strip(e) for e in ours] == [_strip(e) for e in theirs]
    assert ours[0]["choices"][0]["delta"] == {"role": "assistant"}
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in ours)
    assert text == plain["choices"][0]["message"]["content"]
    assert ours[-1]["usage"] == plain["usage"]


def test_streamed_completion_concatenates_to_the_plain_one(servers):
    body = {"model": "model", "prompt": "hello", "max_tokens": 8,
            "temperature": 0}
    _, plain = _both(servers, "POST", "/completion", body)
    jb, pb = _both(servers, "POST", "/completions", {**body, "stream": True})
    ours = _events(pb)
    assert [_strip(e) for e in ours] == [_strip(e) for e in _events(jb)]
    assert ("".join(e["choices"][0]["text"] for e in ours)
            == json.loads(plain)["choices"][0]["text"])


def _usage_after_stop(body: dict, prompt_tokens: int, max_tokens: int):
    """A stop-string match cancels the request while the scheduler may
    still be inside a decode tick: both servers report the tokens
    generated by the time the cancel is seen, which depends on thread
    timing, so only the bounds are compared. Returns the body without
    its usage."""
    usage = body.pop("usage")
    n = usage["completion_tokens"]
    assert usage["prompt_tokens"] == prompt_tokens
    assert 1 <= n <= max_tokens
    assert usage["total_tokens"] == prompt_tokens + n
    return body


def test_stop_strings_match_jax(servers):
    body = {"model": "model", "prompt": "hello", "max_tokens": 8,
            "temperature": 0}
    _, pb = _both(servers, "POST", "/v1/completions", body)
    plain = json.loads(pb)
    full = plain["choices"][0]["text"]
    n_prompt = plain["usage"]["prompt_tokens"]
    stop = full[3:5]

    def stripped(b):
        return _usage_after_stop(_strip(b), n_prompt, body["max_tokens"])

    for stream in (False, True):
        jb, pb = _both(servers, "POST", "/v1/completions",
                       {**body, "stop": [stop, "zzz"], "stream": stream})
        if stream:
            ours, theirs = _events(pb), _events(jb)
            assert stripped(ours[-1]) == stripped(theirs[-1])
            assert [_strip(e) for e in ours[:-1]] == [_strip(e)
                                                      for e in theirs[:-1]]
            text = "".join(e["choices"][0]["text"] for e in ours)
            finish = ours[-1]["choices"][0]["finish_reason"]
        else:
            assert stripped(json.loads(pb)) == stripped(json.loads(jb))
            ch = json.loads(pb)["choices"][0]
            text, finish = ch["text"], ch["finish_reason"]
        assert text == full[:full.index(stop)] and finish == "stop"
    m = StopMatcher(["<|end|>"])
    assert m.push("ab<|e") == "ab" and m.push("nd|>cd") == "" and m.stopped


@pytest.mark.parametrize("chat", [False, True])
def test_logprobs_match_jax(servers, chat):
    """log-softmax of the raw logits (before penalties and temperature),
    the chosen token and the top alternatives."""
    if chat:
        path, body = "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "logprobs": True, "top_logprobs": 3}
    else:
        path, body = "/v1/completions", {"prompt": "hello", "logprobs": 3}
    body.update(model="model", temperature=0, max_tokens=6,
                repeat_penalty=1.3)
    jb, pb = _both(servers, "POST", path, body)
    ours = json.loads(pb)["choices"][0]["logprobs"]
    theirs = json.loads(jb)["choices"][0]["logprobs"]
    if chat:
        ours, theirs = ours["content"], theirs["content"]
        assert [c["token"] for c in ours] == [c["token"] for c in theirs]
        pairs = [(a["logprob"], b["logprob"]) for a, b in zip(ours, theirs)]
        pairs += [(a["top_logprobs"][0]["logprob"],
                   b["top_logprobs"][0]["logprob"])
                  for a, b in zip(ours, theirs)]
        assert all(len(c["top_logprobs"]) == 3 for c in ours)
    else:
        assert ours["tokens"] == theirs["tokens"]
        assert ours["text_offset"] == theirs["text_offset"]
        pairs = list(zip(ours["token_logprobs"], theirs["token_logprobs"]))
        pairs += [(max(a.values()), max(b.values()))
                  for a, b in zip(ours["top_logprobs"],
                                  theirs["top_logprobs"])]
    assert len(pairs) >= 6
    assert all(abs(a - b) < LOGPROB_ATOL for a, b in pairs), pairs


def test_models_health_and_metrics_match_jax(servers):
    _both(servers, "POST", "/v1/completions",
          {"model": "model", "prompt": "x", "max_tokens": 1})
    jb, pb = _both(servers, "GET", "/v1/models")
    assert json.loads(pb) == json.loads(jb)
    jb, pb = _both(servers, "GET", "/health")
    assert json.loads(pb) == json.loads(jb)

    def keys(raw):
        return sorted(line.split("{")[0] for line in raw.decode().splitlines()
                      if line)

    jb, pb = _both(servers, "GET", "/metrics")
    assert keys(pb) == keys(jb)


def test_unknown_and_unported_models(servers):
    status, raw = _port(servers, "POST", "/v1/completions",
                        {"model": "nope", "prompt": "x"})
    assert status == 404 and b"unknown model" in raw
    # a speculative name whose draft dir is missing
    status, raw = _port(servers, "POST", "/v1/completions",
                        {"model": "model+draft", "prompt": "x"})
    assert status == 404 and b"unknown model 'draft'" in raw
    status, raw = _port(servers, "POST", "/v1/chat/completions", {
        "model": "model", "messages": [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "x"}}]}]})
    assert status == 400 and b"only data: image URIs" in raw
    status, _ = _port(servers, "GET", "/nowhere")
    assert status == 404


def test_local_server(servers):
    body = {"model": "model", "prompt": "hello", "max_tokens": 8,
            "temperature": 0}
    _, pb = _port(servers, "POST", "/v1/completions", body)
    want = json.loads(pb)["choices"][0]["text"]
    with LocalServer(servers["ws"] / "model", "default",
                     HyperParams(max_slots=2, batch_size=8),
                     device="cpu") as srv:
        assert srv.completion("hello", max_tokens=8, temperature=0) == want
        assert "".join(srv.completion("hello", stream=True, max_tokens=8,
                                      temperature=0)) == want
        chat = srv.chat([{"role": "user", "content": "hi"}], max_tokens=4,
                        temperature=0)
        assert isinstance(chat, str)
        assert srv.metrics()["requests_total"] == 3
        with pytest.raises(TypeError):
            srv.completion("hello", bogus=1)
