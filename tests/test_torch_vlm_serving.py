"""Vision-language requests behind the port's scheduler and server, on
the CPU (tiny text model, tiny vision tower: make_vlm_workspace), as
tests/test_vlm_serving.py, test_compositions.py and test_paged_scheduler.py
hold the JAX package's.

- An embed request whose rows are the embedding table's own rows is a
  plain request in disguise: its greedy tokens must equal the plain
  request's exactly, on the dense cache, on a paged pool that preempts,
  with a chain or a tree of a self-draft, and with an EAGLE head.
- Over HTTP (http.client): a chat request with a PNG data URI answers
  alone what it answers batched with text requests, and what VLMEngine
  generates (near-tie rule: the engine prefills the whole prompt in one
  forward, the scheduler in chunks and the last token by a decode step);
  its images are encoded on the scheduler thread; a corrupt JPEG, WebP,
  a URL that is not data:, a trailing image token and an InternVL
  config.json without its weights get a 400;
  "model+self:1" answers as "model"; an EAGLE head on the VLM gets a
  400. A malformed PNG, one of more pixels than MAX_PIXELS and image
  data that inflates past its IHDR get a 400 and the next image a 200;
  an image worker killed mid-request fails that request and is
  replaced; a worker slower than its timeout is killed and the image
  refused.
- LocalServer.chat with an image runs from a script with no
  `if __name__ == "__main__":` guard, which runs once (the image workers
  import nothing of it).
"""

import base64
import http.client
import json
import os
import queue
import signal
import struct
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.image import MAX_PIXELS, encode_png
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.engine.vlm import VLMEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models import internvl as ivl
from powerserve_tpu_torch.models.loader import (load_eagle_gguf,
                                                load_gguf_model)
from powerserve_tpu_torch.serving.image_workers import ImageWorkers
from powerserve_tpu_torch.serving.local import LocalServer
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf,
                                                  make_vlm_workspace)
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
NEAR_TIE = 0.5
IMG_ID = 250
# contents only: a prompt may end in the image-context token
RAW_TEMPLATE = "{% for m in messages %}{{ m['content'] }}{% endfor %}"
PROMPTS = [[1, 17, 5, 9, 3, 40, 41, 42, 7, 8], [1, 2, 3, 4, 5, 6, 7],
           [9, 8, 7, 6, 5, 4, 3, 2, 1, 11, 12, 13]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A model root: "model" (the tiny VLM, a raw chat template),
    "eagle" (a random EAGLE head at the text model's widths), "wide/model"
    (a text model of the VLM's vocab at twice its dim)."""
    r = make_vlm_workspace(tmp_path_factory.mktemp("vlm_serve"), "tiny-vlm",
                           GGMLType.Q8_0, seed=0, seq_len=128,
                           chat_template=RAW_TEMPLATE)
    make_eagle_gguf(r / "eagle", "tiny", seed=9)
    make_synthetic_gguf(r / "wide", "tiny", GGMLType.Q8_0, seed=3,
                        seq_len=128, dim=128)
    return r


@pytest.fixture(scope="module")
def vlm(root):
    return ivl.internvl_from_workspace(root / "model", device="cpu")


def _stepwise(sched, prompts, embeds=None, max_tokens=10, reqs=None):
    """Submit every prompt (with its rows; each Request into reqs), step
    until all finish."""
    outs, dones = [], []
    for k, p in enumerate(prompts):
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        req = sched.submit(Request(
            prompt_ids=list(p), max_tokens=max_tokens, temperature=0.0,
            sink=sink, embeds=None if embeds is None else embeds[k]))
        if reqs is not None:
            reqs.append(req)
        outs.append(out)
        dones.append(done)
    for _ in range(1000):
        if all(not d.empty() for d in dones):
            break
        sched.step()
    assert all(not d.empty() for d in dones), "requests did not finish"
    sched.stop()
    return outs


def _table_rows(model, prompts):
    """Each prompt's embedding-table rows, bf16 (the overlay's dtype)."""
    return [model.embed.lookup(torch.tensor(p)).to(torch.bfloat16)
            for p in prompts]


@pytest.mark.parametrize("hp,draft", [
    (dict(), None), (dict(paged_pages=5, page_size=8), None),
    (dict(spec_k=2), "self"), (dict(spec_tree="2,1"), "self"),
    (dict(spec_tree="2,1", paged_pages=8, page_size=8), "self"),
    (dict(spec_k=2), "eagle"), (dict(spec_k=2, paged_pages=8, page_size=8),
                                "eagle")],
    ids=["dense", "paged-preempt", "chain", "tree", "tree-paged", "eagle",
         "eagle-paged"])
def test_embed_requests_equal_plain_requests(root, vlm, hp, draft):
    model, cfg = vlm.llm, vlm.cfg
    kw = dict(max_slots=2, batch_size=8, max_seq_len=64, prefix_cache=0,
              **hp)
    extra = {}
    if draft == "self":
        extra = dict(draft=self_draft_model(model, 1))
    elif draft == "eagle":
        extra = dict(eagle_head=load_eagle_gguf(root / "eagle", model,
                                                cfg.llm, device="cpu")[1])
    want = _stepwise(BatchScheduler(model, cfg, HyperParams(**kw), "cpu",
                                    **extra), PROMPTS)
    sched = BatchScheduler(model, cfg, HyperParams(**kw), "cpu", **extra)
    # the first two prompts with rows, the last plain, batched
    rows = _table_rows(model, PROMPTS)
    rows[2] = None
    reqs = []
    got = _stepwise(sched, PROMPTS, rows, reqs=reqs)
    assert got == want
    if "paged_pages" in hp and draft is None:
        # an embed request was preempted: its rows grew with its prompt
        assert sched.n_preemptions >= 1
        grown = [r for r, p in zip(reqs[:2], PROMPTS)
                 if len(r.prompt_ids) > len(p)]
        assert grown and all(r.embeds.shape[0] == len(r.prompt_ids)
                             for r in grown)


def test_embed_requests_are_checked_and_skip_the_prefix_cache(vlm, root):
    model, cfg = vlm.llm, vlm.cfg
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=64,
                     prefix_cache=2, prefix_cache_min=4)
    rows = _table_rows(model, PROMPTS[:1])[0]
    sched = BatchScheduler(model, cfg, hp, "cpu")
    # a row per prompt token, of the model's width
    with pytest.raises(ValueError, match=r"the prompt takes \[9, 64\]"):
        sched.submit(Request(prompt_ids=PROMPTS[0][:-1], embeds=rows))
    with pytest.raises(ValueError, match=r"the prompt takes \[10, 64\]"):
        sched.submit(Request(prompt_ids=PROMPTS[0], embeds=rows[:, :32]))
    _stepwise(sched, [PROMPTS[0]] * 2, [rows, rows])
    assert sched.prefix_cache.entries == {}
    assert sched.prefix_cache.hits == sched.prefix_cache.misses == 0
    # a draft model of another width cannot take the rows
    _, wide = load_gguf_model(root / "wide" / "model", device="cpu")
    spec = BatchScheduler(model, cfg, HyperParams(max_slots=1, batch_size=8,
                                                  max_seq_len=64, spec_k=2),
                          "cpu", draft=wide)
    with pytest.raises(ValueError, match="draft dim 128 != target dim 64"):
        spec.submit(Request(prompt_ids=PROMPTS[0], embeds=rows))


def test_trimmed_prompt_keeps_its_rows_aligned(vlm):
    """A prompt longer than the slot keeps its tail, rows and all."""
    model, cfg = vlm.llm, vlm.cfg
    long = list(np.random.default_rng(0).integers(3, 200, 40))
    hp = dict(max_slots=1, batch_size=8, max_seq_len=32, prefix_cache=0)
    want = _stepwise(BatchScheduler(model, cfg, HyperParams(**hp), "cpu"),
                     [long], max_tokens=6)
    got = _stepwise(BatchScheduler(model, cfg, HyperParams(**hp), "cpu"),
                    [long],
                    _table_rows(model, [long]), max_tokens=6)
    assert got == want


# -- over HTTP ----------------------------------------------------------------

def _png_uri(seed=0, hw=(60, 100)) -> str:
    img = np.random.default_rng(seed).integers(0, 256, hw + (3,),
                                               dtype=np.uint8)
    return ("data:image/png;base64,"
            + base64.b64encode(encode_png(img, (1, 4))).decode())


def _chat(port, text, url=None, model="model", max_tokens=6):
    content = [{"type": "text", "text": text}]
    if url is not None:
        content.insert(0, {"type": "image_url", "image_url": {"url": url}})
    body = {"model": model, "max_tokens": max_tokens, "temperature": 0,
            "messages": [{"role": "user", "content": content}]}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def served(root):
    ctx = ServerContext(root, "model", HyperParams(max_slots=3, batch_size=8,
                                                   max_seq_len=128),
                        device="cpu")
    server = make_server(ctx, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield dict(ctx=ctx, port=server.server_address[1])
    server.shutdown()
    server.server_close()
    ctx.close()


def _tokens(raw) -> tuple[str, int]:
    body = json.loads(raw)
    return (body["choices"][0]["message"]["content"],
            body["usage"]["prompt_tokens"])


def test_chat_with_an_image_alone_batched_and_on_the_scheduler_thread(
        served, vlm, monkeypatch):
    port, ctx = served["port"], served["ctx"]
    url = _png_uri()
    status, alone = _chat(port, "<IMG_CONTEXT> describe", url)
    assert status == 200
    text, n_prompt = _tokens(alone)
    tok = ctx.get("model").tokenizer
    ids = tok.tokenize("<IMG_CONTEXT> describe")
    # 60 x 100 -> a 3 x 2 grid and the thumbnail: 7 tiles of 4 tokens
    # where the placeholder was
    assert ivl.find_best_tile_grid(100, 60, 56) == (3, 2)
    assert n_prompt == len(ids) - 1 + 7 * 4
    threads = []
    orig = ivl.InternVLModel.embed_multimodal

    def spy(self, ids, px):
        threads.append(threading.current_thread().name)
        return orig(self, ids, px)

    monkeypatch.setattr(ivl.InternVLModel, "embed_multimodal", spy)
    calls = [lambda: _chat(port, "hello there", max_tokens=12),
             lambda: _chat(port, "a b c d e f", max_tokens=12),
             lambda: _chat(port, "<IMG_CONTEXT> describe", url)]
    out = [None] * 3

    def go(i):
        out[i] = calls[i]()

    ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert [s for s, _ in out] == [200, 200, 200]
    assert _tokens(out[2][1])[0] == text
    assert threads == ["batch-scheduler"]
    # the scheduler's reply against VLMEngine's greedy tokens
    assert ctx.get("model").vlm is not None
    eng = VLMEngine(vlm, HyperParams(max_seq_len=128), device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (60, 100, 3),
                                            dtype=np.uint8)
    want = list(eng.generate(ids, [img], 6))
    got = tok.tokenize(text, add_bos=False)
    if tok.to_string(want) != text:
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        full = vlm.expand_image_tokens(ids, 7)
        px = eng.pixel_values([img])
        llm = vlm.cfg.llm
        kv = KVCache.create(llm.n_layers, 1, 128, llm.n_kv_heads,
                            llm.head_size, device="cpu")
        top2 = vlm.prefill_multimodal(kv, full + want[:i], px)[0].topk(2)
        assert float(top2.values[0] - top2.values[1]) < NEAR_TIE


def test_refusals(served, root):
    port = served["port"]
    # a JPEG's first bytes (SOI, APP0) and no more: a corrupt stream
    jpeg = "data:image/jpeg;base64," + base64.b64encode(
        b"\xff\xd8\xff\xe0" + bytes(16)).decode()
    status, raw = _chat(port, "describe", jpeg)
    assert status == 400 and b"corrupt JPEG" in raw
    # WebP stays refused, naming what is taken
    webp = "data:image/webp;base64," + base64.b64encode(
        b"RIFF\x24\x00\x00\x00WEBPVP8 " + bytes(24)).decode()
    status, raw = _chat(port, "describe", webp)
    assert status == 400 and b"WebP" in raw and b"the port takes PNG" in raw
    status, raw = _chat(port, "describe", "http://example.invalid/cat.png")
    assert status == 400 and b"only data: image URIs" in raw
    status, raw = _chat(port, "describe <IMG_CONTEXT>", _png_uri())
    assert status == 400 and b"must end with text" in raw
    status, raw = _chat(port, "describe", _png_uri(), model="model+eagle")
    assert status == 400 and b"no EAGLE head" in raw
    # a draft dir of another width on the VLM
    status, raw = _chat(port, "describe", _png_uri(),
                        model="model+wide/model")
    assert status == 400 and b"draft dim 128 != target dim 64" in raw
    # an InternVL config.json without its checkpoint (HF dirs load as
    # they are: tests/test_torch_internvl.py)
    hf = root / "hf"
    hf.mkdir(exist_ok=True)
    (hf / "config.json").write_text(json.dumps(
        {"architectures": ["InternVLForConditionalGeneration"]}))
    status, raw = _chat(port, "describe", _png_uri(), model="hf")
    assert status == 400 and b"not a loadable InternVL dir" in raw


def test_self_draft_name_answers_as_the_plain_model(served):
    port = served["port"]
    url = _png_uri(3, (50, 50))
    status, plain = _chat(port, "<IMG_CONTEXT> what", url, max_tokens=8)
    status2, spec = _chat(port, "<IMG_CONTEXT> what", url,
                          model="model+self:1", max_tokens=8)
    assert status == status2 == 200
    assert _tokens(spec) == _tokens(plain)
    spec_ctx = served["ctx"].get("model+self:1")
    assert spec_ctx.vlm is not None and spec_ctx.scheduler.draft is not None


def test_local_server_chat_with_images(served, root):
    port = served["port"]
    url = _png_uri(4)
    _, raw = _chat(port, "<IMG_CONTEXT> tell", url)
    with LocalServer(root, "model", HyperParams(max_slots=2, batch_size=8,
                                                max_seq_len=128),
                     device="cpu") as srv:
        msgs = [{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": url}},
            {"type": "text", "text": "<IMG_CONTEXT> tell"}]}]
        assert srv.chat(msgs, max_tokens=6, temperature=0) == _tokens(raw)[0]
        assert "".join(srv.chat(msgs, stream=True, max_tokens=6,
                                temperature=0)) == _tokens(raw)[0]



# -- malformed and hostile images ---------------------------------------------

def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _png_of(width, height, idat, ihdr=None) -> bytes:
    """A PNG of an RGB IHDR (or the given IHDR body) and one IDAT."""
    ihdr = ihdr or struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def _uri(data: bytes) -> str:
    return "data:image/png;base64," + base64.b64encode(data).decode()


_ROW16 = b"\x00" + bytes(48)  # one unfiltered row of 16 RGB pixels
BAD_IMAGES = {
    "truncated": (_uri(encode_png(np.zeros((8, 8, 3), np.uint8))[:-20]),
                  b"truncated PNG chunk"),
    "short-data": (_uri(_png_of(16, 16, zlib.compress(_ROW16 * 8))),
                   b"truncated PNG image data"),
    "corrupt-idat": (_uri(_png_of(16, 16, b"\x78\x9c" + bytes(range(7, 99)))),
                     b"corrupt PNG image data"),
    "zero-size": (_uri(_png_of(0, 0, zlib.compress(b""))),
                  b"PNG of 0 x 0 pixels"),
    "short-ihdr": (_uri(_png_of(0, 0, zlib.compress(b""),
                                ihdr=struct.pack(">II", 16, 16) + bytes(4))),
                   b"IHDR of 12 bytes"),
    "bomb-ihdr": (_uri(_png_of(100_000, 100_000, zlib.compress(b""))),
                  f"more than {MAX_PIXELS}".encode()),
    "oversized-idat": (_uri(_png_of(16, 16, zlib.compress(bytes(10 ** 7)))),
                       b"longer than its IHDR's rows"),
    "bad-base64": ("data:image/png;base64,iVBORw0KGgo@@", b"image:"),
}


@pytest.mark.parametrize("case", list(BAD_IMAGES))
def test_bad_images_get_a_400_and_the_next_image_a_200(served, case):
    port = served["port"]
    url, why = BAD_IMAGES[case]
    status, raw = _chat(port, "<IMG_CONTEXT> describe", url)
    assert status == 400 and why in raw, raw
    status, _ = _chat(port, "<IMG_CONTEXT> describe", _png_uri(6),
                      max_tokens=2)
    assert status == 200


def test_a_killed_image_worker_fails_its_request_and_is_replaced(served):
    """Every worker stopped, a request sent, the workers killed (as the
    out-of-memory killer would): that request gets a 500, the next image
    request a 200 from new workers."""
    port, ctx = served["port"], served["ctx"]
    ctx.get("model")  # the VLM context starts the workers
    old = ctx.image_workers.pids()
    assert len(old) == 4
    for pid in old:
        os.kill(pid, signal.SIGSTOP)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=_chat(
        port, "<IMG_CONTEXT> describe", _png_uri(7))))
    t.start()
    time.sleep(0.5)
    for pid in old:
        os.kill(pid, signal.SIGKILL)
    t.join(timeout=120)
    status, raw = out["r"]
    assert status == 500 and b"image worker exited" in raw
    status, _ = _chat(port, "<IMG_CONTEXT> describe", _png_uri(7),
                      max_tokens=2)
    assert status == 200
    assert not set(ctx.image_workers.pids()) & set(old)


def test_a_slow_image_is_refused_and_its_worker_replaced():
    workers = ImageWorkers(1, timeout=0.05)
    try:
        # Paeth rows take the decoder's wavefront: far over 50 ms
        big = encode_png(np.random.default_rng(0).integers(
            0, 256, (1200, 1200, 3), dtype=np.uint8), (4,))
        first = workers.pids()
        with pytest.raises(ValueError, match="took more than 0.05 s"):
            workers.run(big, 56)
        workers.timeout = 60.0
        img = np.random.default_rng(1).integers(0, 256, (60, 100, 3),
                                                dtype=np.uint8)
        px = workers.run(encode_png(img, (1, 4)), 56)
        assert px.shape == (7, 3, 56, 56)
        assert workers.pids() != first and len(workers.pids()) == 1
    finally:
        workers.close()
    assert workers.pids() == []


def test_local_server_chat_from_a_script_without_a_main_guard(served, root,
                                                              tmp_path):
    url = _png_uri(8)
    _, raw = _chat(served["port"], "<IMG_CONTEXT> tell", url)
    marks = tmp_path / "runs"
    script = tmp_path / "chat.py"
    script.write_text(f"""import json
import sys

sys.path.insert(0, {str(REPO)!r})
with open({str(marks)!r}, "a") as f:
    f.write("run\\n")
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.serving.local import LocalServer

srv = LocalServer({str(root)!r}, "model", HyperParams(
    max_slots=2, batch_size=8, max_seq_len=128), device="cpu")
print(json.dumps(srv.chat([{{"role": "user", "content": [
    {{"type": "image_url", "image_url": {{"url": sys.argv[1]}}}},
    {{"type": "text", "text": "<IMG_CONTEXT> tell"}}]}}],
    max_tokens=6, temperature=0)))
srv.close()
""")
    done = subprocess.run([sys.executable, str(script), url], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.splitlines()[-1]) == _tokens(raw)[0]
    # the script ran once: no worker imported it
    assert marks.read_text() == "run\n"
