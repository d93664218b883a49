"""Vision-language requests over a rank group on the CPU (gloo, tp = 2):
the tower runs on rank 0, a request's input rows go to every rank with
the forward, and the other slots' rows come from the vocab-sharded
embedding lookup (TPModel.embed), as JAX's tp_forward(embeds=,
use_embeds=) overlays them. One rank group for the module: the tp = 2
ServerContext's.

- The sharded multimodal forward against JAX's tp_forward on a 2-device
  CPU mesh (an image slot and a text slot in one batch) and against the
  port's single rank.
- The scheduler over ranks with embed requests (dense, paged, a chain of
  a self-draft) against the single rank's scheduler.
- `serve`'s ServerContext(tp=2) over HTTP: a JPEG request, the PNG of its
  decoded pixels, a text request and "model+self:1" answer what the
  single-rank server answers.

Tolerances as tests/test_torch_tp.py states them: 1e-5 of the logits'
range against the single rank (wo's and down's rows summed in two
partial sums), 3e-2 against JAX (its XLA route dequantizes in bf16);
greedy tokens equal up to a near-tie (top-2 gap < 0.5).
"""

import base64
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models import internvl as jivl
from powerserve_tpu.parallel import tp as jtp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.image import encode_png
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models import internvl as ivl
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.tools.synthetic import make_vlm_workspace
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
SELF_REL = 1e-5
JAX_REL = 3e-2
NEAR_TIE = 0.5
IMG_ID = 250
RAW_TEMPLATE = "{% for m in messages %}{{ m['content'] }}{% endfor %}"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_vlm_workspace(tmp_path_factory.mktemp("tpvlm"), "tiny-vlm",
                              GGMLType.Q8_0, seed=0, seq_len=SEQ,
                              chat_template=RAW_TEMPLATE)


@pytest.fixture(scope="module")
def vlm(root):
    return ivl.internvl_from_workspace(root / "model", device="cpu")


def _hp(**kw):
    return HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ,
                       prefix_cache=0, **kw)


def _serve(ctx):
    server = make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers(root):
    """(tp = 2 context, its port, single-rank context, its port)."""
    tp2 = ServerContext(root, "model", _hp(), device="cpu", tp=2)
    one = ServerContext(root, "model", _hp(), device="cpu")
    s2, s1 = _serve(tp2), _serve(one)
    yield tp2, s2.server_address[1], one, s1.server_address[1]
    for s in (s2, s1):
        s.shutdown()
        s.server_close()
    one.close()
    tp2.close()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_multimodal_forward_over_ranks(root, vlm, servers):
    """Slot 0 takes an image prompt's rows, slot 1 a text prompt's table
    rows: against the single rank and JAX's tp_forward overlay."""
    ranks = servers[0].ranks
    cfg, tmodel = ranks.load(root / "model", 2)
    assert tmodel.shard.model.embed.q.shape[0] == 128  # vocab-sharded
    llm = cfg.llm
    px = np.random.default_rng(3).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    ids = np.asarray([vlm.expand_image_tokens([1, 7, IMG_ID, 9, 11], 2),
                      list(range(30, 42))], np.int64)
    T = ids.shape[1]
    tok = torch.from_numpy(ids)
    # the vocab-sharded lookup over the ranks is the table's, exactly
    assert torch.equal(tmodel.embed.lookup(tok), vlm.llm.embed.lookup(tok))
    rows = vlm.embed_multimodal(tok[:1], torch.from_numpy(px))
    embeds = torch.cat([rows, vlm.llm.embed.lookup(tok[1:])]).to(
        torch.bfloat16)
    pos = torch.arange(T)[None].repeat(2, 1)
    kv2 = tmodel.create_cache(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                              llm.head_size)
    got = tmodel(kv2, tok, pos, logits_mode="last", embeds=embeds)
    kv1 = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                         llm.head_size, "cpu")
    want = vlm.llm(kv1, tok, pos, logits_mode="last", embeds=embeds)
    assert _rel(got, want) <= SELF_REL
    whole = kv2.gathered()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(whole[name], getattr(kv1, name)), name
    # JAX: its own embeddings of slot 0, the overlay inside tp_forward
    jm = jivl.internvl_from_workspace(root / "model")
    jrows = np.asarray(jm.embed_multimodal(jnp.asarray(ids[:1], jnp.int32),
                                           jnp.asarray(px)))
    jemb = np.concatenate([jrows, np.zeros_like(jrows)])
    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jllm = jm.cfg.llm
    p = jtp.shard_params_tp(jm.llm_params, mesh, jllm)
    jkv = jtp.shard_kv_tp(JKVCache.create(jllm.n_layers, 2, SEQ,
                                          jllm.n_kv_heads, jllm.head_size),
                          mesh)
    jout, _ = jax.jit(lambda p, kv, t, q, e, u: jtp.tp_forward(
        p, jllm, kv, t, q, mesh=mesh, backend="xla", embeds=e,
        use_embeds=u))(p, jkv, jnp.asarray(ids, jnp.int32),
                       jnp.asarray(pos.numpy(), jnp.int32),
                       jnp.asarray(jemb), jnp.asarray([True, False]))
    assert _rel(got, np.asarray(jout)) <= JAX_REL
    jax.clear_caches()


def _stepwise(sched, prompts, embeds, max_tokens=8):
    outs, done = [[] for _ in prompts], []
    for out, p, e in zip(outs, prompts, embeds):
        def sink(t, out=out):
            done.append(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=0.0, sink=sink, embeds=e))
    for _ in range(1000):
        if len(done) == len(prompts):
            break
        sched.step()
    assert len(done) == len(prompts), "requests did not finish"
    return outs


@pytest.mark.parametrize("kw,draft", [
    (dict(), None), (dict(paged_pages=8, page_size=8), None),
    (dict(spec_k=2), 1)], ids=["dense", "paged", "chain"])
def test_scheduler_over_ranks_takes_input_rows(root, vlm, servers, kw,
                                               draft):
    """An image request (its encoded rows) beside a text request: the
    single rank's tokens."""
    ranks = servers[0].ranks
    cfg, tmodel = ranks.load(root / "model", 2)
    px = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, 56, 56)).astype(np.float32))
    img = vlm.expand_image_tokens([1, 7, IMG_ID, 9, 11], 1)
    rows = vlm.embed_multimodal(torch.tensor([img]), px)[0].to(
        torch.bfloat16)
    prompts, embeds = [img, [5, 6, 7, 8, 9, 10]], [rows, None]
    got = _stepwise(BatchScheduler(
        tmodel, cfg, _hp(**kw), "cpu",
        draft=None if draft is None else ranks.self_draft(tmodel, draft)),
        prompts, embeds)
    want = _stepwise(BatchScheduler(
        vlm.llm, vlm.cfg, _hp(**kw), "cpu",
        draft=None if draft is None else self_draft_model(vlm.llm, draft)),
        prompts, embeds)
    assert got == want


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
        out = resp.status, json.loads(resp.read())
    finally:
        conn.close()
    assert out[0] == 200, out
    return out[1]["choices"][0]["message"]["content"], out[1]["usage"]


def test_served_images_over_ranks_equal_the_single_rank(servers):
    _, p2, _, p1 = servers
    img = np.random.default_rng(0).integers(0, 256, (60, 100, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80)
    pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    jpeg = "data:image/jpeg;base64," + base64.b64encode(
        buf.getvalue()).decode()
    png = "data:image/png;base64," + base64.b64encode(
        encode_png(pixels)).decode()
    cases = [("<IMG_CONTEXT> describe", jpeg, "model"),
             ("<IMG_CONTEXT> describe", png, "model"),
             ("hello there", None, "model"),
             ("<IMG_CONTEXT> describe", jpeg, "model+self:1")]
    replies = [(_chat(p2, *c[:2], model=c[2]), _chat(p1, *c[:2],
                                                     model=c[2]))
               for c in cases]
    for (got, want), case in zip(replies, cases):
        assert got == want, case
    # the JPEG and the PNG of its pixels answer alike
    assert replies[0][0] == replies[1][0]
    assert replies[3][0][0] == replies[0][0][0]


def test_register_takes_models_built_on_its_own_ranks(root, vlm, servers):
    """ServerContext.register over a rank group serves a model built on
    the context's ranks (a VLM too: its tower on rank 0) and refuses one
    device's model."""
    tp2, p2, _, _ = servers
    cfg, tmodel = tp2.ranks.load(root / "model", 2)
    tok = tp2.get("model").tokenizer
    tvlm = ivl.InternVLModel(vision=vlm.vision, llm=tmodel, cfg=cfg,
                             image_token_id=vlm.image_token_id,
                             tokens_per_tile=vlm.tokens_per_tile,
                             image_size=vlm.image_size)
    tp2.register("again", tmodel, cfg, tok, vlm=tvlm)
    assert _chat(p2, "hello there", model="again") == _chat(p2,
                                                             "hello there")
    with pytest.raises(ValueError, match="built on its own ranks"):
        tp2.register("one", vlm.llm, vlm.cfg, tok)


def test_served_hf_dir_over_ranks_equals_the_single_rank(root, servers):
    """An HF InternVL checkpoint dir as it is, served over the ranks (each
    rank quantizes its text shards to Q8_0 from the safetensors, the tower
    on rank 0): a JPEG chat and a text chat answer what the single-rank
    server answers on the same dir."""
    from hf_internvl import make_hf_internvl

    tp2, p2, _, p1 = servers
    make_hf_internvl(root / "hf")
    img = np.random.default_rng(1).integers(0, 256, (50, 70, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85, progressive=True)
    jpeg = "data:image/jpeg;base64," + base64.b64encode(
        buf.getvalue()).decode()
    for text, url in (("the quick fox", jpeg), ("hello there", None)):
        got = _chat(p2, text, url, model="hf")
        assert got == _chat(p1, text, url, model="hf"), text
    assert type(tp2.get("hf").vlm.llm).__name__ == "TPModel"
