"""Sequence parallelism's compositions on the CPU: MoE models, InternVL
dirs, token trees and EAGLE heads over tp = 2 x sp = 2. One rank group
of four for the module, a ServerContext's (rank 0 this process, ranks
1-3 followers); SEQ 64 positions, 32 a rank, and every case straddles
position 32.

- MoE (tiny-moe, 4 experts, top-2, Q8_0 with an ffn of 128) under
  tp = 2 x sp = 2 and ep = 2 x sp = 2: a prefill and a 4-row chunk
  across the slices against JAX's tp_forward on the same mesh and
  against the single rank.
- A multimodal prefill whose image rows straddle the slices, against
  JAX's tp_forward(embeds=, use_embeds=) and the single-device
  VLMEngine; greedy tokens after it against VLMEngine.generate.
- A token tree's verify against JAX's single-device forward with the
  tree's visibility, then the scheduler's tree step (tree_sample_step):
  its accepted path moves entries from the second slice to the first,
  and the caches put together over tp and sp are the single rank's.
- The schedulers' tree ticks (a self-draft, a draft dir) and EAGLE's
  chain and tree against the single rank's speculating scheduler and
  JAX's plain greedy tokens; the server over the four ranks answers an
  EAGLE request, a draft dir's tree, a MoE dir and an image chat as the
  single-rank server does.

Tolerances (tests/test_torch_sp.py states them): logits within 3e-2 of
the range against JAX (its XLA route dequantizes in bf16), within 2e-2
against the port's single rank (each slice rounds p * vs at its own
running maximum, and the merged layer outputs feed the next layer's
cache quantization); layer 0's K/V bit for bit against the single rank
(the embeddings' projections), after a tree's compaction too; greedy
tokens by the near-tie rule (a stream may part from the reference only
where the reference's teacher-forced top-2 gap is < 0.5). MoE logits are
held only on the rows whose k-th and (k+1)-th router probabilities are
1% apart in every layer (tests/test_torch_tp_moe.py: a nearer pair may
route apart under the merge's roundings).
"""

import base64
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import powerserve_tpu_torch.models.llama as tllama
from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models import internvl as jivl
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.parallel import tp as jtp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.image import encode_png
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.engine.vlm import VLMEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models import internvl as ivl
from powerserve_tpu_torch.models.loader import (load_eagle_gguf,
                                                load_gguf_model)
from powerserve_tpu_torch.parallel.tp import tp_decode_scan
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.speculative.device_tree import (TreeTemplate,
                                                          tree_sample_step)
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf,
                                                  make_vlm_workspace)
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 64
JAX_REL = 3e-2
SELF_REL = 2e-2
NEAR_TIE = 0.5
IMG_ID = 250
RAW_TEMPLATE = "{% for m in messages %}{{ m['content'] }}{% endfor %}"
# prompts whose decoding crosses position 32 (the second slice's first)
PROMPTS = [list(range(40, 69)), [3, 5, 7, 9, 11]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """"model" (tiny-k Q4_K), "draft" (another seed), "eagle" (a head at
    its widths), "moe" (tiny-moe) and "vlm" (tiny-vlm)."""
    r = tmp_path_factory.mktemp("spcomp")
    make_synthetic_gguf(r, "tiny-k", GGMLType.Q4_K, seed=0, seq_len=SEQ,
                        chat_template=RAW_TEMPLATE)
    for name, make in (
            ("draft", lambda d: make_synthetic_gguf(
                d, "tiny-k", GGMLType.Q4_K, seed=7, seq_len=SEQ)),
            ("moe", lambda d: make_synthetic_gguf(
                d, "tiny-moe", GGMLType.Q8_0, seed=7, seq_len=SEQ,
                ffn=128, chat_template=RAW_TEMPLATE)),
            ("vlm", lambda d: make_vlm_workspace(
                d, "tiny-vlm", GGMLType.Q8_0, seed=0, seq_len=SEQ,
                chat_template=RAW_TEMPLATE))):
        (make(tmp_path_factory.mktemp(name)) / "model").rename(r / name)
    make_eagle_gguf(r / "eagle", "tiny-k", seed=9)
    return r


def _hp(**kw) -> HyperParams:
    return HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ,
                       prefix_cache=0, **kw)


def _serve(ctx):
    server = make_server(ctx, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers(root):
    """(the tp = 2 x sp = 2 context, its port, the single-rank context's
    port), both serving --spec-tree 2,1."""
    sp = ServerContext(root, "model", _hp(spec_tree="2,1"), device="cpu",
                       tp=2, sp=2)
    one = ServerContext(root, "model", _hp(spec_tree="2,1"), device="cpu")
    s2, s1 = _serve(sp), _serve(one)
    yield sp, s2.server_address[1], s1.server_address[1]
    for s in (s2, s1):
        s.shutdown()
        s.server_close()
    one.close()
    sp.close()


@pytest.fixture(scope="module")
def single(root):
    cfg, model = load_gguf_model(root / "model", device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return cfg, model, InferenceEngine(model, cfg, hp, device="cpu")


@pytest.fixture(scope="module")
def jax_plain(root):
    """JAX's plain greedy engine on "model" and its 10 tokens after each
    of PROMPTS."""
    jcfg, jparams = jload(root / "model")
    jhp = JHyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    jhp.sampler.temperature = 0.0
    engine = JEngine(jparams, jcfg, jhp, backend="xla")
    return engine, [list(engine.generate(list(p), 10)) for p in PROMPTS]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _near_tie(got, want, top2_gap):
    """got equals want, or first parts where top2_gap(prefix) of the
    reference's teacher-forced logits is < NEAR_TIE."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert len(got) == len(want), (got, want)
        return
    assert top2_gap(list(want[:i])) < NEAR_TIE, (i, got, want)


def _engine_gap(engine, prompt):
    def gap(prefix):
        engine.reset()
        top2 = engine.prefill(list(prompt) + prefix).topk(2).values
        return float(top2[0] - top2[1])

    return gap


def _layer0_and_bookkeeping(whole: dict, kv1: KVCache, label: str) -> None:
    """The cache put together over tp and sp against the single rank's:
    mask and pos equal, layer 0's K/V bit for bit."""
    assert torch.equal(whole["pos"], kv1.pos), label
    assert torch.equal(whole["mask"], kv1.mask), label
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(whole[name][0], getattr(kv1, name)[0]), (label,
                                                                     name)


# -- MoE -------------------------------------------------------------------

# (tp, ep) beside sp = 2
MOE_MESHES = {"tp2-sp2": (2, 1), "ep2-sp2": (1, 2)}


def _gap_spy(monkeypatch) -> list:
    """Each layer's gap between the logs of every row's k-th and
    (k+1)-th router probabilities (rank 0's: the router and its inputs
    are the same on every rank)."""
    gaps = []
    real = tllama.LlamaLayer.route

    def route(self, h, k):
        probs = torch.softmax(h.float() @ self.router.float(), dim=-1)
        top = probs.topk(k + 1, dim=-1).values.log()
        gaps.append((top[:, k - 1] - top[:, k]).numpy())
        return real(self, h, k)

    monkeypatch.setattr(tllama.LlamaLayer, "route", route)
    return gaps


@pytest.mark.parametrize("name", list(MOE_MESHES))
def test_moe_under_sp_matches_jax_and_single(root, servers, name,
                                             monkeypatch):
    """A 30-token prefill of two slots (the grouped route) and a 4-row
    chunk at 30..33 across the slices (the state mode's causal rows over
    both): each step's logits against JAX's tp_forward on {"ep", "sp":
    2, "tp"} and the single rank on the rows routed alike, and the cache
    put together: layer 0 bit for bit."""
    t, e = MOE_MESHES[name]
    group = servers[0].ranks
    cfg, tm = group.load(root / "moe", t, ep=e, sp=2)
    _, model = load_gguf_model(root / "moe", device="cpu")
    jcfg, jparams = jload(root / "moe")
    llm = cfg.llm
    S = 2
    toks = np.random.default_rng(1).integers(3, llm.vocab_size, (S, 34))
    steps = [(toks[:, :30], np.broadcast_to(np.arange(30), (S, 30))),
             (toks[:, 30:], np.broadcast_to(np.arange(30, 34), (S, 4)))]
    mesh = make_mesh({"ep": e, "sp": 2, "tp": t}, devices=jax.devices()[:4])
    jp = jtp.shard_params_tp(jparams, mesh, jcfg.llm)
    args = (llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size)
    kv2, kv1 = tm.create_cache(*args), KVCache.create(*args, "cpu")
    jkv = jtp.shard_kv_tp(JKVCache.create(*args), mesh)
    jfwd = jax.jit(lambda p, kv, tk, q: jtp.tp_forward(
        p, jcfg.llm, kv, tk, q, mesh=mesh, backend="xla",
        logits_mode="all"))
    gaps = _gap_spy(monkeypatch)
    held = 0
    for tk, pos in steps:
        a = (torch.from_numpy(tk), torch.from_numpy(pos.copy()))
        gaps.clear()
        got = tm(kv2, *a, logits_mode="all")
        far = np.min(np.stack(gaps[:llm.n_layers]), axis=0) >= 1e-2
        want = model(kv1, *a, logits_mode="all")
        jout, jkv = jfwd(jp, jkv, jnp.asarray(tk, jnp.int32),
                         jnp.asarray(pos, jnp.int32))
        rows = got.numpy().reshape(-1, got.shape[-1])
        held += int(far.sum())
        if far.any():
            assert _rel(rows[far], want.numpy().reshape(rows.shape)[far]
                        ) <= SELF_REL, name
            assert _rel(rows[far], np.asarray(jout).reshape(rows.shape)[far]
                        ) <= JAX_REL, name
    assert held >= 34  # of the 68 rows
    jax.clear_caches()
    _layer0_and_bookkeeping(kv2.gathered(), kv1, name)


# -- InternVL --------------------------------------------------------------


def test_multimodal_prefill_across_the_slices(root, servers):
    """26 text tokens, then an image's 12 rows (2 tiles and the
    thumbnail) at 26..37 across position 32, then text: the logits
    against JAX's tp_forward(embeds=, use_embeds=) on {"sp": 2, "tp": 2}
    and the single-device VLMEngine's prefill, the cache's layer 0 bit
    for bit; greedy tokens after it against VLMEngine.generate."""
    group = servers[0].ranks
    vlm = ivl.internvl_from_workspace(root / "vlm", device="cpu")
    cfg, tm = group.load(root / "vlm", 2, sp=2)
    engine = VLMEngine(vlm, HyperParams(max_seq_len=SEQ, batch_size=8),
                       device="cpu")
    img = np.random.default_rng(2).integers(0, 256, (56, 112, 3),
                                            dtype=np.uint8)
    px = torch.from_numpy(engine.pixel_values([img]))
    prompt = list(range(60, 86)) + [IMG_ID, 9, 11]
    ids = vlm.expand_image_tokens(prompt, px.shape[0])
    image = [i for i, x in enumerate(ids) if x == IMG_ID]
    assert image[0] < 32 <= image[-1]
    tok = torch.tensor([ids])
    embeds = vlm.embed_multimodal(tok, px).to(torch.bfloat16)
    pos = torch.arange(len(ids))[None]
    llm = cfg.llm
    args = (llm.n_layers, 1, SEQ, llm.n_kv_heads, llm.head_size)
    kv2, kv1 = tm.create_cache(*args), KVCache.create(*args, "cpu")
    got = tm(kv2, tok, pos, logits_mode="last", embeds=embeds)
    want = vlm.prefill_multimodal(kv1, ids, px)
    assert _rel(got, want) <= SELF_REL
    _layer0_and_bookkeeping(kv2.gathered(), kv1, "vlm prefill")
    jm = jivl.internvl_from_workspace(root / "vlm")
    jids = jnp.asarray([ids], jnp.int32)
    jemb = jm.embed_multimodal(jids, jnp.asarray(px.numpy()))
    mesh = make_mesh({"sp": 2, "tp": 2}, devices=jax.devices()[:4])
    jllm = jm.cfg.llm
    jkv = jtp.shard_kv_tp(JKVCache.create(*args), mesh)
    jout, _ = jtp.tp_forward(jtp.shard_params_tp(jm.llm_params, mesh, jllm),
                             jllm, jkv, jids,
                             jnp.asarray(pos.numpy(), jnp.int32), mesh=mesh,
                             backend="xla", embeds=jemb,
                             use_embeds=jnp.asarray([True]))
    assert _rel(got, np.asarray(jout)) <= JAX_REL
    jax.clear_caches()
    n = 8
    first = got.argmax(-1).to(torch.int32)
    mine = [int(first)] + tp_decode_scan(tm, first, kv2, n - 1)[0].tolist()
    ref = list(engine.generate(prompt, [img], n))

    def gap(prefix):
        kv = KVCache.create(*args, "cpu")
        top2 = vlm.prefill_multimodal(kv, ids + prefix, px)[0].topk(2).values
        return float(top2[0] - top2[1])

    _near_tie(mine, ref, gap)


# -- token trees -------------------------------------------------------------


def test_tree_step_moves_the_accepted_path_across_the_slices(root, servers,
                                                             single):
    """Slot 0 committed to 29, slot 1 to 10, a [2, 1, 1] tree (7 nodes
    at c + i, rope c + depth): the verify's logits against JAX's
    single-device forward with the tree's visibility (cache_positions,
    intra_mask) and against the single rank; then the scheduler's greedy
    tree step with the whole model as its self-draft, which accepts
    every level: slot 0's path (nodes at 29, 30, 32, 34) moves the node
    at 32, on the second slice, to 31, on the first. Both caches put
    together over tp and sp are the single rank's (mask, pos, layer 0
    bit for bit), and the steps emit the same tokens."""
    group = servers[0].ranks
    cfg, one, _ = single
    llm = cfg.llm
    _, tm = group.load(root / "model", 2, sp=2)
    drafts = (group.self_draft(tm, llm.n_layers),
              self_draft_model(one, llm.n_layers))
    tpl = TreeTemplate.from_widths([2, 1, 1])
    N, c = tpl.n_nodes, np.asarray([29, 10])
    S = len(c)
    rng = np.random.default_rng(4)
    toks = rng.integers(3, llm.vocab_size, (S, 29))
    pos = np.where(np.arange(29)[None, :] < c[:, None], np.arange(29), -1)
    args = (llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size)
    caches = [(tm.create_cache(*args), tm.create_cache(*args)),
              (KVCache.create(*args, "cpu"), KVCache.create(*args, "cpu"))]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    for m, d, (t_kv, d_kv) in zip((tm, one), drafts, caches):
        for mod, kv in ((m, t_kv), (d, d_kv)):
            mod(kv, t(toks), t(pos), logits_mode="none")
    vt = rng.integers(3, llm.vocab_size, (S, N))
    rope = c[:, None] + tpl.depths[None, :]
    cpos = c[:, None] + np.arange(N)[None, :]
    intra = torch.from_numpy(tpl.anc)
    got, want = (m(kv, t(vt), t(rope), cache_positions=t(cpos),
                   intra_mask=intra, logits_mode="all")
                 for m, (kv, _) in zip((tm, one), caches))
    jcfg, jparams = jload(root / "model")
    jkv = JKVCache.create(*args)
    _, jkv = jforward(jparams, jcfg.llm, jkv, jnp.asarray(toks, jnp.int32),
                      jnp.asarray(pos, jnp.int32), backend="xla",
                      logits_mode="none")
    jout, _ = jforward(jparams, jcfg.llm, jkv, jnp.asarray(vt, jnp.int32),
                       jnp.asarray(rope, jnp.int32),
                       cache_positions=jnp.asarray(cpos, jnp.int32),
                       intra_mask=jnp.asarray(tpl.anc), backend="xla",
                       logits_mode="all")
    assert _rel(got, want) <= SELF_REL
    assert _rel(got, np.asarray(jout)) <= JAX_REL
    jax.clear_caches()
    # back to c, then one step of the scheduler's tree tick on each
    root_tok = torch.as_tensor(toks[np.arange(S), c - 1])
    zero = torch.zeros(S)
    outs = []
    for m, d, (t_kv, d_kv) in zip((tm, one), drafts, caches):
        t_kv.rollback(N)
        outs.append(tree_sample_step(
            m, d, t_kv, d_kv, tpl, root_tok, torch.ones(S, dtype=torch.bool),
            None, zero, zero.long(), zero + 1))
    (emit2, count2, _), (emit1, count1, _) = outs
    assert count1.tolist()[0] == tpl.max_depth + 1  # the whole path
    assert torch.equal(emit2, emit1) and torch.equal(count2, count1)
    for kv2, kv1, label in zip(caches[0], caches[1], ("target", "draft")):
        _layer0_and_bookkeeping(kv2.gathered(), kv1, label)


def _stepwise(sched, prompts, max_tokens=10, embeds=None):
    outs, done = [[] for _ in prompts], []
    for out, p, e in zip(outs, prompts, embeds or [None] * len(prompts)):
        def sink(t, out=out):
            done.append(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=0.0, sink=sink, embeds=e))
    for _ in range(2000):
        if len(done) == len(prompts):
            break
        sched.step()
    assert len(done) == len(prompts), "requests did not finish"
    return outs


# (hyper-params, the draft: "self:N", a dir, or "eagle")
SPEC = {"tree_self": (dict(spec_tree="2,1"), "self:1"),
        "tree_draft_dir": (dict(spec_tree="2,1,1"), "draft"),
        "eagle_chain": (dict(spec_k=3), "eagle"),
        "eagle_tree": (dict(spec_tree="2,1"), "eagle")}


@pytest.mark.parametrize("case", list(SPEC))
def test_sp_speculation_gives_the_single_ranks_tokens(root, servers, single,
                                                      jax_plain, case):
    """The scheduler's speculating ticks over tp = 2 x sp = 2 (a draft
    model's tree, EAGLE's chain and tree with the head's cache whole on
    every sp rank) against the single rank's speculating scheduler and
    JAX's plain greedy tokens (near-tie rule, each by its reference's
    top-2 gap; speculation returns the target's tokens)."""
    kw, draft = SPEC[case]
    group = servers[0].ranks
    cfg, one, engine = single
    _, tm = group.load(root / "model", 2, sp=2)
    if draft == "eagle":
        _, head = load_eagle_gguf(root / "eagle", one, cfg.llm,
                                  device="cpu")
        mine = dict(eagle_head=group.eagle(tm, root / "eagle"))
        ref = dict(eagle_head=head)
    elif draft.startswith("self:"):
        n = int(draft[5:])
        mine = dict(draft=group.self_draft(tm, n))
        ref = dict(draft=self_draft_model(one, n))
    else:
        mine = dict(draft=group.load(root / draft, 2, sp=2)[1])
        ref = dict(draft=load_gguf_model(root / draft, device="cpu")[1])
    sched = BatchScheduler(tm, cfg, _hp(**kw), "cpu", **mine)
    got = _stepwise(sched, PROMPTS)
    assert sched.n_spec_steps > 0
    want = _stepwise(BatchScheduler(one, cfg, _hp(**kw), "cpu", **ref),
                     PROMPTS)
    jengine, jtoks = jax_plain

    def jax_gap(prompt):
        def gap(prefix):
            jengine.reset()
            top = np.sort(np.asarray(jengine.prefill(list(prompt) + prefix)))
            return float(top[-1] - top[-2])

        return gap

    for g, w, j, p in zip(got, want, jtoks, PROMPTS):
        _near_tie(g, w, _engine_gap(engine, p))
        _near_tie(g, j, jax_gap(p))
    sched.release()


# -- through the server ----------------------------------------------------


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
    finally:
        conn.close()
    assert out[0] == 200, out
    return out[1]


def _png_url(seed: int) -> str:
    img = np.random.default_rng(seed).integers(0, 256, (60, 100, 3),
                                               dtype=np.uint8)
    return "data:image/png;base64," + base64.b64encode(
        encode_png(img)).decode()


@pytest.mark.parametrize("model", ["model+eagle", "model+draft", "moe",
                                   "vlm"])
def test_served_over_sp_equals_the_single_rank(root, servers, model):
    """The server over four ranks (serve --tp 2 --sp 2, --spec-tree 2,1)
    answers what the single-rank server answers: an EAGLE head's tree
    ("model+<eagle dir>", the absolute path), a draft dir's tree, a MoE
    dir and an InternVL dir's image chat."""
    _, p2, p1 = servers
    if model == "vlm":
        content = [{"type": "image_url", "image_url": {"url": _png_url(3)}},
                   {"type": "text", "text": "describe the picture"}]
        body = {"model": model, "max_tokens": 8, "temperature": 0,
                "messages": [{"role": "user", "content": content}]}
        path = "/v1/chat/completions"
    else:
        name = model.replace("eagle", str(root / "eagle"))
        body = {"model": name, "max_tokens": 12, "temperature": 0,
                "prompt": "two slices of it"}
        path = "/v1/completions"
    got, want = (_post(p, path, body) for p in (p2, p1))
    for key in ("choices", "usage"):
        assert got[key] == want[key], (model, key)
    if model != "vlm":  # its decoding crosses into the second slice
        assert 20 < got["usage"]["prompt_tokens"] < 32
