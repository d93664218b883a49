"""EAGLE speculation on the CPU: the port's advance(visible=), the
forward's final hidden states, eagle_forward, load_eagle_gguf, the chain
and tree scans and EagleChainEngine against the JAX package and against
plain greedy decoding, on a tiny synthetic workspace with random EAGLE
heads written as GGUFs.

Greedy speculation is lossless: its tokens are the plain greedy tokens,
but a verify of several rows and a one-row decode step round apart, so
two streams may part at a near-tie (the reference's top-2 logit gap <
0.5), as tests/test_eagle.py's scheduler tests allow by construction.
The exact-replica head (fc = [I; 0], the 1-layer target's own layer,
norm and head) computes the target's function, so it accepts every
draft.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.kv.paged import PagedKVCache as JPagedKVCache
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import fuse_layer as jfuse_layer
from powerserve_tpu.models.loader import load_eagle_gguf as jload_eagle
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.speculative.device_tree import (
    TreeTemplate as JTreeTemplate)
from powerserve_tpu.speculative.device_tree import _level_visibility
from powerserve_tpu.speculative.eagle import (
    EagleChainEngine as JEagleChainEngine)
from powerserve_tpu.speculative.eagle import eagle_forward as jeagle_forward
from powerserve_tpu_torch import run
from powerserve_tpu_torch.core.config import HyperParams, ModelConfig
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.kv.paged import PagedKVCache, PagePool
from powerserve_tpu_torch.models.loader import load_eagle_gguf, load_gguf_model
from powerserve_tpu_torch.sampling.sampler import (DrawState,
                                                   sample_dist_batched)
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.speculative.device_tree import TreeTemplate
from powerserve_tpu_torch.speculative.eagle import (EagleChainEngine,
                                                    eagle_forward,
                                                    eagle_spec_scan,
                                                    eagle_tree_spec_scan,
                                                    replica_head)
from powerserve_tpu_torch.speculative.engine import SpecStats
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
NEAR_TIE = 0.5
PROMPT = [3, 17, 5, 9, 44, 12]
# logits and features against JAX's: the JAX XLA route dequantizes in
# bf16 where the port (and the TPU kernels) dequantize in f32, and the
# orders of f32 sums differ; one head layer and a 2-layer target stay
# well inside ~2% of the range (ROADMAP, known differences)
REL = 2e-2


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tiny Q8_0 target and two random heads: "eagle" (EAGLE-1: no
    attn_norm on layer 0, an fc bias) and "eagle_norm" (layer 0 with its
    attn_norm). Each: JAX (cfg, params) / (e_llm, EagleParams), port
    (cfg, model) / (e_llm, EagleHead), and the dir."""
    d = make_synthetic_gguf(tmp_path_factory.mktemp("eagle_t"), "tiny",
                            GGMLType.Q8_0, seed=0, seq_len=SEQ)
    jcfg, jparams = jload(d / "model")
    cfg, model = load_gguf_model(d / "model", device="cpu")
    out = {"dir": d, "jax": (jcfg, jparams), "port": (cfg, model)}
    for name, seed, norm in (("eagle", 9, False), ("eagle_norm", 10, True)):
        h = make_eagle_gguf(tmp_path_factory.mktemp(name), "tiny", seed=seed,
                            input_norm=norm)
        out[name] = (h, jload_eagle(h, jparams, jcfg.llm),
                     load_eagle_gguf(h, model, cfg.llm, device="cpu"))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jengine(ws):
    jcfg, jparams = ws["jax"]
    jhp = JHyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    jhp.sampler.temperature = 0.0
    return JEngine(jparams, jcfg, jhp, backend="xla")


def _near_tie(got, want, prompt, jengine):
    """got equals want, or first differs where the JAX engine's teacher-
    forced top-2 logit gap is < NEAR_TIE."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert len(got) == len(want), (got, want)
        return
    jengine.reset()
    logits = np.sort(np.asarray(jengine.prefill(list(prompt) + want[:i])))
    assert logits[-1] - logits[-2] < NEAR_TIE, (i, got, want)


def _plain_greedy(cfg, model, prompt, n):
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return list(InferenceEngine(model, cfg, hp, device="cpu").generate(
        prompt, n))


def _replica(model) -> tuple:
    """(1-layer target, exact-replica head): fc = [I; 0] feeds the
    embedding alone, and the head's layer, norm and lm_head are the
    target's."""
    target = self_draft_model(model, 1)
    return target, replica_head(target)


# -- KV and forward -----------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_advance_visible_matches_jax(paged):
    """advance(visible=) sets visible lanes and clears invisible ones of
    active slots, counting both into pos; dropped lanes touch nothing."""
    S, T, Tq = 3, 16, 4
    if paged:
        kv = PagedKVCache.create(1, S, T, 1, 32, "cpu", n_pages=6,
                                 page_size=8)
        jkv = JPagedKVCache.create(1, S, T, 1, 32, n_pages=6, page_size=8)
    else:
        kv = KVCache.create(1, S, T, 1, 32, "cpu")
        jkv = JKVCache.create(1, S, T, 1, 32)
    rng = np.random.default_rng(0)
    for step in range(3):
        pos = rng.integers(-1, T + 2, (S, Tq))
        vis = rng.random((S, Tq)) < 0.5
        active = np.array([True, step != 1, True])
        kv.advance(torch.from_numpy(pos), torch.from_numpy(active),
                   visible=torch.from_numpy(vis))
        jkv = jkv.advance(jnp.asarray(pos, jnp.int32), jnp.asarray(active),
                          visible=jnp.asarray(vis))
        np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))
        np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    # visible=None is the old rule
    kv.advance(torch.tensor([[2, 3]] * S))
    jkv = jkv.advance(jnp.asarray([[2, 3]] * S, jnp.int32))
    np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))


@pytest.mark.parametrize("mode", ["none", "all", "argmax_all", "tree",
                                  "deferred"])
def test_final_hidden_matches_jax(ws, mode):
    """forward(return_final_hidden=True) after a 6-token prefill: the last
    layer's pre-norm hidden [S, Tq, dim] bf16 against JAX's, and the
    logits are the head over it; with the tree options, and with the
    deferred route over the paged pool (JAX: the same rows on its dense
    cache)."""
    (jcfg, jparams), (cfg, model) = ws["jax"], ws["port"]
    llm = cfg.llm
    S = 2
    toks = np.arange(12, dtype=np.int32).reshape(S, 6) * 7 % 200 + 3
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (S, 6)).copy()
    if mode == "deferred":
        kv = PagedKVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads,
                                 llm.head_size, "cpu", n_pages=8,
                                 page_size=8)
        pool = PagePool(8, S, kv.max_pages, 8)
        for s in range(S):
            pool.ensure(s, 16)
        pool.flush(kv)
    else:
        kv = KVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads,
                            llm.head_size, "cpu")
    jkv = JKVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads,
                          llm.head_size)
    vt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    vp = np.full((S, 4), 6, np.int32) + np.arange(4, dtype=np.int32)
    kw, jkw = {}, {}
    if mode == "tree":  # a [2, 1] tree: rope at depths, nodes at c + i
        tpl = JTreeTemplate.from_widths([2, 1])
        vp = np.full((S, 4), 6, np.int32) + tpl.depths[None, :4]
        cp = np.full((S, 4), 6, np.int32) + np.arange(4, dtype=np.int32)
        anc = tpl.anc[:4, :4]
        kw = dict(cache_positions=torch.from_numpy(cp).long(),
                  intra_mask=torch.from_numpy(anc))
        jkw = dict(cache_positions=jnp.asarray(cp), intra_mask=anc)
    lm = {"none": "none", "all": "all", "argmax_all": "argmax_all",
          "tree": "all", "deferred": "all"}[mode]
    for t, p, m, kws, jkws in ((toks, pos, "none", {}, {}),
                               (vt, vp, lm, kw, jkw)):
        got, hid = model(kv, torch.from_numpy(t).long(),
                         torch.from_numpy(p).long(), logits_mode=m,
                         return_final_hidden=True,
                         kv_update="deferred" if (mode == "deferred"
                                                  and m != "none")
                         else "inline", **kws)
        want, jkv, jhid = jforward(jparams, jcfg.llm, jkv, jnp.asarray(t),
                                   jnp.asarray(p), backend="xla",
                                   logits_mode=m, return_final_hidden=True,
                                   **jkws)
        assert hid.dtype == torch.bfloat16 and hid.shape == (S, t.shape[1],
                                                             llm.dim)
        assert _rel(hid.float().numpy(), np.asarray(jhid, np.float32)) < REL
    if lm == "argmax_all":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif lm == "all":
        assert _rel(got.numpy(), want) < REL
        # the logits are the head over the returned hidden state
        assert torch.equal(model.logits(hid, "all"), got)


# -- the head -----------------------------------------------------------------


def _jhead(ws, name, fuse):
    """JAX's EagleParams for head `name`, its layers fused (wqkv, wgu)
    when the fused chain is compared."""
    e_llm, ep = ws[name][1]
    if fuse:
        ep = dataclasses.replace(ep, layers=tuple(jfuse_layer(lw)
                                                  for lw in ep.layers))
    return e_llm, ep


@pytest.mark.parametrize("mode", ["all", "argmax"])
@pytest.mark.parametrize("name", ["eagle", "eagle_norm"])
@pytest.mark.parametrize("fuse", [True, False])
def test_eagle_forward_matches_jax(ws, fuse, name, mode):
    """eagle_forward over an 8-token prefill (unfused layers, the fc
    through concat2's composition) then a 3-row decode-sized batch of
    two slots (fused: the concat2 fc, the fused layer chain and head,
    against JAX's fused route in interpret mode; unfused: the plain
    composition against JAX's): logits (or greedy tokens) and
    feature_out."""
    e_llm, head = ws[name][2]
    je_llm, jep = _jhead(ws, name, fuse)
    assert head.input_norm == (name == "eagle_norm")
    S, dim = 2, e_llm.dim
    rng = np.random.default_rng(5)
    kv = KVCache.create(1, S, SEQ, e_llm.n_kv_heads, e_llm.head_size, "cpu")
    jkv = JKVCache.create(1, S, SEQ, e_llm.n_kv_heads, e_llm.head_size)
    steps = [(8, 0, "none"), (3, 8, mode)]
    for tq, p0, m in steps:
        toks = rng.integers(3, 250, (S, tq)).astype(np.int32)
        feats = rng.standard_normal((S, tq, dim)).astype(np.float32)
        pos = np.broadcast_to(p0 + np.arange(tq, dtype=np.int32),
                              (S, tq)).copy()
        got, feat = eagle_forward(head, kv, torch.from_numpy(toks).long(),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(pos).long(),
                                  logits_mode=m, fuse_layers=fuse)
        want, jfeat, jkv = jax.jit(
            lambda k_, a, b, c, m=m, f=fuse: jeagle_forward(
                jep, je_llm, k_, a, b, c,
                backend="pallas_interpret" if f else "xla", logits_mode=m,
                fuse_layers=f, fuse_head=f))(
            jkv, jnp.asarray(toks), jnp.asarray(feats), jnp.asarray(pos))
        assert feat.dtype == torch.float32
        assert _rel(feat.numpy(), jfeat) < REL
    if mode == "argmax":
        assert got.dtype == torch.int32 and got.shape == (S,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert got.shape == (S, 3, head.head_width)
        assert _rel(got.numpy(), want) < REL
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))


def test_eagle_tree_level_matches_jax(ws):
    """A [2, 1] tree's head levels: the port's key positions, intra mask
    and visible=False against JAX's vis_override of _level_visibility;
    the drafted entries stay masked and pos counts them."""
    e_llm, head = ws["eagle"][2]
    je_llm, jep = _jhead(ws, "eagle", False)
    tpl = TreeTemplate.from_widths([2, 1])
    S, dim, c = 2, e_llm.dim, 5
    rng = np.random.default_rng(6)
    kv = KVCache.create(1, S, SEQ, e_llm.n_kv_heads, e_llm.head_size, "cpu")
    jkv = JKVCache.create(1, S, SEQ, e_llm.n_kv_heads, e_llm.head_size)
    toks = rng.integers(3, 250, (S, c)).astype(np.int32)
    feats = rng.standard_normal((S, c, dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(c, dtype=np.int32), (S, c)).copy()
    eagle_forward(head, kv, torch.from_numpy(toks).long(),
                  torch.from_numpy(feats), torch.from_numpy(pos).long(),
                  logits_mode="none")
    jfwd = jax.jit(lambda k_, a, b, c, cp=None, vis=None, m="none":
                   jeagle_forward(jep, je_llm, k_, a, b, c,
                                  cache_positions=cp, vis_override=vis,
                                  backend="xla", logits_mode=m),
                   static_argnames="m")
    _, _, jkv = jfwd(jkv, jnp.asarray(toks), jnp.asarray(feats),
                     jnp.asarray(pos))
    mask0 = jkv.mask
    keys = torch.full((S, tpl.n_nodes), c) + torch.arange(tpl.n_nodes)
    for d in range(tpl.max_depth):
        lev = tpl.levels[d]
        t = rng.integers(3, 250, (S, len(lev))).astype(np.int32)
        f = rng.standard_normal((S, len(lev), dim)).astype(np.float32)
        rope = np.full((S, len(lev)), c, np.int32) + tpl.depths[lev]
        cpos = np.full((S, len(lev)), c, np.int32) + lev
        got, feat = eagle_forward(
            head, kv, torch.from_numpy(t).long(), torch.from_numpy(f),
            torch.from_numpy(rope).long(),
            cache_positions=torch.from_numpy(cpos).long(),
            intra_mask=torch.from_numpy(tpl.anc[lev]), key_positions=keys,
            visible=False, logits_mode="all")
        vis = _level_visibility(mask0, tpl.anc[lev],
                                jnp.full((S,), c, jnp.int32), SEQ)
        want, jfeat, jkv = jfwd(jkv, jnp.asarray(t), jnp.asarray(f),
                                jnp.asarray(rope), jnp.asarray(cpos), vis,
                                m="all")
        assert _rel(got.numpy(), want) < REL
        assert _rel(feat.numpy(), jfeat) < REL
    n_drafted = tpl.n_nodes - len(tpl.levels[-1])
    assert kv.pos.tolist() == [c + n_drafted] * S
    assert not kv.mask[:, c:].any() and kv.mask[:, :c].all()


@pytest.mark.parametrize("name", ["eagle", "eagle_norm"])
def test_load_eagle_gguf_matches_jax(ws, name):
    """The loaded head: JAX's geometry, its weights, input_norm from the
    presence of blk.0.attn_norm, and the target's own embedding and
    lm_head objects (no copy)."""
    e_llm, head = ws[name][2]
    je_llm, jep = ws[name][1]
    _, model = ws["port"]
    assert dataclasses.asdict(e_llm) == dataclasses.asdict(je_llm)
    assert head.llm == e_llm
    assert head.input_norm == jep.input_norm == (name == "eagle_norm")
    assert head.embed is model.embed and head.lm_head is model.lm_head
    assert head.out_norm is None and jep.out_norm is None
    np.testing.assert_array_equal(head.fc.q.numpy(), np.asarray(jep.fc.q))
    np.testing.assert_array_equal(head.fc.scales.float().numpy(),
                                  np.asarray(jep.fc.scales, np.float32))
    np.testing.assert_array_equal(head.fc_bias.numpy(),
                                  np.asarray(jep.fc_bias))
    (layer,), (jl,) = head.layers, jep.layers
    # the port fuses q|k|v and gate|up at load; JAX keeps them apart
    np.testing.assert_array_equal(
        layer.wqkv.q.numpy(),
        np.concatenate([np.asarray(w.q) for w in (jl.wq, jl.wk, jl.wv)],
                       axis=-1))
    np.testing.assert_array_equal(
        layer.wgu.q.numpy(),
        np.concatenate([np.asarray(w.q) for w in (jl.w_gate, jl.w_up)],
                       axis=-1))
    np.testing.assert_array_equal(layer.w_down.q.numpy(),
                                  np.asarray(jl.w_down.q))
    np.testing.assert_array_equal(layer.ffn_norm.numpy(),
                                  np.asarray(jl.ffn_norm))


# -- the scans and the engine -------------------------------------------------


@pytest.mark.parametrize("tree", [None, [2, 1]])
def test_exact_replica_accepts_every_draft(ws, tree):
    """The exact-replica head over the 1-layer target: the plain greedy
    tokens of that target, and every draft accepted (chain: k + 1 tokens
    a step; tree: max_depth + 1)."""
    _, model = ws["port"]
    target, head = _replica(model)
    cfg = ModelConfig(llm=target.llm)
    tpl = None if tree is None else TreeTemplate.from_widths(tree)
    stats = SpecStats()
    eng = EagleChainEngine(target, cfg, head, k=3, block_steps=4,
                           max_seq=SEQ, template=tpl, device="cpu")
    got = list(eng.generate(PROMPT, 24, stats=stats))
    assert got == _plain_greedy(cfg, target, PROMPT, 24)
    per_step = 4 if tpl is None else tpl.max_depth + 1
    assert stats.tokens_per_step == per_step, stats.summary()
    assert stats.accepted == stats.steps * (per_step - 1)


@pytest.mark.parametrize("tree", [None, [2, 1]])
def test_random_head_matches_plain_and_jax(ws, tree):
    """A random EAGLE-1 head, chain (k = 3) or [2, 1] tree: the plain
    greedy tokens and the JAX engine's (near-tie rule)."""
    (jcfg, jparams), (cfg, model) = ws["jax"], ws["port"]
    e_llm, head = ws["eagle"][2]
    je_llm, jep = ws["eagle"][1]
    tpl = None if tree is None else TreeTemplate.from_widths(tree)
    eng = EagleChainEngine(model, cfg, head, k=3, block_steps=4, max_seq=SEQ,
                           template=tpl, device="cpu")
    got = list(eng.generate(PROMPT, 20))
    jtpl = None if tree is None else JTreeTemplate.from_widths(tree)
    jeng = JEagleChainEngine(jparams, jcfg, jep, je_llm, k=3, block_steps=4,
                             max_seq=SEQ, backend="xla", template=jtpl)
    want = list(jeng.generate(PROMPT, 20))
    jengine = _jengine(ws)
    _near_tie(got, want, PROMPT, jengine)
    _near_tie(got, _plain_greedy(cfg, model, PROMPT, 20), PROMPT, jengine)


def test_engine_reset_and_reuse(ws):
    """generate twice, with a reset between and without: the same tokens
    (both caches and the carried feature start anew)."""
    cfg, model = ws["port"]
    _, head = ws["eagle_norm"][2]
    eng = EagleChainEngine(model, cfg, head, k=2, block_steps=2,
                           max_seq=SEQ, device="cpu")
    a = list(eng.generate(PROMPT, 8))
    eng.reset()
    b = list(eng.generate(PROMPT, 8))
    c = list(eng.generate(PROMPT[:4], 8))
    d = list(eng.generate(PROMPT, 8))
    assert a == b == d and len(c) == 8


def _prefilled(model, head, S, lengths):
    """Both caches of S slots prefilled with lengths[s] tokens (as the
    scheduler's prefill pairs features): (t_kv, e_kv, root, root_feat)."""
    llm, e_llm = model.llm, head.llm
    t_kv = KVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads,
                          llm.head_size, "cpu")
    e_kv = KVCache.create(e_llm.n_layers, S, SEQ, e_llm.n_kv_heads,
                          e_llm.head_size, "cpu")
    n = max(lengths)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(3, 250, (S, n + 1), generator=g)
    pos = torch.arange(n).expand(S, n).clone()
    pos[pos >= torch.tensor(lengths)[:, None]] = -1
    _, f = model(t_kv, toks[:, :n], pos, logits_mode="none",
                 return_final_hidden=True)
    f = f.float()
    eagle_forward(head, e_kv, toks[:, :n],
                  torch.cat([torch.zeros(S, 1, llm.dim), f[:, :-1]], dim=1),
                  pos, logits_mode="none")
    last = torch.tensor(lengths) - 1
    root = toks.gather(1, torch.tensor(lengths)[:, None])[:, 0]
    return t_kv, e_kv, root, f[torch.arange(S), last]


@pytest.mark.parametrize("tree", [None, [2, 1]])
def test_greedy_step_equals_sampled_step_at_temperature_zero(ws, tree):
    """The greedy step body (argmax drafts, an argmax_all verify: what
    the graphs replay) against the sampled step with every slot at
    temperature 0 and no draws (the scheduler's tick): the same
    tokens, counts, roots and features, and both caches bit for bit;
    three slots, one inactive."""
    cfg, model = ws["port"]
    _, head = ws["eagle"][2]
    S, steps = 3, 3
    active = torch.tensor([True, False, True])
    zeros = torch.zeros(S)
    sets = (active, None, zeros, torch.full((S,), 40), torch.ones(S))
    outs = []
    for sample in (False, True):
        t_kv, e_kv, root, feat = _prefilled(model, head, S, [7, 4, 11])
        if tree is None:
            out = eagle_spec_scan(model, head, t_kv, e_kv, root, feat, steps,
                                  3, *sets, sample=sample)
        else:
            out = eagle_tree_spec_scan(model, head, t_kv, e_kv, root, feat,
                                       steps, TreeTemplate.from_widths(tree),
                                       *sets, sample=sample)
        outs.append((out, t_kv, e_kv))
    (a, ta, ea), (b, tb, eb) = outs
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for p, q in ((ta, tb), (ea, eb)):
        for name in ("k", "v", "k_scale", "v_scale", "mask", "pos"):
            assert torch.equal(getattr(p, name), getattr(q, name)), name
    assert (a[0][:, 1] == -1).all() and (a[1][:, 1] == 0).all()


def _gens(S, seed):
    return DrawState.create(S, "cpu", range(seed, seed + S))


@pytest.mark.parametrize("sample", ["chain", True, "wor"])
def test_seeded_sampled_steps_reproduce(ws, sample):
    """Sampled chain steps, exact-match tree steps and WOR tree steps at
    temperature 0.8: the same seeds give the same tokens, and each slot
    emits at least one token a step."""
    cfg, model = ws["port"]
    _, head = ws["eagle"][2]
    S = 2
    runs = []
    for _ in range(2):
        t_kv, e_kv, root, feat = _prefilled(model, head, S, [6, 9])
        sets = (torch.ones(S, dtype=torch.bool), _gens(S, 3),
                torch.full((S,), 0.8), torch.full((S,), 40), torch.ones(S))
        if sample == "chain":
            out = eagle_spec_scan(model, head, t_kv, e_kv, root, feat, 3, 3,
                                  *sets, sample=True)
        else:
            out = eagle_tree_spec_scan(model, head, t_kv, e_kv, root, feat,
                                       3, TreeTemplate.from_widths([2, 1]),
                                       *sets, sample=sample)
        runs.append(out)
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    assert (runs[0][1] >= 1).all()


def test_replica_sampling_is_lossless_and_accepts(ws):
    """Speculative sampling with the exact-replica head at temperature 1:
    the first emitted token's marginal is the target's sampling
    distribution (4096 slots), and nearly every draft is accepted
    (q = p up to rounding)."""
    _, model = ws["port"]
    target, head = _replica(model)
    llm = target.llm
    S, k = 4096, 3
    root = torch.full((S,), 7)
    temp, top_k, top_p = torch.ones(S), torch.full((S,), 8), torch.ones(S)

    def fresh(lm):
        return KVCache.create(lm.n_layers, S, 16, lm.n_kv_heads,
                              lm.head_size, "cpu")

    logits = target(fresh(llm), root[:, None],
                    torch.zeros(S, 1, dtype=torch.long))
    p0 = sample_dist_batched(logits[:1, :llm.vocab_size], temp[:1],
                             top_k[:1], top_p[:1])[0].numpy()
    emitted, counts, _, _ = eagle_spec_scan(
        target, head, fresh(llm), fresh(head.llm), root,
        torch.zeros(S, llm.dim), 1, k, torch.ones(S, dtype=torch.bool),
        _gens(S, 0), temp, top_k, top_p, sample=True)
    hist = np.bincount(emitted[0, :, 0].numpy(),
                       minlength=llm.vocab_size).astype(np.float64)
    hist /= hist.sum()
    assert 0.5 * np.abs(hist - p0).sum() < 0.08
    assert counts[0].float().mean().item() > 0.9 * (k + 1)


def test_wor_replica_accepts_the_deepest_path(ws):
    """WOR tree steps with the exact-replica head at temperature 1: rank-0
    candidates are drawn from q = p, so nearly every step emits
    max_depth + 1 tokens."""
    _, model = ws["port"]
    target, head = _replica(model)
    S = 64
    t_kv, e_kv, root, feat = _prefilled(target, head, S, [3] * S)
    tpl = TreeTemplate.from_widths([2, 1])
    _, counts, _, _ = eagle_tree_spec_scan(
        target, head, t_kv, e_kv, root, feat, 2, tpl,
        torch.ones(S, dtype=torch.bool), _gens(S, 0), torch.ones(S),
        torch.full((S,), 8), torch.ones(S), sample="wor")
    assert counts.float().mean().item() > 0.95 * (tpl.max_depth + 1)


@pytest.mark.parametrize("engine", ["chain", "device-tree"])
def test_cli_eagle_equals_run(ws, engine):
    """`run --draft <eagle head>` (the chain) and `--spec-engine
    device-tree --spec-tree 2,1` print the plain run's greedy tokens;
    --spec-engine eagle without an EAGLE head, and the host tree engine
    with one, are refused."""
    cfg, model = ws["port"]
    base = ["-d", str(ws["dir"]), "-p", "hello", "-n", "12",
            "--temperature", "0", "--no-progress", "--device", "cpu"]
    plain = run.run_prompt(run.parse_args(base))
    extra = ["--draft", str(ws["eagle"][0]), "--spec-k", "3"]
    if engine == "device-tree":
        extra += ["--spec-engine", "device-tree", "--spec-tree", "2,1"]
    spec = run.run_prompt(run.parse_args(base + extra))
    _near_tie(spec.ids, plain.ids, plain.prompt_ids, _jengine(ws))
    assert spec.spec.emitted == len(spec.ids) == 12
    with pytest.raises(SystemExit):
        run.run_prompt(run.parse_args(base + ["--spec-engine", "eagle"]))
    with pytest.raises(SystemExit):
        run.run_prompt(run.parse_args(base + ["--spec-engine", "eagle",
                                              "--draft", str(ws["dir"])]))
    with pytest.raises(SystemExit):
        run.run_prompt(run.parse_args(base + extra[:2]
                                      + ["--spec-engine", "tree"]))
