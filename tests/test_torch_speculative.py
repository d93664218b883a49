"""Chain speculation on the CPU: the fused decode-layer chain, the
factored draft head and the deferred paged verify against the JAX
package, and the chain engines against plain greedy decoding, on tiny
synthetic workspaces.

Greedy speculation is lossless: its tokens are the plain greedy tokens,
but a verify of k + 1 rows and a one-row decode step round differently,
so two streams may part at a near-tie (the reference's top-2 logit gap
< 0.5), as tests/test_speculative.py allows too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.speculative.chain import ChainSpecEngine as JChainEngine
from powerserve_tpu.speculative.draft_head import (
    make_draft_head as jmake_draft_head)
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.kv.paged import PagedKVCache, PagePool
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.ops.qmatmul import QLinear, dequant
from powerserve_tpu_torch.sampling.sampler import (DrawState,
                                                   sample_dist_batched)
from powerserve_tpu_torch.speculative.chain import (ChainSpecEngine,
                                                    chain_spec_sample_scan,
                                                    chain_spec_scan,
                                                    self_draft_model,
                                                    with_draft_head)
from powerserve_tpu_torch.speculative.draft_head import make_draft_head
from powerserve_tpu_torch.speculative.engine import SpecStats
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
NEAR_TIE = 0.5
# the fused chain against JAX's in interpret mode: the same roundings
# but the bf16 dequant of its MXU dots and the f32 dot orders, over 2
# layers (test_torch_model.py measures 0.5-0.9% on these models)
LOGIT_REL = 1.5e-2
PROMPT = [3, 17, 5, 9, 44, 12]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """name -> (workspace, JAX (cfg, params), port (cfg, model))."""
    out = {}
    for name, kw in {"tiny": dict(preset="tiny", quant=GGMLType.Q8_0),
                     "tiny-k": dict(preset="tiny-k", quant=GGMLType.Q4_K),
                     "qwen2-bias": dict(preset="tiny", quant=GGMLType.Q8_0,
                                        arch="qwen2", bias=True),
                     "draft": dict(preset="tiny", quant=GGMLType.Q8_0,
                                   seed=7)}.items():
        kw = dict(kw)
        w = make_synthetic_gguf(tmp_path_factory.mktemp(name),
                                kw.pop("preset"), kw.pop("quant"),
                                seed=kw.pop("seed", 0), seq_len=SEQ, **kw)
        out[name] = (w, jload(w / "model"),
                     load_gguf_model(w / "model", device="cpu"))
    return out


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("name", ["tiny", "tiny-k", "qwen2-bias"])
def test_fused_layers_match_jax(ws, name):
    """forward(fuse_layers=True) on a decode step of two slots and on a
    verify of four rows (argmax_all) against the JAX fused chain."""
    _, (jcfg, jparams), (cfg, model) = ws[name]
    llm = cfg.llm
    jkv = JKVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                          llm.head_size)
    kv = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    toks = np.arange(12, dtype=np.int32).reshape(2, 6) * 7 % 200 + 3
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    steps = [(toks, pos, "none", False),
             (np.array([[17], [23]], np.int32), np.array([[6], [6]], np.int32),
              "last", True),
             (np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32),
              np.array([[7, 8, 9, 10], [7, 8, 9, 10]], np.int32), "all", True)]
    for t, p, mode, fuse in steps:
        got = model(kv, torch.from_numpy(t), torch.from_numpy(p).long(),
                    logits_mode=mode, fuse_layers=fuse)
        want, jkv = jax.jit(
            lambda prm, c, a, b, m=mode, f=fuse: jforward(
                prm, jcfg.llm, c, a, b, backend="pallas_interpret",
                logits_mode=m, fuse_layers=f or None))(
            jparams, jkv, jnp.asarray(t), jnp.asarray(p))
        if mode != "none":
            assert _rel(got.numpy(), want) < LOGIT_REL
    # argmax_all is the argmax of every row of the "all" logits
    kv.rollback(4)
    am = model(kv, torch.from_numpy(steps[2][0]),
               torch.from_numpy(steps[2][1]).long(),
               logits_mode="argmax_all", fuse_layers=True)
    assert am.shape == (2, 4) and am.dtype == torch.int32
    assert torch.equal(am, got.argmax(dim=-1).to(torch.int32))


def _plain_greedy(cfg, model, prompt, n):
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return list(InferenceEngine(model, cfg, hp, device="cpu").generate(
        prompt, n))


def _jengine(ws_entry):
    _, (jcfg, jparams), _ = ws_entry
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


@pytest.mark.parametrize("draft", ["self:2", "self:1", "separate"])
def test_chain_spec_greedy_matches_plain_and_jax(ws, draft):
    """The greedy chain engine (k = 3, 4 steps per block) emits the plain
    greedy stream, and the JAX chain engine's on the same workspace."""
    _, (jcfg, jparams), (cfg, model) = ws["tiny"]
    _, (jdcfg, jdparams), (dcfg, dmodel) = ws["draft"]
    kw = (dict(self_draft_layers=int(draft[5:])) if draft != "separate"
          else None)
    eng = ChainSpecEngine(model, cfg, None if kw else dmodel, k=3,
                          block_steps=4, max_seq=SEQ, device="cpu",
                          **(kw or {}))
    stats = SpecStats()
    got = list(eng.generate(PROMPT, 20, stats=stats))
    assert len(got) == 20 and stats.emitted == 20
    assert stats.drafted == 3 * stats.steps
    jeng = _jengine(ws["tiny"])
    _near_tie(got, _plain_greedy(cfg, model, PROMPT, 20), PROMPT, jeng)
    jkw = (dict(self_draft_layers=int(draft[5:])) if kw
           else dict(draft_params=jdparams, draft_cfg=jdcfg))
    jspec = JChainEngine(jparams, jcfg, k=3, block_steps=4, max_seq=SEQ,
                         backend="xla", **jkw)
    _near_tie(got, list(jspec.generate(PROMPT, 20)), PROMPT, jeng)


def test_full_self_draft_accepts_its_drafts(ws):
    _, _, (cfg, model) = ws["tiny"]
    eng = ChainSpecEngine(model, cfg, self_draft_layers=cfg.llm.n_layers,
                          k=3, block_steps=4, max_seq=SEQ, device="cpu")
    stats = SpecStats()
    assert len(list(eng.generate([3, 17, 5], 16, stats=stats))) == 16
    # the draft is the target (its fused chain rounds apart only at
    # near-ties)
    assert stats.accept_rate > 0.8 and stats.tokens_per_step > 3.0


def _fresh_pair(model, llm, S, prompt):
    """Target and draft caches of S slots, each prefilled with prompt."""
    kvs = [KVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads,
                          llm.head_size, device="cpu") for _ in range(2)]
    toks = torch.tensor([prompt] * S)
    pos = torch.arange(len(prompt)).expand(S, -1)
    for kv in kvs:
        model(kv, toks, pos, logits_mode="none")
    return kvs


def test_sample_scan_at_temperature_zero_is_greedy(ws):
    """Slots at temperature 0 draw nothing: their speculative sampling
    reduces to the greedy scheme, step for step, caches included."""
    _, _, (cfg, model) = ws["tiny"]
    llm = cfg.llm
    draft = self_draft_model(model, 1)
    S, k, n = 3, 3, 4
    root = torch.tensor([7, 9, 11])
    t1, _ = _fresh_pair(model, llm, S, PROMPT)
    d1 = KVCache.create(1, S, SEQ, llm.n_kv_heads, llm.head_size, "cpu")
    draft(d1, torch.tensor([PROMPT] * S),
          torch.arange(len(PROMPT)).expand(S, -1), logits_mode="none")
    t2, d2 = t1.clone(), d1.clone()
    toks, counts, r1 = chain_spec_scan(model, draft, t1, d1, root, n, k)
    ones = torch.ones(S)
    emitted, counts2, r2 = chain_spec_sample_scan(
        model, draft, t2, d2, root, n, k, torch.ones(S, dtype=torch.bool),
        None, torch.zeros(S), torch.full((S,), 40), ones)
    assert torch.equal(counts, counts2) and torch.equal(r1, r2)
    lanes = torch.arange(k + 1)
    keep = lanes[None, None, :] < counts[..., None]
    assert torch.equal(torch.where(keep, toks, -1), emitted)
    assert torch.equal(t1.pos, t2.pos) and torch.equal(t1.mask, t2.mask)
    assert torch.equal(d1.pos, d2.pos)


def test_rejection_sampling_lossless_and_higher_acceptance(ws):
    """The first emitted token's marginal is the target's sampling
    distribution (losslessness), and a perfect draft (the full-depth
    self-draft) accepts nearly everything, far above exact-match
    acceptance on the same distribution."""
    _, _, (cfg, model) = ws["tiny"]
    llm = cfg.llm
    S, k = 4096, 3
    root = torch.full((S,), 7)
    temp, top_k, top_p = torch.ones(S), torch.full((S,), 8), torch.ones(S)

    def fresh(slots=S):
        return KVCache.create(llm.n_layers, slots, 16, llm.n_kv_heads,
                              llm.head_size, "cpu")

    logits = model(fresh(1), root[:1, None],
                   torch.zeros(1, 1, dtype=torch.long))
    p0 = sample_dist_batched(logits[:, :llm.vocab_size], temp[:1], top_k[:1],
                             top_p[:1])[0].numpy()
    gens = DrawState.create(S, "cpu", range(S))
    draft = self_draft_model(model, llm.n_layers)
    emitted, counts, _ = chain_spec_sample_scan(
        model, draft, fresh(), fresh(), root, 1, k,
        torch.ones(S, dtype=torch.bool), gens, temp, top_k, top_p)
    first = emitted[0, :, 0].numpy()
    hist = np.bincount(first, minlength=llm.vocab_size).astype(np.float64)
    hist /= hist.sum()
    assert 0.5 * np.abs(hist - p0).sum() < 0.08
    mean_tokens = counts[0].float().mean().item()
    assert mean_tokens > 0.9 * (k + 1)
    assert mean_tokens > 1.0 + k * float((p0 ** 2).sum()) + 0.5


def _port_qlinear(jl) -> QLinear:
    return QLinear(*(torch.from_numpy(np.array(a)) if a is not None
                     else None for a in (jl.q, jl.scales, jl.bias)),
                   packed=jl.packed, unsigned=jl.unsigned,
                   in_features=jl.in_features, out_features=jl.out_features,
                   pack_group=jl.pack_group, scale_group=jl.scale_group)


def test_draft_head_matches_jax_and_stays_lossless(ws):
    """make_draft_head factors the lm_head as JAX's does (the factored
    product within the int8 requantization of V), and a greedy chain
    whose draft uses it still emits the plain greedy stream."""
    _, (jcfg, jparams), (cfg, model) = ws["tiny"]
    llm = cfg.llm
    # full rank on the tiny head: exact up to the quantization of U and V
    u, v = make_draft_head(model.lm_head, rank=llm.dim)
    ju, jv = jmake_draft_head(jparams.lm_head, rank=llm.dim)
    assert (u.in_features, u.out_features) == (llm.dim, llm.dim)
    assert (v.in_features, v.out_features) == (llm.dim, llm.vocab_size)
    ours = dequant(u) @ dequant(v)
    theirs = dequant(_port_qlinear(ju)) @ dequant(_port_qlinear(jv))
    head = dequant(model.lm_head)
    assert _rel(ours.numpy(), theirs.numpy()) < 2e-2
    assert _rel(ours.numpy(), head.numpy()) < 2e-2
    # the factored head as a draft: tokens unchanged
    eng = ChainSpecEngine(model, cfg, self_draft_layers=1, k=3,
                          block_steps=4, max_seq=SEQ, device="cpu")
    eng.draft = with_draft_head(eng.draft, (u, v))
    got = list(eng.generate(PROMPT, 12))
    _near_tie(got, _plain_greedy(cfg, model, PROMPT, 12), PROMPT,
              _jengine(ws["tiny"]))


def test_deferred_paged_verify_matches_inline(ws):
    """A verify of five rows over the paged pool through the deferred
    route against the inline write-then-attend route: logits within the
    roundings of the two attention orders, the same greedy tokens, and
    after the commit the pool holds what per-layer writes of the same
    K/V would; layer 0's K/V, computed before any attention, are
    bit-equal to the inline route's."""
    _, _, (cfg, model) = ws["tiny"]
    llm = cfg.llm
    S, page = 2, 8
    kv = PagedKVCache.create(llm.n_layers, S, 64, llm.n_kv_heads,
                             llm.head_size, "cpu", n_pages=20,
                             page_size=page)
    pool = PagePool(20, S, kv.max_pages, page)
    for s, n in enumerate((30, 19)):
        assert pool.ensure(s, n + 5)
    pool.flush(kv)
    pos = torch.stack([torch.arange(24), torch.arange(24).clamp(max=13)])
    pos[1, 14:] = -1
    model(kv, torch.arange(48).reshape(2, 24) % 200 + 3, pos,
          logits_mode="none")
    a, b = kv.clone(), kv.clone()
    toks = torch.tensor([[5, 6, 7, 8, 9], [10, 11, 12, 13, 14]])
    vpos = kv.pos.long()[:, None] + torch.arange(5)[None]
    inline = model(a, toks, vpos, logits_mode="all")
    blocks = []
    from unittest import mock
    real = PagedKVCache.commit

    def keep(self, bl, index):
        blocks.extend(bl)
        return real(self, bl, index)

    with mock.patch.object(PagedKVCache, "commit", keep):
        deferred = model(b, toks, vpos, logits_mode="all",
                         kv_update="deferred")
    # the in-flight partition rounds p * vs to bf16 at its own maximum,
    # the kernel at its running chunk maximum (2^-9 relative per
    # probability, as between two chunkings of the kernel)
    assert _rel(deferred.numpy(), inline.numpy()) < 1e-2
    top2 = inline.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) >= NEAR_TIE
    assert torch.equal(deferred.argmax(-1)[clear], inline.argmax(-1)[clear])
    assert torch.equal(a.pos, b.pos) and torch.equal(a.mask, b.mask)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(a, name)[0], getattr(b, name)[0]), name
    c = kv.clone()
    pages, offs = c.locate(vpos)
    s_idx, t_idx = (pages < c.n_pages).nonzero(as_tuple=True)
    pages, offs = pages[s_idx, t_idx], offs[s_idx, t_idx]
    for layer, (kq, ks, vq, vs) in enumerate(blocks):
        for pool_t, val in ((c.k, kq), (c.k_scale, ks), (c.v, vq),
                            (c.v_scale, vs)):
            pool_t[layer][pages, :, offs] = val[s_idx, t_idx]
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(b, name), getattr(c, name)), name
    with pytest.raises(ValueError):
        model(KVCache.create(llm.n_layers, S, 64, llm.n_kv_heads,
                             llm.head_size, "cpu"), toks, vpos,
              kv_update="deferred")


def test_paged_chain_spec_matches_dense(ws):
    """The greedy chain over a paged target pool (deferred verify) emits
    the dense cache's stream."""
    _, _, (cfg, model) = ws["tiny-k"]
    llm = cfg.llm
    draft = self_draft_model(model, 1)
    outs = []
    for paged in (False, True):
        if paged:
            t_kv = PagedKVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads,
                                       llm.head_size, "cpu", n_pages=8,
                                       page_size=8)
            pool = PagePool(8, 1, t_kv.max_pages, 8)
            assert pool.ensure(0, 64)
            pool.flush(t_kv)
        else:
            t_kv = KVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads,
                                  llm.head_size, "cpu")
        d_kv = KVCache.create(1, 1, 64, llm.n_kv_heads, llm.head_size, "cpu")
        pos = torch.arange(len(PROMPT) - 1)[None]
        toks = torch.tensor([PROMPT[:-1]])
        model(t_kv, toks, pos, logits_mode="none")
        draft(d_kv, toks, pos, logits_mode="none")
        out = chain_spec_scan(model, draft, t_kv, d_kv,
                              torch.tensor([PROMPT[-1]]), 4, 3)
        outs.append((out, t_kv.pos.clone()))
    (t0, c0, _), p0 = outs[0]
    (t1, c1, _), p1 = outs[1]
    assert torch.equal(c0, c1) and torch.equal(p0, p1)
    keep = torch.arange(4)[None, None, :] < c0[..., None]
    assert torch.equal(torch.where(keep, t0, -1), torch.where(keep, t1, -1))


def test_pool_rollback_per_slot_matches_jax():
    """The dense cache's rollback serves the pool: a per-slot drop (the
    chain's k - n_acc, 0 for inactive slots) leaves the pool's mask and
    pos as JAX's PagedKVCache.rollback leaves them, K/V untouched."""
    from powerserve_tpu.kv.paged import PagedKVCache as JPagedKVCache

    S, page = 3, 8
    jkv = JPagedKVCache.create(1, S, 40, 2, 8, n_pages=12, page_size=page)
    kv = PagedKVCache.create(1, S, 40, 2, 8, "cpu", n_pages=12,
                             page_size=page)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8], [-1] * 9,
                    [9, 10, 11, 12, 13, 14, 15, 16, 17]], np.int32)
    jkv = jkv.advance(jnp.asarray(pos))
    kv.advance(torch.from_numpy(pos).long())
    k_before = kv.k.clone()
    drop = np.array([3, 0, 5], np.int32)
    active = np.array([True, False, True])
    jkv = jkv.rollback(jnp.asarray(drop), active=jnp.asarray(active))
    kv.rollback(torch.from_numpy(drop), active=torch.from_numpy(active))
    np.testing.assert_array_equal(kv.mask.numpy(), np.asarray(jkv.mask))
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    assert torch.equal(kv.k, k_before)
