"""Token-tree speculation on the CPU: the port's TreeTemplate, KV ops,
the tree mode of flash-decode's twin, tree_spec_scan, DeviceTreeEngine,
the host tree engine and the scheduler's tree tick against the JAX
package and against plain greedy decoding, on tiny synthetic
workspaces.

Greedy speculation is lossless: its tokens are the plain greedy tokens,
but a verify of N tree rows and a one-row decode step round differently,
so two streams may part at a near-tie (the reference's top-2 logit gap
< 0.5), as tests/test_device_tree.py allows too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.kv.paged import PagedKVCache as JPagedKVCache
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.ops.attention import (
    build_visibility as jbuild_visibility)
from powerserve_tpu.ops.flash_decode import (
    flash_decode_quant as jflash_decode_quant)
from powerserve_tpu.speculative.device_tree import (
    DeviceTreeEngine as JDeviceTreeEngine)
from powerserve_tpu.speculative.device_tree import (
    TreeTemplate as JTreeTemplate)
from powerserve_tpu.speculative.device_tree import _level_visibility
from powerserve_tpu.speculative.device_tree import (
    tree_spec_scan as jtree_spec_scan)
from powerserve_tpu.speculative.engine import (
    SpeculativeEngine as JSpeculativeEngine)
from powerserve_tpu.speculative.tree import (
    SpeculativeConfig as JSpeculativeConfig)
from powerserve_tpu_torch import run
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.kv.paged import PagedKVCache
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.ops.flash_decode import (
    KERNEL_CHUNK, decode_visibility, flash_decode_paged_reference,
    flash_decode_quant, flash_decode_quant_reference, kernel_walk,
    pack_intra, unpack_bits)
from powerserve_tpu_torch.sampling.sampler import (DrawState,
                                                   sample_dist_batched)
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.speculative.device_tree import (MAX_NODES,
                                                          DeviceTreeEngine,
                                                          TreeTemplate,
                                                          tree_spec_scan)
from powerserve_tpu_torch.speculative.engine import (SpecStats,
                                                     SpeculativeEngine)
from powerserve_tpu_torch.speculative.tree import (SpeculativeConfig,
                                                   TokenTree)
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
NEAR_TIE = 0.5
PROMPT = [3, 17, 5, 9, 44, 12]
# a grown tree at these knobs: the tiny models' distributions are flat,
# so the default min_prob of 0.2 keeps only the root
GROW = dict(min_prob=0.0, draft_temperature=0.3)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """name -> (workspace, JAX (cfg, params), port (cfg, model))."""
    out = {}
    for name, seed in (("tiny", 0), ("draft", 7)):
        w = make_synthetic_gguf(tmp_path_factory.mktemp(name), "tiny",
                                GGMLType.Q8_0, seed=seed, seq_len=SEQ)
        out[name] = (w, jload(w / "model"),
                     load_gguf_model(w / "model", device="cpu"))
    return out


def _jengine(ws_entry):
    _, (jcfg, jparams), _ = ws_entry
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


def _plain_greedy(cfg, model, prompt, n):
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return list(InferenceEngine(model, cfg, hp, device="cpu").generate(
        prompt, n))


# -- TreeTemplate --------------------------------------------------------------


@pytest.mark.parametrize("widths", [[2, 1], [1, 1, 1], [2, 2, 1]])
def test_template_fields_match_jax(widths):
    got, want = TreeTemplate.from_widths(widths), JTreeTemplate.from_widths(
        widths)
    for name in ("parents", "ranks", "n_nodes", "max_depth", "max_children",
                 "assignments", "level_topk"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("depths", "child_table", "anc"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    assert [list(x) for x in got.levels] == [list(x) for x in want.levels]
    assert got.key() == want.key()
    assert got.is_chain == (widths == [1, 1, 1])


@pytest.mark.parametrize("parents,ranks", [([0], [0]), ([-1, 1], [0, 0]),
                                           ([-1, 0, 0], [0, 2]),
                                           ([-1, 0, 0], [0, 0, 2])])
def test_template_validation_matches_jax(parents, ranks):
    for cls in (TreeTemplate, JTreeTemplate):
        with pytest.raises(ValueError):
            cls(parents, ranks)


def test_template_above_the_verify_limit_is_refused():
    """A tree of more nodes than a flash-decode verify takes is refused
    at construction, naming the limit (JAX builds it)."""
    widths = [2, 2, 2]  # 15 nodes: the largest of this shape that fits
    assert TreeTemplate.from_widths(widths).n_nodes == 15 <= MAX_NODES
    big = [3, 2, 2]  # 1 + 3 + 6 + 12 = 22 nodes
    assert JTreeTemplate.from_widths(big).n_nodes == 22
    with pytest.raises(ValueError, match=str(MAX_NODES)):
        TreeTemplate.from_widths(big)


# -- the KV ops ----------------------------------------------------------------

L, S, T, HKV, D, PAGE, P = 2, 3, 32, 2, 8, 4, 20
NAMES = ("k", "v", "k_scale", "v_scale", "mask", "pos")


def _caches(paged):
    if not paged:
        return (JKVCache.create(L, S, T, HKV, D),
                KVCache.create(L, S, T, HKV, D, "cpu"))
    # slot 2's last logical page is unallocated
    table = np.full((S, T // PAGE), P, np.int32)
    perm = np.random.default_rng(5).permutation(P)
    table[0, :5] = perm[:5]
    table[1, :8] = perm[5:13]
    table[2, :6] = perm[13:19]
    jkv = JPagedKVCache.create(L, S, T, HKV, D, n_pages=P,
                               page_size=PAGE).assign_pages(table)
    kv = PagedKVCache.create(L, S, T, HKV, D, "cpu", n_pages=P,
                             page_size=PAGE)
    kv.assign_pages(table)
    return jkv, kv


def _assert_same(jkv, kv):
    for name in NAMES:
        np.testing.assert_array_equal(getattr(kv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)


@pytest.mark.parametrize("paged", [False, True])
def test_kv_ops_match_jax(paged):
    """set_mask, copy_token, gather_tokens and rollback + commit_tokens
    (-1 padding, a destination past capacity) leave the codes, scales,
    mask and pos bit-equal to JAX's."""
    jkv, kv = _caches(paged)
    rng = np.random.default_rng(0)
    pos = np.stack([np.arange(20), np.arange(20), np.arange(20)]).astype(
        np.int32)
    pos[1, 12:] = -1
    index = kv.write_index(torch.from_numpy(pos).long())
    for layer in range(L):
        k, v = (rng.standard_normal((S, 20, HKV, D)).astype(np.float32)
                for _ in range(2))
        jkv = jkv.append(layer, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos))
        kv.write(layer, torch.from_numpy(k), torch.from_numpy(v), index)
    jkv = jkv.advance(jnp.asarray(pos))
    kv.advance(torch.from_numpy(pos).long())
    _assert_same(jkv, kv)

    jkv = jkv.set_mask(1, jnp.array([1, 2]), False)
    kv.set_mask(1, torch.tensor([1, 2]), False)
    jkv = jkv.copy_token(0, dst=jnp.asarray(3), src=jnp.asarray(17))
    kv.copy_token(0, torch.tensor(3), torch.tensor(17))
    _assert_same(jkv, kv)

    # a tree of 6 nodes written at c = 10 and the accepted path compacted
    src = np.array([[10, 12, 15, -1, -1, -1], [10, 11, -1, -1, -1, -1],
                    [10, 13, 14, 15, -1, -1]], np.int32)
    n_acc = np.array([3, 2, 4], np.int32)
    c = np.array([10, 10, 10], np.int32)
    jkv = jkv.rollback(jkv.pos - jnp.asarray(c))
    kv.rollback(kv.pos - torch.from_numpy(c))
    jkv = jkv.commit_tokens(jnp.arange(S), jnp.asarray(src),
                            jnp.asarray(n_acc))
    kv.commit_tokens(torch.arange(S), torch.from_numpy(src).long(),
                     torch.from_numpy(n_acc))
    _assert_same(jkv, kv)
    # a compaction whose destinations run past capacity drop there
    start = np.array([29, 2, 30], np.int32)
    src2 = np.array([[0, 1, 2, 3], [5, -1, 6, 7], [31, 30, 29, 28]],
                    np.int32)
    jkv = jkv.gather_tokens(jnp.arange(S), jnp.asarray(src2),
                            jnp.asarray(start))
    kv.gather_tokens(torch.arange(S), torch.from_numpy(src2).long(),
                     torch.from_numpy(start))
    _assert_same(jkv, kv)


# -- the tree mode's twin --------------------------------------------------


H = 8


def _attn_inputs(seed, S_, Tq, T_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S_, Tq, H, D * 4)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (S_, HKV, T_, D * 4)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((S_, HKV, T_)) * 0.05).astype(np.float32)
              for _ in range(2))
    return q, kq, ks, vq, vs


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("rows", ["verify", "level1", "level2"])
def test_tree_twin_matches_jax_kernel(rows):
    """The twin's tree mode (key positions c + i, a verify's ancestor
    rows or a draft level's rows over all nodes, the committed mask)
    against JAX flash_decode_quant in interpret mode on JAX's visibility
    (build_visibility with the ancestor mask; _level_visibility)."""
    tpl = TreeTemplate.from_widths([2, 2, 1])
    N, S_, T_ = tpl.n_nodes, 2, 640
    c = np.array([300, 517], np.int32)
    mask = np.arange(T_)[None, :] < c[:, None]
    keys = (c[:, None] + np.arange(N)[None, :]).astype(np.int32)
    if rows == "verify":
        intra = tpl.anc
        jvis = jbuild_visibility(jnp.asarray(mask), jnp.asarray(keys),
                                 jnp.asarray(intra))
    else:
        intra = tpl.anc[tpl.levels[int(rows[-1])]]
        jvis = _level_visibility(jnp.asarray(mask), intra, jnp.asarray(c),
                                 T_)
    q, kq, ks, vq, vs = _attn_inputs(N, S_, intra.shape[0], T_)
    scale = 1.0 / np.sqrt(D * 4)
    want = np.asarray(jflash_decode_quant(
        *(jnp.asarray(a) for a in (q, kq, ks, vq, vs)), jvis, scale,
        interpret=True))
    bits = pack_intra(torch.from_numpy(intra))
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, mask, keys)]
    # the JAX kernel's 512-token chunks in one sequence: only the order
    # of the f32 dot sums differs (a bf16-rounded p * vs by one last bit)
    one = flash_decode_quant(*t, scale, chunk=512, split=T_, bits=bits)
    assert _rel(one.numpy(), want) < 1e-5
    # the kernel's own 16-token steps in its per-warp splits round p * vs
    # at other running maxima (2^-9 relative per probability)
    assert _rel(flash_decode_quant(*t, scale, bits=bits).numpy(),
                want) < 3e-3


@pytest.mark.parametrize("widths", [[2, 1], [2, 1, 1], [7], [3, 2, 1]],
                         ids=["rows20", "rows28", "rows32", "rows64"])
def test_tree_twin_walk_matches_jax_kernel(widths):
    """The twin's default walk (kernel_walk: the kernel's 16-token steps
    over its per-warp ranges) at G * Tq = 4 * N verify rows, on both sides
    of 32, the most one warp of the kernel holds: four slots at 32/8
    heads, so that a warp walks several steps, against JAX
    flash_decode_quant in interpret mode on JAX's visibility."""
    tpl = TreeTemplate.from_widths(widths)
    N, S_, T_, H_, Hkv_, D_ = tpl.n_nodes, 4, 640, 32, 8, 32
    c = np.array([400, 517, 450, 610], np.int32)
    mask = np.arange(T_)[None, :] < c[:, None]
    keys = (c[:, None] + np.arange(N)[None, :]).astype(np.int32)
    jvis = jbuild_visibility(jnp.asarray(mask), jnp.asarray(keys),
                             jnp.asarray(tpl.anc))
    rng = np.random.default_rng(N)
    q = rng.standard_normal((S_, N, H_, D_)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (S_, Hkv_, T_, D_)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((S_, Hkv_, T_)) * 0.05).astype(np.float32)
              for _ in range(2))
    scale = 1.0 / np.sqrt(D_)
    want = np.asarray(jflash_decode_quant(
        *(jnp.asarray(a) for a in (q, kq, ks, vq, vs)), jvis, scale,
        interpret=True))
    bits = pack_intra(torch.from_numpy(tpl.anc))
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, mask, keys)]
    vis = decode_visibility(t[5], t[6], N, bits)
    _, split = kernel_walk(vis, Hkv_, H_ // Hkv_)
    assert (split > KERNEL_CHUNK).all()  # several steps a warp
    # the kernel's own 16-token steps in its per-warp splits round p * vs
    # at other running maxima (2^-9 relative per probability)
    assert _rel(flash_decode_quant(*t, scale, bits=bits).numpy(),
                want) < 3e-3


@pytest.mark.parametrize("Tq", [1, 5, 16])
def test_causal_rows_are_todays_rule(Tq):
    """Lower-triangular bit rows over J = Tq keys give today's causal
    visibility and twin outputs bit for bit, dense and paged; bits pack
    and unpack losslessly over 32 keys."""
    rng = np.random.default_rng(Tq)
    S_, T_ = 3, 96
    q, kq, ks, vq, vs = _attn_inputs(Tq, S_, Tq, T_)
    mask = rng.random((S_, T_)) < 0.6
    pos = rng.integers(-1, T_ + 2, (S_, Tq)).astype(np.int32)
    causal = pack_intra(torch.ones(Tq, Tq, dtype=torch.bool).tril())
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, mask, pos)]
    assert torch.equal(flash_decode_quant_reference(*t, 0.2, bits=causal),
                       flash_decode_quant_reference(*t, 0.2))
    pt = torch.arange(S_ * T_ // 8, dtype=torch.int32).reshape(S_, -1)
    pools = [x.reshape((S_, HKV, T_ // 8, 8) + x.shape[3:]).movedim(2, 1)
             .reshape((-1, HKV, 8) + x.shape[3:]) for x in t[1:5]]
    args = (t[0], *pools, pt, t[5], t[6], 0.2)
    assert torch.equal(flash_decode_paged_reference(*args, bits=causal),
                       flash_decode_paged_reference(*args))
    rows = torch.from_numpy(rng.random((Tq, 32)) < 0.5)
    assert torch.equal(unpack_bits(pack_intra(rows), 32), rows)


def test_paged_tree_verify_routes_match_jax(ws):
    """A [2, 1, 1] verify (rope c + depth, nodes at c + i, the ancestor
    rows) over the paged pool: the inline route (the paged tree mode)
    and the deferred route (the in-flight merge with the ancestor rows)
    against each other and against the JAX forward on its pool, and the
    deferred route's layer 0 K/V bit-equal to the inline route's."""
    from powerserve_tpu.models.llama import forward as jforward

    _, (jcfg, jparams), (cfg, model) = ws["tiny"]
    llm = cfg.llm
    tpl = TreeTemplate.from_widths([2, 1, 1])
    N, S_, page, n_pages = tpl.n_nodes, 2, 8, 20
    table = np.full((S_, SEQ // page), n_pages, np.int32)
    table[0, :6] = np.arange(6)
    table[1, :5] = np.arange(10, 15)
    kv = PagedKVCache.create(llm.n_layers, S_, SEQ, llm.n_kv_heads,
                             llm.head_size, "cpu", n_pages=n_pages,
                             page_size=page)
    kv.assign_pages(table)
    jkv = JPagedKVCache.create(llm.n_layers, S_, SEQ, llm.n_kv_heads,
                               llm.head_size, n_pages=n_pages,
                               page_size=page).assign_pages(table)
    lens = [30, 19]
    pos = np.stack([np.arange(30), np.arange(30)]).astype(np.int32)
    pos[1, 19:] = -1
    toks = (np.arange(60).reshape(2, 30) * 7 % 200 + 3).astype(np.int32)
    model(kv, torch.from_numpy(toks).long(), torch.from_numpy(pos).long(),
          logits_mode="none")
    _, jkv = jforward(jparams, jcfg.llm, jkv, jnp.asarray(toks),
                      jnp.asarray(pos), backend="xla", logits_mode="none")
    c = np.asarray(lens, np.int32)[:, None]
    vt = (np.arange(14).reshape(2, 7) * 11 % 200 + 5).astype(np.int32)
    rope = c + tpl.depths[None, :]
    cpos = c + np.arange(N)[None, :]
    a, b = kv.clone(), kv.clone()
    t = lambda x: torch.from_numpy(x).long()  # noqa: E731
    intra = torch.from_numpy(tpl.anc)
    inline = model(a, t(vt), t(rope), cache_positions=t(cpos),
                   intra_mask=intra, logits_mode="all")
    deferred = model(b, t(vt), t(rope), cache_positions=t(cpos),
                     intra_mask=intra, logits_mode="all",
                     kv_update="deferred")
    want, _ = jforward(jparams, jcfg.llm, jkv, jnp.asarray(vt),
                       jnp.asarray(rope), cache_positions=jnp.asarray(cpos),
                       intra_mask=jnp.asarray(tpl.anc), backend="xla",
                       logits_mode="all")
    want = np.asarray(want)
    # the in-flight partition rounds p * vs at its own maximum; the JAX
    # CPU route dequantizes its matmuls in bf16 (test_torch_model.py)
    assert _rel(deferred.numpy(), inline.numpy()) < 1e-2
    assert _rel(inline.numpy(), want) < 1.5e-2
    assert _rel(deferred.numpy(), want) < 1.5e-2
    assert torch.equal(a.pos, b.pos) and torch.equal(a.mask, b.mask)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(a, name)[0], getattr(b, name)[0]), name


# -- tree_spec_scan and the engines --------------------------------------------


@pytest.mark.parametrize("draft", ["self:1", "separate"])
def test_device_tree_engine_matches_plain_and_jax(ws, draft):
    """Greedy DeviceTreeEngine ([2, 1, 1], 4 steps a block) emits the
    plain greedy stream, and JAX DeviceTreeEngine's on the same
    workspace (near-tie rule)."""
    _, (jcfg, jparams), (cfg, model) = ws["tiny"]
    _, (jdcfg, jdparams), (_, dmodel) = ws["draft"]
    tpl = TreeTemplate.from_widths([2, 1, 1])
    kw = (dict(self_draft_layers=1) if draft == "self:1"
          else dict(draft=dmodel))
    stats = SpecStats()
    got = list(DeviceTreeEngine(model, cfg, template=tpl, block_steps=4,
                                max_seq=SEQ, device="cpu", **kw).generate(
        PROMPT, 20, stats=stats))
    assert len(got) == 20 and stats.emitted == 20
    assert stats.drafted == (tpl.n_nodes - 1) * stats.steps
    jeng = _jengine(ws["tiny"])
    _near_tie(got, _plain_greedy(cfg, model, PROMPT, 20), PROMPT, jeng)
    jkw = (dict(self_draft_layers=1) if draft == "self:1"
           else dict(draft_params=jdparams, draft_cfg=jdcfg))
    jspec = JDeviceTreeEngine(jparams, jcfg,
                              template=JTreeTemplate.from_widths([2, 1, 1]),
                              block_steps=4, max_seq=SEQ, backend="xla",
                              **jkw)
    _near_tie(got, list(jspec.generate(PROMPT, 20)), PROMPT, jeng)


def test_full_self_draft_accepts_the_deepest_path(ws):
    """Draft == target: the argmax path through the tree is accepted,
    so every step emits max_depth + 1 tokens (near-ties aside)."""
    _, _, (cfg, model) = ws["tiny"]
    tpl = TreeTemplate.from_widths([2, 1, 1])
    stats = SpecStats()
    out = list(DeviceTreeEngine(model, cfg,
                                self_draft_layers=cfg.llm.n_layers,
                                template=tpl, block_steps=4, max_seq=SEQ,
                                device="cpu").generate([3, 17, 5], 16,
                                                       stats=stats))
    assert len(out) == 16
    assert stats.tokens_per_step > 0.8 * (tpl.max_depth + 1)


def _prefilled_pair(model, draft, S_, lengths):
    """Target and draft caches of S_ slots, slot s prefilled with the
    first lengths[s] tokens of PROMPT-like sequences."""
    out = []
    for m in (model, draft):
        llm = m.llm
        kv = KVCache.create(llm.n_layers, S_, SEQ, llm.n_kv_heads,
                            llm.head_size, "cpu")
        Tm = max(lengths)
        toks = torch.arange(S_ * Tm).reshape(S_, Tm) * 7 % 200 + 3
        pos = torch.arange(Tm).expand(S_, Tm).clone()
        pos[pos >= torch.tensor(lengths)[:, None]] = -1
        m(kv, toks, pos, logits_mode="none")
        out.append(kv)
    return out, toks


def test_tree_spec_scan_batched_active_matches_jax(ws):
    """Two slots at different lengths, the second inactive: the active
    slot's stream equals JAX tree_spec_scan's on the same prefill (near
    ties aside); the inactive one emits nothing, keeps its root, and its
    mask and pos do not move."""
    (_, (jcfg, jparams), (cfg, model)) = ws["tiny"]
    draft = self_draft_model(model, 1)
    tpl = TreeTemplate.from_widths([2, 1])
    (t_kv, d_kv), toks = _prefilled_pair(model, draft, 2, [6, 4])
    mask_before, pos_before = t_kv.mask[1].clone(), t_kv.pos[1].clone()
    root = torch.tensor([21, 33])
    active = torch.tensor([True, False])
    emitted, counts, new_root = tree_spec_scan(model, draft, t_kv, d_kv,
                                               root, 5, tpl, active)
    assert (counts[:, 1] == 0).all() and int(new_root[1]) == 33
    assert torch.equal(t_kv.mask[1], mask_before)
    assert int(t_kv.pos[1]) == int(pos_before) == int(d_kv.pos[1])
    got = [int(t) for i in range(5) for t in emitted[i, 0, :counts[i, 0]]]

    from powerserve_tpu.engine.loops import prefill_step
    from powerserve_tpu.speculative.chain import self_draft_config

    jllm = jcfg.llm
    d_llm = self_draft_config(jllm, 1)
    jt = JKVCache.create(jllm.n_layers, 2, SEQ, jllm.n_kv_heads,
                         jllm.head_size)
    jd = JKVCache.create(1, 2, SEQ, jllm.n_kv_heads, jllm.head_size)
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0)
    pos[1, 4:] = -1
    jtoks = jnp.asarray(toks.numpy().astype(np.int32))
    _, jt = prefill_step(jparams, jtoks, jnp.asarray(pos), jt, jllm, "xla")
    _, jd = prefill_step(jparams, jtoks, jnp.asarray(pos), jd, d_llm, "xla")
    je, jc, *_ = jtree_spec_scan(
        jparams, jparams, jt, jd, jnp.asarray([21, 33], jnp.int32), jllm,
        d_llm, 5, JTreeTemplate.from_widths([2, 1]).key(), "xla",
        active=jnp.asarray([True, False]))
    je, jc = np.asarray(je), np.asarray(jc)
    assert (jc[:, 1] == 0).all()
    want = [int(t) for i in range(5) for t in je[i, 0, :jc[i, 0]]]
    _near_tie(got, want, list(toks[0, :6].tolist()) + [21],
              _jengine(ws["tiny"]))


def _python_tree_loop(target, draft, t_kv, d_kv, tpl, root, n_steps):
    """Greedy tree steps as a plain Python loop: level forwards, then per
    slot the host's acceptance walk (TokenTree.accepted_chain) and the
    accepted entries moved one by one (copy_token)."""
    S_, N = root.shape[0], tpl.n_nodes
    depths = torch.from_numpy(tpl.depths).long()
    anc = torch.from_numpy(tpl.anc)
    out = []
    for _ in range(n_steps):
        c = d_kv.pos.long()
        mask0 = d_kv.mask.clone()
        tokens = torch.zeros(S_, N, dtype=torch.long)
        tokens[:, 0] = root
        keys = c[:, None] + torch.arange(N)[None, :]
        for d, lev in enumerate(tpl.levels):
            lev = torch.from_numpy(lev).long()
            logits = draft(d_kv, tokens[:, lev], c[:, None] + depths[lev],
                           cache_positions=c[:, None] + lev,
                           intra_mask=anc[lev], key_positions=keys,
                           attn_mask=mask0, logits_mode="all",
                           fuse_layers=True)
            for row, child, r in tpl.assignments[d]:
                tokens[:, child] = torch.topk(
                    logits[:, row, :target.llm.vocab_size],
                    tpl.level_topk[d]).indices[:, r]
        sampled = target(t_kv, tokens, c[:, None] + depths[None, :],
                         cache_positions=keys, intra_mask=anc,
                         logits_mode="argmax_all").long()
        emitted = []
        for s in range(S_):
            tree = TokenTree()
            for i in range(N):
                tree.add(int(tokens[s, i]), tpl.parents[i], 1.0)
            accepted, emit = tree.accepted_chain(sampled[s].numpy())
            chain = [0] + accepted
            for kv in (t_kv, d_kv):
                n = int(kv.pos[s] - c[s])
                kv.rollback(torch.tensor([n if i == s else 0
                                          for i in range(S_)]))
                for j, node in enumerate(chain):
                    kv.copy_token(s, int(c[s]) + j, int(c[s]) + node)
                kv.mask[s, int(c[s]):int(c[s]) + len(chain)] = True
                kv.pos[s] += len(chain)
            root[s] = emit[-1]
            emitted.append(emit)
        out.append(emitted)
    return out


@pytest.mark.parametrize("draft", ["self:1", "separate"])
def test_tree_step_twin_matches_python_loop(ws, draft):
    """The replayed greedy step's eager twin (tree_spec_scan on the CPU)
    against the plain Python loop: the same emitted tokens, and both
    caches bit for bit."""
    _, _, (cfg, model) = ws["tiny"]
    dmodel = (self_draft_model(model, 1) if draft == "self:1"
              else ws["draft"][2][1])
    tpl = TreeTemplate.from_widths([2, 2, 1])
    (t1, d1), _ = _prefilled_pair(model, dmodel, 2, [6, 3])
    t2, d2 = t1.clone(), d1.clone()
    root = torch.tensor([7, 9])
    emitted, counts, r1 = tree_spec_scan(model, dmodel, t1, d1, root, 4, tpl)
    want = _python_tree_loop(model, dmodel, t2, d2, tpl, root.clone(), 4)
    for i in range(4):
        for s in range(2):
            assert emitted[i, s, :counts[i, s]].tolist() == want[i][s]
    for a, b in ((t1, t2), (d1, d2)):
        for name in NAMES:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("sample", [True, "wor"])
def test_sampled_steps_at_temperature_zero_are_greedy(ws, sample):
    """Slots at temperature 0 draw nothing: exact-match steps reduce to
    the greedy tree step, emitted tokens, counts, roots and caches
    included; WOR steps emit the greedy stream (their siblings of the
    argmax carry no draft mass, so they are never accepted, and a step
    may stop where greedy's takes a second-ranked child)."""
    _, _, (cfg, model) = ws["tiny"]
    draft = self_draft_model(model, 1)
    tpl = TreeTemplate.from_widths([2, 1, 1])
    S_ = 3
    (t1, d1), _ = _prefilled_pair(model, draft, S_, [6, 5, 6])
    t2, d2 = t1.clone(), d1.clone()
    root = torch.tensor([7, 9, 11])
    e1, c1, r1 = tree_spec_scan(model, draft, t1, d1, root, 3, tpl)
    e2, c2, r2 = tree_spec_scan(
        model, draft, t2, d2, root, 3, tpl, torch.ones(S_, dtype=torch.bool),
        None, torch.zeros(S_), torch.full((S_,), 40), torch.ones(S_),
        sample=sample)
    if sample == "wor":
        for s in range(S_):
            a, b = ([int(t) for i in range(3) for t in e[i, s, :c[i, s]]]
                    for e, c in ((e1, c1), (e2, c2)))
            n = min(len(a), len(b))
            assert n >= 3 and a[:n] == b[:n]
        return
    assert torch.equal(c1, c2) and torch.equal(r1, r2)
    keep = torch.arange(tpl.max_depth + 1)[None, None, :] < c1[..., None]
    assert torch.equal(torch.where(keep, e1, -1), torch.where(keep, e2, -1))
    for a, b in ((t1, t2), (d1, d2)):
        for name in NAMES:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_wor_first_token_is_the_targets_sample(ws):
    """WOR verification is lossless: over many seeded slots the first
    emitted token follows the target's sampling distribution."""
    _, _, (cfg, model) = ws["tiny"]
    llm = cfg.llm
    S_ = 2048
    tpl = TreeTemplate.from_widths([3])
    root = torch.full((S_,), 7)
    temp, top_k, top_p = torch.ones(S_), torch.full((S_,), 8), torch.ones(S_)

    def fresh(layers):
        return KVCache.create(layers, S_, 8, llm.n_kv_heads, llm.head_size,
                              "cpu")

    one = KVCache.create(llm.n_layers, 1, 8, llm.n_kv_heads, llm.head_size,
                         "cpu")
    logits = model(one, root[:1, None], torch.zeros(1, 1, dtype=torch.long))
    p0 = sample_dist_batched(logits[:, :llm.vocab_size], temp[:1],
                             top_k[:1], top_p[:1])[0].numpy()
    gens = DrawState.create(S_, "cpu", range(S_))
    draft = self_draft_model(model, 1)
    emitted, counts, _ = tree_spec_scan(
        model, draft, fresh(llm.n_layers), fresh(1), root, 1, tpl,
        torch.ones(S_, dtype=torch.bool), gens, temp, top_k, top_p,
        sample="wor")
    hist = np.bincount(emitted[0, :, 0].numpy(),
                       minlength=llm.vocab_size).astype(np.float64)
    assert 0.5 * np.abs(hist / hist.sum() - p0).sum() < 0.1
    assert (counts[0] >= 1).all() and (counts[0] <= 2).all()


def test_host_engine_matches_jax_and_plain(ws):
    """The host tree engine (the target as its own draft, so trees grow
    and are accepted) emits the plain greedy stream and JAX's
    SpeculativeEngine's, step for step."""
    _, (jcfg, jparams), (cfg, model) = ws["tiny"]
    stats = SpecStats()
    got = list(SpeculativeEngine(model, cfg, model, cfg,
                                 SpeculativeConfig(**GROW), max_seq=SEQ,
                                 device="cpu").generate(PROMPT, 16,
                                                        stats=stats))
    assert len(got) == 16 and stats.accepted > 0
    jeng = _jengine(ws["tiny"])
    _near_tie(got, _plain_greedy(cfg, model, PROMPT, 16), PROMPT, jeng)
    jstats_eng = JSpeculativeEngine(jparams, jcfg, jparams, jcfg,
                                    JSpeculativeConfig(**GROW), max_seq=SEQ,
                                    backend="xla")
    _near_tie(got, list(jstats_eng.generate(PROMPT, 16)), PROMPT, jeng)


# -- the scheduler's tree tick and the entry points ----------------------------


REQS = [dict(prompt_ids=[1, 4, 9, 11]), dict(prompt_ids=list(range(3, 20))),
        dict(prompt_ids=[5, 5, 5, 6]), dict(prompt_ids=[7, 8])]


def _serve(model, cfg, draft=None, **hp_kw):
    """Run REQS (greedy, 14 tokens each) through a scheduler to the end:
    each request's tokens."""
    hp = HyperParams(max_slots=4, batch_size=8, max_seq_len=SEQ,
                     spec_horizon=2, **hp_kw)
    s = BatchScheduler(model, cfg, hp, device="cpu", draft=draft)
    outs = [[] for _ in REQS]
    reqs = [s.submit(Request(max_tokens=14, temperature=0.0,
                             sink=lambda t, o=o: t is not None and o.append(t),
                             **r)) for r, o in zip(REQS, outs)]
    while any(not r.finish_reason for r in reqs):
        s.step()
    return outs, s


@pytest.mark.parametrize("pool,wor", [({}, False),
                                      (dict(paged_pages=24, page_size=8),
                                       False), ({}, True)])
def test_scheduler_tree_tick_serves_the_plain_replies(ws, pool, wor):
    """spec_tree "2,1" with a 1-layer self-draft, on the dense cache and
    on a pool that preempts (exact-match), and with spec_wor: every
    greedy reply is the plain scheduler's (near ties aside), through the
    replayed greedy tree tick."""
    _, _, (cfg, model) = ws["tiny"]
    want, _ = _serve(model, cfg, **pool)
    got, s = _serve(model, cfg, self_draft_model(model, 1), spec_tree="2,1",
                    spec_wor=wor, **pool)
    assert s.spec_template.n_nodes == 5 and s.n_spec_steps > 0
    assert ("tree", wor) in {k[:2] for k in s.graphs.graphs}
    jeng = _jengine(ws["tiny"])
    for r, g, w in zip(REQS, got, want):
        assert len(g) == len(w) == 14
        _near_tie(g, w, r["prompt_ids"], jeng)


def test_scheduler_sampled_tree_tick_reproduces(ws):
    """A sampling slot beside a greedy one runs the eager tree tick: the
    seeded request reproduces its tokens, the greedy one stays plain."""
    _, _, (cfg, model) = ws["tiny"]

    def once():
        hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ,
                         spec_horizon=2, spec_tree="2,1")
        s = BatchScheduler(model, cfg, hp, device="cpu",
                           draft=self_draft_model(model, 1))
        outs = ([], [])
        reqs = [s.submit(Request(prompt_ids=[5, 5, 5, 6], max_tokens=10,
                                 temperature=t, seed=3,
                                 sink=lambda x, o=o: x is not None
                                 and o.append(x)))
                for t, o in zip((0.8, 0.0), outs)]
        while any(not r.finish_reason for r in reqs):
            s.step()
        return outs

    a, b = once(), once()
    assert a == b and len(a[0]) == len(a[1]) == 10
    _near_tie(a[1], _plain_greedy(cfg, model, [5, 5, 5, 6], 10),
              [5, 5, 5, 6], _jengine(ws["tiny"]))


@pytest.mark.parametrize("args", [
    ["--spec-engine", "device-tree", "--spec-tree", "2,1,1",
     "--self-draft-layers", "1"],
    ["--spec-engine", "device-tree", "--spec-tree", "2,1", "--draft", "D"],
    ["--spec-engine", "tree", "--draft", "D"]])
def test_cli_tree_engines_equal_run(ws, args):
    w = ws["tiny"][0]
    base = ["-d", str(w / "model"), "-p", "hello", "-n", "12",
            "--temperature", "0", "--no-progress", "--device", "cpu"]
    plain = run.run_prompt(run.parse_args(base))
    args = [str(ws["draft"][0] / "model") if a == "D" else a for a in args]
    spec = run.run_prompt(run.parse_args(base + args))
    assert spec.spec.emitted == len(spec.ids) == 12
    _near_tie(spec.ids, plain.ids, plain.prompt_ids, _jengine(ws["tiny"]))
    with pytest.raises(SystemExit):  # the tree engine needs a draft model
        run.run_prompt(run.parse_args(base + ["--spec-engine", "tree",
                                              "--self-draft-layers", "1"]))
