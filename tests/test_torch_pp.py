"""The port's pipeline parallelism (powerserve_tpu_torch/parallel/pp.py)
on the CPU: two stages over gloo (one rank group for the module: rank 0
this process, rank 1 a follower), against the port's single rank and the
JAX package's pp_forward, pp_decode_scan, pp_prefill_microbatched and
pp_mesh scheduler on a 2-device CPU mesh (the counterparts of JAX's
tests/test_pp.py and tests/test_compositions.py).

The pipelined forward is held bit for bit against the port's single
rank: each stage runs its layers as one device runs them and the
residual crosses in bf16, so logits, tokens and the cache put together
over the stages are the single rank's bits. The microbatched prefill
runs each microbatch's slots as a forward of their own, so its cache is
held bit for bit against one device's forward over the same
microbatches (the products' routes depend on the row count), and the
next decode step against the whole batch's prefill within 2e-2 of the
logits' range (a product over fewer rows rounds otherwise, so some K/V
entries sit one int8 step apart). Against JAX (its XLA route
dequantizes in bf16): 3e-2 of the logits' range, and greedy tokens by
the near-tie rule (a stream may part only where the single rank's
teacher-forced top-2 gap is < 0.5).
"""

import os
import queue
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.scheduler import BatchScheduler as JScheduler
from powerserve_tpu.engine.scheduler import Request as JRequest
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.parallel import pp as jpp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.parallel import pp
from powerserve_tpu_torch.parallel.tp import start_rank_group
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SEQ = 64
JAX_REL = 3e-2
NEAR_TIE = 0.5
PROMPTS = [[3, 17, 5, 9], list(range(20, 41))]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """"model" (tiny Q8_0, 2 layers), "draft" (another seed) and "eagle"
    (a random head at tiny's widths)."""
    r = tmp_path_factory.mktemp("ppserve")
    make_synthetic_gguf(r, "tiny", GGMLType.Q8_0, seed=0, seq_len=SEQ)
    w = make_synthetic_gguf(tmp_path_factory.mktemp("draft"), "tiny",
                            GGMLType.Q8_0, seed=7, seq_len=SEQ)
    (w / "model").rename(r / "draft")
    make_eagle_gguf(r / "eagle", "tiny", seed=9)
    return r


@pytest.fixture(scope="module")
def single(root):
    cfg, model = load_gguf_model(root / "model", device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return cfg, model, InferenceEngine(model, cfg, hp, device="cpu")


@pytest.fixture(scope="module")
def jmodel(root):
    cfg, params = jload(root / "model", stacked=True)
    mesh = make_mesh({"pp": 2}, devices=jax.devices()[:2])
    return cfg, params, mesh, jpp.shard_params_pp(params, mesh, cfg.llm)


@pytest.fixture(scope="module")
def ranks(root):
    group = start_rank_group(2, "gloo", "cpu", threads=1)
    yield group, group.load(root / "model", 1, pp=2)[1]
    group.close()


def _caches(cfg, model, S):
    llm = cfg.llm
    args = (llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size)
    return KVCache.create(*args, "cpu"), model.create_cache(*args)


def _near_tie(got, want, prompt, single):
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert len(got) == len(want), (got, want)
        return
    engine = single[2]
    engine.reset()
    top2 = engine.prefill(list(prompt) + list(want[:i])).topk(2).values
    assert float(top2[0] - top2[1]) < NEAR_TIE, (i, got, want)


def _same_cache(kv, kv1):
    whole = kv.gathered()
    for name in ("k", "v", "k_scale", "v_scale", "mask", "pos"):
        assert torch.equal(whole[name], getattr(kv1, name)), name


@pytest.mark.parametrize("mode", ["all", "last", "argmax_all"])
def test_pp_forward_matches_jax_and_is_the_single_ranks(single, jmodel,
                                                        ranks, mode):
    """pp_forward over two stages (JAX tests/test_pp.py:39): the single
    rank's outputs and cache bit for bit; JAX's pp_forward's logits
    within 3e-2 of their range."""
    cfg, one, _ = single
    group, model = ranks
    S, C = 4, 4
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.llm.vocab_size, (S, C)))
    pos = torch.arange(C)[None].expand(S, C)
    kv1, kv = _caches(cfg, model, S)
    want = one(kv1, tokens, pos, logits_mode=mode)
    got = pp.pp_forward(model, kv, tokens, pos, logits_mode=mode)
    assert torch.equal(got, want)
    _same_cache(kv, kv1)
    if mode == "all":
        jcfg, _, mesh, jp = jmodel
        llm = jcfg.llm
        jkv = jpp.shard_kv_pp(JKVCache.create(
            llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size), mesh)
        jlog, _ = jpp.pp_forward(jp, llm, jkv, jnp.asarray(tokens.numpy()),
                                 jnp.asarray(pos.numpy()), mesh=mesh,
                                 backend="xla", logits_mode="all")
        jlog = np.asarray(jlog)
        assert np.abs(got.numpy() - jlog).max() <= JAX_REL * np.abs(
            jlog).max()


def test_pp_decode_chain_matches_jax_and_single(single, jmodel, ranks):
    """A prefill, then pp_decode_scan's greedy steps (JAX
    tests/test_pp.py:64): the single rank's tokens exactly, JAX's by the
    near-tie rule."""
    cfg, one, _ = single
    group, model = ranks
    prompt = torch.tensor([[3, 17, 5, 9], [8, 1, 2, 6]])
    pos = torch.arange(4)[None].expand(2, 4)
    kv1, kv = _caches(cfg, model, 2)
    cur = pp.pp_forward(model, kv, prompt, pos, logits_mode="argmax")
    assert torch.equal(cur, one(kv1, prompt, pos, logits_mode="argmax"))
    got = pp.pp_decode_scan(model, cur, kv, 8)
    toks, tok = [], cur
    for _ in range(8):
        tok = one(kv1, tok[:, None], kv1.pos.long()[:, None],
                  logits_mode="argmax")
        toks.append(tok)
    assert torch.equal(got, torch.stack(toks, 1))
    _same_cache(kv, kv1)
    jcfg, _, mesh, jp = jmodel
    llm = jcfg.llm
    jkv = jpp.shard_kv_pp(JKVCache.create(llm.n_layers, 2, SEQ,
                                          llm.n_kv_heads, llm.head_size),
                          mesh)
    jlog, jkv = jpp.pp_forward(jp, llm, jkv, jnp.asarray(prompt.numpy()),
                               jnp.asarray(pos.numpy()), mesh=mesh,
                               backend="xla", logits_mode="last")
    jcur = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    jgot, _ = jpp.pp_decode_scan(jp, jcur, jkv, llm, 8, mesh, "xla")
    for s in range(2):
        p = prompt[s].tolist()
        _near_tie([int(jcur[s])] + np.asarray(jgot)[s].tolist(),
                  [int(cur[s])] + got[s].tolist(), p, single)


def test_pp_microbatched_prefill_matches_jax_and_single(single, jmodel,
                                                        ranks):
    """GPipe prefill in two microbatches (JAX tests/test_pp.py:91): the
    cache one device's forward over the same microbatches writes, pos and
    mask the whole batch's, and the next decode step's logits the whole
    batch's (2e-2) and JAX's (3e-2)."""
    cfg, one, _ = single
    group, model = ranks
    S, C = 4, 8
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.llm.vocab_size, (S, C)))
    pos = torch.arange(C)[None].expand(S, C)
    kv_mb, kv = _caches(cfg, model, S)
    pp.pp_prefill_microbatched(model, kv, tokens, pos, n_micro=2)
    kv_one = KVCache.create(*(cfg.llm.n_layers, S, SEQ, cfg.llm.n_kv_heads,
                              cfg.llm.head_size), "cpu")
    one(kv_one, tokens, pos, logits_mode="none")
    for half in (slice(0, 2), slice(2, 4)):
        part = KVCache.create(cfg.llm.n_layers, 2, SEQ, cfg.llm.n_kv_heads,
                              cfg.llm.head_size, "cpu")
        one(part, tokens[half], pos[half], logits_mode="none")
        for name in ("k", "v", "k_scale", "v_scale"):
            getattr(kv_mb, name)[:, half] = getattr(part, name)
        kv_mb.mask[half], kv_mb.pos[half] = part.mask, part.pos
    _same_cache(kv, kv_mb)
    assert torch.equal(kv_mb.pos, kv_one.pos)
    assert torch.equal(kv_mb.mask, kv_one.mask)
    cur = torch.tensor([5, 6, 7, 8])
    step = (cur[:, None], kv_one.pos.long()[:, None])
    got = pp.pp_forward(model, kv, *step, logits_mode="last")
    want = one(kv_one, *step, logits_mode="last")
    assert float((got - want).abs().max()) <= 2e-2 * float(
        want.abs().max())
    jcfg, _, mesh, jp = jmodel
    llm = jcfg.llm
    jkv = jpp.shard_kv_pp(JKVCache.create(llm.n_layers, S, SEQ,
                                          llm.n_kv_heads, llm.head_size),
                          mesh)
    jkv = jpp.pp_prefill_microbatched(jp, llm, jkv,
                                      jnp.asarray(tokens.numpy()),
                                      jnp.asarray(pos.numpy()), mesh=mesh,
                                      n_micro=2, backend="xla")
    jlog, _ = jpp.pp_forward(jp, llm, jkv, jnp.asarray(cur.numpy()[:, None]),
                             jkv.pos[:, None].astype(jnp.int32), mesh=mesh,
                             backend="xla", logits_mode="last")
    jlog = np.asarray(jlog)
    assert np.abs(got.numpy() - jlog).max() <= JAX_REL * np.abs(jlog).max()


def _hp(**kw) -> HyperParams:
    return HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ, spec_k=3,
                       prefix_cache=0, **kw)


def _stepwise(sched, prompts, max_tokens=10, embeds=None):
    outs, dones = [], []
    for i, p in enumerate(prompts):
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=0.0, sink=sink,
                             embeds=None if embeds is None else embeds[i]))
        outs.append(out)
        dones.append(done)
    for _ in range(2000):
        if all(not d.empty() for d in dones):
            break
        sched.step()
    assert all(not d.empty() for d in dones), "requests did not finish"
    return outs


def _rows(cfg, prompts):
    rng = np.random.default_rng(5)
    return [torch.as_tensor(rng.standard_normal(
        (len(p), cfg.llm.dim)).astype(np.float32)).to(torch.bfloat16)
        for p in prompts]


# (hp keywords, the draft: None, "dir" or "eagle")
SCHED = {
    "dense": ({}, None),
    # 4 pages of 8 for two requests of 4 + 10 and 21 + 10 tokens: a
    # recompute preemption
    "paged_preempt": (dict(paged_pages=4, page_size=8), None),
    "mm": ({}, None),
    "chain_draft_dir": ({}, "dir"),
    "eagle_chain": ({}, "eagle"),
    "eagle_tree": (dict(spec_tree="2,1"), "eagle"),
}


@pytest.mark.parametrize("case", list(SCHED))
def test_pp_scheduler_gives_the_single_ranks_replies(root, single, ranks,
                                                     case):
    """The scheduler's ticks over two stages (JAX tests/test_pp.py:130-298,
    tests/test_compositions.py:73): plain dense and paged (with a
    preemption), multimodal prefills (input rows for every prompt), a
    draft model's chain (both models staged) and EAGLE's chain and tree
    (the head whole on every stage): the single rank's replies exactly."""
    cfg, one, _ = single
    group, model = ranks
    kw, kind = SCHED[case]
    embeds = _rows(cfg, PROMPTS) if case == "mm" else None
    draft = {None: {}, "dir": lambda: dict(
        draft=group.load(root / "draft", 1, pp=2)[1]),
        "eagle": lambda: dict(eagle_head=group.eagle(model,
                                                     root / "eagle"))}[kind]
    want = _stepwise(BatchScheduler(one, cfg, _hp(), "cpu"), PROMPTS,
                     embeds=embeds)
    sched = BatchScheduler(model, cfg, _hp(**kw), "cpu",
                           **(draft() if callable(draft) else draft))
    assert _stepwise(sched, PROMPTS, embeds=embeds) == want
    if kind is not None:
        assert sched.n_spec_steps > 0
    if case == "paged_preempt":
        assert sched.n_preemptions >= 1


@pytest.mark.parametrize("case", ["dense", "paged", "chain_draft_dir"])
def test_pp_scheduler_matches_jax_pp_mesh(root, single, jmodel, ranks,
                                          case):
    """JAX's BatchScheduler(pp_mesh=) on a 2-device mesh (JAX
    tests/test_pp.py:130, :191, tests/test_compositions.py:73): the
    port's pp scheduler's greedy tokens, by the near-tie rule, on the
    dense cache, on a pool of 8 pages of 8 and with a draft model's
    chain (k = 3, both models staged)."""
    jcfg, _, mesh, jp = jmodel
    paged = dict(paged_pages=8, page_size=8) if case == "paged" else {}
    spec = {}
    group, model = ranks
    draft = None
    if case == "chain_draft_dir":
        dcfg, dparams = jload(root / "draft", stacked=True)
        spec = dict(draft_params=jpp.shard_params_pp(dparams, mesh,
                                                     dcfg.llm),
                    draft_llm=dcfg.llm, spec_k=3)
        draft = group.load(root / "draft", 1, pp=2)[1]
    js = JScheduler(jp, jcfg, JHyperParams(max_slots=2, batch_size=8,
                                           max_seq_len=SEQ, prefix_cache=0,
                                           **paged),
                    backend="xla", pp_mesh=mesh, **spec)
    outs, dones = [], []
    for p in PROMPTS:
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        js.submit(JRequest(prompt_ids=list(p), max_tokens=10,
                           temperature=0.0, sink=sink))
        outs.append(out)
        dones.append(done)
    for _ in range(600):
        if all(not d.empty() for d in dones):
            break
        js.step()
    js.stop()
    got = _stepwise(BatchScheduler(model, single[0], _hp(**paged), "cpu",
                                   draft=draft), PROMPTS)
    for g, w, p in zip(got, outs, PROMPTS):
        _near_tie(g, w, p, single)


def test_pp_refuses_what_jax_refuses(root, single, ranks):
    """JAX tests/test_compositions.py:94: a self-draft and a draft model's
    token tree do not run under pp (JAX asserts; the port raises a
    ValueError, the server answers 400); serve --pp with --tp exits 2."""
    group, model = ranks
    with pytest.raises(ValueError, match="self-draft"):
        group.self_draft(model, 1)
    draft = group.load(root / "draft", 1, pp=2)[1]
    with pytest.raises(ValueError, match="token tree"):
        BatchScheduler(model, single[0], _hp(spec_tree="2,2"), "cpu",
                       draft=draft)
    out = subprocess.run(
        [sys.executable, "-m", "powerserve_tpu_torch", "serve", "-d",
         str(root), "--device", "cpu", "--pp", "2", "--tp", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 2 and "pp runs alone" in out.stderr
