"""EAGLE heads over a rank group on the CPU (gloo, tp = 2): the head's
layer sharded like a target layer, its fc and norms replicated, its
embedding and lm_head the target's own (vocab-sharded) shards, its cache
over kv heads (the JAX prepare_eagle_for_tp / eagle_param_specs /
tp_eagle_*). One rank group of 2 for the module.

- Each rank's head shards are the slices JAX's shard_eagle_tp puts on
  device r of a 2-device CPU mesh.
- eagle_forward over the ranks (a prefill chunk, then a decode-sized
  batch, logits and features) against the single rank's.
- The scheduler's EAGLE chain and tree ticks over the ranks (dense, paged,
  a factored head) give the plain greedy tokens, as JAX's tp scheduler
  with the same head does (tp_eagle_prefill, tp_eagle_spec_scan,
  tp_eagle_tree_spec_scan); the exact-replica head over a 1-layer
  target accepts every draft.

Tolerances as tests/test_torch_tp.py states them: 1e-5 of the range
against the single rank (wo's and down's rows summed in two partial
sums); greedy tokens equal up to a near-tie (top-2 gap < 0.5).
"""

import jax
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.scheduler import BatchScheduler as JScheduler
from powerserve_tpu.engine.scheduler import Request as JRequest
from powerserve_tpu.models.loader import load_eagle_gguf as jload_eagle
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.parallel import tp as jtp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.config import HyperParams, ModelConfig
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.loader import load_eagle_gguf, load_gguf_model
from powerserve_tpu_torch.parallel import tp
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.speculative.eagle import eagle_forward
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 64
SELF_REL = 1e-5
NEAR_TIE = 0.5
PROMPTS = [[3, 5, 7, 9, 11], [101, 7, 42], list(range(20, 37))]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tiny Q8_0 target (vocab 256: split over the ranks) and a
    random EAGLE-1 head at its widths (4 heads, 2 kv heads)."""
    d = make_synthetic_gguf(tmp_path_factory.mktemp("tp_eagle"), "tiny",
                            GGMLType.Q8_0, seed=0, seq_len=SEQ) / "model"
    h = make_eagle_gguf(tmp_path_factory.mktemp("tp_eagle_head"), "tiny",
                        seed=9)
    return d, h


@pytest.fixture(scope="module")
def single(ws):
    d, h = ws
    cfg, model = load_gguf_model(d, device="cpu")
    _, head = load_eagle_gguf(h, model, cfg.llm, device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return cfg, model, head, InferenceEngine(model, cfg, hp, device="cpu")


@pytest.fixture(scope="module")
def ranks(ws):
    d, h = ws
    group = tp.start_rank_group(2, "gloo", "cpu", threads=1)
    cfg, tmodel = group.load(d, 2)
    yield group, tmodel, group.eagle(tmodel, h)
    group.close()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_head_shards_are_eagle_param_specs_slices(ws):
    d, h = ws
    jcfg, jparams = jload(d)
    je_llm, jep = jload_eagle(h, jparams, jcfg.llm)
    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jsharded = jtp.shard_eagle_tp(jep, mesh, je_llm)

    def on(arr, r):
        dev = mesh.devices.flat[r]
        return next(np.asarray(s.data) for s in arr.addressable_shards
                    if s.device == dev)

    cfg, model = load_gguf_model(d, device="cpu", fuse=False)
    _, head = load_eagle_gguf(h, model, cfg.llm, device="cpu", fuse=False)
    for r in range(2):
        target = tp.shard_params_tp(model, r, 2)
        local = tp.shard_eagle_tp(head, r, 2, target)
        assert local.llm.n_heads == 2 and local.llm.n_kv_heads == 1
        mine, ref = local.layers[0], jsharded.layers[0]
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            for part in ("q", "scales"):
                assert np.array_equal(getattr(getattr(mine, name), part)
                                      .numpy(),
                                      on(getattr(getattr(ref, name), part),
                                         r)), (r, name, part)
        for part in ("q", "scales"):  # replicated
            assert np.array_equal(getattr(local.fc, part).numpy(),
                                  on(getattr(jsharded.fc, part), r))
        # the target's own shards of the embedding and the lm_head
        for part in ("q", "scales"):
            assert torch.equal(getattr(local.embed, part),
                               getattr(target.embed, part))
            assert np.array_equal(getattr(local.lm_head, part).numpy(),
                                  on(getattr(jsharded.lm_head, part), r))


def test_eagle_forward_over_ranks(single, ranks):
    """A target prefill chunk keeping its final hidden states, the head's
    chunk over them, then a decode-sized head batch: logits and features
    of the single rank's."""
    cfg, model, head, _ = single
    _, tmodel, thead = ranks
    llm, e_llm = cfg.llm, head.llm
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(3, 256, (2, 12)))
    pos = torch.arange(12)[None].repeat(2, 1)
    kv1 = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                         llm.head_size, "cpu")
    e1 = KVCache.create(1, 2, SEQ, e_llm.n_kv_heads, e_llm.head_size, "cpu")
    kv2 = tmodel.create_cache(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                              llm.head_size)
    e2 = tmodel.create_cache(1, 2, SEQ, e_llm.n_kv_heads, e_llm.head_size)
    assert thead.llm.n_heads == e_llm.n_heads
    assert thead.head_width == head.head_width == llm.vocab_size
    outs = []
    for target, h, kv, e_kv in ((model, head, kv1, e1),
                                (tmodel, thead, kv2, e2)):
        logits, feats = target(kv, tok, pos, logits_mode="all",
                               return_final_hidden=True)
        feats = feats.float()
        hl, hf = eagle_forward(h, e_kv, tok, torch.cat(
            [torch.zeros_like(feats[:, :1]), feats[:, :-1]], dim=1), pos,
            logits_mode="all")
        nxt = hl[:, -1].argmax(-1)
        dl, df = eagle_forward(h, e_kv, nxt[:, None], hf[:, -1:],
                               torch.full((2, 1), 12), logits_mode="all")
        am, _ = eagle_forward(h, e_kv, nxt[:, None], df,
                              torch.full((2, 1), 13), logits_mode="argmax")
        outs.append((logits, feats, hl, hf, dl, df, am))
    for a, b in zip(outs[1], outs[0]):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            assert _rel(a, b) <= SELF_REL
    whole = e2.gathered()
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(whole[name], getattr(e1, name)), name


def _stepwise(sched, prompts, max_tokens=8):
    outs, done = [[] for _ in prompts], []
    for out, p in zip(outs, prompts):
        def sink(t, out=out):
            done.append(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=0.0, sink=sink))
    for _ in range(1000):
        if len(done) == len(prompts):
            break
        sched.step()
    assert len(done) == len(prompts), "requests did not finish"
    return outs


def _agree(got, want, engine):
    for g, w, p in zip(got, want, PROMPTS):
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            assert len(g) == len(w), (g, w)
            continue
        engine.reset()
        top2 = engine.prefill(list(p) + w[:i]).topk(2).values
        assert float(top2[0] - top2[1]) < NEAR_TIE, (i, g, w)


@pytest.fixture(scope="module")
def plain(single):
    cfg, model, _, _ = single
    return _stepwise(BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=SEQ), "cpu"), PROMPTS)


def _jax_tp_eagle(ws, hp_kw):
    """JAX's tp scheduler with the same head on a 2-device mesh."""
    import threading

    d, h = ws
    jcfg, jparams = jload(d)
    je_llm, jep = jload_eagle(h, jparams, jcfg.llm)
    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jhp = JHyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ, **hp_kw)
    s = JScheduler(jtp.shard_params_tp(jparams, mesh, jcfg.llm), jcfg, jhp,
                   backend="xla", tp_mesh=mesh,
                   eagle_params=jtp.shard_eagle_tp(jep, mesh, je_llm),
                   eagle_llm=je_llm)
    s.start()
    outs, dones = [], []
    try:
        for p in PROMPTS:
            out, done = [], threading.Event()

            def sink(t, out=out, done=done):
                done.set() if t is None else out.append(t)

            s.submit(JRequest(prompt_ids=list(p), max_tokens=8,
                              temperature=0.0, sink=sink))
            outs.append(out)
            dones.append(done)
        for dn in dones:
            assert dn.wait(timeout=300)
    finally:
        s.stop()
    jax.clear_caches()
    return outs


# case -> (hyper-params, factored head rank, against JAX)
CASES = {"chain": (dict(spec_k=3), 0, True),
         "tree": (dict(spec_tree="2,1"), 0, True),
         "tree-paged": (dict(spec_tree="2,1", paged_pages=16, page_size=8),
                        0, False),
         "chain-factored": (dict(spec_k=2), 32, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_eagle_ticks_over_ranks_give_the_plain_tokens(ws, single, ranks,
                                                      plain, case):
    cfg, model, _, engine = single
    group, tmodel, thead = ranks
    kw, rank, vs_jax = CASES[case]
    head = thead if not rank else group.eagle(tmodel, ws[1], rank)
    sched = BatchScheduler(tmodel, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=SEQ, **kw), "cpu",
        eagle_head=head)
    got = _stepwise(sched, PROMPTS)
    assert sched.n_spec_steps > 0
    _agree(got, plain, engine)
    if vs_jax:
        _agree(got, _jax_tp_eagle(ws, kw), engine)
    sched.release()


def test_exact_replica_over_ranks_accepts_every_draft(single, ranks):
    """The exact-replica head of a 1-layer target's shards: the 1-layer
    target's plain tokens, every draft accepted."""
    cfg, model, _, _ = single
    group, tmodel, _ = ranks
    one = group.self_draft(tmodel, 1)
    head = group.replica_eagle(one)
    one_cfg = ModelConfig(llm=one.llm)
    hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ, spec_k=3)
    sched = BatchScheduler(one, one_cfg, hp, "cpu", eagle_head=head)
    got = _stepwise(sched, PROMPTS[:2])
    want = _stepwise(BatchScheduler(self_draft_model(model, 1), one_cfg,
                                    HyperParams(max_slots=2, batch_size=8,
                                                max_seq_len=SEQ), "cpu"),
                     PROMPTS[:2])
    assert got == want
    assert sched.n_spec_accepted == sched.n_spec_drafted > 0
    sched.release()
