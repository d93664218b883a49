"""Mixture-of-experts models over a rank group on the CPU (gloo): tensor
parallelism (tp = 2: every expert stack split like the dense FFN) and
expert parallelism (ep = 2, tp = 1: two experts a rank), against the JAX
package's shard_map forward on a 2-device CPU mesh and against the
port's single rank. One rank group of 2 for the module.

The model is tiny-moe (4 experts, top-2) in Q8_0 with an ffn of 128, so
each rank's down slabs hold K = 64, a multiple of the 32-wide blocks;
tiny-moe's own ffn of 96 (48 a rank) is refused as JAX refuses it.

Tolerances (as tests/test_torch_tp.py and tests/test_torch_moe.py state
them): against the single rank 1e-5 of the logits' range (the expert
down's rows are summed in two partial sums, or the experts' outputs over
two ranks, then added: another order than one rank's); against JAX
(bf16 dequantization on its XLA route) 3e-2 of the range, over the rows
whose k-th and (k+1)-th router probabilities are 1% apart in every layer
(a nearer pair may route apart in the other package). Schedulers over
ranks give the single rank's greedy tokens, or part from them only where
the single rank's top-2 logit gap is below 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import powerserve_tpu_torch.models.llama as tllama
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.parallel import tp as jtp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.parallel import tp
from powerserve_tpu_torch.speculative.chain import self_draft_model
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 64
SELF_REL = 1e-5
JAX_REL = 3e-2
NEAR_TIE = 0.5
# (tp, ep) of each composition
MESHES = {"tp2": (2, 1), "ep2": (1, 2)}
PROMPTS = [[3, 5, 7, 9, 11], [101, 7, 42], list(range(20, 37))]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_synthetic_gguf(tmp_path_factory.mktemp("tpmoe"), "tiny-moe",
                               GGMLType.Q8_0, seed=7, seq_len=SEQ,
                               ffn=128) / "model"


@pytest.fixture(scope="module")
def single(ws):
    cfg, model = load_gguf_model(ws, device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return cfg, model, InferenceEngine(model, cfg, hp, device="cpu")


@pytest.fixture(scope="module")
def jmodel(ws):
    return jload(ws)


@pytest.fixture(scope="module")
def ranks(ws):
    group = tp.start_rank_group(2, "gloo", "cpu", threads=1)
    models = {name: group.load(ws, t, 1, ep=e)[1]
              for name, (t, e) in MESHES.items()}
    yield group, models
    group.close()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mesh(name):
    t, e = MESHES[name]
    return make_mesh({"ep": e, "tp": t}, devices=jax.devices()[:2])


def test_a_down_that_does_not_split_is_refused_as_jax_refuses(tmp_path):
    """tiny-moe's ffn of 96 leaves 48 rows of each expert down a rank:
    no whole 32-wide block. JAX's prepare_params_for_tp refuses it, and
    the port with JAX's message."""
    d = make_synthetic_gguf(tmp_path, "tiny-moe", GGMLType.Q8_0, seed=0,
                            seq_len=SEQ) / "model"
    jcfg, jparams = jload(d)
    with pytest.raises(ValueError) as want:
        jtp.prepare_params_for_tp(jparams, jcfg.llm, 2)
    _, model = load_gguf_model(d, device="cpu")
    with pytest.raises(ValueError) as got:
        tp.shard_params_tp(model, 0, 2)
    assert str(got.value) == str(want.value) == ("K=96 not row-shardable "
                                                 "over tp=2")
    with pytest.raises(ValueError, match="experts split"):
        tp.shard_params_tp(model, 0, 1, 0, 3)


@pytest.mark.parametrize("name", list(MESHES))
def test_expert_shards_are_param_specs_slices(single, jmodel, name):
    """Rank r's expert stacks (and router) are the slices JAX's
    param_specs puts on device r: gate/up over N and down over K by tp,
    the experts over ep."""
    cfg, model, _ = single
    jcfg, jparams = jmodel
    t, e = MESHES[name]
    mesh = _mesh(name)
    jsharded = jtp.shard_params_tp(jparams, mesh, jcfg.llm)

    def on(arr, r):
        dev = mesh.devices.flat[r]
        return next(np.asarray(s.data) for s in arr.addressable_shards
                    if s.device == dev)

    for r in range(2):
        local = tp.shard_params_tp(model, r % t, t, r // t, e)
        for i, lw in enumerate(local.layers):
            assert lw.w_gate_exps.n_slabs == 4 // e
            for field in ("w_gate_exps", "w_up_exps", "w_down_exps"):
                mine, ref = getattr(lw, field), getattr(jsharded.layers, field)
                for part in ("q", "scales"):
                    assert np.array_equal(getattr(mine, part).numpy(),
                                          on(getattr(ref, part), r)[i]), (
                        r, field, part)
            assert np.array_equal(lw.router.numpy(),
                                  on(jsharded.layers.router, r)[i])


def _jax_forward(jmodel, name, steps, S):
    """JAX's tp_forward on the mesh over `steps` (tokens, positions, logits
    mode); the last step's logits."""
    jcfg, jparams = jmodel
    llm = jcfg.llm
    mesh = _mesh(name)
    p = jtp.shard_params_tp(jparams, mesh, llm)
    kv = jtp.shard_kv_tp(JKVCache.create(llm.n_layers, S, SEQ,
                                         llm.n_kv_heads, llm.head_size), mesh)
    for toks, pos, mode in steps:
        fwd = jax.jit(lambda p, kv, t, q, mode=mode: jtp.tp_forward(
            p, llm, kv, t, q, mesh=mesh, backend="xla", logits_mode=mode))
        out, kv = fwd(p, kv, jnp.asarray(toks), jnp.asarray(pos, jnp.int32))
    return np.asarray(out)


def _gap_spy(monkeypatch) -> list:
    """Each layer's gap between the logs of every row's k-th and
    (k+1)-th router probabilities (rank 0's layers: the router and its
    inputs are replicated)."""
    gaps = []
    real = tllama.LlamaLayer.route

    def route(self, h, k):
        probs = torch.softmax(h.float() @ self.router.float(), dim=-1)
        top = probs.topk(k + 1, dim=-1).values.log()
        gaps.append((top[:, k - 1] - top[:, k]).numpy())
        return real(self, h, k)

    monkeypatch.setattr(tllama.LlamaLayer, "route", route)
    return gaps


# a 20-token prefill of 2 slots (the grouped route at 16-row tiles), a
# 2-slot decode step (grouped), a 1-slot decode step (single-token route
# without ep, grouped under ep)
def _steps(rng, vocab):
    toks = rng.integers(3, vocab, (2, 21))
    pre = (toks[:, :20], np.broadcast_to(np.arange(20), (2, 20)).copy(),
           "all")
    return [[pre, (toks[:, 20:21], np.full((2, 1), 20), "all")],
            [(pre[0][:1], pre[1][:1], "none"),
             (toks[:1, 20:21], np.full((1, 1), 20), "all")]]


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_forward_over_ranks(single, jmodel, ranks, name, monkeypatch):
    cfg, model, _ = single
    llm = cfg.llm
    _, models = ranks
    tmodel = models[name]
    for n, steps in enumerate(_steps(np.random.default_rng(0),
                                     llm.vocab_size)):
        S = steps[0][0].shape[0]
        kv1 = KVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads,
                             llm.head_size, "cpu")
        kv2 = tmodel.create_cache(llm.n_layers, S, SEQ, llm.n_kv_heads,
                                  llm.head_size)
        gaps = _gap_spy(monkeypatch)
        for toks, pos, mode in steps:
            gaps.clear()
            args = (torch.from_numpy(toks), torch.from_numpy(pos))
            got = tmodel(kv2, *args, logits_mode=mode)
            n_layers_seen = len(gaps)
            want = model(kv1, *args, logits_mode=mode)
            if mode != "none":
                assert _rel(got, want) <= SELF_REL, (name, toks.shape)
        assert n_layers_seen == llm.n_layers
        if n == 0:  # JAX's route at one token is held in test_torch_moe.py
            jwant = _jax_forward(jmodel, name, steps, S)
            far = np.min(np.stack(gaps[:llm.n_layers]), axis=0) >= 1e-2
            rows = got.numpy().reshape(-1, got.shape[-1])
            assert far.mean() >= 0.5
            assert _rel(rows[far], jwant.reshape(rows.shape)[far]) <= JAX_REL
        whole = kv2.gathered()
        for field in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(whole[field], getattr(kv1, field)), field


def _stepwise(sched, prompts, max_tokens=6):
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


def _agree(got, want, prompts, engine):
    for g, w, p in zip(got, want, prompts):
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            assert len(g) == len(w), (g, w)
            continue
        engine.reset()
        top2 = engine.prefill(list(p) + w[:i]).topk(2).values
        assert float(top2[0] - top2[1]) < NEAR_TIE, (i, g, w)


# (mesh, hyper-params, draft): plain dense and paged, a chain and a
# device tree of a 1-layer self-draft, and expert parallelism
SCHED = {"tp2-dense": ("tp2", {}, None),
         "tp2-paged": ("tp2", dict(paged_pages=16, page_size=8), None),
         "tp2-chain": ("tp2", dict(spec_k=2), 1),
         "tp2-tree": ("tp2", dict(spec_tree="2,1"), 1),
         "ep2-paged-chain": ("ep2", dict(paged_pages=16, page_size=8,
                                         spec_k=2), 1)}


@pytest.mark.parametrize("case", list(SCHED))
def test_schedulers_over_ranks_give_the_single_ranks_tokens(single, ranks,
                                                            case):
    cfg, model, engine = single
    group, models = ranks
    name, kw, n_draft = SCHED[case]
    hp = HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ, **kw)
    draft = None if n_draft is None else group.self_draft(models[name],
                                                          n_draft)
    sched = BatchScheduler(models[name], cfg, hp, "cpu", draft=draft)
    got = _stepwise(sched, PROMPTS)
    ref = BatchScheduler(model, cfg, HyperParams(
        max_slots=2, batch_size=8, max_seq_len=SEQ, **kw), "cpu",
        draft=None if n_draft is None else self_draft_model(model, n_draft))
    want = _stepwise(ref, PROMPTS)
    _agree(got, want, PROMPTS, engine)
    if n_draft is not None:
        assert sched.n_spec_steps > 0
    sched.release()
