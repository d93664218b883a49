"""Mixture-of-experts parity on the CPU: the port's grouped dispatch,
combine, grouped matmul twin, expert-stack loading and MoE forward
against the JAX package on the same inputs (numpy, seeded).

Tolerances: the dispatch layout is integer bookkeeping and must be
bit-equal; combine adds the same f32 products in the same order. The
grouped twin follows the kernel's numerics (f32 weights at block_m 16,
bf16 weights at 128); against the Pallas kernel in interpret mode it
agrees to f32 rounding where both round alike. Whole-model logits carry
the bf16 roundings of the two packages' routes, as in
tests/test_torch_model.py (~2-3% of the logit range on these 2-layer
models); greedy tokens may differ only at a near-tie.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import powerserve_tpu_torch.models.llama as tllama
from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.generator import InferenceEngine as JEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.llama import _moe_grouped_decode_wins
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.ops import moe as jmoe
from powerserve_tpu.ops.qmatmul import QLinear as JQLinear
from powerserve_tpu.ops.qmatmul import qmatmul_grouped as jqmatmul_grouped
from powerserve_tpu.tools.bench_params import (
    make_device_params as jmake_device_params)
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models.llama import moe_route
from powerserve_tpu_torch.models.loader import (load_gguf_model,
                                                params_from_numpy)
from powerserve_tpu_torch.ops.moe import combine, group_dispatch
from powerserve_tpu_torch.ops.qmatmul import QLinear, qmatmul_grouped
from powerserve_tpu_torch.tools.bench_params import make_device_params
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 128
# the JAX XLA route dequantizes in bf16, the port in f32 at decode and
# bf16 at prefill: ~2% of the logit range over 2 layers
LOGIT_REL = 3e-2
NEAR_TIE = 0.5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _routing(rng, n, k, e):
    topi = np.stack([rng.choice(e, size=k, replace=False) for _ in range(n)])
    topw = rng.random((n, k)).astype(np.float32)
    return topi.astype(np.int32), topw


# (tokens, k, experts, n_local, e_off, block_m)
DISPATCH = [(37, 2, 4, 2, 1, 8), (19, 2, 4, 4, 0, 8), (8, 8, 128, 128, 0, 16),
            (72, 2, 8, 8, 0, 128), (5, 3, 6, 3, 3, 4)]


@pytest.mark.parametrize("n,k,e,n_local,e_off,bm", DISPATCH)
def test_group_dispatch_matches_jax(n, k, e, n_local, e_off, bm):
    topi, topw = _routing(np.random.default_rng(n + e), n, k, e)
    want = jmoe.group_dispatch(jnp.asarray(topi), jnp.asarray(topw),
                               n_local, e_off, bm)
    got = group_dispatch(torch.from_numpy(topi), torch.from_numpy(topw),
                         n_local, e_off, bm)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 or g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,k,e,n_local,e_off,bm", DISPATCH)
def test_combine_matches_jax(n, k, e, n_local, e_off, bm):
    rng = np.random.default_rng(n * k)
    topi, topw = _routing(rng, n, k, e)
    tok, w, _ = jmoe.group_dispatch(jnp.asarray(topi), jnp.asarray(topw),
                                    n_local, e_off, bm)
    y = rng.standard_normal((tok.shape[0], 24)).astype(np.float32)
    want = np.asarray(jmoe.combine(jnp.asarray(y), tok, w, n))
    got = combine(torch.from_numpy(y), torch.from_numpy(np.array(tok)),
                  torch.from_numpy(np.array(w)), n, k).numpy()
    # the same products added in the same (row) order
    np.testing.assert_array_equal(got, want)


def _stacks(rng, fmt, e, k, n):
    ws = (rng.standard_normal((e, k, n)) * 0.1).astype(np.float32)
    jparts = [JQLinear.from_float(w, fmt) for w in ws]
    jl = dataclasses.replace(
        jparts[0], q=jnp.stack([p.q for p in jparts]),
        scales=jnp.stack([p.scales for p in jparts]),
        bias=None if jparts[0].bias is None
        else jnp.stack([p.bias for p in jparts]))
    tl = QLinear.stack([QLinear.from_float(w, fmt, device="cpu") for w in ws])
    return jl, tl


@pytest.mark.parametrize("fmt,n,bm,tiles", [
    (GGMLType.Q8_0, 128, 16, [1, 0, 2]), (GGMLType.Q8_0, 256, 128, [2, 0]),
    (GGMLType.Q4_K, 256, 16, [0, 2, 2, 1]), (GGMLType.Q4_K, 128, 128, [1, 1])])
def test_grouped_twin_matches_pallas_interpret(fmt, n, bm, tiles):
    rng = np.random.default_rng(n + bm)
    k = 512
    jl, tl = _stacks(rng, fmt, 3, k, n)
    assert (tl.packed, tl.pack_group) == (jl.packed, jl.pack_group)
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    x = np.array(jnp.asarray(
        rng.standard_normal((len(tiles) * bm, k)), jnp.bfloat16
    ).astype(jnp.float32))
    ids = np.asarray(tiles, np.int32)
    got = qmatmul_grouped(torch.from_numpy(x), tl, torch.from_numpy(ids),
                          bm).numpy()
    # block_m 16: the kernel's f32 dequant and dots (the JAX kernel in
    # f32); block_m 128: weights rounded to bf16 after an f32 dequant (the
    # JAX kernel in bf16). Its packed kernel folds the Q4_K minimum through
    # a bf16 block-sum dot instead: 2^-9 per weight apart there
    compute = jnp.float32 if bm == 16 else jnp.bfloat16
    want = np.asarray(jqmatmul_grouped(
        jnp.asarray(x), jl, jnp.asarray(ids), block_m=bm,
        backend="pallas_interpret", compute_dtype=compute))
    tol = 1e-2 if (bm == 128 and fmt == GGMLType.Q4_K) else 1e-5
    assert _rel(got, want) < tol


def test_grouped_twin_slab_views():
    """Each tile equals the dense twin on that slab's 2-D view; ids past
    the stack clip to the last slab."""
    rng = np.random.default_rng(11)
    _, tl = _stacks(rng, GGMLType.Q4_0, 3, 256, 64)
    x = torch.from_numpy(rng.standard_normal((4 * 16, 256)).astype(
        np.float32))
    ids = torch.tensor([2, 0, 1, 7], dtype=torch.int32)
    got = qmatmul_grouped(x, tl, ids, 16)
    from powerserve_tpu_torch.ops.qmatmul import qmatmul
    for i, e in enumerate([2, 0, 1, 2]):
        view = tl.slab(e)
        assert view.q.data_ptr() == tl.q[e].data_ptr()  # a view, no copy
        torch.testing.assert_close(got[i * 16:(i + 1) * 16],
                                   qmatmul(x[i * 16:(i + 1) * 16], view),
                                   rtol=0, atol=0)


@pytest.fixture(scope="module")
def moe_models(tmp_path_factory):
    """name -> (workspace, JAX (cfg, params), port (cfg, model))."""
    out = {}
    for name, kw in (("tiny-moe", {}),
                     ("tiny-moe-64", dict(experts=64, experts_used=2))):
        ws = make_synthetic_gguf(tmp_path_factory.mktemp(name), "tiny-moe",
                                 GGMLType.Q8_0, seed=7, seq_len=SEQ, **kw)
        out[name] = (ws, jload(ws / "model"),
                     load_gguf_model(ws / "model", device="cpu"))
    return out


def _spy_routes(monkeypatch) -> tuple[list, list]:
    """Record (route, block_m) of every MoE FFN the port runs, and per
    layer each row's gap between the logs of its k-th and (k+1)-th
    router probabilities."""
    seen, gaps = [], []
    real_route, real_topk = tllama.moe_route, tllama.LlamaLayer.route

    def spy(rows):
        seen.append(real_route(rows))
        return seen[-1]

    def route(self, h, k):
        probs = torch.softmax(h.float() @ self.router.float(), dim=-1)
        top = probs.topk(k + 1, dim=-1).values.log()
        gaps.append((top[:, k - 1] - top[:, k]).numpy())
        return real_topk(self, h, k)

    monkeypatch.setattr(tllama, "moe_route", spy)
    monkeypatch.setattr(tllama.LlamaLayer, "route", route)
    return seen, gaps


def _steps(name):
    """(route, block_m, steps): forward calls (tokens, positions, logits
    mode) over fresh caches; the last call takes the named route."""
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 250, (8, 72)).astype(np.int32)
    if name == "grouped-128":  # a 72-token prefill
        return ("grouped", 128), [(toks[:1], np.arange(72)[None], "all")]
    if name == "single":  # a 5-token prefill (dense), then one token
        return ("single", 1), [(toks[:1, :5], np.arange(5)[None], "none"),
                               (toks[:1, 5:6], np.full((1, 1), 5), "last")]
    # S = 8 decode after an S = 8 prefill of 3 tokens each. "dense" is
    # named for the route the JAX package takes there (16 assignments
    # over 4 experts: its dense route over every expert); the port's
    # grouped route at block_m 16 is held against it
    pos = np.broadcast_to(np.arange(3), (8, 3))
    return ("grouped", 16), [(toks[:, :3], pos, "none"),
                   (toks[:, 3:4], np.full((8, 1), 3), "all")]


@pytest.mark.parametrize("name", ["grouped-128", "single", "dense",
                                  "grouped-16"])
def test_moe_forward_matches_jax(moe_models, monkeypatch, name):
    ws_name = "tiny-moe-64" if name == "grouped-16" else "tiny-moe"
    _, (jcfg, jparams), (cfg, model) = moe_models[ws_name]
    llm = cfg.llm
    route, steps = _steps(name)
    S = steps[0][0].shape[0]
    jkv = JKVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size)
    kv = KVCache.create(llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    seen, gaps = _spy_routes(monkeypatch)
    for toks, pos, mode in steps:
        seen.clear()
        gaps.clear()
        got = model(kv, torch.from_numpy(toks), torch.from_numpy(
            np.ascontiguousarray(pos)).long(), logits_mode=mode).numpy()
        fwd = jax.jit(functools.partial(jforward, logits_mode=mode,
                                        backend="xla"), static_argnums=(1,))
        want, jkv = fwd(jparams, jcfg.llm, jkv, jnp.asarray(toks),
                        jnp.asarray(pos, jnp.int32))
    assert seen == [route] * llm.n_layers
    want = np.asarray(want)
    assert got.shape == want.shape
    # a row whose k-th and (k+1)-th router probabilities are within 1% in
    # some layer may route to another expert in the other package, whose
    # router inputs differ by its roundings (measured: a gap of 2e-4 moved
    # one row of the 72-token prefill by 4% of the range); those rows are
    # left out, all others compared
    far = np.min(np.stack(gaps), axis=0) >= 1e-2
    rows = got.reshape(-1, got.shape[-1]) if mode == "all" else got
    keep = far if mode == "all" else far.reshape(S, -1)[:, -1]
    assert keep.mean() >= 0.5  # measured 0.5-1.0 of the rows

    assert _rel(rows[keep], want.reshape(rows.shape)[keep]) < LOGIT_REL
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))


def test_moe_route_rule():
    # a single token; grouped at the tensor-core tile from MOE_GROUP_MIN
    # rows; every other batch grouped at block_m 16, those included that
    # the JAX package sends through its dense route (8 rows top-2 of 8
    # experts: 16 assignments, as many slabs as all 8)
    assert not _moe_grouped_decode_wins(8 * 2, 8)
    assert _moe_grouped_decode_wins(8 * 8, 128)
    assert moe_route(1) == ("single", 1)
    assert moe_route(8) == ("grouped", 16)
    assert moe_route(tllama.MOE_GROUP_MIN - 1) == ("grouped", 16)
    assert moe_route(tllama.MOE_GROUP_MIN) == ("grouped", 128)


@pytest.mark.parametrize("rows", [2, 8, 70])
def test_moe_routes_tool_dense_matches_grouped(rows):
    """tools/moe_routes.py's dense baseline (every expert on every row,
    unrouted pairs weighted 0) computes the model's MoE FFN: the same
    dequantized weights and f32 sums, at 16 rows or fewer in the same
    order, above them rounded to bf16 on both routes alike."""
    from powerserve_tpu_torch.tools.moe_routes import dense_all_experts

    cfg, model = make_device_params("tiny-moe", "q8_0", seed=0, device="cpu")
    k = cfg.llm.n_experts_used
    g = torch.Generator().manual_seed(rows)
    h = torch.randn(rows, cfg.llm.dim, generator=g).to(torch.bfloat16)
    layer = model.layers[0]
    want = layer.moe_ffn(h, k)
    got = dense_all_experts(layer, h, k)
    assert _rel(got.numpy(), want.numpy()) < 1e-6


def test_router_top_k_matches_jax(moe_models):
    """Routed ids and renormalized weights of the first layer against
    jax.lax.top_k, where the k-th and (k+1)-th probabilities differ."""
    _, _, (cfg, model) = moe_models["tiny-moe-64"]
    layer = model.layers[0]
    rng = np.random.default_rng(5)
    h = rng.standard_normal((40, cfg.llm.dim)).astype(np.float32)
    topi, topw = layer.route(torch.from_numpy(h), 2)
    rl = jnp.asarray(h) @ jnp.asarray(layer.router.numpy())
    probs = jax.nn.softmax(rl, axis=-1)
    jw, ji = jax.lax.top_k(probs, 3)
    apart = np.asarray(jw[:, 1] - jw[:, 2]) > 1e-6
    assert apart.sum() >= 30
    np.testing.assert_array_equal(topi.numpy()[apart],
                                  np.asarray(ji[:, :2])[apart])
    jw = np.asarray(jw[:, :2]) / np.maximum(
        np.asarray(jw[:, :2]).sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(topw.numpy(), jw, rtol=1e-6)


def test_moe_layers_load_as_jax(moe_models):
    ws, (_, jparams), (cfg, model) = moe_models["tiny-moe"]
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jparams))
    # the stacked tree ([L, E, ...] expert leaves) and the tuple tree
    # ([E, ...] per layer) carry over alike
    _, jtuple = jload(ws / "model", stacked=False)
    own = model.state_dict()
    for t in (tree, dataclasses.asdict(
            jax.tree_util.tree_map(np.asarray, jtuple))):
        other = params_from_numpy(t, cfg, device="cpu").state_dict()
        assert own.keys() == other.keys()
        for k in own:
            assert torch.equal(own[k], other[k]), k
    lw = tree["layers"]
    for i, layer in enumerate(model.layers):
        assert layer.wqkv is not None and layer.wgu is None  # QKV fused
        np.testing.assert_array_equal(layer.router.numpy(), lw["router"][i])
        for name in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            stack = getattr(layer, name)
            assert stack.n_slabs == cfg.llm.n_experts
            np.testing.assert_array_equal(stack.q.numpy(), lw[name]["q"][i])
            np.testing.assert_array_equal(stack.scales.numpy(),
                                          lw[name]["scales"][i])


def test_params_from_numpy_on_jax_device_params():
    """JAX's make_device_params("tiny-moe", "q8_0") tree ([L, E, ...]
    expert leaves, bf16 scales) carried over; the forward agrees."""
    jcfg, jparams = jmake_device_params("tiny-moe", "q8_0")
    tree = dataclasses.asdict(jax.tree_util.tree_map(np.asarray, jparams))
    # the port's make_device_params gives the same config
    cfg, own = make_device_params("tiny-moe", "q8_0", device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = params_from_numpy(tree, cfg, device="cpu")
    llm = cfg.llm
    layer = model.layers[1]
    assert layer.w_down_exps.q.shape == (4, llm.hidden_dim, llm.dim)
    assert layer.w_gate_exps.scales.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        layer.w_up_exps.q.numpy(), tree["layers"]["w_up_exps"]["q"][1])
    toks = np.arange(9, dtype=np.int32)[None] * 11 % 250
    pos = np.arange(9, dtype=np.int32)[None]
    kv = KVCache.create(llm.n_layers, 1, 32, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    got = model(kv, torch.from_numpy(toks), torch.from_numpy(pos).long(),
                logits_mode="all").numpy()
    jkv = JKVCache.create(llm.n_layers, 1, 32, llm.n_kv_heads, llm.head_size)
    want, _ = jforward(jparams, llm, jkv, jnp.asarray(toks), jnp.asarray(pos),
                       backend="xla", logits_mode="all")
    # these random weights span the whole int8 range (activations in the
    # tens), so the two packages' bf16 roundings grow through the layers:
    # measured 0.6-1.6% of the range on 7 of the 9 rows, 7% and 10% on two
    # (the JAX XLA and interpret routes agree with each other there; the
    # dense "tiny" preset's device params show the same, up to 36%)
    err = np.abs(got - np.asarray(want)).max(-1) / np.abs(want).max()
    assert np.median(err) < LOGIT_REL and err.max() < 0.15
    assert np.corrcoef(got.ravel(), np.asarray(want).ravel())[0, 1] > 0.99
    # and the same layout
    assert cfg.llm.n_experts == 4 and cfg.llm.n_experts_used == 2
    assert own.layers[0].w_gate_exps.q.shape == (4, llm.dim, llm.hidden_dim)
    # W8 expert slabs need K % 128 == 0 (tests/test_torch_w8_moe.py
    # builds them at wider dims)
    with pytest.raises(ValueError, match="not a multiple of 128"):
        make_device_params("tiny-moe", "w8", device="cpu")


def _near_tie_equal(got, want, logits_at):
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert got == want
        return
    top2 = np.sort(np.asarray(logits_at(i)))[-2:]
    assert top2[1] - top2[0] < NEAR_TIE, (i, got, want)


def test_greedy_run_matches_jax(moe_models):
    from powerserve_tpu.run import build_engine as jbuild
    from powerserve_tpu_torch import run

    ws, _, _ = moe_models["tiny-moe"]
    hp = JHyperParams(max_slots=1, batch_size=128)
    hp.sampler.temperature = 0.0
    jeng, jtok = jbuild(str(ws / "model"), hp, backend="xla")
    prompt = "The quick brown fox jumps over the lazy dog"
    ids = jtok.tokenize(prompt)
    want = list(jeng.generate(ids, 12, stop_fn=jtok.should_stop))
    got = run.run_prompt(run.parse_args(
        ["-d", str(ws), "-p", prompt, "-n", "12", "--temperature", "0",
         "--no-progress", "--device", "cpu"]))
    assert got.prompt_ids == ids

    def logits_at(i):
        jeng.reset()
        return jeng.prefill(ids + want[:i])

    _near_tie_equal(got.ids, want, logits_at)
    # the engine on a batch-prefilled prompt of the same model
    kw = dict(max_slots=2, batch_size=4, max_seq_len=SEQ)
    jhp, thp = JHyperParams(**kw), HyperParams(**kw)
    jhp.sampler.temperature = thp.sampler.temperature = 0.0
    _, (jcfg, jparams), (cfg, model) = moe_models["tiny-moe"]
    jeng2 = JEngine(jparams, jcfg, jhp, backend="xla")
    eng2 = InferenceEngine(model, cfg, thp, device="cpu")
    p2 = [1, 5, 9, 12, 3, 7, 40, 41, 2, 8]
    want2 = list(jeng2.generate(p2, 10))

    def logits_at2(i):
        jeng2.reset()
        return jeng2.prefill(p2 + want2[:i])

    _near_tie_equal(list(eng2.generate(p2, 10)), want2, logits_at2)


def test_greedy_server_bodies_match_jax(moe_models):
    """The port's HTTP server and the JAX server on the MoE workspace:
    greedy completion bodies equal except ids and timestamps."""
    import asyncio
    import http.client
    import threading

    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from powerserve_tpu.serving.server import ServerContext as JContext
    from powerserve_tpu.serving.server import build_app
    from powerserve_tpu_torch.serving.server import ServerContext, make_server

    ws, _, _ = moe_models["tiny-moe"]
    jctx = JContext(ws, "model", JHyperParams(max_slots=2, batch_size=8),
                    backend="xla")
    ctx = ServerContext(ws, "model", HyperParams(max_slots=2, batch_size=8),
                        device="cpu")
    server = make_server(ctx, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    async def jax_call(body):
        client = TestClient(TestServer(build_app(jctx)))
        await client.start_server()
        try:
            resp = await client.request("POST", "/v1/completions", json=body)
            return resp.status, await resp.read()
        finally:
            await client.close()

    def port_call(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            conn.request("POST", "/v1/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        for prompt, n in (("hello", 8), ("The quick brown fox", 6)):
            body = {"model": "model", "prompt": prompt, "max_tokens": n,
                    "temperature": 0}
            (js, jb), (ps, pb) = asyncio.run(jax_call(body)), port_call(body)
            assert js == ps == 200
            strip = [{k: v for k, v in json.loads(b).items()
                      if k not in ("id", "created")} for b in (jb, pb)]
            assert strip[0] == strip[1]
    finally:
        server.shutdown()
        server.server_close()
        ctx.close()
        for m in jctx.models.values():
            m.scheduler.stop()
