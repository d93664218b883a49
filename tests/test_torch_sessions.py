"""KV-prefix persistence, pinned prefix-cache entries, HTTP sessions and
multi-model eviction in the port, against the JAX package on the CPU.

Prefix files (kv/persist.py) and session files (the JAX server's
_save_session_npz layout) written by either package load in the other
bit for bit. The session replies of the port's server (dense and paged,
a plain, a "+self:N" and an EAGLE name) are the JAX server's: greedy, on
prompts whose tokens meet no near tie between the two packages (the JAX
CPU route dequantizes in bf16, the port in f32; tests/test_torch_server.py
holds the same bodies), so they are compared as they are.
"""

import asyncio
import http.client
import json
import shutil
import threading

import numpy as np
import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from powerserve_tpu.core.config import HyperParams as JHyperParams  # noqa: E402
from powerserve_tpu.engine.scheduler import PrefixCache as JPrefixCache  # noqa: E402
from powerserve_tpu.kv.cache import KVCache as JKVCache  # noqa: E402
from powerserve_tpu.kv.persist import load_prefix as jload_prefix  # noqa: E402
from powerserve_tpu.kv.persist import save_prefix as jsave_prefix  # noqa: E402
from powerserve_tpu.run import main as jrun_main  # noqa: E402
from powerserve_tpu.serving.server import ServerContext as JServerContext  # noqa: E402
from powerserve_tpu.serving.server import (_load_session_npz,  # noqa: E402
                                           _save_session_npz, build_app)
from powerserve_tpu_torch.core.config import HyperParams  # noqa: E402
from powerserve_tpu_torch.core.gguf import GGMLType  # noqa: E402
from powerserve_tpu_torch.engine.scheduler import PrefixCache  # noqa: E402
from powerserve_tpu_torch.kv.cache import KVCache  # noqa: E402
from powerserve_tpu_torch.kv.persist import (load_prefix,  # noqa: E402
                                             load_session,
                                             load_session_apart,
                                             save_prefix, save_session)
from powerserve_tpu_torch.run import build_engine, parse_args, run_prompt  # noqa: E402
from powerserve_tpu_torch.serving.server import ServerContext, make_server  # noqa: E402
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,  # noqa: E402
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: E402,F401

L, H, T, D = 2, 2, 24, 16
SESS = "You are a terse assistant with strong opinions."
ASK = {"model": "model", "prompt": " hello", "max_tokens": 6,
       "temperature": 0.0}


def _random_prefix(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"n": n,
            "k": rng.integers(-127, 128, (L, H, n, D), dtype=np.int8),
            "v": rng.integers(-127, 128, (L, H, n, D), dtype=np.int8),
            "k_scale": rng.random((L, H, n), dtype=np.float32),
            "v_scale": rng.random((L, H, n), dtype=np.float32)}


def _port_cache(snap=None, slot=1):
    kv = KVCache.create(L, 2, T, H, D, device="cpu")
    if snap is not None:
        kv.restore_slot_prefix(slot, kv.snapshot_from_host(snap))
    return kv


def _jax_cache(snap=None, slot=1):
    import jax.numpy as jnp

    kv = JKVCache.create(L, 2, T, H, D)
    if snap is not None:
        kv = kv.restore_slot_prefix(slot, {
            k: (v if k == "n" else jnp.asarray(v)) for k, v in snap.items()})
    return kv


# -- kv/persist.py ----------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_prefix_files_load_across_packages_bit_for_bit(tmp_path, writer):
    """A prefix saved by one package from slot 1 loads into slot 0 of the
    other's cache: the same codes, scales, mask and pos."""
    snap = _random_prefix(9)
    path = tmp_path / "p.npz"
    if writer == "jax":
        assert jsave_prefix(_jax_cache(snap), path, slot=1) == 9
        kv = _port_cache()
        assert load_prefix(kv, path) == 9
        got = {k: getattr(kv, k)[:, 0, :, :9].numpy()
               for k in ("k", "v", "k_scale", "v_scale")}
        mask, pos = kv.mask[0].numpy(), int(kv.pos[0])
    else:
        assert save_prefix(_port_cache(snap), path, slot=1) == 9
        jkv, n = jload_prefix(_jax_cache(), path)
        assert n == 9
        got = {k: np.asarray(getattr(jkv, k))[:, 0, :, :9]
               for k in ("k", "v", "k_scale", "v_scale")}
        mask, pos = np.asarray(jkv.mask)[0], int(jkv.pos[0])
    for k in got:
        assert got[k].dtype == snap[k].dtype
        assert np.array_equal(got[k], snap[k]), k
    assert pos == 9 and mask.tolist() == [True] * 9 + [False] * (T - 9)


REFUSALS = {
    "quantization": dict(quantized=False),
    "layers": dict(k=np.zeros((L + 1, H, 4, D), np.int8)),
    "heads": dict(k=np.zeros((L, H + 1, 4, D), np.int8)),
    "head_dim": dict(k=np.zeros((L, H, 4, D * 2), np.int8)),
    "too_long": dict(n=T + 1, k=np.zeros((L, H, T + 1, D), np.int8),
                     v=np.zeros((L, H, T + 1, D), np.int8),
                     k_scale=np.zeros((L, H, T + 1), np.float32),
                     v_scale=np.zeros((L, H, T + 1), np.float32)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_load_prefix_refuses_what_jax_refuses(tmp_path, case):
    """A quantization mode, a geometry or a length the cache cannot take
    is a ValueError in both packages, and the port's cache is untouched."""
    snap = _random_prefix(4)
    data = {"k": snap["k"], "v": snap["v"], "quantized": True, "n": 4,
            "k_scale": snap["k_scale"], "v_scale": snap["v_scale"]}
    data.update(REFUSALS[case])
    path = tmp_path / "bad.npz"
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in data.items()})
    kv = _port_cache()
    with pytest.raises(ValueError):
        load_prefix(kv, path)
    assert not kv.mask.any() and not kv.pos.any()
    with pytest.raises(ValueError):
        jload_prefix(_jax_cache(), path)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_synthetic_gguf(tmp_path_factory.mktemp("sess"), "tiny",
                               GGMLType.Q8_0, seed=0, seq_len=128)


def test_load_prefix_writes_in_place_under_the_engines_decode_block(ws,
                                                                   tmp_path):
    """load_prefix keeps the engine's cache object and its storage, so
    the decode block the engine built over it (a replayed graph on the
    card) reads the loaded prefix: the tokens are those of a fresh engine
    fed the prefix's stream and the prompt whole."""
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    eng, _ = build_engine(str(ws / "model"), hp, "cpu")
    first = [1, 40, 41, 42, 43, 44, 45]
    out = list(eng.generate(first, 5))  # builds the step over eng.kv
    stream = first + out[:-1]
    save_prefix(eng.kv, tmp_path / "p.npz")
    kv, storage = eng.kv, [t.data_ptr() for t in eng.kv.storage]
    eng.reset()
    assert load_prefix(eng.kv, tmp_path / "p.npz") == len(stream)
    assert eng.kv is kv and [t.data_ptr() for t in kv.storage] == storage
    prompt = [1, 60, 61, 62]
    got = list(eng.generate(prompt, 6))
    ref, _ = build_engine(str(ws / "model"), hp, "cpu")
    assert got == list(ref.generate(stream + prompt, 6))


@pytest.mark.parametrize("order", ["port_then_jax", "jax_then_port"])
def test_run_save_kv_then_load_kv_matches_jax_run(ws, tmp_path, capsys,
                                                  order):
    """`run --save-kv` by one package, then `run --load-kv` of that file
    by the other: both print the JAX run's text, and the loaded run's
    tokens are a fresh run's over the prefix's stream and the prompt."""
    path = str(tmp_path / "p.npz")
    first = ["-d", str(ws), "-p", "The quick brown fox", "-n", "6",
             "--temperature", "0"]
    second = ["-d", str(ws), "-p", "jumps over", "-n", "6",
              "--temperature", "0"]

    def port(argv):
        r = run_prompt(parse_args(argv + ["--device", "cpu",
                                          "--no-progress"]))
        return capsys.readouterr().out.strip(), r

    def jax(argv):
        assert jrun_main(argv + ["--backend", "xla", "--no-progress"]) == 0
        return capsys.readouterr().out.strip()

    if order == "port_then_jax":
        text1, r1 = port(first + ["--save-kv", path])
        assert text1 == jax(first)
    else:
        text1 = jax(first + ["--save-kv", path])
        assert port(first)[0] == text1
        r1 = port(first)[1]
    want = jax(second + ["--load-kv", path])
    text2, r2 = port(second + ["--load-kv", path])
    assert text2 == want
    z = np.load(path)
    assert int(z["n"]) == len(r1.prompt_ids) + len(r1.ids) - 1
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=128)
    hp.sampler.temperature = 0.0
    eng, _ = build_engine(str(ws / "model"), hp, "cpu")
    stream = r1.prompt_ids + r1.ids[:-1] + r2.prompt_ids
    assert r2.ids == list(eng.generate(stream, 6))


# -- PrefixCache pinning ------------------------------------------------------

PIN_CASES = {
    # a pinned entry skips min_len; an unpinned short one is not stored
    "min_len": [("put", [1, 2], False), ("put", [3, 4], True)],
    # capacity 2: pinned entries never count nor go
    "capacity": [("put", [1] * 5, True), ("put", [2] * 5, False),
                 ("put", [3] * 5, False), ("put", [4] * 5, False),
                 ("put", [5] * 6, True)],
    # re-putting an entry pinned takes it out of the eviction order
    "repin": [("put", [1] * 5, False), ("put", [2] * 5, False),
              ("put", [1] * 5, True), ("put", [3] * 5, False),
              ("put", [4] * 5, False)],
    "drop": [("put", [1] * 5, True), ("put", [2] * 5, False),
             ("drop", [1] * 5, None), ("drop", [2] * 5, None),
             ("drop", [9] * 5, None), ("put", [3] * 5, False)],
}


@pytest.mark.parametrize("case", list(PIN_CASES))
def test_prefix_cache_pinning_matches_jax(case):
    ours, theirs = PrefixCache(2, 4), JPrefixCache(2, 4)
    for op, ids, pin in PIN_CASES[case]:
        if op == "put":
            ours.put(ids, {"n": len(ids)}, pin=pin)
            theirs.put(ids, {"n": len(ids)}, pin=pin)
        else:
            assert ours.drop(ids) == theirs.drop(ids)
        assert list(ours.entries) == list(theirs.entries)
        assert ours.pinned == theirs.pinned
        assert ours._order == theirs._order
    probe = [1] * 5 + [7]
    a, b = ours.match(probe), theirs.match(probe)
    assert (a and a[0]) == (b and b[0])


# -- session files --------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_npz_roundtrip_with_eagle_feat(tmp_path, writer):
    """Every group of an entry (kv, the draft's d, an EAGLE feature's
    feat) and each group's n go through a session file written by either
    package and read by the other."""
    saved = {"kv": {"n": 7, "k": np.arange(12, dtype=np.int8).reshape(3, 4)},
             "d": {"n": 7, "k": np.ones((2, 2), np.int8)},
             "feat": {"v": np.linspace(0, 1, 8, dtype=np.float32)}}
    path = str(tmp_path / "sess.npz")
    if writer == "jax":
        _save_session_npz(path, [3, 1, 4], saved)
        ids, loaded = load_session(path)
        # the server's loader: inflated by a child process, mapped back
        assert load_session_apart(path)[0] == ids
        for g, sub in load_session_apart(path)[1].items():
            for k, v in sub.items():
                assert np.array_equal(v, loaded[g][k])
    else:
        save_session(path, [3, 1, 4], saved)
        ids, loaded = _load_session_npz(path)
        loaded = {g: {k: v if k == "n" else np.asarray(v)
                      for k, v in sub.items()} for g, sub in loaded.items()}
    assert ids == [3, 1, 4] and set(loaded) == {"kv", "d", "feat"}
    assert loaded["kv"]["n"] == 7 and isinstance(loaded["kv"]["n"], int)
    for g, sub in saved.items():
        for k, v in sub.items():
            assert np.array_equal(loaded[g][k], v) and (
                k == "n" or loaded[g][k].dtype == v.dtype)


# -- the server ---------------------------------------------------------------


def _jax(jctx, method, path, body=None):
    async def go():
        client = TestClient(TestServer(build_app(jctx)))
        await client.start_server()
        try:
            resp = await client.request(method, path, json=body)
            return resp.status, await resp.read()
        finally:
            await client.close()

    return asyncio.run(go())


def _port(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _text(raw: bytes) -> str:
    return json.loads(raw)["choices"][0]["text"]


class _Served:
    def __init__(self, root, hp, **kw):
        self.ctx = ServerContext(root, "model", hp, device="cpu", **kw)
        self.server = make_server(self.ctx, "127.0.0.1", 0)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def __call__(self, method, path, body=None):
        return _port(self.port, method, path, body)

    def ask(self, session, model="model", **kw):
        status, raw = self("POST", "/v1/completions",
                           {**ASK, "model": model, "session": session, **kw})
        assert status == 200, raw
        return _text(raw)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.ctx.close()


def _hp(**kw):
    return HyperParams(max_slots=2, batch_size=8, **kw)


@pytest.fixture(scope="module")
def served(ws, tmp_path_factory):
    """The JAX server (dense) with a session "j" saved to a file, and its
    replies on it; the port's servers on the dense cache and on a paged
    pool; an EAGLE head dir beside the model."""
    make_eagle_gguf(ws / "eagle", "tiny", seed=3)
    tmp = tmp_path_factory.mktemp("jsess")
    jctx = JServerContext(ws, "model", JHyperParams(max_slots=2, batch_size=8),
                          backend="xla")
    status, raw = _jax(jctx, "POST", "/v1/sessions", {
        "model": "model", "prompt": SESS, "id": "j",
        "save_path": str(tmp / "j.npz")})
    assert status == 200, raw
    status, raw = _jax(jctx, "POST", "/v1/completions",
                       {**ASK, "session": "j"})
    assert status == 200, raw
    servers = {"dense": _Served(ws, _hp()),
               "paged": _Served(ws, _hp(paged_pages=40, page_size=8))}
    yield dict(jctx=jctx, jfile=tmp / "j.npz", jtext=_text(raw), **servers)
    for s in servers.values():
        s.close()
    for m in jctx.models.values():
        m.scheduler.stop()


LAYOUTS = ["dense", "paged"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sessions_api(served, tmp_path, layout):
    """The port's mirror of the JAX server's test_sessions_api: a hit's
    reply equals the cleared cache's (a whole re-prefill of the same
    stream) and the restored file's, and the JAX server's (a chat
    request's too); 404 after delete."""
    srv = served[layout]
    path = str(tmp_path / "s1.npz")
    status, raw = srv("POST", "/v1/sessions", {
        "model": "model", "prompt": SESS, "id": "s1", "save_path": path})
    assert status == 200, raw
    body = json.loads(raw)
    assert body["id"] == "s1" and body["object"] == "session"
    assert body["tokens"] > 0
    status, raw = srv("GET", "/v1/sessions")
    assert any(s["id"] == "s1" for s in json.loads(raw)["data"])

    sched = srv.ctx.models["model"].scheduler
    key = tuple(srv.ctx.sessions["s1"]["ids"])
    assert key in sched.prefix_cache.pinned
    hits = sched.prefix_cache.hits
    hit = srv.ask("s1")
    assert sched.prefix_cache.hits > hits
    assert hit == served["jtext"]
    sched.clear_prefixes()
    assert srv.ask("s1") == hit
    chat = {"model": "model", "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]}
    status, ours = srv("POST", "/v1/chat/completions",
                       {**chat, "session": "s1"})
    assert status == 200
    status, theirs = _jax(served["jctx"], "POST", "/v1/chat/completions",
                          {**chat, "session": "j"})
    assert status == 200
    assert (json.loads(ours)["choices"][0]["message"]
            == json.loads(theirs)["choices"][0]["message"])

    status, raw = srv("DELETE", "/v1/sessions/s1")
    assert status == 200 and json.loads(raw)["deleted"] is True
    assert srv("POST", "/v1/completions", {**ASK, "session": "s1"})[0] == 404
    status, raw = srv("POST", "/v1/sessions", {
        "model": "model", "id": "s1", "load_path": path})
    assert status == 200 and json.loads(raw)["tokens"] == body["tokens"]
    assert srv.ask("s1") == hit
    assert key in sched.prefix_cache.pinned
    srv("DELETE", "/v1/sessions/s1")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_prefix_cache(served, layout):
    """The mirror of the JAX server's test_spec_prefix_cache: a session
    on "model+self:N" pins both caches' prefixes; its reply equals the
    cleared cache's and the plain name's on the JAX server."""
    srv = served[layout]
    name = "model+self:2"
    status, raw = srv("POST", "/v1/sessions", {
        "model": name, "prompt": SESS, "id": "sp1"})
    assert status == 200, raw
    sched = srv.ctx.models[name].scheduler
    key = tuple(srv.ctx.sessions["sp1"]["ids"])
    assert "draft" in sched.prefix_cache.entries[key]
    hit = srv.ask("sp1", model=name)
    assert hit == served["jtext"]
    sched.clear_prefixes()
    assert srv.ask("sp1", model=name) == hit
    srv("DELETE", "/v1/sessions/sp1")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_eagle_session_keeps_the_carried_feature(served, tmp_path, layout):
    """A session on an EAGLE name pins the target's and the head's
    prefixes and the carried feature; its file holds them (feat.v), and
    the hit, the cleared and the restored replies are the plain name's
    on the JAX server (greedy EAGLE emits the target's tokens)."""
    srv = served[layout]
    name = "model+eagle"
    path = str(tmp_path / "e.npz")
    status, raw = srv("POST", "/v1/sessions", {
        "model": name, "prompt": SESS, "id": "e1", "save_path": path})
    assert status == 200, raw
    ids, groups = load_session(path)
    assert set(groups) == {"kv", "d", "feat"}
    sched = srv.ctx.models[name].scheduler
    assert groups["feat"]["v"].shape == (sched.cfg.llm.dim,)
    assert np.array_equal(groups["feat"]["v"],
                          sched.prefix_cache.entries[tuple(ids)]["feat"])
    hit = srv.ask("e1", model=name)
    assert hit == served["jtext"]
    sched.clear_prefixes()
    assert srv.ask("e1", model=name) == hit
    srv("DELETE", "/v1/sessions/e1")
    assert srv("POST", "/v1/sessions", {
        "model": name, "id": "e1", "load_path": path})[0] == 200
    assert srv.ask("e1", model=name) == hit
    srv("DELETE", "/v1/sessions/e1")


def test_session_files_resume_across_packages(served, tmp_path):
    """A session the JAX server saved resumes in the port's server with
    the JAX server's reply; one the port saved resumes in the JAX
    server with it too."""
    srv = served["dense"]
    status, raw = srv("POST", "/v1/sessions", {
        "model": "model", "id": "js", "load_path": str(served["jfile"])})
    assert status == 200, raw
    assert srv.ask("js") == served["jtext"]
    path = str(tmp_path / "p.npz")
    srv("DELETE", "/v1/sessions/js")
    assert srv("POST", "/v1/sessions", {
        "model": "model", "prompt": SESS, "id": "ps",
        "save_path": path})[0] == 200
    srv("DELETE", "/v1/sessions/ps")
    ids, groups = load_session(path)
    jids, jgroups = load_session(served["jfile"])
    assert ids == jids and set(groups) == set(jgroups) == {"kv"}
    jctx = served["jctx"]
    status, raw = _jax(jctx, "POST", "/v1/sessions", {
        "model": "model", "id": "jp", "load_path": path})
    assert status == 200, raw
    status, raw = _jax(jctx, "POST", "/v1/completions",
                       {**ASK, "session": "jp"})
    assert status == 200 and _text(raw) == served["jtext"]
    _jax(jctx, "DELETE", "/v1/sessions/jp")


REFUSED = {
    "empty_prompt": ("POST", "/v1/sessions", {"model": "model",
                                              "prompt": ""}, 400),
    "too_long": ("POST", "/v1/sessions", {"model": "model",
                                          "prompt": "x" * 130}, 400),
    "unknown_session": ("POST", "/v1/completions",
                        {**ASK, "session": "nope"}, 404),
    "unknown_session_chat": ("POST", "/v1/chat/completions", {
        "model": "model", "session": "nope", "max_tokens": 2,
        "messages": [{"role": "user", "content": "hi"}]}, 404),
    "delete_unknown": ("DELETE", "/v1/sessions/nope", None, 404),
}


def _same_arrays(a, b):
    ids_a, ga = load_session(a)
    ids_b, gb = load_session(b)
    assert ids_a == ids_b and set(ga) == set(gb)
    for g in ga:
        for k, v in ga[g].items():
            assert np.array_equal(v, gb[g][k]), (g, k)


@pytest.mark.parametrize("mesh", ["pp", "sp"])
def test_sessions_over_pp_and_sp_load_on_one_rank(served, ws, tmp_path,
                                                  mesh):
    """A session saved by a pp = 2 server (two stages: every layer put
    together) or an sp = 2 server (two slices of the positions put
    together) loads on the single-rank server to the same reply, and the
    single rank's file on theirs; under pp the file is the single
    rank's bit for bit (the pipelined forward is)."""
    single = served["dense"]
    sid = f"one_{mesh}"
    assert single("POST", "/v1/sessions", {
        "model": "model", "prompt": SESS, "id": sid,
        "save_path": str(tmp_path / "one.npz")})[0] == 200
    want = single.ask(sid)
    par = _Served(ws, _hp(max_seq_len=128), **{mesh: 2})
    try:
        status, raw = par("POST", "/v1/sessions", {
            "model": "model", "prompt": SESS, "id": "p",
            "save_path": str(tmp_path / "par.npz")})
        assert status == 200, raw
        assert par.ask("p") == want
        if mesh == "pp":
            _same_arrays(tmp_path / "one.npz", tmp_path / "par.npz")
        assert par("POST", "/v1/sessions", {
            "model": "model", "id": "from_one",
            "load_path": str(tmp_path / "one.npz")})[0] == 200
        assert par.ask("from_one") == want
    finally:
        par.close()
    assert single("POST", "/v1/sessions", {
        "model": "model", "id": f"from_{mesh}",
        "load_path": str(tmp_path / "par.npz")})[0] == 200
    assert single.ask(f"from_{mesh}") == want


@pytest.mark.parametrize("case", list(REFUSED))
def test_session_refusals_match_jax(served, case):
    method, path, body, status = REFUSED[case]
    assert served["dense"](method, path, body)[0] == status
    assert _jax(served["jctx"], method, path, body)[0] == status


@pytest.mark.parametrize("case", ["prefix_cache_off", "draft_mismatch"])
def test_session_refusals_of_the_model(ws, served, case):
    """A disabled prefix cache, and a file whose groups do not fit the
    model (a plain session on a speculating name), are 400s."""
    if case == "prefix_cache_off":
        srv = _Served(ws, _hp(prefix_cache=0))
        try:
            assert srv("POST", "/v1/sessions", {
                "model": "model", "prompt": SESS})[0] == 400
        finally:
            srv.close()
        return
    status, raw = served["dense"]("POST", "/v1/sessions", {
        "model": "model+self:1", "load_path": str(served["jfile"])})
    assert status == 400 and b"draft-cache mismatch" in raw


def test_model_eviction_budget(tmp_path):
    """The mirror of the JAX server's test_model_eviction_budget: past
    max_models the least recently used idle context is evicted (its
    scheduler stopped, its caches, graphs and snapshots dropped); a
    touched one stays. A session stays registered across its model's
    eviction, and the next request re-prefills it to the same reply; a
    "+self:N" context keeps its shared weights when its base goes."""
    root = tmp_path / "root"
    make_synthetic_gguf(root / "a", "tiny", GGMLType.Q8_0, seed=0,
                        seq_len=64)
    for f in (root / "a" / "model").iterdir():
        f.rename(root / "a" / f.name)
    shutil.copytree(root / "a", root / "b")
    shutil.copytree(root / "a", root / "c")
    srv = _Served(root, _hp(), max_models=2)
    try:
        ctx = srv.ctx
        assert srv("POST", "/v1/sessions", {
            "model": "a", "prompt": "shared preamble", "id": "s"})[0] == 200
        before = srv.ask("s", model="a")
        ctx.get("b")
        assert set(ctx.models) == {"a", "b"}
        a_sched = ctx.models["a"].scheduler
        ctx.get("c")  # a is the least recently used and idle
        assert set(ctx.models) == {"b", "c"}
        assert a_sched._thread is None and a_sched.kv is None
        assert a_sched.model is None and not a_sched.graphs.graphs
        ctx.get("b")  # b is used again, c is now the oldest
        assert srv.ask("s", model="a") == before  # a reloads, c goes
        assert set(ctx.models) == {"b", "a"} and "s" in ctx.sessions
        ctx.get("a+self:1")  # a is used again: b goes
        assert set(ctx.models) == {"a", "a+self:1"}
        ctx.get("c")  # a goes; a+self:1 keeps its weights
        assert set(ctx.models) == {"a+self:1", "c"}
        assert srv.ask("s", model="a+self:1") == before
    finally:
        srv.close()
