"""HTTP sessions and eviction over a rank group on the CPU (gloo): a
tp = 2 x dp = 2 server (four ranks: this process and three followers it
starts) against the single-device server on the same tiny workspace.

A saved session holds every head in the global order, gathered from the
owning block's ranks: the file's arrays are the single device's bit for
bit (each rank computes its heads' columns of the same products). A
loaded file goes to every rank, which keeps its heads, in every dp
block. This file imports no JAX.
"""

import http.client
import json
import threading

import numpy as np

from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.kv.persist import load_session
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SESS = "You are a terse assistant with strong opinions."


class _Served:
    def __init__(self, root, **kw):
        hp = HyperParams(max_slots=2, batch_size=8)
        self.ctx = ServerContext(root, "model", hp, device="cpu", **kw)
        self.server = make_server(self.ctx, "127.0.0.1", 0)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def __call__(self, method, path, body=None):
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.server.server_address[1], timeout=300)
        try:
            conn.request(method, path,
                         None if body is None else json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def ask(self, model="model", prompt=" hello"):
        status, raw = self("POST", "/v1/completions", {
            "model": model, "session": "s", "prompt": prompt,
            "max_tokens": 6, "temperature": 0})
        assert status == 200, raw
        return json.loads(raw)["choices"][0]["text"]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.ctx.close()


def _same_file(a, b):
    ids_a, ga = load_session(a)
    ids_b, gb = load_session(b)
    assert ids_a == ids_b and set(ga) == set(gb)
    for g in ga:
        assert set(ga[g]) == set(gb[g])
        for k, v in ga[g].items():
            w = gb[g][k]
            assert np.array_equal(v, w) and (k == "n" or v.dtype == w.dtype)


def test_tp_sessions_save_the_single_devices_file_and_resume(tmp_path):
    ws = make_synthetic_gguf(tmp_path / "ws", "tiny", GGMLType.Q8_0, seed=0,
                             seq_len=128)
    single = _Served(ws)
    try:
        assert single("POST", "/v1/sessions", {
            "model": "model", "prompt": SESS, "id": "s",
            "save_path": str(tmp_path / "one.npz")})[0] == 200
        want = single.ask()
        want_b = single.ask(prompt=" again")
    finally:
        single.close()

    tp = _Served(ws, tp=2, dp=2, max_models=1)
    try:
        ranks = tp.ctx.ranks
        assert tp("POST", "/v1/sessions", {
            "model": "model", "prompt": SESS, "id": "s",
            "save_path": str(tmp_path / "tp.npz")})[0] == 200
        _same_file(tmp_path / "one.npz", tmp_path / "tp.npz")
        assert tp.ask() == want
        # the single device's file, into every rank's heads of both dp
        # blocks: two requests at once take a slot of each block
        assert tp("DELETE", "/v1/sessions/s")[0] == 200
        assert tp("POST", "/v1/sessions", {
            "model": "model", "id": "s",
            "load_path": str(tmp_path / "one.npz")})[0] == 200
        out = {}
        threads = [threading.Thread(target=lambda p=p: out.__setitem__(
            p, tp.ask(prompt=p))) for p in (" hello", " again")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert out == {" hello": want, " again": want_b}
        # max_models 1: "model+self:1" evicts "model"; its caches go on
        # every rank, the weights the self-draft shares stay, and the
        # session's tokens are prefilled again
        base = tp.ctx.models["model"].scheduler
        oids = {base.kv.oid, base.model.oid}
        tp.ctx.get("model+self:1")
        assert set(tp.ctx.models) == {"model+self:1"} and base.kv is None
        assert oids & set(ranks.objs) == {
            tp.ctx.models["model+self:1"].scheduler.model.oid}
        assert tp.ask(model="model+self:1") == want
    finally:
        tp.close()
