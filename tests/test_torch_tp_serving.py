"""The port's scheduler and server over a rank group on the CPU (gloo):
tensor parallelism (tp = 2), with data parallelism (dp = 2) over it,
against the port's single rank and the JAX package's tp scheduler, as
tests/test_tp_serving.py holds JAX's. One rank group of 4 for the
module: rank 0 is this process, ranks 1-3 followers; a tp = 2 model uses
ranks 0-1, a tp = 2 x dp = 2 model all four. The HTTP cases start
`python -m powerserve_tpu_torch serve --tp 2 ...` processes, which start
their own followers.

Greedy tokens must be the single rank's: the sharded forward sums wo's
and down's rows in two partial sums (another order), so two streams may
part only where the single rank's teacher-forced top-2 logit gap is
< 0.5 (the reference's near-tie rule); against JAX (bf16 dequant on its
XLA route) the same rule.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import pytest

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.scheduler import BatchScheduler as JScheduler
from powerserve_tpu.engine.scheduler import Request as JRequest
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu.parallel.tp import shard_params_tp as jshard
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.parallel.distributed import free_port
from powerserve_tpu_torch.parallel.tp import start_rank_group
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.serving.server import main as serve_main
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
NEAR_TIE = 0.5
SEQ = 128
# short prompts, a 25-token one (a prefix-cache entry), an 11-token one
# (two prefill chunks of 8)
PROMPTS = [[3, 5, 7, 9, 11], [101, 7, 42], list(range(20, 45)),
           [8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A model root: "model" (tiny-k Q4_K), "draft" (another seed) and
    "eagle" (a random EAGLE head at tiny-k's widths)."""
    r = tmp_path_factory.mktemp("tpserve")
    make_synthetic_gguf(r, "tiny-k", GGMLType.Q4_K, seed=0, seq_len=SEQ)
    # prefill chunks of 8 (the twins' prefill attention is slow at 128)
    hp = json.loads((r / "hparams.json").read_text())
    (r / "hparams.json").write_text(json.dumps({**hp, "batch_size": 8}))
    w = make_synthetic_gguf(tmp_path_factory.mktemp("draft"), "tiny-k",
                            GGMLType.Q4_K, seed=7, seq_len=SEQ)
    (w / "model").rename(r / "draft")
    make_eagle_gguf(r / "eagle", "tiny-k", seed=9)
    return r


@pytest.fixture(scope="module")
def single(root):
    cfg, model = load_gguf_model(root / "model", device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return cfg, model, InferenceEngine(model, cfg, hp, device="cpu")


@pytest.fixture(scope="module")
def ranks(root):
    group = start_rank_group(4, "gloo", "cpu", threads=1)
    models = {(tp, dp): group.load(root / "model", tp, dp)[1]
              for tp, dp in ((2, 1), (2, 2))}
    yield group, models
    group.close()


def _hp(**kw) -> HyperParams:
    return HyperParams(max_slots=4, batch_size=8, max_seq_len=SEQ, spec_k=3,
                       **kw)


def _stepwise(sched, prompts, max_tokens=8):
    """Submit every prompt, step the scheduler until all finish."""
    outs, dones = [], []
    for p in prompts:
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=0.0, sink=sink))
        outs.append(out)
        dones.append(done)
    for _ in range(2000):
        if all(not d.empty() for d in dones):
            break
        sched.step()
    assert all(not d.empty() for d in dones), "requests did not finish"
    return outs


def _agree(got, want, prompts, single):
    """Each stream equals want's, or first parts at a near tie of the
    single rank's teacher-forced logits."""
    engine = single[2]
    for g, w, p in zip(got, want, prompts):
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            assert len(g) == len(w), (g, w)
            continue
        engine.reset()
        top2 = engine.prefill(list(p) + w[:i]).topk(2).values
        assert float(top2[0] - top2[1]) < NEAR_TIE, (i, g, w)


@pytest.fixture(scope="module")
def plain(single):
    cfg, model, _ = single
    return {n: _stepwise(BatchScheduler(model, cfg, _hp(), "cpu"), PROMPTS, n)
            for n in (8, 12)}


CASES = {
    "dense": ((2, 1), {}, 8),
    "paged": ((2, 1), dict(paged_pages=32, page_size=8), 8),
    "dense_dp": ((2, 2), {}, 8),
    # 12 pages of 8 for 4 slots: 6 a dp block; block 1's two requests
    # need 5 + 3, so a slot preempts a victim of its own block
    "paged_dp_preempt": ((2, 2), dict(paged_pages=12, page_size=8), 12),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_over_ranks_gives_the_single_ranks_tokens(
        ranks, single, plain, case):
    group, models = ranks
    mesh, hp, n = CASES[case]
    cfg = single[0]
    sched = BatchScheduler(models[mesh], cfg, _hp(**hp), "cpu")
    got = _stepwise(sched, PROMPTS, n)
    _agree(got, plain[n], PROMPTS, single)
    if sched.pool is not None:
        assert sched.pool.n_groups == mesh[1]
        assert sched.pool.n_free == hp["paged_pages"]
    if case == "paged_dp_preempt":
        assert sched.n_preemptions > 0


def test_scheduler_over_ranks_matches_jax_tp(ranks, single, plain, root):
    """JAX's BatchScheduler(tp_mesh=) on a 2-device CPU mesh: the same
    greedy tokens as the port's tp = 2 scheduler (near-tie rule)."""
    jcfg, jparams = jload(root / "model")
    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    js = JScheduler(jshard(jparams, mesh, jcfg.llm), jcfg,
                    JHyperParams(max_slots=4, batch_size=8,
                                 max_seq_len=SEQ), backend="xla",
                    tp_mesh=mesh)
    js.start()
    try:
        dones, outs = [], []
        for p in PROMPTS:
            done, ids = threading.Event(), []

            def sink(t, ids=ids, done=done):
                done.set() if t is None else ids.append(t)

            js.submit(JRequest(prompt_ids=list(p), max_tokens=8,
                               temperature=0.0, sink=sink))
            dones.append(done)
            outs.append(ids)
        for d in dones:
            assert d.wait(timeout=300)
    finally:
        js.stop()
    group, models = ranks
    got = _stepwise(BatchScheduler(models[(2, 1)], single[0], _hp(), "cpu"),
                    PROMPTS)
    _agree(got, outs, PROMPTS, single)
    _agree(outs, plain[8], PROMPTS, single)


SPEC = {
    "chain": ((2, 1), "self", {}, {}),
    "tree": ((2, 1), "self", {}, dict(spec_tree="2,1")),
    "tree_paged_dp": ((2, 2), "self", {}, dict(spec_tree="2,1",
                                               paged_pages=32, page_size=8)),
    "draft_head": ((2, 1), "self", dict(rank=32), {}),
    "draft_dir_paged": ((2, 2), "dir", {}, dict(paged_pages=32,
                                                page_size=8)),
}


@pytest.mark.parametrize("case", list(SPEC))
def test_speculation_over_ranks_gives_the_plain_tokens(
        ranks, single, plain, root, case):
    """Chain and tree ticks with a 1-layer self-draft, a factored draft
    head (rank 32, factored from the whole lm_head on every rank) and a
    draft model dir, each sharded as the target is: the plain tokens."""
    group, models = ranks
    mesh, kind, head, hp = SPEC[case]
    target = models[mesh]
    if kind == "self":
        draft = group.self_draft(target, 1)
    else:
        draft = group.load(root / "draft", *mesh)[1]
    if head:
        draft = group.with_draft_head(draft, head["rank"])
        assert draft.shard.model.lm_head_lr is not None
    sched = BatchScheduler(target, single[0], _hp(**hp), "cpu", draft=draft)
    _agree(_stepwise(sched, PROMPTS), plain[8], PROMPTS, single)
    assert sched.n_spec_steps > 0


def test_prefix_cache_entry_restores_into_another_dp_block(ranks, single,
                                                           plain):
    """An entry saved by dp block 0's slot restores into block 1's: every
    rank keeps its heads of the snapshot under rank 0's key."""
    group, models = ranks
    sched = BatchScheduler(models[(2, 2)], single[0], _hp(), "cpu")
    long = PROMPTS[2]
    first = _stepwise(sched, [long])  # slot 0: block 0
    assert len(sched.prefix_cache.entries) == 1
    # two short requests take slots 0 and 1; the long one slot 2, block 1
    again = _stepwise(sched, [PROMPTS[0], PROMPTS[1], long])
    assert sched.prefix_cache.hits == 1
    assert again[2] == first[0]
    _agree(first, plain[8][2:3], [long], single)
    sched.prefix_cache.entries.clear()
    sched.prefix_cache._order.clear()
    assert _stepwise(sched, [long]) == first


def test_refusals_over_ranks(ranks, single):
    import torch

    group, models = ranks
    sched = BatchScheduler(models[(2, 1)], single[0], _hp(), "cpu")
    # input rows take (tests/test_torch_tp_vlm.py), at the prompt's shape
    with pytest.raises(ValueError, match="Request.embeds of shape"):
        sched.submit(Request(prompt_ids=[1, 2],
                             embeds=torch.zeros(3, single[0].llm.dim)))
    with pytest.raises(ValueError, match="same ranks"):
        BatchScheduler(models[(2, 1)], single[0], _hp(), "cpu",
                       draft=single[1])
    with pytest.raises(ValueError, match="pages"):
        BatchScheduler(models[(2, 2)], single[0],
                       _hp(paged_pages=9, page_size=8), "cpu")


# -- the HTTP server: serve --tp 2 [--dp 2] as a process ----------------------


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serve(root, *flags):
    """A `serve` process on a free port, up: (process, port)."""
    port = free_port()
    # one thread a rank: the ranks wait on each other at every operation,
    # and idle threads spinning in a loaded test run starve them
    proc = subprocess.Popen(
        [sys.executable, "-m", "powerserve_tpu_torch", "serve", "-d",
         str(root), "--model", "model", "--device", "cpu", "--port",
         str(port), "--max-slots", "4", *flags], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("GET", "/health")
            if conn.getresponse().status == 200:
                return proc, port
        except OSError:
            time.sleep(0.2)
        finally:
            conn.close()
    proc.kill()
    raise AssertionError("serve did not come up")


def _bodies(port, models, prompts=("hello", "the quick fox")):
    """Each (model, prompt)'s greedy body without its id and timestamp,
    every request at once."""
    out = {}

    def one(m, p):
        status, body = _post(port, {"model": m, "prompt": p,
                                    "max_tokens": 6, "temperature": 0})
        assert status == 200, body
        out[m, p] = {k: v for k, v in body.items()
                     if k not in ("id", "created")}

    for m in models:  # load each model before the requests race
        one(m, prompts[0])
    threads = [threading.Thread(target=one, args=(m, p))
               for m in models for p in prompts[1:]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(out) == len(models) * len(prompts)
    return out


@pytest.fixture(scope="module")
def single_server(root):
    """The single-rank servers the processes' bodies are held against."""
    ctxs = {}

    def start(**hp):
        key = tuple(sorted(hp.items()))
        if key not in ctxs:
            ctx = ServerContext(root, "model", HyperParams(
                max_slots=4, batch_size=8, **hp), device="cpu")
            srv = make_server(ctx, "127.0.0.1", 0)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            ctxs[key] = (ctx, srv)
        return ctxs[key][1].server_address[1]

    yield start
    for ctx, srv in ctxs.values():
        srv.shutdown()
        srv.server_close()
        ctx.close()


@pytest.mark.parametrize("flags,hp,names", [
    (("--tp", "2"), {}, ("model", "model+self:1", "model+eagle")),
    (("--tp", "2", "--dp", "2", "--paged-pages", "16", "--page-size", "8",
      "--spec-tree", "2,1"), dict(paged_pages=16, page_size=8,
                                  spec_tree="2,1"),
     ("model", "model+self:1", "model+eagle")),
], ids=["tp2_dense_chain", "tp2_dp2_paged_tree"])
def test_serve_tp_bodies_equal_the_single_rank_servers(root, single_server,
                                                       flags, hp, names):
    proc, port = _serve(root, *flags)
    try:
        got = _bodies(port, names)
    finally:
        proc.terminate()
        err = proc.communicate(timeout=60)[1]
    want = _bodies(single_server(**hp), names)
    assert got == want
    assert "[E]" not in err, err  # no step failed, no rank left
    assert proc.returncode == 0, err


def _children(pid: int) -> list[int]:
    out = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d.name))
    return out


def test_a_dead_follower_ends_the_server_with_an_error(root):
    proc, port = _serve(root, "--tp", "2")
    try:
        assert _post(port, {"model": "model", "prompt": "hi",
                            "max_tokens": 2, "temperature": 0})[0] == 200
        kids = _children(proc.pid)
        assert len(kids) == 1, kids
        os.kill(kids[0], signal.SIGKILL)
        err = proc.communicate(timeout=60)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 1
    assert "rank 1 of 2 exited with code -9" in err, err


# what each refusal names: pp runs alone, sp takes the dense cache;
# --gspmd and --distributed are queued
REFUSED_BECAUSE = {"--pp": "pp runs alone", "--sp": "paged KV",
                   "--gspmd": "ROADMAP §1 item 8",
                   "--distributed": "ROADMAP §1 item 8"}


@pytest.mark.parametrize("flag", [("--pp", "2", "--tp", "2"),
                                  ("--sp", "2", "--paged-pages", "16"),
                                  ("--gspmd",), ("--distributed",)])
def test_serve_refuses_what_is_not_ported(root, capsys, flag):
    with pytest.raises(SystemExit) as e:
        serve_main(["-d", str(root), "--device", "cpu", *flag])
    assert e.value.code == 2
    assert REFUSED_BECAUSE[flag[0]] in capsys.readouterr().err
