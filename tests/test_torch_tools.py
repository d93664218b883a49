"""The port's tools against the JAX package's on the CPU: perplexity
(the calculator, compute_perplexity over chunks on the prefill and the
decode routes), forward(return_hidden=True), dump-activations and
cos-sim, run --dump-speedinfo, param-search, bench-kernels on the plain
twin, the MMLU and MMMU harnesses and the gate against the port's CPU
server, and the CLI's dispatch of every JAX command name.

The JAX forward runs its Pallas kernels in interpret mode. The two
forwards round differently (the port dequantizes in f32 and rounds the
attention operands to bf16 as the CUDA kernels do; tests/
test_torch_model.py measures logits within 0.5-0.9% of their range on
these 2-layer models), so log-probabilities and hidden states agree to
that level, not to the bit.
"""

import ast
import functools
import json
import pathlib
import subprocess
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.llama import forward as jforward
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.tools import cos_sim as jcos_sim
from powerserve_tpu.tools import mmlu as jmmlu
from powerserve_tpu.tools import mmmu as jmmmu
from powerserve_tpu.tools import param_search as jparam_search
from powerserve_tpu.tools.dump_activations import dump_forward as jdump
from powerserve_tpu.tools.perplexity import (
    PerplexityCalculator as JCalculator)
from powerserve_tpu.tools.perplexity import (
    compute_perplexity as jcompute_perplexity)
from powerserve_tpu_torch import __main__ as cli
from powerserve_tpu_torch import run
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.image import encode_png
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models import llama
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.serving.server import ServerContext, make_server
from powerserve_tpu_torch.speculative.device_tree import TreeTemplate
from powerserve_tpu_torch.speculative.tree import SpeculativeConfig
from powerserve_tpu_torch.tools import bench_kernels, cos_sim, gate, mmlu
from powerserve_tpu_torch.tools import mmmu, param_search
from powerserve_tpu_torch.tools.dump_activations import dump_forward
from powerserve_tpu_torch.tools.perplexity import (PerplexityCalculator,
                                                   compute_perplexity,
                                                   next_token_log_probs)
from powerserve_tpu_torch.tools.synthetic import (make_eagle_gguf,
                                                  make_synthetic_gguf,
                                                  make_vlm_workspace)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEQ = 64
# hidden states and logits against the interpret-mode JAX forward, as a
# share of the JAX values' range (test_torch_model.py's LOGIT_REL)
REL = 1.5e-2
# perplexity against JAX's interpret-mode kernels: exp of the mean of 50
# log-probabilities, whose errors (the logits', ~1% of their range at
# most) mostly cancel in the mean; measured 1.3e-4 (tiny Q8_0) to 2.5e-4
# (tiny-k Q4_K) at batches 20 and 64
PPL_REL = 2e-3
# the gate's perplexity against the JAX gate's, which runs the XLA route
# (logits up to ~2-3% of their range from the port's: test_torch_model.py)
GATE_PPL_REL = 3e-2


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (workspace, JAX (cfg, params), port (cfg, model))."""
    out = {}
    for name, preset, quant in (("tiny", "tiny", GGMLType.Q8_0),
                                ("tiny-k", "tiny-k", GGMLType.Q4_K)):
        # seq_len 256: room for a speculative engine's blocks
        ws = make_synthetic_gguf(tmp_path_factory.mktemp(name), preset,
                                 quant, seed=0, seq_len=256)
        out[name] = (ws, jload(ws / "model"),
                     load_gguf_model(ws / "model", device="cpu"))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ids(n: int, vocab: int, seed: int = 0) -> list[int]:
    return np.random.default_rng(seed).integers(3, vocab, n).tolist()


# -- perplexity -------------------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 3])
def test_calculator_gives_jax_float(warmup):
    rng = np.random.default_rng(warmup)
    logits = (rng.standard_normal((2, 7, 50)) * 4).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7))
    ours, theirs = PerplexityCalculator(warmup), JCalculator(warmup)
    for lg, tk in zip(logits, toks):
        ours.update(lg, tk)
        theirs.update(lg, tk)
    assert (ours.ppl, ours.count, ours.seen) == (theirs.ppl, theirs.count,
                                                  theirs.seen)
    # the device formula in f64 feeds the same sum up to f64 rounding
    calc = PerplexityCalculator(warmup)
    for lg, tk in zip(logits, toks):
        calc.add_log_probs(next_token_log_probs(
            torch.from_numpy(lg), torch.from_numpy(tk)).numpy())
    assert abs(calc.ppl - theirs.ppl) <= 1e-12 * theirs.ppl


@pytest.mark.parametrize("name,batch", [("tiny", 20), ("tiny-k", 20),
                                        ("tiny", 64)])
def test_compute_perplexity_matches_jax(models, name, batch):
    """50 tokens: at batch 20, chunks of 20 and 20 rows (the prefill
    route) and a last chunk of 10 (the decode route); at 64, one chunk."""
    _, (jcfg, jparams), (_, model) = models[name]
    ids = _ids(50, jcfg.llm.vocab_size)
    got = compute_perplexity(model, ids, batch_size=batch, max_seq=SEQ,
                             warmup_batches=0)
    want = jcompute_perplexity(jparams, jcfg, ids, batch_size=batch,
                               max_seq=SEQ, backend="pallas_interpret",
                               warmup_batches=0)
    assert np.isfinite(got) and abs(got - want) / want < PPL_REL, (got, want)


def test_perplexity_chunks_take_both_routes(models):
    """Chunks of more than 16 rows attend through flash-prefill, a last
    chunk of at most 16 through flash-decode; the warm-up skips the
    first batch's predictions as JAX's does."""
    _, (jcfg, jparams), (_, model) = models["tiny"]
    ids = _ids(45, jcfg.llm.vocab_size, seed=1)
    calls = {"flash_prefill_quant": [], "flash_decode_quant": []}
    wraps = {}
    for fn in calls:
        real = getattr(llama, fn)

        def spy(q, *a, _real=real, _fn=fn, **kw):
            calls[_fn].append(q.shape[1])
            return _real(q, *a, **kw)

        wraps[fn] = spy
    with mock.patch.multiple(llama, **wraps):
        got = compute_perplexity(model, ids, batch_size=20, max_seq=SEQ)
    n_layers = model.llm.n_layers
    assert calls["flash_prefill_quant"] == [20] * (2 * n_layers)
    assert calls["flash_decode_quant"] == [5] * n_layers
    want = jcompute_perplexity(jparams, jcfg, ids, batch_size=20, max_seq=SEQ,
                               backend="pallas_interpret")
    assert abs(got - want) / want < PPL_REL


def test_perplexity_cli_prints_jax_keys(models, tmp_path, capsys):
    ws, (jcfg, jparams), (_, model) = models["tiny"]
    corpus = tmp_path / "c.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog " * 4)
    assert cli.main(["perplexity", "-d", str(ws / "model"), "-p",
                     str(corpus), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"perplexity", "n_tokens"} and out["perplexity"] > 1


# -- return_hidden, dump-activations, cos-sim --------------------------------


@pytest.mark.parametrize("name", ["tiny", "tiny-k"])
def test_return_hidden_matches_jax(models, name):
    _, (jcfg, jparams), (cfg, model) = models[name]
    llm = cfg.llm
    toks = np.asarray([_ids(24, llm.vocab_size, 2)], np.int32)
    pos = np.arange(24, dtype=np.int32)[None]
    kv = KVCache.create(llm.n_layers, 1, SEQ, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    logits, hidden = model(kv, torch.from_numpy(toks),
                           torch.from_numpy(pos).long(), logits_mode="all",
                           return_hidden=True)
    fwd = jax.jit(functools.partial(jforward, logits_mode="all",
                                    backend="pallas_interpret",
                                    return_hidden=True), static_argnums=(1,))
    jkv = JKVCache.create(llm.n_layers, 1, SEQ, llm.n_kv_heads,
                          llm.head_size)
    jlogits, _, jhidden = fwd(jparams, jcfg.llm, jkv, jnp.asarray(toks),
                              jnp.asarray(pos))
    assert hidden.shape == (llm.n_layers, 1, 24, llm.dim)
    assert hidden.dtype == torch.bfloat16
    for layer in range(llm.n_layers):
        assert _rel(hidden[layer].float(), jhidden[layer]) < REL, layer
    assert _rel(logits, jlogits) < REL
    # the flag adds outputs only: the same logits and cache bits without it
    kv2 = KVCache.create(llm.n_layers, 1, SEQ, llm.n_kv_heads, llm.head_size,
                         device="cpu")
    plain = model(kv2, torch.from_numpy(toks), torch.from_numpy(pos).long(),
                  logits_mode="all")
    assert torch.equal(plain, logits)
    assert torch.equal(kv.k, kv2.k) and torch.equal(kv.v_scale, kv2.v_scale)
    with pytest.raises(ValueError, match="return_hidden"):
        model(kv, torch.from_numpy(toks[:, :1]),
              torch.from_numpy(pos[:, :1]).long(), kv_update="deferred",
              return_hidden=True)


def test_dumps_match_jax_and_cos_sim_agrees(models, tmp_path, capsys):
    """The port's dumps (int8 cache) against JAX's dump_forward with its
    int8 cache: the same files, every layer's cosine >= 0.999; the port's
    cos-sim prints what JAX's does on the same directories."""
    ws, (jcfg, jparams), (_, model) = models["tiny-k"]
    ids = _ids(12, jcfg.llm.vocab_size, 3)
    ours = dump_forward(model, ids, tmp_path / "ours")
    theirs = jdump(jparams, jcfg, ids, tmp_path / "theirs",
                   backend="pallas_interpret", kv_dtype="int8")
    rows = cos_sim.compare(ours, theirs)
    assert [r[0] for r in rows] == [f"layer_{i:02d}.npy" for i in range(2)] \
        + ["logits.npy"]
    assert all(cs >= 0.999 for _, cs, _ in rows), rows
    assert rows == jcos_sim.compare(ours, theirs)
    assert cos_sim.compare(ours / "logits.npy", theirs / "logits.npy") == \
        jcos_sim.compare(ours / "logits.npy", theirs / "logits.npy")
    assert cos_sim.main([str(ours), str(theirs)]) == 0
    printed = capsys.readouterr().out
    assert jcos_sim.main([str(ours), str(theirs)]) == 0
    assert capsys.readouterr().out == printed
    # the CLI writes the same files as the function
    assert cli.main(["dump-activations", "-d", str(ws / "model"), "-p",
                     "the quick brown fox", "-o", str(tmp_path / "cli"),
                     "--device", "cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "cli").iterdir()) == \
        sorted(p.name for p in ours.iterdir())


# -- run --dump-speedinfo ----------------------------------------------------


def test_run_dump_speedinfo_appends_jax_lines(models, tmp_path, monkeypatch):
    from powerserve_tpu.run import main as jrun

    ws = models["tiny"][0]
    argv = ["-d", str(ws), "-p", "the quick brown", "-n", "5",
            "--temperature", "0", "--no-progress"]
    ours = tmp_path / "ours.jsonl"
    for _ in range(2):
        assert run.main(argv + ["--device", "cpu", "--dump-speedinfo",
                                str(ours)]) == 0
    theirs = tmp_path / "theirs.jsonl"
    monkeypatch.setenv("POWERSERVE_DUMP_SPEEDINFO", str(theirs))
    assert jrun(argv + ["--backend", "xla"]) == 0
    lines = [json.loads(x) for x in ours.read_text().splitlines()]
    want = json.loads(theirs.read_text())
    assert len(lines) == 2
    for got in lines:
        assert list(got) == list(want)
        assert (got["n_prefill"], got["n_decode"]) == (want["n_prefill"],
                                                       want["n_decode"])
        assert got["prefill_speed"] > 0 and got["decode_speed"] > 0
    with pytest.raises(SystemExit, match="dump-speedinfo"):
        run.main(argv + ["--device", "cpu", "--self-draft-layers", "1",
                         "--dump-speedinfo", str(ours)])


# -- param-search ------------------------------------------------------------


def test_param_search_grids_are_jax_and_fit_the_port():
    assert param_search.DEFAULT_GRID == jparam_search.DEFAULT_GRID
    assert param_search.CHAIN_GRID == jparam_search.CHAIN_GRID
    assert param_search.TREE_GRID == jparam_search.TREE_GRID
    assert max(param_search.DEFAULT_GRID["draft_batch_size"]) <= \
        llama.DECODE_MAX_TQ
    for widths in param_search.TREE_GRID["widths"]:
        tpl = TreeTemplate.from_widths([int(w) for w in widths.split(",")])
        assert tpl.n_nodes <= 16


def test_param_search_host_tree_records_jax_keys(models, tmp_path):
    from powerserve_tpu_torch.speculative.engine import SpeculativeEngine

    ws, _, (cfg, model) = models["tiny"]
    _, draft = load_gguf_model(ws / "model", device="cpu")

    def make_engine(spec):
        return SpeculativeEngine(model, cfg, draft, cfg, spec, max_seq=SEQ,
                                 device="cpu")

    grid = {"draft_batch_size": [4, 6], "draft_top_k": [3],
            "draft_temperature": [1.0], "p_base": [0.9],
            "max_fan_out": [2], "min_prob": [0.1]}
    out = tmp_path / "search.jsonl"
    results = param_search.run_search(make_engine, [1, 5, 9], 6, grid, out)
    assert len(results) == 2
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    keys = set(SpeculativeConfig().__dict__) | {
        "tokens_per_step", "accept_rate", "emitted", "decode_ms",
        "decode_speed"}
    assert all(set(r) == keys for r in recs)
    # a draft identical to the target accepts every draft
    assert all(r["accept_rate"] == 1.0 for r in recs)


@pytest.mark.parametrize("engine", ["chain", "device-tree", "eagle"])
def test_param_search_cli_over_the_device_engines(models, tmp_path, engine,
                                                  capsys):
    ws = models["tiny"][0]
    out = tmp_path / "search.jsonl"
    argv = ["param-search", "-d", str(ws / "model"), "--engine", engine,
            "-n", "8", "-o", str(out), "--device", "cpu"]
    if engine == "eagle":
        make_eagle_gguf(tmp_path / "head", "tiny", GGMLType.Q8_0)
        argv += ["--draft-dir", str(tmp_path / "head")]
    else:
        argv += ["--self-draft-layers", "1"]
    assert cli.main(argv) == 0
    grid = (param_search.TREE_GRID if engine == "device-tree"
            else param_search.CHAIN_GRID)
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r[next(iter(grid))] for r in recs] == next(iter(grid.values()))
    for r in recs:
        assert set(r) == set(grid) | {"tokens_per_step", "accept_rate",
                                      "emitted", "wall_s", "wall_tok_s"}
        assert r["emitted"] == 8
    best = json.loads(capsys.readouterr().out)["best"]
    assert best == max(recs, key=lambda r: r["wall_tok_s"])


# -- bench-kernels -----------------------------------------------------------


def test_bench_kernels_runs_the_twin_on_the_cpu(monkeypatch, capsys):
    row = bench_kernels.bench_qmatmul(GGMLType.Q4_K, 256, 64, 2, 3, "cpu")
    assert list(row) == ["fmt", "K", "N", "M", "us_per_call", "GBps"]
    assert row["fmt"] == "Q4_K" and row["us_per_call"] > 0
    monkeypatch.setattr(bench_kernels, "CASES", [(GGMLType.Q8_0, 64, 32, 1),
                                                 (GGMLType.Q4_0, 64, 32, 4)])
    assert cli.main(["bench-kernels", "--iters", "2", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["fmt"], r["M"]) for r in lines] == [("Q8_0", 1), ("Q4_0", 4)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_kernels.main(["--iters", "1"])


# -- the HTTP harnesses and the gate ----------------------------------------


@pytest.fixture(scope="module")
def cpu_server(tmp_path_factory):
    """The port's HTTP server on the CPU over a tiny vision-language
    workspace (it answers text and image chats)."""
    root = tmp_path_factory.mktemp("vlm")
    make_vlm_workspace(root, "tiny-vlm", seq_len=256)
    ctx = ServerContext(root, "model", HyperParams(max_slots=2, batch_size=8),
                        device="cpu")
    server = make_server(ctx, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield dict(root=root, url=f"http://127.0.0.1:{server.server_address[1]}")
    server.shutdown()
    server.server_close()
    ctx.close()


def test_mmlu_prompts_and_parsing_are_jax(tmp_path):
    ex = ("What is 1+1?", ["1", "2", "3", "4"], "B")
    for q, opts, example in (("What is 2+2?", ["3", "4", "5", "6"], ex),
                             ("Pick one", ["a", "b", "c", "d"], None)):
        assert mmlu.build_prompt(q, opts, example) == \
            jmmlu.build_prompt(q, opts, example)
    for text in (" B. because", "the answer is C", "unclear", "d", "AB",
                 "(a) or B", ""):
        assert mmlu.parse_choice(text) == jmmlu.parse_choice(text)
    assert mmmu.build_question("Q?", list("wxyz")) == \
        jmmmu.build_question("Q?", list("wxyz"))
    png = tmp_path / "a.png"
    png.write_bytes(encode_png(np.zeros((4, 4, 3), np.uint8)))
    assert mmmu.image_to_data_uri(png) == jmmmu.image_to_data_uri(png)


def _mmlu_dir(d) -> pathlib.Path:
    d.mkdir()
    (d / "math_test.csv").write_text(
        "What is 1+1?,1,2,3,4,B\nWhat is 2+2?,3,4,5,6,B\n"
        "What is 3+3?,6,7,8,9,A\n")
    (d / "misc_test.csv").write_text(
        '"Which, with a comma?",x,y,z,w,D\nSky color?,red,blue,green,'
        'gray,B\n')
    return d


def test_mmlu_and_mmmu_harnesses_match_jax_on_the_cpu_server(cpu_server,
                                                             tmp_path):
    url = cpu_server["url"]
    data = _mmlu_dir(tmp_path / "mmlu")
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert mmlu.main(["--data-dir", str(data), "--url", url, "-o",
                      str(ours)]) == 0
    assert jmmlu.main(["--data-dir", str(data), "--url", url, "-o",
                       str(theirs)]) == 0
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert got == want and got["total_n"] == 3
    # MMMU: an image question and a text one
    png = tmp_path / "img.png"
    png.write_bytes(encode_png(
        np.random.default_rng(0).integers(0, 255, (40, 60, 3), np.uint8)))
    rows = [{"question": "What is shown?", "options": ["a cat", "a dog"],
             "answer": "A", "image": "img.png"},
            {"question": "2+2?", "options": ["3", "4", "5"], "answer": "b"}]
    jsonl = tmp_path / "mmmu.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for harness, out in ((mmmu, ours), (jmmmu, theirs)):
        assert harness.main(["--data", str(jsonl), "--url", url, "--model",
                             "model", "-o", str(out)]) == 0
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert got == want and got["n"] == 2
    with pytest.raises(RuntimeError, match="404"):
        mmlu.ask_server(url, "no-such-model", "hi")


def _keys(d) -> dict:
    return {k: _keys(v) if isinstance(v, dict) and k != "per_subject"
            else None for k, v in d.items()}


def test_gate_on_the_cpu_matches_jax(models, tmp_path):
    """The gate over a workspace with --device cpu: perplexity, the
    self-draft's acceptance and MMLU against a server subprocess it
    starts and kills; the verdict's keys are JAX's gate's (its MMLU check
    run here on the port's server only: JAX's would start a JAX server)."""
    from powerserve_tpu.tools.gate import main as jgate

    ws = models["tiny"][0]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("The quick brown fox jumps over the lazy dog. " * 20)
    data = _mmlu_dir(tmp_path / "mmlu")
    procs = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        procs.append(real_popen(*a, **kw))
        return procs[-1]

    common = ["-d", str(ws), "--prompt-file", str(corpus), "--draft",
              "self:1", "--spec-tokens", "16"]
    with mock.patch.object(gate.subprocess, "Popen", popen):
        assert gate.main(common + ["--device", "cpu", "--mmlu-data",
                                   str(data), "--mmlu-limit", "2", "-o",
                                   str(tmp_path / "ours.json")]) == 0
    assert len(procs) == 1 and procs[0].poll() is not None
    assert jgate(common + ["--backend", "xla", "-o",
                           str(tmp_path / "theirs.json")]) == 0
    got = json.loads((tmp_path / "ours.json").read_text())
    want = json.loads((tmp_path / "theirs.json").read_text())
    mm = got["checks"].pop("mmlu")
    want["checks"].pop("mmlu")
    assert _keys(got) == _keys(want)
    assert set(mm) == {"accuracy", "total_n", "per_subject"}
    # each subject's first row is the 1-shot example: 2 + 1 questions
    assert mm["total_n"] == 3 and set(mm["per_subject"]) == {"math", "misc"}
    assert got["pass"] is True and got["backend"] == "cpu"
    ppl, jppl = (r["checks"]["perplexity"]["perplexity"] for r in (got, want))
    assert abs(ppl - jppl) / jppl < GATE_PPL_REL
    assert got["checks"]["speculation"]["generated"] == 16


def test_gate_kills_its_server_when_a_check_raises(tmp_path):
    """A failing MMLU harness still ends the server's process group."""
    procs = []
    real_popen = subprocess.Popen

    def popen(argv, **kw):
        procs.append(real_popen(
            [sys.executable, "-c", "import time; time.sleep(60)"], **kw))
        return procs[-1]

    def boom(argv):
        raise RuntimeError("harness failed")

    with mock.patch.object(gate.subprocess, "Popen", popen), \
            mock.patch.object(gate.urllib.request, "urlopen"), \
            mock.patch.object(mmlu, "main", boom):
        with pytest.raises(RuntimeError, match="harness failed"):
            gate._gate_mmlu("m", str(tmp_path), "cpu", 1, tmp_path)
    assert procs[0].wait(timeout=5) != 0


# -- the CLI -----------------------------------------------------------------


def _jax_commands() -> list[str]:
    """The command names the JAX package's __main__ dispatches."""
    tree = ast.parse((ROOT / "powerserve_tpu" / "__main__.py").read_text())
    return [node.comparators[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Compare)
            and isinstance(node.left, ast.Name) and node.left.id == "cmd"
            and isinstance(node.comparators[0], ast.Constant)]


def test_cli_dispatches_every_jax_command(tmp_path, capsys):
    names = _jax_commands()
    assert len(names) == 15
    for name in names:
        assert (name in cli.COMMANDS) != (name in cli.REFUSED), name
        if name in cli.COMMANDS:
            mod = __import__(f"powerserve_tpu_torch{cli.COMMANDS[name]}",
                             fromlist=["main"])
            assert callable(mod.main), name
    assert set(cli.REFUSED) == {"autotune", "deploy"}
    for name in cli.REFUSED:
        assert cli.main([name, "--help"]) == 2
        assert "not in the port" in capsys.readouterr().err
    assert cli.main(["nope"]) == 1
    assert "unknown command" in capsys.readouterr().out
    assert cli.main([]) == 1
    # synthetic through the dispatch takes its argv
    assert cli.main(["synthetic", str(tmp_path / "ws"), "--preset", "tiny",
                     "--quant", "q8_0", "--seq-len", "32"]) == 0
    assert (tmp_path / "ws" / "model" / "weights.gguf").exists()


def test_cli_module_exit_codes():
    for argv, rc in ((["nope"], 1), (["deploy"], 2)):
        r = subprocess.run([sys.executable, "-m", "powerserve_tpu_torch",
                            *argv], capture_output=True, text=True, cwd=ROOT,
                           timeout=120)
        assert r.returncode == rc, r.stderr


def test_tools_default_to_cuda(models, tmp_path):
    """Without --device cpu every tool asks for the card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    ws = models["tiny"][0]
    corpus = tmp_path / "c.txt"
    corpus.write_text("the quick brown fox")
    model_dir = str(ws / "model")
    for argv in (["perplexity", "-d", model_dir, "-p", str(corpus)],
                 ["dump-activations", "-d", model_dir, "-o",
                  str(tmp_path / "d")],
                 ["param-search", "-d", model_dir, "--engine", "chain",
                  "--self-draft-layers", "1"],
                 ["bench-kernels", "--iters", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    # the gate records the refusal of each check and fails
    out = tmp_path / "gate.json"
    assert cli.main(["gate", "-d", str(ws), "--draft", "self:1", "-o",
                     str(out)]) == 1
    rep = json.loads(out.read_text())
    assert rep["failures"] == ["perplexity", "speculation"]
    assert "device='cpu'" in rep["checks"]["perplexity"]["error"]
