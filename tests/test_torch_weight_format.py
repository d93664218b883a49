"""`run --weight-format w8` and the server's weight_format on the CPU,
against the JAX package's `run` under POWERSERVE_WEIGHT_FORMAT=w8 (its
loader requantizes every projection whose K is a multiple of 128 to W8,
as the port's does).

Tolerance: greedy tokens equal under the near-tie rule (a first
difference only where JAX's top-2 logit gap is below 0.5). The port runs
W8 products with int8 activations (a8); JAX's CPU route keeps bf16
activations and dequantizes the weights to bf16 (ROADMAP section 3, "W8
at small shapes": 1.8-2.2% of the logit range on tiny-k).
"""

import numpy as np
import pytest

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.run import build_engine as jbuild
from powerserve_tpu_torch import run
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.serving.local import LocalServer
from powerserve_tpu_torch.serving.server import ServerContext
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

NEAR_TIE = 0.5
PROMPT = "The quick brown fox jumps over the lazy dog"


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_synthetic_gguf(tmp_path_factory.mktemp("wf"), "tiny-k",
                               GGMLType.Q4_K, seed=0, seq_len=64)


@pytest.fixture
def loads(monkeypatch):
    """Every load_gguf_model call of run.py: (mxu, lm_head is W8)."""
    seen = []
    real = run.load_gguf_model

    def spy(*args, **kw):
        cfg, model = real(*args, **kw)
        seen.append((kw.get("mxu", False), model.lm_head.w8))
        return cfg, model

    monkeypatch.setattr(run, "load_gguf_model", spy)
    return seen


def test_run_w8_matches_jax_run_under_the_variable(ws, monkeypatch, loads):
    monkeypatch.setenv("POWERSERVE_WEIGHT_FORMAT", "w8")
    hp = JHyperParams(max_slots=1, batch_size=128)
    hp.sampler.temperature = 0.0
    jeng, jtok = jbuild(str(ws / "model"), hp, backend="xla")
    monkeypatch.delenv("POWERSERVE_WEIGHT_FORMAT")
    assert jeng.params.lm_head.scale_group == 128  # JAX loaded W8
    ids = jtok.tokenize(PROMPT)
    want = list(jeng.generate(ids, 12, stop_fn=jtok.should_stop))
    got = run.run_prompt(run.parse_args(
        ["-d", str(ws), "-p", PROMPT, "-n", "12", "--temperature", "0",
         "--no-progress", "--device", "cpu", "--weight-format", "w8"]))
    assert loads == [(True, True)]
    assert got.prompt_ids == ids
    i = next((j for j, (a, b) in enumerate(zip(got.ids, want)) if a != b),
             None)
    if i is None:
        assert got.ids == want
    else:
        jeng.reset()
        top2 = np.sort(np.asarray(jeng.prefill(ids + want[:i])))[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (i, got.ids, want)


def test_weight_format_reaches_every_load(ws, loads):
    """gguf by default; with w8 the target and a --draft model both load
    as W8, and an unknown format is refused by argparse."""
    base = ["-d", str(ws), "-p", "hi", "-n", "2", "--temperature", "0",
            "--no-progress", "--device", "cpu"]
    run.run_prompt(run.parse_args(base))
    run.run_prompt(run.parse_args(base + ["--weight-format", "w8",
                                          "--draft", str(ws), "--spec-k",
                                          "2"]))
    assert loads == [(False, False), (True, True), (True, True)]
    with pytest.raises(SystemExit):
        run.parse_args(base + ["--weight-format", "q4"])


def test_server_weight_format(ws):
    """ServerContext and LocalServer load W8 with weight_format="w8" and
    answer the run's greedy tokens; another format is a ValueError."""
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=64)
    want = run.run_prompt(run.parse_args(
        ["-d", str(ws), "-p", "hello", "-n", "6", "--temperature", "0",
         "--no-progress", "--device", "cpu", "--weight-format", "w8"]))
    with LocalServer(ws / "model", "", hp, device="cpu",
                     weight_format="w8") as srv:
        assert srv.ctx.get("").scheduler.model.lm_head.w8
        text = srv.completion("hello", max_tokens=6, temperature=0)
        assert text == srv.ctx.get("").tokenizer.to_string(want.ids)
    with pytest.raises(ValueError, match="weight format"):
        ServerContext(ws / "model", "", hp, device="cpu",
                      weight_format="q4")
