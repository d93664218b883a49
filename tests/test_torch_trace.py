"""core/trace.py on the CPU: the JAX package's span names at its call
sites (prefill chunks and decode blocks of InferenceEngine, the host tree
engine's draft forward and verify), written as a Chrome trace that
Perfetto opens; spans cost nothing when no trace runs; log_perf.

No tolerance: the checks are on names and counts. Span names and
PerfSnapshot's fields are held to the JAX module's."""

import json

import pytest
import torch

from powerserve_tpu.core import trace as jtrace
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core.trace import PerfSnapshot, Trace, log_perf
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.speculative.engine import SpeculativeEngine
from powerserve_tpu_torch.speculative.tree import SpeculativeConfig
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    ws = make_synthetic_gguf(tmp_path_factory.mktemp("trace"), "tiny",
                             GGMLType.Q8_0, seed=0, seq_len=64)
    return load_gguf_model(ws / "model", device="cpu")


def _ranges(path) -> list[str]:
    """The names of the trace's user ranges (record_function), in order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_span_names_are_the_jax_packages():
    for name in ("SPAN_DRAFT_FORWARD", "SPAN_TARGET_FORWARD", "SPAN_VERIFY",
                 "SPAN_PREFILL", "SPAN_DECODE", "SPAN_LOGITS"):
        assert getattr(Trace, name) == getattr(jtrace.Trace, name)
    assert ([f for f in PerfSnapshot.__dataclass_fields__]
            == [f for f in jtrace.PerfSnapshot.__dataclass_fields__])


def test_generate_under_trace(tiny, tmp_path):
    """One prefill span per chunk, one decode span per block; the file is
    Chrome-trace JSON in the directory asked for. Outside a trace the
    spans run as plain code, and a second stop writes nothing."""
    cfg, model = tiny
    hp = HyperParams(max_slots=1, batch_size=4, max_seq_len=64,
                     decode_horizon=2)
    hp.sampler.temperature = 0.0
    eng = InferenceEngine(model, cfg, hp, device="cpu")
    prompt = [1, 5, 9, 12, 3, 7, 40, 41, 2, 8]
    want = list(eng.generate(prompt, 6))
    eng.reset()
    Trace.start_tracing(str(tmp_path / "t"))
    got = list(eng.generate(prompt, 6))
    path = Trace.stop_tracing()
    assert got == want
    assert Trace.stop_tracing() is None
    assert path.startswith(str(tmp_path / "t")) and path.endswith(".json")
    names = _ranges(path)
    # 9 prompt tokens in chunks of 4; 6 tokens in blocks of 2
    assert names.count(Trace.SPAN_PREFILL) == 3
    assert names.count(Trace.SPAN_DECODE) == 3
    with Trace.span("outside"):
        pass


def test_host_tree_engine_spans(tiny, tmp_path):
    """The host tree engine's draft forward (one a tree level) and verify
    (one a step)."""
    cfg, model = tiny
    eng = SpeculativeEngine(model, cfg, model, cfg,
                            SpeculativeConfig(draft_batch_size=8,
                                              max_depth=2),
                            max_seq=64, prefill_chunk=8, device="cpu")
    Trace.start_tracing(str(tmp_path))
    eng.prefill([1, 5, 9, 12, 3, 7])
    steps = 2
    for _ in range(steps):
        eng.step()
    names = _ranges(Trace.stop_tracing())
    assert names.count(Trace.SPAN_VERIFY) == steps
    assert names.count(Trace.SPAN_DRAFT_FORWARD) >= steps


def test_log_perf_returns_a_snapshot():
    first = log_perf("start")
    torch.ones(1000).sum()
    now = log_perf("next", since=first)
    assert isinstance(now, PerfSnapshot) and now.wall_s >= first.wall_s
    assert now.rss_mb > 0 and "wall" in now.delta(first)
