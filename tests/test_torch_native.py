"""The port's native host runtime (powerserve_tpu_torch/core/native.py
over csrc/host/gguf_loader.cpp) against its Python twins: the port of the
JAX package's tests/test_native.py and of the native half of
tests/test_storage.py, plus the build at first use.

Tolerance: none. The repack, the reader, the fp16 conversion and the
merge loops compute the same integers and floats as the twins, so every
comparison is bit for bit."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from powerserve_tpu_torch.core import gguf as G
from powerserve_tpu_torch.core import native
from powerserve_tpu_torch.core import quant as Q
from powerserve_tpu_torch.core.native import (NativeGGUFReader, fp16_to_f32,
                                              native_repack)
from powerserve_tpu_torch.models.loader import qlinear_from_payload
from powerserve_tpu_torch.ops.qmatmul import QLinear
from powerserve_tpu_torch.tokenizer.vocab import GGUFVocab
from torch_threads import one_torch_thread  # noqa: F401

METHODS = ["mmap", "bio", "dio", "async"]


def _same_qlinear(a: QLinear, b: QLinear) -> None:
    for name in ("q", "scales", "bias"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    for name in ("packed", "unsigned", "in_features", "out_features",
                 "pack_group", "scale_group"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("fmt", [G.GGMLType.Q4_0, G.GGMLType.Q8_0,
                                 G.GGMLType.Q4_K, G.GGMLType.Q6_K])
def test_native_repack_matches_numpy(fmt):
    """The C++ repack against core/quant.py's (and pack_nib4's nibbles),
    and the loader's QLinear through it against the numpy route's; at K =
    96 the port keeps 4-bit weights unpacked, which only numpy gives."""
    rng = np.random.default_rng(0)
    n_out, k_in = 8, 512
    w = rng.standard_normal((n_out, k_in)).astype(np.float32)
    payload = Q.quantize(w, fmt)
    ref = Q.repack_gguf_tensor(payload, fmt, (n_out, k_in))
    q, scales, bias, group, unsigned = native_repack(payload, fmt, n_out,
                                                     k_in)
    assert scales.dtype == np.float32
    np.testing.assert_array_equal(scales, ref.scales)
    if fmt in (G.GGMLType.Q4_0, G.GGMLType.Q4_K):
        assert unsigned == (fmt == G.GGMLType.Q4_K)
        np.testing.assert_array_equal(
            q, Q.pack_nib4(ref.q, group, signed_bias=not unsigned))
        assert Q.choose_pack_group(k_in) == group
    else:
        assert group == 0 and not unsigned
        np.testing.assert_array_equal(q, ref.q)
    if fmt == G.GGMLType.Q4_K:
        np.testing.assert_array_equal(bias, ref.bias)
    else:
        assert bias is None
    _same_qlinear(qlinear_from_payload(payload, fmt, (n_out, k_in), True,
                                       "cpu"),
                  QLinear.from_quantized(ref, device="cpu"))
    if fmt == G.GGMLType.Q4_0:
        small = Q.quantize(w[:, :96], fmt)
        _same_qlinear(
            qlinear_from_payload(small, fmt, (n_out, 96), True, "cpu"),
            QLinear.from_quantized(
                Q.repack_gguf_tensor(small, fmt, (n_out, 96)), device="cpu"))
    assert native_repack(payload, G.GGMLType.F32, n_out, k_in) is None


@pytest.fixture(scope="module")
def sample_gguf(tmp_path_factory):
    rng = np.random.default_rng(1)
    w = G.GGUFWriter()
    w.metadata["general.architecture"] = "llama"
    w.metadata["llama.block_count"] = 3
    w.metadata["llama.rope.freq_base"] = 500000.0
    w.metadata["tokenizer.ggml.tokens"] = ["a", "b", "c"]
    w.metadata["flag"] = True
    w.add_float_tensor("a.weight", rng.standard_normal((4, 64)).astype(
        np.float32))
    b = rng.standard_normal((8, 256)).astype(np.float32)
    w.add_tensor("b.weight", (256, 8), G.GGMLType.Q4_K,
                 Q.quantize(b, G.GGMLType.Q4_K))
    path = tmp_path_factory.mktemp("native") / "t.gguf"
    w.write(path)
    return path


def test_native_gguf_reader_matches_python(sample_gguf):
    py = G.GGUFReader(sample_gguf)
    nat = NativeGGUFReader(sample_gguf)
    try:
        md = nat.metadata
        assert md["general.architecture"] == "llama"
        assert md["llama.block_count"] == 3
        assert abs(md["llama.rope.freq_base"] - 500000.0) < 1e-3
        assert md["tokenizer.ggml.tokens"] == ["a", "b", "c"]
        assert md["flag"] is True
        assert set(nat.tensors) == set(py.tensors)
        for name in py.tensors:
            np.testing.assert_array_equal(nat.tensor_raw(name),
                                          py.tensor_raw(name))
            assert nat.tensors[name][0] == py.tensors[name].ggml_type
            assert nat.tensors[name][2] == py.tensors[name].ne
    finally:
        nat.close()
        py.close()


@pytest.mark.parametrize("method", METHODS)
def test_reader_strategies(sample_gguf, method):
    """Every loading strategy, Python and C++, gives the mmap reader's
    metadata and bytes (the JAX package's tests/test_storage.py)."""
    ref = G.GGUFReader(sample_gguf, method="mmap")
    py = G.GGUFReader(sample_gguf, method=method)
    nat = NativeGGUFReader(sample_gguf, method=method)
    try:
        assert py.metadata == ref.metadata
        assert nat.metadata["general.architecture"] == "llama"
        assert set(py.tensors) == set(nat.tensors) == set(ref.tensors)
        for name in ref.tensors:
            np.testing.assert_array_equal(py.tensor_raw(name),
                                          ref.tensor_raw(name))
            np.testing.assert_array_equal(nat.tensor_raw(name),
                                          ref.tensor_raw(name))
    finally:
        for r in (nat, py, ref):
            r.close()


def test_unknown_method_rejected(sample_gguf):
    with pytest.raises(ValueError):
        G.GGUFReader(sample_gguf, method="carrier-pigeon")
    with pytest.raises(ValueError):
        NativeGGUFReader(sample_gguf, method="carrier-pigeon")


def test_native_fp16_convert():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float16)
    x[:4] = [np.inf, -np.inf, 0.0, -0.0]
    x[4] = np.float16(6e-8)  # a subnormal
    got = fp16_to_f32(x)
    np.testing.assert_array_equal(got, x.astype(np.float32))
    np.testing.assert_array_equal(fp16_to_f32(x.view(np.uint8)), got)


def _spm_md(scores: bool) -> dict:
    tokens = ["<unk>", "<s>", "</s>"]
    types = [2, 3, 3]
    tokens += [f"<0x{b:02X}>" for b in range(256)]
    types += [6] * 256
    words = ["▁the", "▁quick", "th", "he", "the", "qu", "ick", "▁",
             "a", "b", "ab", "ba", "aba", "日", "本", "日本"]
    tokens += words
    types += [1] * len(words)
    md = {"tokenizer.ggml.model": "llama",
          "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.token_type": types,
          "tokenizer.ggml.unknown_token_id": 0,
          "tokenizer.ggml.bos_token_id": 1,
          "tokenizer.ggml.eos_token_id": 2}
    if scores:
        md["tokenizer.ggml.scores"] = [float(-i) for i in range(len(tokens))]
    return md


def test_native_tokenizer_matches_python():
    """The C++ merge loop (the vocab's encode) equals the Python loop, SPM
    and BPE, with byte fallback, multibyte UTF-8, ties and vocabs without
    scores; whole prompts too."""
    texts = ["the quick", "abab aba ba", "日本 the", "xyz éé", "", " ",
             "ababababab"]
    for scores in (True, False):
        v = GGUFVocab.from_metadata(_spm_md(scores))
        for t in texts:
            assert (v._spm_encode_fragment(t)
                    == v._spm_encode_fragment_py(t)), (scores, t)
    md = {"tokenizer.ggml.model": "gpt2",
          "tokenizer.ggml.tokens": ["<unk>", "a", "b", "c", "ab", "abc",
                                    "bc", "Ġ", "Ġa"],
          "tokenizer.ggml.token_type": [2] + [1] * 8,
          "tokenizer.ggml.merges": ["a b", "ab c", "b c", "Ġ a"],
          "tokenizer.ggml.unknown_token_id": 0}
    v = GGUFVocab.from_metadata(md)
    for w in ["abc", "abcabc", "aabbcc", "Ġaabc", "x"]:
        assert v._bpe_encode_word(w) == v._bpe_encode_word_py(w), w


def test_native_tokenizer_on_a_workspace(tmp_path):
    """A synthetic workspace's tokenizer: every prompt's ids through the
    C++ loop equal the Python loop's."""
    from powerserve_tpu_torch.tokenizer import Tokenizer
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny", G.GGMLType.Q8_0, seed=0,
                             seq_len=64)
    tok = Tokenizer.from_model_dir(ws / "model")
    v = tok.vocab
    prompts = ["The quick brown fox", "hello, world 123", "日本語 ok",
               "a" * 50]
    native_ids = [tok.tokenize(p) for p in prompts]
    v._spm_encode_fragment = v._spm_encode_fragment_py
    v._bpe_encode_word = v._bpe_encode_word_py
    assert native_ids == [tok.tokenize(p) for p in prompts]


def test_build_under_lock_and_failure(tmp_path, monkeypatch):
    """Two processes that build into an empty directory at once both load
    the library (one compiles, under the lock; the other waits and takes
    it; no temporary file stays). A source that does not compile raises
    with the compiler's output."""
    script = ("import ctypes, sys; from pathlib import Path; "
              "from powerserve_tpu_torch.core import native; "
              "so = native.build(Path(sys.argv[1])); ctypes.CDLL(str(so)); "
              "print(so)")
    root = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", script, str(root)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip().splitlines()[-1] for o, _ in outs}
    assert len(paths) == 1
    (so_dir,) = root.iterdir()
    assert sorted(f.name for f in so_dir.iterdir()) == [native.LIB_NAME,
                                                        "lock"]

    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="bad.cpp") as e:
        native.build(tmp_path / "bad")
    assert "error" in str(e.value)
