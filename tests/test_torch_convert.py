"""The port's HF -> workspace tools against the JAX package's on the CPU:
its safetensors reader and writer against the `safetensors` package
(which only the tests import), convert_hf_model / convert_eagle /
convert_internvl and `convert`'s dispatch on F32 HF directories that
the tests write (byte for byte: the same quantizers and GGUF writer), the
pytorch_model.bin route, BF16 checkpoints and `workspace create`.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from powerserve_tpu.tokenizer import Tokenizer as JTokenizer
from powerserve_tpu.tools import convert_hf as jconvert
from powerserve_tpu.tools.workspace import create_workspace as jcreate
from powerserve_tpu_torch.core.gguf import GGMLType, GGUFReader
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.tokenizer import Tokenizer
from powerserve_tpu_torch.tools import convert_hf
from powerserve_tpu_torch.tools.safetensors import load_file, save_file
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from powerserve_tpu_torch.tools.workspace import create_workspace
from torch_threads import one_torch_thread  # noqa: F401

DIM, VOCAB = 64, 320


def _llama_cfg(**kw) -> dict:
    cfg = {"architectures": ["LlamaForCausalLM"], "hidden_size": DIM,
           "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 256, "rope_theta": 10000.0,
           "rms_norm_eps": 1e-5, "vocab_size": VOCAB,
           "tie_word_embeddings": False}
    cfg.update(kw)
    return cfg


def _llama_tensors(cfg: dict, rng, bias=False, qk_norm=False,
                   experts=0) -> dict:
    dim, ff = cfg["hidden_size"], cfg["intermediate_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or dim // H

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg["vocab_size"], dim),
          "model.norm.weight": 1 + w(dim),
          "lm_head.weight": w(cfg["vocab_size"], dim)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": 1 + w(dim),
            p + "post_attention_layernorm.weight": 1 + w(dim),
            p + "self_attn.q_proj.weight": w(H * hd, dim),
            p + "self_attn.k_proj.weight": w(Hkv * hd, dim),
            p + "self_attn.v_proj.weight": w(Hkv * hd, dim),
            p + "self_attn.o_proj.weight": w(dim, H * hd)})
        if bias:
            sd.update({p + "self_attn.q_proj.bias": w(H * hd),
                       p + "self_attn.k_proj.bias": w(Hkv * hd),
                       p + "self_attn.v_proj.bias": w(Hkv * hd)})
        if qk_norm:
            sd.update({p + "self_attn.q_norm.weight": 1 + w(hd),
                       p + "self_attn.k_norm.weight": 1 + w(hd)})
        if experts:
            sd[p + "block_sparse_moe.gate.weight"] = w(experts, dim)
            for e in range(experts):
                q = f"{p}block_sparse_moe.experts.{e}."
                sd.update({q + "w1.weight": w(ff, dim),
                           q + "w3.weight": w(ff, dim),
                           q + "w2.weight": w(dim, ff)})
        else:
            sd.update({p + "mlp.gate_proj.weight": w(ff, dim),
                       p + "mlp.up_proj.weight": w(ff, dim),
                       p + "mlp.down_proj.weight": w(dim, ff)})
    return sd


def _hf_tokenizer(d) -> None:
    """A byte-level BPE tokenizer.json and its tokenizer_config.json."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = HFTok(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["the quick brown fox jumps over the lazy dog"]
                            * 8, trainer)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))


def _write_hf(d, cfg: dict, sd: dict, shards: int = 1, tokenizer=False):
    d.mkdir(parents=True, exist_ok=True)
    names = sorted(sd)
    for s in range(shards):
        part = {n: sd[n] for n in names[s::shards]}
        st_save_numpy(part, str(d / f"model-{s + 1:05d}-of-{shards:05d}"
                                    ".safetensors"))
    (d / "config.json").write_text(json.dumps(cfg))
    if tokenizer:
        _hf_tokenizer(d)
    return d


def _fixture(name: str, d):
    rng = np.random.default_rng(TEXT_FIXTURES.index(name))
    if name == "llama":
        cfg = _llama_cfg()
        return _write_hf(d, cfg, _llama_tensors(cfg, rng), shards=2,
                         tokenizer=True), "q8_0"
    if name == "llama-q4_k":
        cfg = _llama_cfg(hidden_size=256, intermediate_size=512,
                         tie_word_embeddings=True)
        sd = _llama_tensors(cfg, rng)
        del sd["lm_head.weight"]
        return _write_hf(d, cfg, sd), "q4_k"
    if name == "qwen2-bias":
        cfg = _llama_cfg(architectures=["Qwen2ForCausalLM"])
        return _write_hf(d, cfg, _llama_tensors(cfg, rng, bias=True)), "q8_0"
    if name == "qwen3-qk-norm":
        cfg = _llama_cfg(architectures=["Qwen3ForCausalLM"], head_dim=32)
        return _write_hf(d, cfg, _llama_tensors(cfg, rng, qk_norm=True)), \
            "q8_0"
    if name == "llama3-rope":
        cfg = _llama_cfg(max_position_embeddings=1024, rope_scaling={
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
            "high_freq_factor": 4.0, "original_max_position_embeddings": 64})
        return _write_hf(d, cfg, _llama_tensors(cfg, rng)), "q8_0"
    if name == "mixtral-moe":
        cfg = _llama_cfg(architectures=["MixtralForCausalLM"],
                         num_local_experts=4, num_experts_per_tok=2,
                         head_dim=None)
        return _write_hf(d, cfg, _llama_tensors(cfg, rng, experts=4)), "q8_0"
    raise KeyError(name)


TEXT_FIXTURES = ["llama", "llama-q4_k", "qwen2-bias", "qwen3-qk-norm",
                 "llama3-rope", "mixtral-moe"]


def _same_tree(a, b) -> None:
    """Every file under a has the same bytes under b, and no more."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# -- the safetensors format --------------------------------------------------


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_load_file_matches_safetensors(tmp_path, dtype):
    rng = np.random.default_rng(0)
    arrs = {f"t{i}": rng.standard_normal(shape).astype(np.float32)
            for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (0,)])}
    p = tmp_path / "x.safetensors"
    if dtype == "BF16":
        st_save_torch({k: torch.from_numpy(v).bfloat16()
                       for k, v in arrs.items()}, str(p))
        want = {k: v.float().numpy() for k, v in st_load_torch(str(p)).items()}
    else:
        np_dtype = np.float32 if dtype == "F32" else np.float16
        st_save_numpy({k: v.astype(np_dtype) for k, v in arrs.items()},
                      str(p), metadata={"format": "np"})
        want = st_load_numpy(str(p))
    got = load_file(p)
    assert list(got) == list(want)  # the same order
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))


@pytest.mark.parametrize("case", ["f32", "f16", "bf16", "mixed"])
def test_save_file_writes_the_safetensors_bytes(tmp_path, case):
    rng = np.random.default_rng(1)
    arrs = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in (("b.10", (2, 3)), ("b.9", (4,)), ("a", (1, 1, 2)),
                         ("zeta", (5,)))}
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    if case == "f32":
        save_file(arrs, ours)
        st_save_numpy(arrs, str(theirs))
    elif case == "f16":
        half = {k: v.astype(np.float16) for k, v in arrs.items()}
        save_file(half, ours)
        st_save_numpy(half, str(theirs))
    else:
        ts = {k: torch.from_numpy(v).bfloat16() for k, v in arrs.items()}
        if case == "mixed":
            ts["a"] = ts["a"].float()
            ts["zeta"] = ts["zeta"].half()
        save_file(ts, ours)
        st_save_torch(ts, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


# -- convert ------------------------------------------------------------------


@pytest.mark.parametrize("name", TEXT_FIXTURES)
def test_convert_writes_the_jax_bytes(tmp_path, name):
    hf, quant = _fixture(name, tmp_path / "hf")
    convert_hf.main([str(hf), str(tmp_path / "ours"), "--quant", quant])
    jconvert.main([str(hf), str(tmp_path / "theirs"), "--quant", quant])
    _same_tree(tmp_path / "ours", tmp_path / "theirs")
    # the workspace loads in the port
    cfg, model = load_gguf_model(tmp_path / "ours" / "model", device="cpu")
    assert cfg.llm.n_layers == 2 and cfg.llm.vocab_size == VOCAB


# logits of a converted workspace against JAX's forward on its XLA route
# (test_torch_model.py's LOGIT_REL["xla"]: the routes' roundings differ
# by up to ~2-3% of the logits' range on 2-layer models)
XLA_REL = 3e-2


@pytest.mark.parametrize("name", ["llama3-rope", "qwen2-bias",
                                  "qwen3-qk-norm", "mixtral-moe"])
def test_converted_models_give_jax_logits(tmp_path, name):
    """The port loads each converted architecture as JAX does: rope
    scaling past the original context (positions 90-99 of a 64-token
    original window), QKV biases, QK-norm with its own head_dim, MoE."""
    import jax.numpy as jnp

    from powerserve_tpu.kv.cache import KVCache as JKVCache
    from powerserve_tpu.models.llama import forward as jforward
    from powerserve_tpu.models.loader import load_gguf_model as jload
    from powerserve_tpu_torch.kv.cache import KVCache

    hf, quant = _fixture(name, tmp_path / "hf")
    convert_hf.convert_hf_model(hf, tmp_path / "ws", quant)
    d = tmp_path / "ws" / "model"
    (jcfg, jparams), (cfg, model) = jload(d), load_gguf_model(d, device="cpu")
    llm = cfg.llm
    start = 90 if name == "llama3-rope" else 0
    toks = np.random.default_rng(7).integers(0, VOCAB, (1, 10)).astype(
        np.int32)
    pos = (start + np.arange(10, dtype=np.int32))[None]
    kv = KVCache.create(llm.n_layers, 1, 128, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    got = model(kv, torch.from_numpy(toks), torch.from_numpy(pos).long(),
                logits_mode="all").numpy()
    jkv = JKVCache.create(llm.n_layers, 1, 128, llm.n_kv_heads,
                          llm.head_size)
    want, _ = jforward(jparams, jcfg.llm, jkv, jnp.asarray(toks),
                       jnp.asarray(pos), backend="xla", logits_mode="all")
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < XLA_REL


def test_converted_tokenizer_loads_as_in_jax(tmp_path):
    hf, quant = _fixture("llama", tmp_path / "hf")
    convert_hf.convert_hf_model(hf, tmp_path / "ws", quant)
    d = tmp_path / "ws" / "model"
    ours, theirs = Tokenizer.from_model_dir(d), JTokenizer.from_model_dir(d)
    assert ours.bos_id == theirs.bos_id >= 0
    assert ours.eos_id == theirs.eos_id >= 0
    for text in ("the quick brown fox", "lazy dogs jump\nover 42 foxes"):
        ids = ours.tokenize(text)
        assert ids == theirs.tokenize(text) and ids[0] == ours.bos_id
        assert ours.to_string(ids) == theirs.to_string(ids)


def test_convert_bin_route_writes_the_jax_bytes(tmp_path):
    cfg = _llama_cfg()
    sd = _llama_tensors(cfg, np.random.default_rng(3))
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(cfg))
    names = sorted(sd)
    for i, part in enumerate((names[::2], names[1::2])):
        torch.save({n: torch.from_numpy(sd[n]) for n in part},
                   hf / f"pytorch_model-{i + 1:05d}-of-00002.bin")
    convert_hf.convert_hf_model(hf, tmp_path / "ours", "q8_0")
    jconvert.convert_hf_model(hf, tmp_path / "theirs", "q8_0")
    _same_tree(tmp_path / "ours", tmp_path / "theirs")


def test_bf16_checkpoints_convert_as_in_jax(tmp_path):
    """A BF16 checkpoint converts to the bytes the JAX tool writes for it,
    and for the same values stored as F32. (safetensors.numpy reads BF16
    only once ml_dtypes has registered the dtype with numpy, as importing
    jax does; the port's reader needs no such package.)"""
    cfg = _llama_cfg()
    sd = {k: torch.from_numpy(v).bfloat16()
          for k, v in _llama_tensors(cfg, np.random.default_rng(4)).items()}
    bf = tmp_path / "bf16"
    bf.mkdir()
    save_file(sd, bf / "model.safetensors")
    (bf / "config.json").write_text(json.dumps(cfg))
    f32 = _write_hf(tmp_path / "f32", cfg,
                    {k: v.float().numpy() for k, v in sd.items()})
    convert_hf.convert_hf_model(bf, tmp_path / "ours", "q8_0")
    jconvert.convert_hf_model(f32, tmp_path / "theirs", "q8_0")
    _same_tree(tmp_path / "ours", tmp_path / "theirs")
    jconvert.convert_hf_model(bf, tmp_path / "theirs_bf16", "q8_0")
    _same_tree(tmp_path / "ours", tmp_path / "theirs_bf16")


def _eagle_hf(d, rng):
    H, Hkv, hd = 4, 2, DIM // 4

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    sd = {"fc.weight": w(DIM, 2 * DIM), "fc.bias": w(DIM),
          "layers.0.self_attn.q_proj.weight": w(H * hd, DIM),
          "layers.0.self_attn.k_proj.weight": w(Hkv * hd, DIM),
          "layers.0.self_attn.v_proj.weight": w(Hkv * hd, DIM),
          "layers.0.self_attn.o_proj.weight": w(DIM, H * hd),
          "layers.0.post_attention_layernorm.weight": 1 + w(DIM),
          "layers.0.mlp.gate_proj.weight": w(2 * DIM, DIM),
          "layers.0.mlp.up_proj.weight": w(2 * DIM, DIM),
          "layers.0.mlp.down_proj.weight": w(DIM, 2 * DIM)}
    return _write_hf(d, {
        "model_type": "eagle", "hidden_size": DIM,
        "intermediate_size": 2 * DIM, "num_hidden_layers": 1,
        "num_attention_heads": H, "num_key_value_heads": Hkv,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "vocab_size": 256}, sd)


def test_convert_eagle_writes_the_jax_bytes(tmp_path):
    hf = _eagle_hf(tmp_path / "hf", np.random.default_rng(5))
    convert_hf.main([str(hf), str(tmp_path / "ours"), "--quant", "q8_0"])
    jconvert.main([str(hf), str(tmp_path / "theirs"), "--quant", "q8_0"])
    _same_tree(tmp_path / "ours", tmp_path / "theirs")
    with GGUFReader(tmp_path / "ours" / "weights.gguf") as r:
        assert r.metadata["general.architecture"] == "eagle"


@pytest.mark.parametrize("layout", ["state_dict", "save_pretrained"])
def test_convert_internvl_writes_the_jax_bytes(tmp_path, layout):
    """An InternVL checkpoint in either of its two tensor layouts: the
    text tensors go to convert_hf_model in memory (the JAX tool
    round-trips them through a temporary safetensors file), the vision
    tower and projector to vision.gguf; the same bytes either way."""
    rng = np.random.default_rng(6)
    tc = _llama_cfg(architectures=["Qwen2ForCausalLM"], vocab_size=256,
                    model_type="qwen2")
    text = _llama_tensors(tc, rng, bias=True)
    vision = {n: (rng.standard_normal(shape) * 0.05).astype(np.float32)
              for n, shape in (
                  ("embeddings.patch_embeddings.projection.weight",
                   (32, 3, 14, 14)),
                  ("embeddings.cls_token", (1, 1, 32)),
                  ("encoder.layer.0.attention.q_proj.weight", (32, 32)),
                  ("encoder.layer.0.lambda_1", (32,)))}
    proj = {"linear_1.weight": (rng.standard_normal((64, 128)) * 0.05)
            .astype(np.float32)}
    if layout == "state_dict":
        sd = {"model.language_model." + k[len("model."):]: v
              for k, v in text.items() if k.startswith("model.")}
        sd["lm_head.weight"] = text["lm_head.weight"]
        sd.update({"model.vision_tower." + k: v for k, v in vision.items()})
        sd.update({"model.multi_modal_projector." + k: v
                   for k, v in proj.items()})
    else:
        sd = {"language_model.model." + k[len("model."):]: v
              for k, v in text.items() if k.startswith("model.")}
        sd["language_model.lm_head.weight"] = text["lm_head.weight"]
        sd.update({"vision_tower." + k: v for k, v in vision.items()})
        sd.update({"multi_modal_projector." + k: v for k, v in proj.items()})
    cfg = {"architectures": ["InternVLForConditionalGeneration"],
           "text_config": tc,
           "vision_config": {"num_hidden_layers": 1, "num_attention_heads": 2,
                             "patch_size": [14, 14], "image_size": [56, 56]},
           "downsample_ratio": 0.5, "image_token_id": 250,
           "image_seq_length": 4}
    hf = _write_hf(tmp_path / "hf", cfg, sd, shards=2, tokenizer=True)
    convert_hf.main([str(hf), str(tmp_path / "ours"), "--quant", "q8_0"])
    jconvert.main([str(hf), str(tmp_path / "theirs"), "--quant", "q8_0"])
    _same_tree(tmp_path / "ours", tmp_path / "theirs")
    with GGUFReader(tmp_path / "ours" / "model" / "vision.gguf") as r:
        assert len(r.tensors) == len(vision) + len(proj)
    assert (tmp_path / "ours" / "model" / "tokenizer.json").exists()


# -- workspace ---------------------------------------------------------------


def test_workspace_create_matches_jax(tmp_path):
    src = make_synthetic_gguf(tmp_path / "src", "tiny", GGMLType.Q8_0,
                              seq_len=32)
    hf, _ = _fixture("qwen2-bias", tmp_path / "hf")
    ours = create_workspace(tmp_path / "ours", src / "model", hf,
                            quant="q8_0")
    theirs = jcreate(tmp_path / "theirs", src / "model", hf, quant="q8_0")
    for f in ("workspace.json", "hparams.json"):
        assert (ours / f).read_bytes() == (theirs / f).read_bytes()
    # the GGUF dir is linked, the HF dir converted to the same bytes
    assert (ours / "model_main").is_symlink()
    assert (ours / "model_main").resolve() == (src / "model").resolve()
    _same_tree(ours / "model_draft", theirs / "model_draft")
    # and the copy flag copies
    copied = create_workspace(tmp_path / "copied", src / "model", copy=True)
    assert not (copied / "model_main").is_symlink()
    _same_tree(copied / "model_main", src / "model")
    shutil.rmtree(copied)


def test_workspace_cli_over_an_hf_dir_runs(tmp_path):
    from powerserve_tpu_torch import __main__ as cli
    from powerserve_tpu_torch import run

    hf, _ = _fixture("llama", tmp_path / "hf")
    out = tmp_path / "ws"
    assert cli.main(["workspace", "create", "-m", str(hf), "-o", str(out),
                     "--quant", "q8_0"]) == 0
    res = run.run_prompt(run.parse_args(
        ["-d", str(out), "-p", "the quick", "-n", "3", "--temperature", "0",
         "--device", "cpu", "--no-progress"]))
    assert len(res.ids) == 3
