"""HF checkpoint -> powerserve workspace converter (the JAX package's
tools/convert_hf.py; the same bytes out).

Reads a HuggingFace model dir (config.json + *.safetensors, through the
port's own reader tools/safetensors.py, or pytorch_model*.bin through
torch.load), quantizes the weights to a GGUF-family format and writes a
ready-to-serve workspace:

  out/
    workspace.json  hparams.json
    model/
      weights.gguf   (tensors in llama.cpp naming, quantized)
      tokenizer.json tokenizer_config.json (copied if present)

Rope layout: HF weights are written UNPERMUTED with the metadata key
`powerserve.rope_type = 2` (NEOX); the loader honors it.

BF16 safetensors are widened to f32 and converted (every published
checkpoint is stored so); the JAX tool's reader, safetensors.numpy,
refuses them.

  python -m powerserve_tpu_torch convert <hf dir> <out dir> [--quant q4_k]
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ..core.gguf import GGMLType, GGUFWriter
from ..core.quant import quantize
from ..ops.elementwise import ROPE_TYPE_NEOX
from .safetensors import load_file

QUANTS = {"q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1,
          "q5_0": GGMLType.Q5_0, "q8_0": GGMLType.Q8_0,
          "q2_k": GGMLType.Q2_K, "q3_k": GGMLType.Q3_K,
          "q4_k": GGMLType.Q4_K, "q5_k": GGMLType.Q5_K,
          "q6_k": GGMLType.Q6_K, "iq4_nl": GGMLType.IQ4_NL,
          "iq4_xs": GGMLType.IQ4_XS,
          "f16": GGMLType.F16, "f32": GGMLType.F32}

# formats with 256-element superblocks (others use 32-element blocks)
_BLOCK256 = {GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
             GGMLType.Q6_K, GGMLType.IQ4_XS}

# HF name -> GGUF name (llama.cpp convention, reference llama_weight.hpp)
_GLOBAL_MAP = {
    "model.embed_tokens.weight": "token_embd.weight",
    "model.norm.weight": "output_norm.weight",
    "lm_head.weight": "output.weight",
}
_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm.weight",
    "post_attention_layernorm.weight": "ffn_norm.weight",
    "self_attn.q_proj.weight": "attn_q.weight",
    "self_attn.k_proj.weight": "attn_k.weight",
    "self_attn.v_proj.weight": "attn_v.weight",
    "self_attn.o_proj.weight": "attn_output.weight",
    "self_attn.q_proj.bias": "attn_q.bias",
    "self_attn.k_proj.bias": "attn_k.bias",
    "self_attn.v_proj.bias": "attn_v.bias",
    "self_attn.q_norm.weight": "attn_q_norm.weight",  # qwen3 QK-norm
    "self_attn.k_norm.weight": "attn_k_norm.weight",
    "mlp.gate_proj.weight": "ffn_gate.weight",
    "mlp.up_proj.weight": "ffn_up.weight",
    "mlp.down_proj.weight": "ffn_down.weight",
}


def _iter_hf_tensors(model_dir: Path, keep=None):
    """Yield (name, numpy array) from safetensors shards or torch bins
    (keep: only the names it takes)."""
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            for name, arr in load_file(str(f), keep).items():
                yield name, arr
        return
    bins = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
    import torch

    for f in bins:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        for name, t in sd.items():
            if keep is None or keep(name):
                yield name, t.float().numpy()


def _gguf_name(hf_name: str) -> str | None:
    if hf_name in _GLOBAL_MAP:
        return _GLOBAL_MAP[hf_name]
    if hf_name.startswith("model.layers."):
        rest = hf_name[len("model.layers."):]
        idx, _, tail = rest.partition(".")
        mapped = _LAYER_MAP.get(tail)
        if mapped:
            return f"blk.{idx}.{mapped}"
    return None


def convert_hf_model(model_dir: str | Path, out_dir: str | Path,
                     quant: str = "q4_k") -> Path:
    model_dir = Path(model_dir)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    return write_model(hf_cfg, _iter_hf_tensors(model_dir), model_dir,
                       out_dir, quant)


def write_model(hf_cfg: dict, tensors, tokenizer_dir: Path,
                out_dir: str | Path, quant: str = "q4_k") -> Path:
    """convert_hf_model on a parsed config.json and an iterable of (HF
    name, array): the weights.gguf, the tokenizer files of tokenizer_dir
    and the workspace's JSON files."""
    out_dir = Path(out_dir)
    target = out_dir / "model"
    target.mkdir(parents=True, exist_ok=True)
    w, n_written = model_gguf(hf_cfg, tensors, quant)
    w.write(target / "weights.gguf")

    for f in ("tokenizer.json", "tokenizer_config.json"):
        if (tokenizer_dir / f).exists():
            shutil.copy(tokenizer_dir / f, target / f)

    (out_dir / "workspace.json").write_text(json.dumps({
        "model_main": "model", "model_draft": "",
        "hparams_config": "hparams.json"}))
    (out_dir / "hparams.json").write_text(json.dumps({
        "batch_size": 128, "max_slots": 4,
        "sampler": {"temperature": 0.8, "top_k": 40, "top_p": 0.95}}))
    print(f"wrote {n_written} tensors -> {target / 'weights.gguf'}")
    return out_dir


def model_gguf(hf_cfg: dict, tensors, quant: str = "q4_k"
               ) -> tuple[GGUFWriter, int]:
    """The weights.gguf of a parsed config.json and an iterable of (HF
    name, array), in memory: (the writer, the tensors written)."""
    fmt = QUANTS[quant]

    arch_list = hf_cfg.get("architectures", ["LlamaForCausalLM"])
    arch = ("qwen3moe" if any("Qwen3Moe" in a for a in arch_list)
            else "qwen3" if any("Qwen3" in a for a in arch_list)
            else "qwen2" if any("Qwen2" in a for a in arch_list)
            else "llama")  # Mixtral stays arch "llama" (llama.cpp)
    dim = hf_cfg["hidden_size"]
    n_heads = hf_cfg["num_attention_heads"]
    n_kv = hf_cfg.get("num_key_value_heads", n_heads)
    # some configs carry an explicit null head_dim (e.g. Mixtral)
    head_dim = hf_cfg.get("head_dim") or dim // n_heads
    n_layers = hf_cfg["num_hidden_layers"]

    w = GGUFWriter()
    md = w.metadata
    md["general.architecture"] = arch
    md[f"{arch}.embedding_length"] = dim
    md[f"{arch}.feed_forward_length"] = hf_cfg["intermediate_size"]
    md[f"{arch}.block_count"] = n_layers
    md[f"{arch}.attention.head_count"] = n_heads
    md[f"{arch}.attention.head_count_kv"] = n_kv
    md[f"{arch}.context_length"] = hf_cfg.get("max_position_embeddings", 4096)
    md[f"{arch}.rope.dimension_count"] = head_dim
    md[f"{arch}.attention.key_length"] = head_dim  # qwen3: != dim/heads
    md[f"{arch}.rope.freq_base"] = float(hf_cfg.get("rope_theta", 10000.0))
    # rope scaling -> llama.cpp-standard rope.scaling.* keys (the
    # reference carries these into ggml's YaRN rope, config.hpp:88-97;
    # Llama-3.1 checkpoints need llama3 scaling for positions past the
    # original context window)
    rs = hf_cfg.get("rope_scaling") or {}
    rs_type = rs.get("rope_type", rs.get("type", "none")) or "none"
    if rs_type not in ("none", "default"):
        md[f"{arch}.rope.scaling.type"] = rs_type
        md[f"{arch}.rope.scaling.factor"] = float(rs.get("factor", 1.0))
        md[f"{arch}.rope.scaling.original_context_length"] = int(
            rs.get("original_max_position_embeddings",
                   hf_cfg.get("max_position_embeddings", 4096)))
        if rs_type == "llama3":
            md[f"{arch}.rope.scaling.low_freq_factor"] = float(
                rs.get("low_freq_factor", 1.0))
            md[f"{arch}.rope.scaling.high_freq_factor"] = float(
                rs.get("high_freq_factor", 4.0))
        if rs_type == "yarn":
            if "attention_factor" in rs and rs["attention_factor"]:
                md[f"{arch}.rope.scaling.attn_factor"] = float(
                    rs["attention_factor"])
            md[f"{arch}.rope.scaling.beta_fast"] = float(
                rs.get("beta_fast", 32.0))
            md[f"{arch}.rope.scaling.beta_slow"] = float(
                rs.get("beta_slow", 1.0))
    md[f"{arch}.attention.layer_norm_rms_epsilon"] = float(
        hf_cfg.get("rms_norm_eps", 1e-5))
    md[f"{arch}.vocab_size"] = hf_cfg["vocab_size"]
    md["powerserve.rope_type"] = ROPE_TYPE_NEOX  # unpermuted HF layout
    n_experts = int(hf_cfg.get("num_local_experts",
                               hf_cfg.get("num_experts", 0)) or 0)
    if n_experts:
        md[f"{arch}.expert_count"] = n_experts
        md[f"{arch}.expert_used_count"] = int(
            hf_cfg.get("num_experts_per_tok", 2))
        md[f"{arch}.expert_feed_forward_length"] = int(
            hf_cfg.get("moe_intermediate_size",
                       hf_cfg.get("intermediate_size")))

    tied = bool(hf_cfg.get("tie_word_embeddings", False))
    n_written = 0
    # MoE expert tensors buffer per (layer, kind) until all E arrive,
    # then flush as ONE 3-D gguf tensor [*shape, E] (ggml convention)
    import re as _re

    exp_re = _re.compile(
        r"model\.layers\.(\d+)\.(?:block_sparse_moe|mlp)\.experts\."
        r"(\d+)\.(w1|w2|w3|gate_proj|up_proj|down_proj)\.weight")
    kind_map = {"w1": "ffn_gate_exps", "w3": "ffn_up_exps",
                "w2": "ffn_down_exps", "gate_proj": "ffn_gate_exps",
                "up_proj": "ffn_up_exps", "down_proj": "ffn_down_exps"}
    exp_buf: dict = {}

    def flush_experts(layer, kind):
        parts = exp_buf.pop((layer, kind))
        shape = parts[0].shape
        use = fmt
        block = 256 if fmt in _BLOCK256 else 32
        if shape[-1] % block != 0:
            use = GGMLType.F16
        payloads = [quantize(parts[j], use) for j in range(len(parts))]
        w.add_tensor(f"blk.{layer}.{kind}.weight",
                     tuple(reversed(shape)) + (len(parts),), use,
                     np.concatenate(payloads).tobytes())

    for hf_name, arr in tensors:
        m = exp_re.fullmatch(hf_name)
        if m is not None:
            layer, j, kind = int(m.group(1)), int(m.group(2)), \
                kind_map[m.group(3)]
            buf = exp_buf.setdefault((layer, kind), {})
            buf[j] = np.asarray(arr, np.float32)
            if len(buf) == n_experts:
                exp_buf[(layer, kind)] = [buf[j] for j in range(n_experts)]
                flush_experts(layer, kind)
                n_written += 1
            continue
        if hf_name.endswith((".block_sparse_moe.gate.weight",
                             ".mlp.gate.weight")) \
                and hf_name.startswith("model.layers."):
            layer = hf_name.split(".")[2]
            w.add_float_tensor(f"blk.{layer}.ffn_gate_inp.weight",
                               np.asarray(arr, np.float32))
            n_written += 1
            continue
        name = _gguf_name(hf_name)
        if name is None:
            continue
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 1 or name.endswith(".bias"):
            w.add_float_tensor(name, arr)
        else:
            use = fmt
            block = 256 if fmt in _BLOCK256 else 32
            if arr.shape[-1] % block != 0:
                use = GGMLType.F16
            w.add_tensor(name, tuple(reversed(arr.shape)), use,
                         quantize(arr, use))
        n_written += 1
    if tied:
        pass  # loader falls back to token_embd for lm_head
    assert not exp_buf, f"incomplete expert groups: {list(exp_buf)}"
    return w, n_written


def convert_eagle(model_dir: str | Path, out_dir: str | Path,
                  quant: str = "q8_0") -> Path:
    """Convert an EAGLE draft-head checkpoint (official layout:
    fc.weight [dim, 2*dim] + layers.N.* decoder blocks, e.g.
    yuhuili/EAGLE-LLaMA3-8B) to a weights.gguf with
    general.architecture = "eagle". The head shares the target's
    embedding / lm_head unless the checkpoint carries its own
    (embed_tokens / lm_head keys). Load with
    models.loader.load_eagle_gguf against the target params."""
    model_dir = Path(model_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fmt = QUANTS[quant]

    hf_cfg = json.loads((model_dir / "config.json").read_text())
    dim = hf_cfg["hidden_size"]
    n_heads = hf_cfg["num_attention_heads"]
    n_kv = hf_cfg.get("num_key_value_heads", n_heads)
    head_dim = hf_cfg.get("head_dim", dim // n_heads)
    n_layers = hf_cfg.get("num_hidden_layers", 1)

    w = GGUFWriter()
    md = w.metadata
    md["general.architecture"] = "eagle"
    md["eagle.embedding_length"] = dim
    md["eagle.feed_forward_length"] = hf_cfg["intermediate_size"]
    md["eagle.block_count"] = n_layers
    md["eagle.attention.head_count"] = n_heads
    md["eagle.attention.head_count_kv"] = n_kv
    md["eagle.rope.dimension_count"] = head_dim
    md["eagle.rope.freq_base"] = float(hf_cfg.get("rope_theta", 10000.0))
    md["eagle.attention.layer_norm_rms_epsilon"] = float(
        hf_cfg.get("rms_norm_eps", 1e-5))
    md["eagle.vocab_size"] = hf_cfg.get("vocab_size", 0)
    md["powerserve.rope_type"] = ROPE_TYPE_NEOX

    def head_name(hf_name: str) -> str | None:
        if hf_name in ("fc.weight", "fc.bias"):
            return hf_name
        # checkpoints use bare "layers.N." (no "model." prefix) and may
        # or may not carry embedding / norm / head tensors
        if hf_name in ("embed_tokens.weight", "model.embed_tokens.weight"):
            return "token_embd.weight"
        if hf_name in ("norm.weight", "model.norm.weight"):
            return "output_norm.weight"
        if hf_name in ("lm_head.weight", "head.weight"):
            return "output.weight"
        for pre in ("layers.", "model.layers."):
            if hf_name.startswith(pre):
                idx, _, tail = hf_name[len(pre):].partition(".")
                mapped = _LAYER_MAP.get(tail)
                if mapped:
                    return f"blk.{idx}.{mapped}"
        return None

    n_written = 0
    for hf_name, arr in _iter_hf_tensors(model_dir):
        name = head_name(hf_name)
        if name is None:
            continue
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 1 or name.endswith(".bias"):
            w.add_float_tensor(name, arr)
        else:
            use = fmt
            block = 256 if fmt in _BLOCK256 else 32
            if arr.shape[-1] % block != 0:
                use = GGMLType.F16
            w.add_tensor(name, tuple(reversed(arr.shape)), use,
                         quantize(arr, use))
        n_written += 1
    w.write(out_dir / "weights.gguf")
    print(f"wrote {n_written} tensors -> {out_dir / 'weights.gguf'}")
    return out_dir


_TEXT_PREFIXES = ("model.language_model.", "language_model.",
                  "lm_head.weight")


def read_internvl(model_dir: str | Path, text: bool = True
                  ) -> tuple[dict, dict, dict, dict]:
    """An InternVL checkpoint dir's parts: (the text model's flat
    config.json, its tensors by HF llama/qwen2 name (none unless text),
    the vision tower's and projector's tensors by HF name, the vlm.*
    metadata). Every tensor f32."""
    model_dir = Path(model_dir)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    tc = hf_cfg["text_config"]
    vc = hf_cfg["vision_config"]
    flat = dict(tc)
    flat["architectures"] = tc.get("architectures", ["Qwen2ForCausalLM"
                                   if "qwen2" in str(tc.get("model_type", ""))
                                   else "LlamaForCausalLM"])
    tsd = {}
    vsd = {}
    # two checkpoint layouts exist: "model.language_model.X" /
    # "model.vision_tower.X" (state_dict) and
    # "language_model.model.X" / "vision_tower.X" (save_pretrained)
    keep = None if text else (lambda n: not n.startswith(_TEXT_PREFIXES))
    for name, arr in _iter_hf_tensors(model_dir, keep):
        if name.startswith("model.language_model."):
            tsd["model." + name[len("model.language_model."):]] = \
                np.asarray(arr, np.float32)
        elif name.startswith("language_model.model."):
            tsd["model." + name[len("language_model.model."):]] = \
                np.asarray(arr, np.float32)
        elif name in ("lm_head.weight", "language_model.lm_head.weight"):
            tsd["lm_head.weight"] = np.asarray(arr, np.float32)
        elif name.startswith(("model.vision_tower.",
                              "model.multi_modal_projector.")):
            vsd[name] = np.asarray(arr, np.float32)
        elif name.startswith(("vision_tower.",
                              "multi_modal_projector.")):
            vsd["model." + name] = np.asarray(arr, np.float32)
    md = {"vlm.block_count": int(vc["num_hidden_layers"]),
          "vlm.attention.head_count": int(vc["num_attention_heads"])}
    patch = vc["patch_size"]
    md["vlm.patch_size"] = int(patch[0] if isinstance(patch, list) else patch)
    img = vc["image_size"]
    md["vlm.image_size"] = int(img[0] if isinstance(img, list) else img)
    md["vlm.layer_norm_epsilon"] = float(vc.get("layer_norm_eps", 1e-6))
    md["vlm.downsample_ratio"] = float(hf_cfg.get("downsample_ratio", 0.5))
    md["vlm.image_token_id"] = int(hf_cfg["image_token_id"])
    md["vlm.image_seq_length"] = int(hf_cfg["image_seq_length"])
    return flat, tsd, vsd, md


def convert_internvl(model_dir: str | Path, out_dir: str | Path,
                     quant: str = "q4_k") -> Path:
    """InternVL VLM checkpoint -> workspace with BOTH weight files:
    text weights quantized into weights.gguf (llama.cpp naming) and the
    vision tower + projector into vision.gguf (HF tensor names, F32,
    plus vlm.* metadata) — the reference ships its VLM as NPU context
    binaries; here the whole VLM lives in the GGUF workspace and loads
    via models/internvl.py:internvl_from_workspace."""
    model_dir = Path(model_dir)
    out_dir = Path(out_dir)
    flat, tsd, vsd, vlm_md = read_internvl(model_dir)
    # the text tensors in the order the JAX tool reads them back from
    # the f32 safetensors file it writes them to: by name
    write_model(flat, sorted(tsd.items()), model_dir, out_dir, quant)

    # --- vision tower + projector --------------------------------------
    target = out_dir / "model"
    w = GGUFWriter()
    md = w.metadata
    md["general.architecture"] = "internvl-vision"
    md.update(vlm_md)
    for name, arr in vsd.items():
        w.add_float_tensor(name, np.asarray(arr, np.float32))
    w.write(target / "vision.gguf")
    print(f"wrote {len(vsd)} vision tensors -> {target / 'vision.gguf'}")
    return out_dir


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch convert")
    ap.add_argument("model_dir", help="HF model dir")
    ap.add_argument("out_dir", help="workspace output dir")
    ap.add_argument("--quant", default="q4_k", choices=sorted(QUANTS))
    args = ap.parse_args(argv)
    cfg = json.loads((Path(args.model_dir) / "config.json").read_text())
    archs = cfg.get("architectures", [])
    if any("InternVL" in a for a in archs):
        convert_internvl(args.model_dir, args.out_dir, args.quant)
    elif (any("Eagle" in a for a in archs)
          or cfg.get("model_type") == "eagle"
          or cfg.get("draft_architecture") == "eagle"):
        convert_eagle(args.model_dir, args.out_dir, args.quant)
    else:
        convert_hf_model(args.model_dir, args.out_dir, args.quant)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
