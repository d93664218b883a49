"""Synthetic GGUF workspace generator — random-weight models at any
architecture size, for tests and benchmarks without model downloads.
(Counterpart of the reference's gguf_export pipeline P3, but generating
instead of converting.) make_eagle_gguf writes a random EAGLE draft head
at a preset's widths (`--eagle-head`); make_vision_gguf a random InternVL
vision tower and projector (vision.gguf) beside a text model, and
make_vlm_workspace both (`--vlm PRESET`)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.config import ModelConfig
from ..core.gguf import GGMLType, GGUFWriter
from ..core.quant import quantize

# well-known shapes for headline models (README benchmark table)
PRESETS = {
    "qwen2-0.5b": dict(dim=896, ffn=4864, layers=24, heads=14, kv_heads=2,
                       vocab=151936, arch="qwen2", bias=True),
    "llama-1b": dict(dim=2048, ffn=8192, layers=16, heads=32, kv_heads=8,
                     vocab=128256, arch="llama", bias=False),
    "qwen2.5-3b": dict(dim=2048, ffn=11008, layers=36, heads=16, kv_heads=2,
                       vocab=151936, arch="qwen2", bias=True),
    "llama-8b": dict(dim=4096, ffn=14336, layers=32, heads=32, kv_heads=8,
                     vocab=128256, arch="llama", bias=False),
    "tiny": dict(dim=64, ffn=128, layers=2, heads=4, kv_heads=2,
                 vocab=256, arch="llama", bias=False),
    # 256-divisible dims: smallest preset valid for K-quant superblocks
    # (q4_k/q5_k/q6_k need K % 256 == 0)
    "tiny-k": dict(dim=256, ffn=512, layers=2, heads=4, kv_heads=2,
                   vocab=512, arch="llama", bias=False),
    # mixture-of-experts (mixtral-as-llama layout: router + _exps)
    "tiny-moe": dict(dim=64, ffn=96, layers=2, heads=4, kv_heads=2,
                     vocab=256, arch="llama", bias=False, experts=4,
                     experts_used=2),
    # bench-scale MoE that fits one v5e chip at q4 (~6.3GB experts):
    # 11.3B expert params, 2-of-8 routed (the dense-all-experts scan
    # reads every expert per step — the grouped-dispatch kernel gap
    # shows up as decode tok/s here)
    "mixtral-lite": dict(dim=4096, ffn=3584, layers=32, heads=32,
                         kv_heads=8, vocab=32000, arch="llama",
                         bias=False, experts=8, experts_used=2),
    # qwen3moe-shaped wide-expert preset (E=128, top-8, tiny expert
    # ffn): the decode-batch grouped-dispatch case — S=8 x k=8 routes
    # at most 64 of 128 experts, so exact grouped dispatch reads
    # ~half the expert slabs dense-all-experts streams (4 layers keeps
    # bench compile time sane; the per-layer marginal cost is what
    # the A/B measures)
    "qwen3moe-lite": dict(dim=2048, ffn=768, layers=4, heads=16,
                          kv_heads=4, vocab=32000, arch="llama",
                          bias=False, experts=128, experts_used=8),
}


# InternVL vision towers (patch 14, pixel shuffle 0.5, q/k/v biases, layer
# scale): InternViT-300M-448px's widths, and the JAX tests' tiny tower
VISION_PRESETS = {
    "internvit-300m": dict(dim=1024, ffn=4096, layers=24, heads=16,
                           patch=14, image=448, eps=1e-6, downsample=0.5),
    "tiny-vit": dict(dim=64, ffn=128, layers=2, heads=4, patch=14, image=56,
                     eps=1e-6, downsample=0.5),
}
# vision-language models: (text preset, vision preset, image-context id)
VLM_PRESETS = {
    "internvl2.5-4b": ("qwen2.5-3b", "internvit-300m", 151667),
    "tiny-vlm": ("tiny", "tiny-vit", 250),
}


def _simple_vocab(n: int) -> tuple[list[str], list[float], list[int]]:
    """byte-fallback SPM-ish vocab: specials + 256 bytes + filler."""
    tokens = ["<unk>", "<s>", "</s>"]
    types = [2, 3, 3]
    tokens += [f"<0x{b:02X}>" for b in range(256)]
    types += [6] * 256
    i = 0
    while len(tokens) < n:
        tokens.append(f"tok{i}")
        types.append(1)
        i += 1
    scores = [0.0] * len(tokens)
    return tokens[:n], scores[:n], types[:n]


def make_synthetic_gguf(
    out_dir: str | Path,
    preset: str = "tiny",
    quant: int = GGMLType.Q4_K,
    seed: int = 0,
    seq_len: int = 2048,
    chat_template: str = "",
    special: dict[int, str] | None = None,
    **overrides,
) -> Path:
    """Write a workspace dir: weights.gguf + model.json + workspace.json.
    chat_template: the tokenizer's template (default none: chatml);
    special: token ids to make control tokens of the given text."""
    p = dict(PRESETS[preset])
    p.update(overrides)
    dim, ffn, L = p["dim"], p["ffn"], p["layers"]
    H, Hkv, V = p["heads"], p["kv_heads"], p["vocab"]
    hd = dim // H
    arch = p["arch"]
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    model_dir = out_dir / "model"
    model_dir.mkdir(parents=True, exist_ok=True)

    w = GGUFWriter()
    md = w.metadata
    md["general.architecture"] = arch
    md[f"{arch}.embedding_length"] = dim
    md[f"{arch}.feed_forward_length"] = ffn
    md[f"{arch}.block_count"] = L
    md[f"{arch}.attention.head_count"] = H
    md[f"{arch}.attention.head_count_kv"] = Hkv
    md[f"{arch}.context_length"] = seq_len
    md[f"{arch}.rope.dimension_count"] = hd
    md[f"{arch}.rope.freq_base"] = 500000.0 if "llama" in preset else 10000.0
    md[f"{arch}.attention.layer_norm_rms_epsilon"] = 1e-5
    md[f"{arch}.vocab_size"] = V
    E = int(p.get("experts", 0))
    if E:
        md[f"{arch}.expert_count"] = E
        md[f"{arch}.expert_used_count"] = int(p.get("experts_used", 2))
    toks, scores, types = _simple_vocab(V)
    for i, text in (special or {}).items():
        toks[i], types[i] = text, 3
    if chat_template:
        md["tokenizer.chat_template"] = chat_template
    md["tokenizer.ggml.model"] = "llama"
    md["tokenizer.ggml.tokens"] = toks
    md["tokenizer.ggml.scores"] = scores
    md["tokenizer.ggml.token_type"] = types
    md["tokenizer.ggml.bos_token_id"] = 1
    md["tokenizer.ggml.eos_token_id"] = 2
    md["tokenizer.ggml.unknown_token_id"] = 0

    def add(name, shape_out_in, fmt=quant, scale=0.02):
        arr = (rng.standard_normal(shape_out_in, dtype=np.float32) * scale)
        # quant formats need the inner dim to be block-aligned
        block = 256 if fmt in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
                               GGMLType.Q5_K, GGMLType.Q6_K,
                               GGMLType.IQ4_XS) else 32
        f = fmt if shape_out_in[1] % block == 0 else GGMLType.F16
        w.add_tensor(name, tuple(reversed(shape_out_in)), f, quantize(arr, f))

    def add_norm(name):
        w.add_float_tensor(name, np.ones(dim, np.float32))

    add("token_embd.weight", (V, dim))
    for i in range(L):
        pre = f"blk.{i}."
        add_norm(pre + "attn_norm.weight")
        add_norm(pre + "ffn_norm.weight")
        add(pre + "attn_q.weight", (H * hd, dim))
        add(pre + "attn_k.weight", (Hkv * hd, dim))
        add(pre + "attn_v.weight", (Hkv * hd, dim))
        add(pre + "attn_output.weight", (dim, H * hd))
        if p.get("bias"):
            for nm, n_out in (("attn_q.bias", H * hd), ("attn_k.bias", Hkv * hd),
                              ("attn_v.bias", Hkv * hd)):
                w.add_float_tensor(pre + nm,
                                   rng.standard_normal(n_out).astype(np.float32) * 0.01)
        if E:
            w.add_float_tensor(
                pre + "ffn_gate_inp.weight",
                rng.standard_normal((E, dim)).astype(np.float32) * 0.05)

            def add_exps(name, shape_out_in):
                block = 256 if quant in (
                    GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
                    GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.IQ4_XS) else 32
                f = quant if shape_out_in[1] % block == 0 else GGMLType.F16
                payloads = [quantize(
                    rng.standard_normal(shape_out_in,
                                        dtype=np.float32) * 0.02, f)
                    for _ in range(E)]
                w.add_tensor(name,
                             tuple(reversed(shape_out_in)) + (E,), f,
                             np.concatenate(payloads).tobytes())

            add_exps(pre + "ffn_gate_exps.weight", (ffn, dim))
            add_exps(pre + "ffn_up_exps.weight", (ffn, dim))
            add_exps(pre + "ffn_down_exps.weight", (dim, ffn))
        else:
            add(pre + "ffn_gate.weight", (ffn, dim))
            add(pre + "ffn_up.weight", (ffn, dim))
            add(pre + "ffn_down.weight", (dim, ffn))
    add_norm("output_norm.weight")
    add("output.weight", (V, dim))
    w.write(model_dir / "weights.gguf")

    (out_dir / "workspace.json").write_text(json.dumps({
        "model_main": "model", "model_draft": "",
        "hparams_config": "hparams.json",
    }))
    (out_dir / "hparams.json").write_text(json.dumps({
        "batch_size": 128, "max_slots": 4,
        "sampler": {"temperature": 0.0, "top_k": 40, "top_p": 0.95},
    }))
    return out_dir


def make_eagle_gguf(out_dir: str | Path, preset: str = "tiny",
                    quant: int = GGMLType.Q8_0, seed: int = 0,
                    scale: float = 0.05, fc_bias: bool = True,
                    input_norm: bool = False) -> Path:
    """Write a random EAGLE head (weights.gguf in out_dir) at a preset's
    widths, in the layout of an official EAGLE-1 head converted to GGUF:
    fc [2 * dim -> dim] (+ bias), one decoder layer, no attn_norm on
    layer 0 unless input_norm, no final norm, and the target's embedding
    and lm_head (no token_embd / output tensors)."""
    p = PRESETS[preset]
    dim, ffn, H, Hkv = p["dim"], p["ffn"], p["heads"], p["kv_heads"]
    hd = dim // H
    rng = np.random.default_rng(seed)
    w = GGUFWriter()
    md = w.metadata
    md["general.architecture"] = "eagle"
    md["eagle.embedding_length"] = dim
    md["eagle.feed_forward_length"] = ffn
    md["eagle.block_count"] = 1
    md["eagle.attention.head_count"] = H
    md["eagle.attention.head_count_kv"] = Hkv
    md["eagle.rope.dimension_count"] = hd
    md["eagle.rope.freq_base"] = (500000.0 if "llama" in preset
                                  else 10000.0)
    md["eagle.attention.layer_norm_rms_epsilon"] = 1e-5

    def add(name, shape_out_in):
        arr = rng.standard_normal(shape_out_in, dtype=np.float32) * scale
        w.add_tensor(name, tuple(reversed(shape_out_in)), quant,
                     quantize(arr, quant))

    add("fc.weight", (dim, 2 * dim))
    if fc_bias:
        w.add_float_tensor(
            "fc.bias", rng.standard_normal(dim, dtype=np.float32) * 0.01)
    if input_norm:
        w.add_float_tensor("blk.0.attn_norm.weight",
                           np.ones(dim, np.float32))
    add("blk.0.attn_q.weight", (H * hd, dim))
    add("blk.0.attn_k.weight", (Hkv * hd, dim))
    add("blk.0.attn_v.weight", (Hkv * hd, dim))
    add("blk.0.attn_output.weight", (dim, H * hd))
    add("blk.0.ffn_gate.weight", (ffn, dim))
    add("blk.0.ffn_up.weight", (ffn, dim))
    add("blk.0.ffn_down.weight", (dim, ffn))
    w.add_float_tensor("blk.0.ffn_norm.weight", np.ones(dim, np.float32))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    w.write(out_dir / "weights.gguf")
    return out_dir


def tokens_per_tile(preset: str) -> int:
    """Image-context ids per tile of a vision preset."""
    v = VISION_PRESETS[preset]
    return int((v["image"] // v["patch"]) ** 2 * v["downsample"] ** 2)


def random_vision_state(preset: str, text_dim: int,
                        seed: int = 0) -> dict[str, np.ndarray]:
    """A random HF-layout state dict (model.vision_tower.* and
    model.multi_modal_projector.*, f32, [out, in] weights) at a vision
    preset's widths, its projector into text_dim."""
    v = VISION_PRESETS[preset]
    D, Fw, p = v["dim"], v["ffn"], v["patch"]
    n_pos = (v["image"] // p) ** 2 + 1
    D4 = int(D / v["downsample"] ** 2)
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * scale

    pre = "model.vision_tower."
    sd = {pre + "embeddings.patch_embeddings.projection.weight":
          rand(D, 3, p, p),
          pre + "embeddings.patch_embeddings.projection.bias": rand(D),
          pre + "embeddings.cls_token": rand(1, 1, D),
          pre + "embeddings.position_embeddings": rand(1, n_pos, D)}
    for i in range(v["layers"]):
        lp = pre + f"encoder.layer.{i}."
        for n in "qkv":
            sd[lp + f"attention.{n}_proj.weight"] = rand(D, D)
            sd[lp + f"attention.{n}_proj.bias"] = rand(D, scale=0.01)
        sd[lp + "attention.projection_layer.weight"] = rand(D, D)
        sd[lp + "attention.projection_layer.bias"] = rand(D, scale=0.01)
        sd[lp + "mlp.fc1.weight"] = rand(Fw, D)
        sd[lp + "mlp.fc1.bias"] = rand(Fw, scale=0.01)
        sd[lp + "mlp.fc2.weight"] = rand(D, Fw)
        sd[lp + "mlp.fc2.bias"] = rand(D, scale=0.01)
        for n in ("layernorm_before", "layernorm_after"):
            sd[lp + f"{n}.weight"] = 1.0 + rand(D, scale=0.1)
            sd[lp + f"{n}.bias"] = rand(D, scale=0.1)
        sd[lp + "lambda_1"] = 0.1 + rand(D, scale=0.01)
        sd[lp + "lambda_2"] = 0.1 + rand(D, scale=0.01)
    pp = "model.multi_modal_projector."
    sd.update({pp + "layer_norm.weight": 1.0 + rand(D4, scale=0.1),
               pp + "layer_norm.bias": rand(D4, scale=0.1),
               pp + "linear_1.weight": rand(text_dim, D4),
               pp + "linear_1.bias": rand(text_dim, scale=0.01),
               pp + "linear_2.weight": rand(text_dim, text_dim),
               pp + "linear_2.bias": rand(text_dim, scale=0.01)})
    return sd


def make_vision_gguf(model_dir: str | Path, preset: str = "tiny-vit",
                     text_dim: int = 64, image_token_id: int = 250,
                     seed: int = 0) -> Path:
    """Write model_dir/vision.gguf: a random vision tower and projector at
    a vision preset's widths, with the tensor names and vlm.* metadata
    of the JAX package's tools/convert_hf.py convert_internvl (f32)."""
    v = VISION_PRESETS[preset]
    w = GGUFWriter()
    md = w.metadata
    md["general.architecture"] = "internvl-vision"
    md["vlm.block_count"] = int(v["layers"])
    md["vlm.attention.head_count"] = int(v["heads"])
    md["vlm.patch_size"] = int(v["patch"])
    md["vlm.image_size"] = int(v["image"])
    md["vlm.layer_norm_epsilon"] = float(v["eps"])
    md["vlm.downsample_ratio"] = float(v["downsample"])
    md["vlm.image_token_id"] = int(image_token_id)
    md["vlm.image_seq_length"] = tokens_per_tile(preset)
    for name, arr in random_vision_state(preset, text_dim, seed).items():
        w.add_float_tensor(name, arr)
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    w.write(model_dir / "vision.gguf")
    return model_dir / "vision.gguf"


def make_vlm_workspace(out_dir: str | Path, preset: str = "tiny-vlm",
                       quant: int = GGMLType.Q8_0, seed: int = 0,
                       seq_len: int = 2048, chat_template: str = "") -> Path:
    """A workspace whose model dir holds a random text model
    (weights.gguf, the image-context id a control token "<IMG_CONTEXT>")
    and vision.gguf."""
    text, vision, image_id = VLM_PRESETS[preset]
    make_synthetic_gguf(out_dir, text, quant, seed, seq_len,
                        chat_template=chat_template,
                        special={image_id: "<IMG_CONTEXT>"})
    make_vision_gguf(Path(out_dir) / "model", vision, PRESETS[text]["dim"],
                     image_id, seed + 1)
    return Path(out_dir)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch synthetic",
                                 description="generate a synthetic workspace")
    ap.add_argument("out_dir")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--quant", default="q4_k",
                    choices=["q4_0", "q4_1", "q5_0", "q8_0", "q2_k", "q3_k",
                             "q4_k", "q5_k", "q6_k", "iq4_nl", "iq4_xs",
                             "f16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--eagle-head", action="store_true",
                    help="write a random EAGLE draft head (weights.gguf) "
                         "at the preset's widths instead of a workspace")
    ap.add_argument("--vlm", default="", choices=[""] + sorted(VLM_PRESETS),
                    help="write a vision-language workspace (text model "
                         "and vision.gguf) of this preset instead")
    args = ap.parse_args(argv)
    fmt = {"q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1,
           "q5_0": GGMLType.Q5_0, "q8_0": GGMLType.Q8_0,
           "q2_k": GGMLType.Q2_K, "q3_k": GGMLType.Q3_K,
           "q4_k": GGMLType.Q4_K, "q5_k": GGMLType.Q5_K,
           "q6_k": GGMLType.Q6_K, "iq4_nl": GGMLType.IQ4_NL,
           "iq4_xs": GGMLType.IQ4_XS, "f16": GGMLType.F16}[args.quant]
    if args.vlm:
        out = make_vlm_workspace(args.out_dir, args.vlm, fmt, args.seed,
                                 args.seq_len)
        print(f"vision-language workspace written to {out}")
        return 0
    if args.eagle_head:
        out = make_eagle_gguf(args.out_dir, args.preset, fmt, args.seed)
        print(f"eagle head written to {out}")
        return 0
    out = make_synthetic_gguf(args.out_dir, args.preset, fmt, args.seed,
                              args.seq_len)
    print(f"workspace written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
