"""Synthetic GGUF workspace generator — random-weight models at any
architecture size, for tests and benchmarks without model downloads.
(Counterpart of the reference's gguf_export pipeline P3, but generating
instead of converting.)"""

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
    **overrides,
) -> Path:
    """Write a workspace dir: weights.gguf + model.json + workspace.json."""
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


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="generate a synthetic workspace")
    ap.add_argument("out_dir")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--quant", default="q4_k",
                    choices=["q4_0", "q4_1", "q5_0", "q8_0", "q2_k", "q3_k",
                             "q4_k", "q5_k", "q6_k", "iq4_nl", "iq4_xs",
                             "f16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=2048)
    args = ap.parse_args()
    fmt = {"q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1,
           "q5_0": GGMLType.Q5_0, "q8_0": GGMLType.Q8_0,
           "q2_k": GGMLType.Q2_K, "q3_k": GGMLType.Q3_K,
           "q4_k": GGMLType.Q4_K, "q5_k": GGMLType.Q5_K,
           "q6_k": GGMLType.Q6_K, "iq4_nl": GGMLType.IQ4_NL,
           "iq4_xs": GGMLType.IQ4_XS, "f16": GGMLType.F16}[args.quant]
    out = make_synthetic_gguf(args.out_dir, args.preset, fmt, args.seed,
                              args.seq_len)
    print(f"workspace written to {out}")


if __name__ == "__main__":
    main()
