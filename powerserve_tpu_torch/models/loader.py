"""Model loading: GGUF workspaces -> LlamaModel on a device, and the
carry-over of parameters that were loaded elsewhere as numpy arrays.

Tensor names follow the GGUF/llama.cpp convention (token_embd.weight,
blk.{i}.attn_q.weight, ...); an EAGLE draft head's GGUF
(general.architecture "eagle") loads against its target model
(load_eagle_gguf). Every GGUF type other than Q4_0, Q4_K and
Q8_0 is requantized to Q8_0 at load (core/quant.py:repack_gguf_tensor).
Q4_0, Q4_K, Q8_0 and Q6_K projections are repacked by the native
runtime (core/native.py: multithreaded C++, bit-equal to
repack_gguf_tensor and pack_nib4), as the JAX package's loader does;
the other types, 4-bit weights the port keeps unpacked (K % 128 != 0)
and W8 requantization take core/quant.py.
MoE layers (Mixtral-as-llama, Qwen3-MoE) carry ffn_gate_inp (the router)
and 3-D ffn_{gate,up,down}_exps tensors, loaded as expert stacks.

RoPE layout: llama.cpp's HF->GGUF converter permutes Wq/Wk so that
adjacent-pair rotation (NORM) matches HF's half rotation; qwen2-family
weights are not permuted and use NEOX. A file may override the choice
with powerserve.rope_type.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.config import LLMConfig, ModelConfig, RopeConfig
from ..core.device import resolve_device
from ..core.gguf import GGMLType, GGUFReader
from ..core.logging import get_logger
from ..core.native import native_repack
from ..core.quant import repack_gguf_tensor
from ..ops.elementwise import ROPE_TYPE_NEOX, ROPE_TYPE_NORM
from ..ops.qmatmul import QLinear
from .llama import LlamaLayer, LlamaModel, QEmbedding

log = get_logger("loader")

# llama-family architectures sharing the same forward
LLAMA_FAMILY = {"llama", "qwen2", "qwen3", "qwen2moe", "qwen3moe",
                "internlm2", "internlm3", "smallthinker", "internvl"}

# load_gguf_model's formats as run/serve name them: the file's own, or
# W8 (mxu=True)
WEIGHT_FORMATS = ("gguf", "w8")

_QLINEAR_META = ("packed", "unsigned", "in_features", "out_features",
                 "pack_group", "scale_group")


def config_from_gguf_metadata(md: dict[str, Any]) -> ModelConfig:
    """GGUF metadata -> ModelConfig (the reference's gguf_config_to_json)."""
    arch = md.get("general.architecture", "llama")
    if arch not in LLAMA_FAMILY:
        raise ValueError(f"unsupported architecture '{arch}' "
                         f"(supported: {sorted(LLAMA_FAMILY)})")

    def key(suffix: str, default=None):
        return md.get(f"{arch}.{suffix}", default)

    dim = int(key("embedding_length", 2048))
    n_heads = int(key("attention.head_count", 32))
    n_kv = int(key("attention.head_count_kv", n_heads))
    head_size = int(key("attention.key_length", dim // n_heads))
    rope_dims = int(key("rope.dimension_count", head_size))
    vocab = md.get("tokenizer.ggml.tokens")
    vocab_size = int(key("vocab_size",
                         len(vocab) if vocab is not None else 32000))
    default_rope = (ROPE_TYPE_NEOX
                    if arch in ("qwen2", "qwen3", "qwen2moe", "qwen3moe",
                                "internvl", "internlm2", "internlm3")
                    else ROPE_TYPE_NORM)
    scaling_type = str(key("rope.scaling.type", "none") or "none")
    if scaling_type not in ("none", "linear", "yarn", "llama3"):
        raise ValueError(f"unsupported rope scaling type '{scaling_type}'")
    scaling_factor = float(key("rope.scaling.factor", 1.0) or 1.0)
    n_ctx_orig = int(key("rope.scaling.original_context_length",
                         key("context_length", 2048)))
    freq_scale = 1.0 / float(key("rope.scale_linear", 1.0) or 1.0)
    ext_factor = 0.0
    if scaling_type == "linear" and scaling_factor != 0:
        freq_scale = 1.0 / scaling_factor
    elif scaling_type == "yarn" and scaling_factor != 0:
        freq_scale = 1.0 / scaling_factor
        ext_factor = 1.0
    rope = RopeConfig(
        n_dims=rope_dims,
        n_ctx_orig=n_ctx_orig,
        freq_base=float(key("rope.freq_base", 10000.0)),
        freq_scale=freq_scale,
        ext_factor=ext_factor,
        attn_factor=float(key("rope.scaling.attn_factor", 1.0) or 1.0),
        beta_fast=float(key("rope.scaling.beta_fast", 32.0) or 32.0),
        beta_slow=float(key("rope.scaling.beta_slow", 1.0) or 1.0),
        rope_type=int(md.get("powerserve.rope_type", default_rope)),
        scaling_type="llama3" if scaling_type == "llama3" else "none",
        scaling_factor=scaling_factor,
        low_freq_factor=float(key("rope.scaling.low_freq_factor", 1.0)
                              or 1.0),
        high_freq_factor=float(key("rope.scaling.high_freq_factor", 4.0)
                               or 4.0),
    )
    n_experts = int(key("expert_count", 0) or 0)
    ffn_len = (int(key("expert_feed_forward_length", 0) or 0)
               if n_experts else 0)
    llm = LLMConfig(
        dim=dim,
        hidden_dim=ffn_len or int(key("feed_forward_length", 4 * dim)),
        n_experts=n_experts,
        n_experts_used=int(key("expert_used_count", 0) or 0),
        n_layers=int(key("block_count", 16)),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_size=head_size,
        seq_len=int(key("context_length", 2048)),
        vocab_size=vocab_size,
        kv_dim=n_kv * head_size,
        rope=rope,
        norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
    )
    return ModelConfig(arch=arch, llm=llm)


def _concat_qlinear(parts: list[QLinear | None]) -> QLinear | None:
    """Concatenate QLinears along the output axis (same K and format),
    or None when they cannot share one kernel call."""
    if any(p is None for p in parts):
        return None
    head = parts[0]
    for p in parts[1:]:
        if (p.packed != head.packed or p.unsigned != head.unsigned
                or p.pack_group != head.pack_group
                or p.scale_group != head.scale_group
                or p.in_features != head.in_features
                or p.scales.dtype != head.scales.dtype
                or (p.bias is None) != (head.bias is None)):
            return None
    return QLinear(
        torch.cat([p.q for p in parts], dim=-1),
        torch.cat([p.scales for p in parts], dim=-1),
        None if head.bias is None else torch.cat([p.bias for p in parts],
                                                 dim=-1),
        packed=head.packed, unsigned=head.unsigned,
        in_features=head.in_features,
        out_features=sum(p.out_features for p in parts),
        pack_group=head.pack_group, scale_group=head.scale_group)


def fuse_layer(w: dict) -> dict:
    """Fuse the QKV and gate/up projections of one layer's weight dict
    into single matmuls where their formats agree (MoE layers have no
    dense gate/up but still fuse QKV)."""
    out = dict(w)
    wqkv = _concat_qlinear([w.get("wq"), w.get("wk"), w.get("wv")])
    if wqkv is not None:
        bqkv = None
        if w.get("bq") is not None:
            bqkv = torch.cat([w["bq"], w["bk"], w["bv"]], dim=-1)
        out.update(wqkv=wqkv, bqkv=bqkv, wq=None, wk=None, wv=None, bq=None,
                   bk=None, bv=None)
    wgu = _concat_qlinear([w.get("w_gate"), w.get("w_up")])
    if wgu is not None:
        out.update(wgu=wgu, w_gate=None, w_up=None)
    return out


def _lm_head_from_embedding(emb: QEmbedding) -> QLinear:
    """Tied embeddings: the embedding table as the output projection."""
    q = emb.q.t().contiguous()  # [D, V]
    scales = emb.scales.t().contiguous()
    bias = None if emb.bias is None else emb.bias.t().contiguous()
    return QLinear(q, scales, bias, packed=False, unsigned=False,
                   in_features=q.shape[0], out_features=q.shape[1])


def qlinear_from_payload(raw: np.ndarray, ggml_type: int,
                         shape: tuple[int, int], pack: bool,
                         device: str | torch.device,
                         mxu: bool = False) -> QLinear:
    """A GGUF weight payload [N_out, K_in] as a QLinear on `device`: the
    native repack where it gives the layout the port keeps, else
    core/quant.py's (the module docstring)."""
    n_out, k_in = shape
    is4bit = ggml_type in (GGMLType.Q4_0, GGMLType.Q4_K)
    if not mxu and (not is4bit or (pack and k_in % 128 == 0)):
        nat = native_repack(raw, ggml_type, n_out, k_in)
        if nat is not None:
            q, scales, bias, group, unsigned = nat
            return QLinear(_tensor(q, device), _tensor(scales, device),
                           None if bias is None else _tensor(bias, device),
                           packed=group > 0, unsigned=unsigned,
                           in_features=k_in, out_features=n_out,
                           pack_group=group)
    qt = repack_gguf_tensor(raw, ggml_type, shape)
    return QLinear.from_quantized(qt, pack=pack, device=device, mxu=mxu)


def _qlinear_from_gguf(reader: GGUFReader, name: str, pack: bool,
                       device: torch.device, mxu: bool = False) -> QLinear:
    info = reader.tensors[name]
    return qlinear_from_payload(reader.tensor_raw(name), info.ggml_type,
                                info.shape, pack, device, mxu)


def _qlinear_experts(reader: GGUFReader, name: str, pack: bool,
                     device: torch.device) -> QLinear:
    """3-D expert tensor [E, N_out, K_in] -> an expert stack. ggml stores
    the experts contiguously (slowest axis), so the payload splits into E
    equal 2-D payloads."""
    info = reader.tensors[name]
    n_exp = info.shape[0]
    raw = reader.tensor_raw(name)
    per = raw.size // n_exp
    parts = [qlinear_from_payload(raw[e * per:(e + 1) * per],
                                  info.ggml_type, tuple(info.shape[1:]),
                                  pack, "cpu")
             for e in range(n_exp)]
    return QLinear.stack(parts).to(device)


def _embedding_from_gguf(reader: GGUFReader, name: str,
                         device: torch.device) -> QEmbedding:
    info = reader.tensors[name]
    qt = repack_gguf_tensor(reader.tensor_raw(name), info.ggml_type,
                            info.shape)
    # repack gives [K=dim, N=vocab]; the embedding wants [V, D]
    bias = None if qt.bias is None else _tensor(qt.bias.T, device)
    return QEmbedding(_tensor(qt.q.T, device), _tensor(qt.scales.T, device),
                      bias)


def _float_from_gguf(reader: GGUFReader, name: str,
                     device: torch.device) -> torch.Tensor | None:
    if name not in reader.tensors:
        return None
    return _tensor(reader.tensor_float(name).astype(np.float32), device)


def gguf_architecture(path: str | os.PathLike) -> str | None:
    """general.architecture of weights.gguf (or a model dir holding it),
    None where there is no such file."""
    p = Path(path)
    if p.is_dir():
        p = p / "weights.gguf"
    if not p.exists():
        return None
    reader = GGUFReader(p)
    try:
        return reader.metadata.get("general.architecture")
    finally:
        reader.close()


def load_gguf_model(path: str | os.PathLike | GGUFReader, pack: bool = True,
                    fuse: bool = True,
                    device: str | torch.device | None = None,
                    mxu: bool = False) -> tuple[ModelConfig, LlamaModel]:
    """Load weights.gguf (or a model dir holding it, or an open
    GGUFReader, which this closes) onto `device` (default cuda).
    Llama-family models, dense or MoE.

    mxu=True requantizes the attention, dense FFN and lm_head projections
    whose K is a multiple of 128 to the W8 format (core/quant.py:
    requantize_w8); expert stacks and the tied embedding keep theirs."""
    dev = resolve_device(device)
    if isinstance(path, GGUFReader):
        reader = path
    else:
        p = Path(path)
        if p.is_dir():
            p = p / "weights.gguf"
        reader = GGUFReader(p)
    cfg = config_from_gguf_metadata(reader.metadata)
    layers = []
    for i in range(cfg.llm.n_layers):
        pre = f"blk.{i}."
        projs = [("wq", "attn_q.weight"), ("wk", "attn_k.weight"),
                 ("wv", "attn_v.weight"), ("wo", "attn_output.weight")]
        moe = pre + "ffn_gate_exps.weight" in reader.tensors
        if not moe:
            projs += [("w_gate", "ffn_gate.weight"), ("w_up", "ffn_up.weight"),
                      ("w_down", "ffn_down.weight")]
        w = {name: _qlinear_from_gguf(reader, pre + gguf, pack, dev, mxu)
             for name, gguf in projs}
        if moe:
            router = reader.tensor_float(pre + "ffn_gate_inp.weight")
            w["router"] = _tensor(router.T.astype(np.float32), dev)
            for name in ("gate", "up", "down"):
                w[f"w_{name}_exps"] = _qlinear_experts(
                    reader, f"{pre}ffn_{name}_exps.weight", pack, dev)
        for name, gguf in (("attn_norm", "attn_norm.weight"),
                           ("ffn_norm", "ffn_norm.weight"),
                           ("q_norm", "attn_q_norm.weight"),
                           ("k_norm", "attn_k_norm.weight"),
                           ("bq", "attn_q.bias"), ("bk", "attn_k.bias"),
                           ("bv", "attn_v.bias")):
            w[name] = _float_from_gguf(reader, pre + gguf, dev)
        layers.append(fuse_layer(w) if fuse else w)
    embed = _embedding_from_gguf(reader, "token_embd.weight", dev)
    out_norm = _float_from_gguf(reader, "output_norm.weight", dev)
    if "output.weight" in reader.tensors:
        lm_head = _qlinear_from_gguf(reader, "output.weight", pack, dev, mxu)
        cfg.llm.tie_embeddings = False
    else:
        lm_head = _lm_head_from_embedding(embed)
        cfg.llm.tie_embeddings = True
    reader.close()
    model = LlamaModel(cfg.llm, embed, [LlamaLayer(**w) for w in layers],
                       out_norm, lm_head)
    return cfg, model


def load_eagle_gguf(path: str | os.PathLike, target: LlamaModel,
                    target_llm: LLMConfig, pack: bool = True,
                    fuse: bool = True,
                    device: str | torch.device | None = None):
    """Load an EAGLE head GGUF (general.architecture "eagle", the eagle.*
    metadata) against its target model onto `device` (default cuda).

    The head shares the target's embedding and lm_head objects (no second
    copy on the device) unless the file carries its own token_embd /
    output tensors; blk.0 without attn_norm means EAGLE-1's identity
    input norm (input_norm=False). Returns (head LLMConfig, EagleHead)."""
    import dataclasses

    from ..speculative.eagle import EagleHead

    dev = resolve_device(device)
    p = Path(path)
    if p.is_dir():
        p = p / "weights.gguf"
    reader = GGUFReader(p)
    md = reader.metadata
    if md.get("general.architecture") != "eagle":
        raise ValueError(f"{p}: not an eagle head "
                         f"(arch={md.get('general.architecture')})")
    L = int(md.get("eagle.block_count", 1))
    dim = int(md.get("eagle.embedding_length", target_llm.dim))
    n_heads = int(md.get("eagle.attention.head_count", target_llm.n_heads))
    n_kv = int(md.get("eagle.attention.head_count_kv",
                      target_llm.n_kv_heads))
    head_dim = int(md.get("eagle.rope.dimension_count",
                          dim // max(n_heads, 1)))
    rope = dataclasses.replace(
        target_llm.rope,
        freq_base=float(md.get("eagle.rope.freq_base",
                               target_llm.rope.freq_base)),
        rope_type=int(md.get("powerserve.rope_type",
                             target_llm.rope.rope_type)),
        n_dims=head_dim)
    e_llm = dataclasses.replace(
        target_llm, n_layers=L, dim=dim, n_heads=n_heads, n_kv_heads=n_kv,
        head_size=head_dim, kv_dim=n_kv * head_dim, rope=rope,
        hidden_dim=int(md.get("eagle.feed_forward_length",
                              target_llm.hidden_dim)),
        norm_eps=float(md.get("eagle.attention.layer_norm_rms_epsilon",
                              target_llm.norm_eps)))
    input_norm = "blk.0.attn_norm.weight" in reader.tensors
    layers = []
    for i in range(L):
        pre = f"blk.{i}."
        w = {name: _qlinear_from_gguf(reader, pre + gguf, pack, dev)
             for name, gguf in (("wq", "attn_q.weight"),
                                ("wk", "attn_k.weight"),
                                ("wv", "attn_v.weight"),
                                ("wo", "attn_output.weight"),
                                ("w_gate", "ffn_gate.weight"),
                                ("w_up", "ffn_up.weight"),
                                ("w_down", "ffn_down.weight"))}
        for name, gguf in (("attn_norm", "attn_norm.weight"),
                           ("ffn_norm", "ffn_norm.weight"),
                           ("bq", "attn_q.bias"), ("bk", "attn_k.bias"),
                           ("bv", "attn_v.bias")):
            w[name] = _float_from_gguf(reader, pre + gguf, dev)
        if w["attn_norm"] is None:  # read by no layer (layer 0 only)
            w["attn_norm"] = torch.ones(dim, dtype=torch.float32, device=dev)
        layers.append(LlamaLayer(**(fuse_layer(w) if fuse else w)))
    fc = _qlinear_from_gguf(reader, "fc.weight", pack, dev)
    fc_bias = _float_from_gguf(reader, "fc.bias", dev)
    embed = (_embedding_from_gguf(reader, "token_embd.weight", dev)
             if "token_embd.weight" in reader.tensors else target.embed)
    lm_head = (_qlinear_from_gguf(reader, "output.weight", pack, dev)
               if "output.weight" in reader.tensors else target.lm_head)
    out_norm = _float_from_gguf(reader, "output_norm.weight", dev)
    reader.close()
    return e_llm, EagleHead(e_llm, fc, fc_bias, layers, embed, lm_head,
                            out_norm, input_norm)


# ---------------------------------------------------------------------------
# carry-over from numpy trees
# ---------------------------------------------------------------------------

def _tensor(a, device: torch.device) -> torch.Tensor:
    """numpy array (f32, int8, uint8 or ml_dtypes bfloat16) -> tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _qlinear_from_tree(d: dict, device: torch.device,
                       i: int | None = None) -> QLinear:
    def pick(a):
        return None if a is None else _tensor(a if i is None else a[i],
                                              device)

    meta = {k: d[k] for k in _QLINEAR_META}
    return QLinear(pick(d["q"]), pick(d["scales"]), pick(d.get("bias")),
                   **meta)


def params_from_numpy(tree: dict, cfg: ModelConfig | LLMConfig,
                      device: str | torch.device | None = None) -> LlamaModel:
    """The JAX package's LlamaParams as nested dicts of numpy arrays ->
    LlamaModel on `device` (default cuda).

    tree: {"embed": {q, scales, bias}, "layers": {field: leaf},
    "out_norm": array, "lm_head": qlinear}. A QLinear is a dict of q,
    scales, bias plus its metadata (packed, unsigned, in_features,
    out_features, pack_group, scale_group); "layers" leaves are stacked
    on a leading [L] axis (or "layers" is a list of per-layer dicts).
    Expert stacks are [L, E, ...] in the stacked tree, [E, ...] per layer.
    Absent or None fields are absent weights."""
    dev = resolve_device(device)
    llm = cfg.llm if isinstance(cfg, ModelConfig) else cfg
    e = tree["embed"]
    embed = QEmbedding(_tensor(e["q"], dev), _tensor(e["scales"], dev),
                       None if e.get("bias") is None
                       else _tensor(e["bias"], dev))
    stacked = tree["layers"]
    per_layer = (stacked if isinstance(stacked, (list, tuple))
                 else [stacked] * llm.n_layers)
    fields = ("attn_norm", "ffn_norm", "wqkv", "bqkv", "wq", "wk", "wv",
              "bq", "bk", "bv", "wo", "wgu", "w_gate", "w_up", "w_down",
              "q_norm", "k_norm", "router", "w_gate_exps", "w_up_exps",
              "w_down_exps")
    layers = []
    for i, lw in enumerate(per_layer):
        idx = None if isinstance(stacked, (list, tuple)) else i
        kw = {}
        for name in fields:
            leaf = lw.get(name)
            if leaf is None:
                continue
            if isinstance(leaf, dict):
                kw[name] = _qlinear_from_tree(leaf, dev, idx)
            else:
                kw[name] = _tensor(leaf if idx is None else leaf[idx], dev)
        layers.append(LlamaLayer(**kw))
    return LlamaModel(llm, embed, layers, _tensor(tree["out_norm"], dev),
                      _qlinear_from_tree(tree["lm_head"], dev))
