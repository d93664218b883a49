"""Random quantized parameters at a preset's full width, built directly
on the device from a seeded torch.Generator — no host-to-device weight
transfer, so an 8B model materializes in seconds. Values are random;
kernel timing is that of real weights of the same formats.

Like the JAX package's tools/bench_params.py: fused wqkv / gate|up
projections, bf16 scales (and Q4_K minimums), int8 embedding with f32
scales, vocabulary padded to a multiple of 256 (vocab_size is the padded
size). MoE presets get a router uniform in [-0.05, 0.05] and expert
stacks (gate and up dim -> ffn, down ffn -> dim, one slab per expert).
quant "w8" gives the W8 format: int8 weights with f32 scales in
[0.001, 0.021) per 128 rows, no minimum (expert stacks too: int8 [E, K,
N], scales [E, K/128, N]).

make_device_vision_params gives a random InternVL vision tower and
projector at a vision preset's widths, make_device_internvl a whole
vision-language model (tools/synthetic.py VLM_PRESETS).
"""

from __future__ import annotations

import torch

from ..core.config import LLMConfig, ModelConfig, RopeConfig
from ..core.device import resolve_device
from ..core.quant import MXU_GROUP, QK, choose_pack_group
from ..models.internvl import InternVLModel
from ..models.llama import LlamaLayer, LlamaModel, QEmbedding
from ..models.vit import VisionParams, make_vision_params
from ..ops.elementwise import ROPE_TYPE_NORM
from ..ops.qmatmul import QLinear
from .synthetic import (PRESETS, VISION_PRESETS, VLM_PRESETS,
                        tokens_per_tile)


def _rand_qlinear(g: torch.Generator, k: int, n: int, quant: str,
                  dev: torch.device, experts: int = 0) -> QLinear:
    """A random [K, N] weight, or a stack of `experts` slabs."""
    lead = (experts,) if experts else ()
    kb = k // QK

    def uniform(shape, lo, width, dtype=torch.bfloat16):
        return (torch.rand(lead + shape, generator=g, device=dev) * width
                + lo).to(dtype)

    def int8(rows):
        return torch.randint(-128, 128, lead + (rows, n), generator=g,
                             device=dev, dtype=torch.int8)

    if quant == "w8":
        if k % MXU_GROUP:
            raise ValueError(f"W8: K={k} is not a multiple of {MXU_GROUP}")
        return QLinear(int8(k), uniform((k // MXU_GROUP, n), 0.001, 0.02,
                                        torch.float32), None, packed=False,
                       unsigned=False, in_features=k, out_features=n,
                       scale_group=MXU_GROUP)
    scales = uniform((kb, n), 0.001, 0.02)
    if quant in ("q4_0", "q4_k"):
        q = torch.randint(0, 256, lead + (k // 2, n), generator=g,
                          device=dev, dtype=torch.uint8)
        bias = uniform((kb, n), 0.0, 0.01) if quant == "q4_k" else None
        return QLinear(q, scales, bias, packed=True,
                       unsigned=quant == "q4_k", in_features=k,
                       out_features=n, pack_group=choose_pack_group(k))
    if quant != "q8_0":
        raise ValueError(f"quant {quant!r}: q4_0, q4_k, q8_0 or w8")
    return QLinear(int8(k), scales, None, packed=False, unsigned=False,
                   in_features=k, out_features=n)


def make_device_params(preset: str = "llama-8b", quant: str = "q4_k",
                       seed: int = 0,
                       device: str | torch.device | None = None,
                       layers: int | None = None
                       ) -> tuple[ModelConfig, LlamaModel]:
    """(ModelConfig, LlamaModel) with random weights on `device`
    (default cuda); layers: the preset's depth cut to that many (the
    first layers of the full model's, the same seed)."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    E = int(p.get("experts", 0))
    dim, ffn, L = p["dim"], p["ffn"], int(layers or p["layers"])
    H, Hkv, V = p["heads"], p["kv_heads"], p["vocab"]
    hd = dim // H
    vpad = (V + 255) // 256 * 256
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ones = torch.ones(dim, dtype=torch.float32, device=dev)

    def ffn_weights() -> dict:
        if not E:
            return dict(wgu=_rand_qlinear(g, dim, 2 * ffn, quant, dev),
                        w_down=_rand_qlinear(g, ffn, dim, quant, dev))
        return dict(
            router=torch.rand((dim, E), generator=g, device=dev) * 0.1 - 0.05,
            w_gate_exps=_rand_qlinear(g, dim, ffn, quant, dev, E),
            w_up_exps=_rand_qlinear(g, dim, ffn, quant, dev, E),
            w_down_exps=_rand_qlinear(g, ffn, dim, quant, dev, E))

    layers = [LlamaLayer(
        ones, ones,
        wqkv=_rand_qlinear(g, dim, (H + 2 * Hkv) * hd, quant, dev),
        wo=_rand_qlinear(g, H * hd, dim, quant, dev),
        **ffn_weights()) for _ in range(L)]
    embed = QEmbedding(
        torch.randint(-128, 128, (vpad, dim), generator=g, device=dev,
                      dtype=torch.int8),
        torch.rand((vpad, dim // QK), generator=g, device=dev) * 0.02,
        None)
    lm_head = _rand_qlinear(g, dim, vpad, quant, dev)
    rope = RopeConfig(n_dims=hd, freq_base=500000.0, rope_type=ROPE_TYPE_NORM)
    llm = LLMConfig(dim=dim, hidden_dim=ffn, n_layers=L, n_heads=H,
                    n_kv_heads=Hkv, head_size=hd, seq_len=2048,
                    vocab_size=vpad, kv_dim=Hkv * hd, rope=rope,
                    n_experts=E, n_experts_used=int(p.get("experts_used", 2)))
    model = LlamaModel(llm, embed, layers, ones, lm_head)
    return ModelConfig(arch=p["arch"], llm=llm), model


def make_device_vision_params(preset: str = "internvit-300m",
                              text_dim: int = 2048, seed: int = 0,
                              device: str | torch.device | None = None
                              ) -> VisionParams:
    """A random vision tower and projector on `device` (default cuda):
    weights normal with std 0.02 ([in, out]; the layers' stored bf16),
    biases 0.01, norms near 1, layer scales near 0.1."""
    dev = resolve_device(device)
    v = VISION_PRESETS[preset]
    D, Fw, p = v["dim"], v["ffn"], v["patch"]
    D4 = int(D / v["downsample"] ** 2)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(*shape, scale=0.02, mean=0.0):
        return torch.randn(shape, generator=g, device=dev) * scale + mean

    layers = [dict(qkv_w=rand(D, 3 * D), qkv_b=rand(3 * D, scale=0.01),
                   proj_w=rand(D, D), proj_b=rand(D, scale=0.01),
                   fc1_w=rand(D, Fw), fc1_b=rand(Fw, scale=0.01),
                   fc2_w=rand(Fw, D), fc2_b=rand(D, scale=0.01),
                   ln1_w=rand(D, scale=0.1, mean=1.0),
                   ln1_b=rand(D, scale=0.1),
                   ln2_w=rand(D, scale=0.1, mean=1.0),
                   ln2_b=rand(D, scale=0.1),
                   lambda1=rand(D, scale=0.01, mean=0.1),
                   lambda2=rand(D, scale=0.01, mean=0.1))
              for _ in range(v["layers"])]
    top = dict(patch_w=rand(3 * p * p, D), patch_b=rand(D),
               cls_token=rand(1, 1, D),
               pos_embed=rand(1, (v["image"] // p) ** 2 + 1, D),
               proj_ln_w=rand(D4, scale=0.1, mean=1.0),
               proj_ln_b=rand(D4, scale=0.1),
               proj_fc1_w=rand(D4, text_dim),
               proj_fc1_b=rand(text_dim, scale=0.01),
               proj_fc2_w=rand(text_dim, text_dim),
               proj_fc2_b=rand(text_dim, scale=0.01))
    return make_vision_params(top, layers, p, v["heads"], v["eps"],
                              v["downsample"], dev)


def make_device_internvl(preset: str = "internvl2.5-4b", quant: str = "q4_k",
                         seed: int = 0,
                         device: str | torch.device | None = None,
                         text_layers: int | None = None
                         ) -> InternVLModel:
    """A random vision-language model on `device` (default cuda): the
    text preset's make_device_params (text_layers: its depth cut) and
    the vision preset's tower."""
    text, vision, image_id = VLM_PRESETS[preset]
    cfg, llm = make_device_params(text, quant, seed, device,
                                  layers=text_layers)
    vp = make_device_vision_params(vision, cfg.llm.dim, seed + 1, device)
    return InternVLModel(vision=vp, llm=llm, cfg=cfg,
                         image_token_id=image_id,
                         tokens_per_tile=tokens_per_tile(vision),
                         image_size=VISION_PRESETS[vision]["image"])
