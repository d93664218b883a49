"""Random quantized parameters at a preset's full width, built directly
on the device from a seeded torch.Generator — no host-to-device weight
transfer, so an 8B model materializes in seconds. Values are random;
kernel timing is that of real weights of the same formats.

Like the JAX package's tools/bench_params.py: fused wqkv / gate|up
projections, bf16 scales (and Q4_K minimums), int8 embedding with f32
scales, vocabulary padded to a multiple of 256 (vocab_size is the padded
size).
"""

from __future__ import annotations

import torch

from ..core.config import LLMConfig, ModelConfig, RopeConfig
from ..core.device import resolve_device
from ..core.quant import QK, choose_pack_group
from ..models.llama import LlamaLayer, LlamaModel, QEmbedding
from ..ops.elementwise import ROPE_TYPE_NORM
from ..ops.qmatmul import QLinear
from .synthetic import PRESETS


def _rand_qlinear(g: torch.Generator, k: int, n: int, quant: str,
                  dev: torch.device) -> QLinear:
    kb = k // QK

    def uniform(shape, lo, width):
        return (torch.rand(shape, generator=g, device=dev) * width
                + lo).to(torch.bfloat16)

    scales = uniform((kb, n), 0.001, 0.02)
    if quant in ("q4_0", "q4_k"):
        q = torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                          dtype=torch.uint8)
        bias = uniform((kb, n), 0.0, 0.01) if quant == "q4_k" else None
        return QLinear(q, scales, bias, packed=True,
                       unsigned=quant == "q4_k", in_features=k,
                       out_features=n, pack_group=choose_pack_group(k))
    if quant != "q8_0":
        raise ValueError(f"quant {quant!r}: q4_0, q4_k or q8_0")
    q = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    return QLinear(q, scales, None, packed=False, unsigned=False,
                   in_features=k, out_features=n)


def make_device_params(preset: str = "llama-8b", quant: str = "q4_k",
                       seed: int = 0,
                       device: str | torch.device | None = None
                       ) -> tuple[ModelConfig, LlamaModel]:
    """(ModelConfig, LlamaModel) with random weights on `device`
    (default cuda). Dense presets only."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    if p.get("experts"):
        raise NotImplementedError("mixture-of-experts presets are not "
                                  "ported yet")
    dim, ffn, L = p["dim"], p["ffn"], p["layers"]
    H, Hkv, V = p["heads"], p["kv_heads"], p["vocab"]
    hd = dim // H
    vpad = (V + 255) // 256 * 256
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ones = torch.ones(dim, dtype=torch.float32, device=dev)
    layers = [LlamaLayer(
        ones, ones,
        wqkv=_rand_qlinear(g, dim, (H + 2 * Hkv) * hd, quant, dev),
        wo=_rand_qlinear(g, H * hd, dim, quant, dev),
        wgu=_rand_qlinear(g, dim, 2 * ffn, quant, dev),
        w_down=_rand_qlinear(g, ffn, dim, quant, dev)) for _ in range(L)]
    embed = QEmbedding(
        torch.randint(-128, 128, (vpad, dim), generator=g, device=dev,
                      dtype=torch.int8),
        torch.rand((vpad, dim // QK), generator=g, device=dev) * 0.02,
        None)
    lm_head = _rand_qlinear(g, dim, vpad, quant, dev)
    rope = RopeConfig(n_dims=hd, freq_base=500000.0, rope_type=ROPE_TYPE_NORM)
    llm = LLMConfig(dim=dim, hidden_dim=ffn, n_layers=L, n_heads=H,
                    n_kv_heads=Hkv, head_size=hd, seq_len=2048,
                    vocab_size=vpad, kv_dim=Hkv * hd, rope=rope)
    model = LlamaModel(llm, embed, layers, ones, lm_head)
    return ModelConfig(arch=p["arch"], llm=llm), model
