"""Llama-family transformer (llama, qwen2 = llama + QKV bias, qwen3 =
llama + QK-norm): the dense branch of the JAX package's forward as
nn.Modules with a Python loop over the layers.

LlamaLayer holds one layer's weights (the JAX LayerWeights, unstacked)
and LlamaModel the embedding, the layers, the final norm and the
lm_head (the JAX LlamaParams). Numerics follow the JAX package: bf16
residual stream, f32 norms, quantized matmuls with bf16 inputs and f32
outputs, int8 KV cache with per-(token, head) scales.

Each layer writes its new K/V into the cache in place before attention
(the JAX main path defers the write past the layer scan to dodge an XLA
aliasing cost; the cache contents are the same). Decode-sized batches
(Tq <= 16) attend through the flash-decode kernel, prefill chunks through
the plain gqa_attention_quant.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.config import LLMConfig
from ..core.quant import QK
from ..kv.cache import KVCache
from ..ops.attention import build_visibility, gqa_attention_quant
from ..ops.elementwise import apply_rope, rms_norm, rope_cos_sin, silu_hadamard
from ..ops.flash_decode import flash_decode_quant
from ..ops.fused import fused_linear
from ..ops.qmatmul import QLinear, qmatmul

# the largest query batch that attends through the flash-decode kernel
DECODE_MAX_TQ = 16


class QEmbedding(nn.Module):
    """Quantized embedding table: rows gathered, then dequantized."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("q", q)  # int8 [V, D]
        self.register_buffer("scales", scales)  # f32 [V, D // 32]
        self.register_buffer("bias", bias)  # f32 [V, D // 32] or None

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = (self.q[tokens].float()
             * self.scales[tokens].float().repeat_interleave(QK, dim=-1))
        if self.bias is not None:
            x = x - self.bias[tokens].float().repeat_interleave(QK, dim=-1)
        return x


class LlamaLayer(nn.Module):
    """One decoder layer. Fused projections (wqkv, wgu) when the loader
    could concatenate them, else the separate ones."""

    def __init__(self, attn_norm: torch.Tensor, ffn_norm: torch.Tensor, *,
                 wo: QLinear, w_down: QLinear, wqkv: QLinear | None = None,
                 bqkv: torch.Tensor | None = None, wq: QLinear | None = None,
                 wk: QLinear | None = None, wv: QLinear | None = None,
                 bq: torch.Tensor | None = None,
                 bk: torch.Tensor | None = None,
                 bv: torch.Tensor | None = None, wgu: QLinear | None = None,
                 w_gate: QLinear | None = None, w_up: QLinear | None = None,
                 q_norm: torch.Tensor | None = None,
                 k_norm: torch.Tensor | None = None):
        super().__init__()
        if (wqkv is None) == (wq is None) or (wgu is None) == (w_gate is None):
            raise ValueError("give either wqkv or wq/wk/wv, and either wgu "
                             "or w_gate/w_up")
        for name, t in (("attn_norm", attn_norm), ("ffn_norm", ffn_norm),
                        ("bqkv", bqkv), ("bq", bq), ("bk", bk), ("bv", bv),
                        ("q_norm", q_norm), ("k_norm", k_norm)):
            self.register_buffer(name, t)
        self.wqkv, self.wq, self.wk, self.wv = wqkv, wq, wk, wv
        self.wo, self.wgu, self.w_gate, self.w_up = wo, wgu, w_gate, w_up
        self.w_down = w_down

    @staticmethod
    def _lin(h: torch.Tensor, w: QLinear, b: torch.Tensor | None):
        y = qmatmul(h, w)
        return y if b is None else y + b

    def forward(self, x: torch.Tensor, llm: LLMConfig, kv: KVCache,
                layer: int, cos: torch.Tensor, sin: torch.Tensor,
                vis: torch.Tensor, index: tuple) -> torch.Tensor:
        S, Tq, _ = x.shape
        H, Hkv, D = llm.n_heads, llm.n_kv_heads, llm.head_size
        eps = llm.norm_eps
        h = rms_norm(x, self.attn_norm, eps).to(torch.bfloat16)
        h = h.reshape(S * Tq, -1)
        if self.wqkv is not None:
            qkv = self._lin(h, self.wqkv, self.bqkv)
            q = qkv[:, : H * D]
            k = qkv[:, H * D: (H + Hkv) * D]
            v = qkv[:, (H + Hkv) * D:]
        else:
            q = self._lin(h, self.wq, self.bq)
            k = self._lin(h, self.wk, self.bk)
            v = self._lin(h, self.wv, self.bv)
        q = q.reshape(S, Tq, H, D)
        k = k.reshape(S, Tq, Hkv, D)
        v = v.reshape(S, Tq, Hkv, D)
        if self.q_norm is not None:  # qwen3 QK-norm, before RoPE
            q = rms_norm(q, self.q_norm, eps)
            k = rms_norm(k, self.k_norm, eps)
        q = apply_rope(q, cos, sin, llm.rope.rope_type)
        k = apply_rope(k, cos, sin, llm.rope.rope_type)

        kv.write(layer, k, v, index)
        cache = (kv.k[layer], kv.k_scale[layer], kv.v[layer],
                 kv.v_scale[layer])
        scale = 1.0 / math.sqrt(D)
        if Tq <= DECODE_MAX_TQ:
            attn = flash_decode_quant(q, *cache, vis, scale)
        else:
            attn = gqa_attention_quant(q, *cache, vis, scale)
        attn_out = qmatmul(attn.reshape(S * Tq, -1).to(torch.bfloat16),
                           self.wo)
        x = x + attn_out.reshape(S, Tq, -1).to(x.dtype)

        h2 = rms_norm(x, self.ffn_norm, eps).to(torch.bfloat16)
        h2 = h2.reshape(S * Tq, -1)
        if self.wgu is not None:
            gu = qmatmul(h2, self.wgu)
            f = gu.shape[-1] // 2
            gate, up = gu[:, :f], gu[:, f:]
        else:
            gate, up = qmatmul(h2, self.w_gate), qmatmul(h2, self.w_up)
        act = silu_hadamard(gate, up).to(torch.bfloat16)
        down = qmatmul(act, self.w_down)
        return x + down.reshape(S, Tq, -1).to(x.dtype)


class LlamaModel(nn.Module):
    def __init__(self, llm: LLMConfig, embed: QEmbedding,
                 layers: list[LlamaLayer], out_norm: torch.Tensor,
                 lm_head: QLinear):
        super().__init__()
        self.llm = llm
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.register_buffer("out_norm", out_norm)
        self.lm_head = lm_head

    def head(self, h: torch.Tensor, argmax: bool = False) -> torch.Tensor:
        """Final norm + lm_head (+ greedy argmax) on rows [M, dim]."""
        return fused_linear(self.lm_head, norm=(h, self.out_norm),
                            argmax=argmax, eps=self.llm.norm_eps)

    @torch.no_grad()
    def forward(self, kv: KVCache, tokens: torch.Tensor,
                positions: torch.Tensor, *,
                active: torch.Tensor | None = None,
                logits_mode: str = "last") -> torch.Tensor:
        """One forward pass over a batch of slots; updates kv in place.

        tokens/positions: [S, Tq] (positions drive RoPE and the cache
        writes; -1 or >= max_seq are not written). active: [S] bool rows
        whose pos advances (default all).
        logits_mode: "last" -> f32 [S, vocab] for the final position;
          "all" -> [S, Tq, vocab]; "argmax" -> greedy tokens int32 [S];
          "none" -> [S, 0].
        """
        llm = self.llm
        S, Tq = tokens.shape
        x = self.embed.lookup(tokens).to(torch.bfloat16)
        cos, sin = rope_cos_sin(positions, llm.rope, llm.head_size)
        vis = build_visibility(kv.mask, positions)
        index = kv.write_index(positions)
        for i, layer in enumerate(self.layers):
            x = layer(x, llm, kv, i, cos, sin, vis, index)
        kv.advance(positions, active=active)

        if logits_mode == "none":
            return torch.zeros(S, 0, dtype=torch.float32, device=x.device)
        if logits_mode == "argmax":
            return self.head(x[:, -1, :], argmax=True)
        if logits_mode == "last":
            return self.head(x[:, -1, :])
        if logits_mode == "all":
            return self.head(x.reshape(S * Tq, -1)).reshape(S, Tq, -1)
        raise ValueError(f"logits_mode {logits_mode!r}")
