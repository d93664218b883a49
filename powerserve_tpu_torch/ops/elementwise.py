"""Elementwise, normalization and rotary ops in plain PyTorch (the JAX
package leaves these to XLA too). Norms compute in f32."""

from __future__ import annotations

import math

import torch

from ..core.config import RopeConfig

ROPE_TYPE_NORM = 0  # rotate adjacent pairs (GGUF llama layout, permuted Wq/Wk)
ROPE_TYPE_NEOX = 2  # rotate split halves (HF layout, qwen2/neox)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x / rms(x) * w in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)) * weight.float()


def silu_hadamard(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in f32."""
    g = gate.float()
    return g * torch.sigmoid(g) * up.float()


def rope_frequencies(cfg: RopeConfig, head_dim: int,
                     device: torch.device | None = None) -> torch.Tensor:
    """Per-pair extrapolation inverse frequencies [head_dim // 2] f32,
    with llama3-style per-dim frequency factors when configured."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    inv_freq = 1.0 / (cfg.freq_base ** exponents)
    if cfg.scaling_type == "llama3":
        factor = cfg.scaling_factor
        lo_f, hi_f = cfg.low_freq_factor, cfg.high_freq_factor
        old_ctx = float(cfg.n_ctx_orig)
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (old_ctx / wavelen - lo_f) / max(hi_f - lo_f, 1e-6)
        smooth = smooth.clamp(0.0, 1.0)
        scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(wavelen < old_ctx / hi_f, inv_freq, scaled)
    return inv_freq


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float,
                   base: float) -> float:
    """ggml_rope_yarn_corr_dim: pair index where n_rot full rotations fit
    in the original context."""
    return (n_dims * math.log(n_ctx_orig / (n_rot * 2.0 * math.pi))
            / (2.0 * math.log(base)))


def rope_cos_sin(positions: torch.Tensor, cfg: RopeConfig,
                 head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim // 2] for the given positions:
    linear scaling (angle = pos * inv_freq * freq_scale) or, with
    ext_factor != 0, YaRN's ramp between interpolated and extrapolated
    angles plus its magnitude correction."""
    inv_freq = rope_frequencies(cfg, head_dim, positions.device)
    theta_extrap = positions.float()[..., None] * inv_freq
    theta_interp = cfg.freq_scale * theta_extrap
    mscale = cfg.attn_factor
    if cfg.ext_factor != 0.0:
        n_dims = cfg.n_dims if cfg.n_dims > 0 else head_dim
        low = math.floor(_yarn_corr_dim(n_dims, cfg.n_ctx_orig,
                                        cfg.beta_fast, cfg.freq_base))
        high = math.ceil(_yarn_corr_dim(n_dims, cfg.n_ctx_orig,
                                        cfg.beta_slow, cfg.freq_base))
        low, high = max(low, 0.0), min(high, n_dims - 1.0)
        i = torch.arange(head_dim // 2, dtype=torch.float32,
                         device=positions.device)
        y = (i - low) / max(0.001, high - low)
        ramp = (1.0 - y.clamp(0.0, 1.0)) * cfg.ext_factor
        theta = theta_interp * (1.0 - ramp) + theta_extrap * ramp
        mscale = mscale * (1.0 + 0.1 * math.log(1.0 / cfg.freq_scale))
    else:
        theta = theta_interp
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rope_type: int = ROPE_TYPE_NEOX) -> torch.Tensor:
    """Rotate head vectors. x: [..., T, n_heads, head_dim];
    cos/sin: [..., T, head_dim // 2] (broadcast over heads)."""
    dtype = x.dtype
    xf = x.float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    if rope_type == ROPE_TYPE_NEOX:
        half = x.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:  # NORM: adjacent pairs (x[2i], x[2i+1])
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(x.shape)
    return out.to(dtype)
