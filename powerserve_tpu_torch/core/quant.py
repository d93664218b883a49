"""GGUF-family block quantization: numpy reference codecs + the repacked
[K, N] layout the matmul kernels read (numpy only; the same layout as
powerserve_tpu/core/quant.py, kept as the port's own copy).

Formats implemented from the public ggml block layouts (reference
libs/ggml/src/ggml-common.h:158-311 documents the structs; dequant
semantics per libs/ggml/src/ggml-quants.c dequantize_row_{q4_0,q8_0,q4_K}):

- Q4_0: 32-elem block = fp16 scale d + 16 bytes of nibbles; byte j packs
  element j (low nibble) and element j+16 (high nibble); x = d * (q - 8).
- Q8_0: 32-elem block = fp16 scale d + 32 int8; x = d * q.
- Q4_K: 256-elem superblock = fp16 d, fp16 dmin, 12 bytes of 6-bit
  sub-scales/mins (8 of each), 128 bytes of nibbles. Within each
  64-elem chunk c (4 chunks), byte j of its 32 bytes packs element
  64c+j (low) and 64c+32+j (high); sub-block s = 2c (+1 for highs):
  x = d*sc[s]*q - dmin*mn[s].

The representation produced by `repack_*` keeps weights quantized in
device memory with the contraction dim K on rows and the output dim N
contiguous along each row (see ops/qmatmul.py):

  QuantizedTensor:
    q      int8  [K, N]      (zero-point already subtracted for Q4_0)
    scales f32   [K//32, N]  per-32-block scale
    bias   f32   [K//32, N] or None   per-32-block additive minimum
                              (Q4_K; dequant = q*scale - bias_term where
                               bias applies per *element count*, so
                               x[k,n] = q[k,n]*scales[k//32,n] - bias[k//32,n])

plus an optional nibble-packed form (pack_nib4): uint8 [K//2, N] in pack
groups of G rows (choose_pack_group); within group g, byte row
g*G/2 + i packs k = g*G + i (low nibble) and k = g*G + G/2 + i (high
nibble).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gguf import GGMLType, GGML_TYPE_LAYOUT

QK = 32  # Q4_0 / Q8_0 block size
QK_K = 256  # K-quant superblock size


# ---------------------------------------------------------------------------
# numpy reference codecs (golden for kernel tests)
# ---------------------------------------------------------------------------

def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """float [..., K] -> Q4_0 payload bytes (K % 32 == 0)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    # scale from signed absmax (value with largest |x| keeps its sign)
    idx = np.argmax(np.abs(x), axis=1)
    amax = x[np.arange(nb), idx]
    d = amax / -8.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.round(x * inv_d[:, None]) + 8.0, 0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = (lo | (hi << 4)).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:] = qs
    return out.reshape(-1)


def dequantize_q4_0(payload: np.ndarray) -> np.ndarray:
    blocks = payload.reshape(-1, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [nb,32]
    return (q * d).reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    amax = np.max(np.abs(x), axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.round(x * inv_d[:, None]), -127, 127).astype(np.int8)
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(payload: np.ndarray) -> np.ndarray:
    blocks = payload.reshape(-1, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def _pack_k_scales(sc6: np.ndarray, mn6: np.ndarray) -> np.ndarray:
    """Pack 8 six-bit scales + 8 six-bit mins into 12 bytes per superblock.

    Layout (inverse of get_scale_min_k4, ggml-quants.c:1912):
      j<4:  byte[j]   low6 = sc[j];   byte[j+4] low6 = mn[j]
            byte[j]   hi2  = sc[j+4] bits 4-5; byte[j+4] hi2 = mn[j+4] bits 4-5
      j>=4: byte[j+4] low4 = sc[j] bits 0-3; hi4 = mn[j] bits 0-3
    """
    nb = sc6.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        out[:, j] = (sc6[:, j] & 63) | ((sc6[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (mn6[:, j] & 63) | ((mn6[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc6[:, j + 4] & 0xF) | ((mn6[:, j + 4] & 0xF) << 4)
    return out


def _unpack_k_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12 bytes -> (8 scales, 8 mins), 6-bit each. [nb,12] -> 2x [nb,8]."""
    q = scales.astype(np.uint16)
    sc = np.empty(q.shape[:-1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = q[..., j] & 63
        mn[..., j] = q[..., j + 4] & 63
        sc[..., j + 4] = (q[..., j + 8] & 0xF) | ((q[..., j] >> 6) << 4)
        mn[..., j + 4] = (q[..., j + 8] >> 4) | ((q[..., j + 4] >> 6) << 4)
    return sc, mn


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """float [..., K] -> Q4_K payload (K % 256 == 0). Simple min/max fit
    (not ggml's iterative search — dequant layout is what matters)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    smin = np.minimum(sub.min(axis=2), 0.0)  # mins stored non-negative: m = -min
    smax = sub.max(axis=2)
    scale = (smax - smin) / 15.0  # per-sub-block float scale
    neg_min = -smin
    d = scale.max(axis=1) / 63.0  # superblock scale of scales
    dmin = neg_min.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_dmin = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    sc6 = np.clip(np.round(scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.round(neg_min * inv_dmin[:, None]), 0, 63).astype(np.uint8)
    d16 = d.astype(np.float16)
    dmin16 = dmin.astype(np.float16)
    # quantize with the *decoded* scales so roundtrip is tight
    eff_scale = d16.astype(np.float32)[:, None] * sc6
    eff_min = dmin16.astype(np.float32)[:, None] * mn6
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1.0, eff_scale), 0.0)
    q = np.clip(np.round((sub + eff_min[:, :, None]) * inv_s[:, :, None]), 0, 15)
    q = q.astype(np.uint8)  # [nb, 8, 32]
    # pack nibbles: per 64-elem chunk c, byte j = elem(64c+j) | elem(64c+32+j)<<4
    chunks = q.reshape(nb, 4, 64)
    qs = (chunks[:, :, :32] | (chunks[:, :, 32:] << 4)).reshape(nb, 128)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = _pack_k_scales(sc6, mn6)
    out[:, 16:] = qs
    return out.reshape(-1)


def dequantize_q4_k(payload: np.ndarray) -> np.ndarray:
    blocks = payload.reshape(-1, 144)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc6, mn6 = _unpack_k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:].reshape(nb, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo[:, :, None, :], hi[:, :, None, :]], axis=2)  # [nb,4,2,32]
    q = q.reshape(nb, 8, 32)
    scale = d * sc6.astype(np.float32)  # [nb,8]
    minv = dmin * mn6.astype(np.float32)
    x = q * scale[:, :, None] - minv[:, :, None]
    return x.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    """float [..., K] -> Q4_1 payload (asymmetric: x = d*q + m)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 15).astype(np.uint8)
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_q4_1(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:1556 layout: d, m fp16; nibble j -> elems j, j+16."""
    blocks = payload.reshape(-1, 20)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 4:]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    """float -> Q5_0 (signed 5-bit, x = d*(q-16))."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    idx = np.argmax(np.abs(x), axis=1)
    amax = x[np.arange(nb), idx]
    d = amax / -16.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 16.0, 0, 31).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qh = np.zeros(nb, np.uint32)
    for j in range(16):
        qh |= ((lo[:, j].astype(np.uint32) >> 4) & 1) << j
        qh |= ((hi[:, j].astype(np.uint32) >> 4) & 1) << (j + 16)
    out = np.empty((nb, 22), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:6] = qh[:, None].view(np.uint8).reshape(nb, 4)
    out[:, 6:] = (lo & 0xF) | ((hi & 0xF) << 4)
    return out.reshape(-1)


def dequantize_q5_0(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:1577: 5th bits packed in a u32 (j and j+12<<... per
    source: xh_0 = ((qh >> j) << 4) & 0x10, xh_1 = (qh >> (j+12)) & 0x10)."""
    blocks = payload.reshape(-1, 22)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 2:6].copy().view(np.uint32)[:, 0]
    qs = blocks[:, 6:]
    j = np.arange(16)
    xh0 = ((qh[:, None] >> j) << 4) & 0x10
    xh1 = (qh[:, None] >> (j + 12)) & 0x10
    x0 = ((qs & 0x0F) | xh0).astype(np.int32) - 16
    x1 = ((qs >> 4) | xh1).astype(np.int32) - 16
    q = np.concatenate([x0, x1], axis=1).astype(np.float32)
    return (q * d).reshape(-1)


def dequantize_q5_1(payload: np.ndarray) -> np.ndarray:
    """Like Q5_0 with an additive fp16 min (ggml-quants.c:1604)."""
    blocks = payload.reshape(-1, 24)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 4:8].copy().view(np.uint32)[:, 0]
    qs = blocks[:, 8:]
    j = np.arange(16)
    xh0 = ((qh[:, None] >> j) << 4) & 0x10
    xh1 = (qh[:, None] >> (j + 12)) & 0x10
    x0 = ((qs & 0x0F) | xh0).astype(np.float32)
    x1 = ((qs >> 4) | xh1).astype(np.float32)
    q = np.concatenate([x0, x1], axis=1)
    return (q * d + m).reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    """float -> Q5_K (min/max fit; layout-faithful, not ggml's search)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = sub.max(axis=2)
    scale = (smax - smin) / 31.0
    neg_min = -smin
    d = scale.max(axis=1) / 63.0
    dmin = neg_min.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_dm = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    sc6 = np.clip(np.round(scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn6 = np.clip(np.round(neg_min * inv_dm[:, None]), 0, 63).astype(np.uint8)
    d16 = d.astype(np.float16)
    dmin16 = dmin.astype(np.float16)
    eff_s = d16.astype(np.float32)[:, None] * sc6
    eff_m = dmin16.astype(np.float32)[:, None] * mn6
    inv_s = np.where(eff_s > 0, 1.0 / np.where(eff_s == 0, 1.0, eff_s), 0.0)
    q = np.clip(np.round((sub + eff_m[:, :, None]) * inv_s[:, :, None]),
                0, 31).astype(np.uint8)  # [nb, 8, 32], 5-bit
    # pack: per 64-chunk c, ql byte l = q[2c][l] low4 | q[2c+1][l] high<<4;
    # qh bit (2c) of byte l = q[2c][l] bit4; bit (2c+1) = q[2c+1][l] bit4
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    for c in range(4):
        lo_sub, hi_sub = q[:, 2 * c], q[:, 2 * c + 1]
        ql[:, 32 * c:32 * (c + 1)] = (lo_sub & 0xF) | ((hi_sub & 0xF) << 4)
        qh |= ((lo_sub >> 4) & 1) << (2 * c)
        qh |= ((hi_sub >> 4) & 1) << (2 * c + 1)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = _pack_k_scales(sc6, mn6)
    out[:, 16:48] = qh
    out[:, 48:] = ql
    return out.reshape(-1)


def dequantize_q5_k(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:2777: per 64-chunk, low nibbles + qh bit u1 for the
    first 32, high nibbles + bit u2 for the second 32."""
    blocks = payload.reshape(-1, 176)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc6, mn6 = _unpack_k_scales(blocks[:, 4:16])  # [nb, 8]
    qh = blocks[:, 16:48]  # [nb, 32]
    ql = blocks[:, 48:].reshape(nb, 4, 32)
    out = np.empty((nb, 8, 32), np.float32)
    scale = d * sc6.astype(np.float32)  # [nb, 8]
    minv = dmin * mn6.astype(np.float32)
    for c in range(4):
        lo = (ql[:, c] & 0x0F) + (((qh >> (2 * c)) & 1) << 4)
        hi = (ql[:, c] >> 4) + (((qh >> (2 * c + 1)) & 1) << 4)
        out[:, 2 * c] = lo * scale[:, 2 * c, None] - minv[:, 2 * c, None]
        out[:, 2 * c + 1] = hi * scale[:, 2 * c + 1, None] - minv[:, 2 * c + 1, None]
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """float -> Q6_K: per-16 int8 scales vs fp16 superscale; x=d*sc*q,
    q in [-32, 31]."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    idx = np.argmax(np.abs(sub), axis=2)
    amax = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]
    s16 = amax / -32.0  # per-16 float scale
    d = np.abs(s16).max(axis=1) / 127.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    sc = np.clip(np.round(s16 * inv_d[:, None]), -127, 127).astype(np.int8)
    d16 = d.astype(np.float16)
    eff = d16.astype(np.float32)[:, None] * sc  # [nb, 16]
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1.0, eff), 0.0)
    q = np.clip(np.round(sub * inv_s[:, :, None]) + 32, 0, 63).astype(np.uint8)
    q = q.reshape(nb, QK_K)  # elements in natural order, 6-bit codes
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):  # 128-elem halves
        base = 128 * half
        ls = np.arange(32)
        q1 = q[:, base + ls]
        q2 = q[:, base + 32 + ls]
        q3 = q[:, base + 64 + ls]
        q4 = q[:, base + 96 + ls]
        ql[:, 64 * half + ls] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql[:, 64 * half + 32 + ls] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        qh[:, 32 * half + ls] = ((q1 >> 4) | ((q2 >> 4) << 2)
                                 | ((q3 >> 4) << 4) | ((q4 >> 4) << 6))
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, :128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d16[:, None].view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def dequantize_q6_k(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:2991: per 128-half, four 32-runs from low/high
    nibbles of ql + 2-bit planes of qh; per-16 int8 scales."""
    blocks = payload.reshape(-1, 210)
    nb = blocks.shape[0]
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)  # [nb, 16]
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)  # [nb,1]
    out = np.empty((nb, QK_K), np.float32)
    ls = np.arange(32)
    for half in range(2):
        base = 128 * half
        qlh = ql[:, 64 * half:64 * (half + 1)]
        qhh = qh[:, 32 * half:32 * (half + 1)]
        q1 = ((qlh[:, ls] & 0xF) | (((qhh >> 0) & 3) << 4)).astype(np.int32) - 32
        q2 = ((qlh[:, 32 + ls] & 0xF) | (((qhh >> 2) & 3) << 4)).astype(np.int32) - 32
        q3 = ((qlh[:, ls] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int32) - 32
        q4 = ((qlh[:, 32 + ls] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int32) - 32
        soff = 8 * half
        for qi, (qv, srange) in enumerate(
                [(q1, 0), (q2, 2), (q3, 4), (q4, 6)]):
            s_idx = soff + srange + ls // 16  # is = l/16 -> 0 or 1
            vals = qv * sc[np.arange(nb)[:, None], s_idx] * d
            out[:, base + 32 * qi + ls] = vals
    return out.reshape(-1)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    """float -> Q2_K: 16 sub-blocks of 16, 4-bit scales/mins vs fp16
    superscales, 2-bit quants; x = d*sc*q - dmin*mn (simple min/max
    fit, layout per ggml-common.h block_q2_K)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = np.maximum(sub.max(axis=2), 0.0)
    scale = (smax - smin) / 3.0
    neg_min = -smin
    d = scale.max(axis=1) / 15.0
    dmin = neg_min.max(axis=1) / 15.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    inv_dm = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1.0, dmin), 0.0)
    sc4 = np.clip(np.round(scale * inv_d[:, None]), 0, 15).astype(np.uint8)
    mn4 = np.clip(np.round(neg_min * inv_dm[:, None]), 0, 15).astype(np.uint8)
    d16 = d.astype(np.float16)
    dmin16 = dmin.astype(np.float16)
    eff_s = d16.astype(np.float32)[:, None] * sc4
    eff_m = dmin16.astype(np.float32)[:, None] * mn4
    inv_s = np.where(eff_s > 0, 1.0 / np.where(eff_s == 0, 1.0, eff_s), 0.0)
    q = np.clip(np.round((sub + eff_m[:, :, None]) * inv_s[:, :, None]),
                0, 3).astype(np.uint8)  # [nb, 16, 16]
    # pack: per 128-half h, byte l (0..31) holds 4 elems at 2-bit shifts
    # j=0..3; sub-block of (h, j, l) = 8h + 2j + (l >= 16)
    qs = np.zeros((nb, 2, 32), np.uint8)
    for h in range(2):
        for j in range(4):
            lo16 = q[:, 8 * h + 2 * j]
            hi16 = q[:, 8 * h + 2 * j + 1]
            run = np.concatenate([lo16, hi16], axis=1)  # [nb, 32]
            qs[:, h] |= run << (2 * j)
    out = np.empty((nb, 84), np.uint8)
    out[:, :16] = (sc4 | (mn4 << 4))
    out[:, 16:80] = qs.reshape(nb, 64)
    out[:, 80:82] = d16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 82:84] = dmin16[:, None].view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def dequantize_q2_k(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:1993 (dequantize_row_q2_K)."""
    blocks = payload.reshape(-1, 84)
    nb = blocks.shape[0]
    sc4 = (blocks[:, :16] & 0xF).astype(np.float32)
    mn4 = (blocks[:, :16] >> 4).astype(np.float32)
    qs = blocks[:, 16:80].reshape(nb, 2, 32)
    d = blocks[:, 80:82].copy().view(np.float16).astype(np.float32)  # [nb,1]
    dmin = blocks[:, 82:84].copy().view(np.float16).astype(np.float32)
    scale = d * sc4  # [nb, 16]
    minv = dmin * mn4
    out = np.empty((nb, 16, 16), np.float32)
    for h in range(2):
        for j in range(4):
            run = (qs[:, h] >> (2 * j)) & 3  # [nb, 32]
            for half16 in range(2):
                s = 8 * h + 2 * j + half16
                out[:, s] = (run[:, 16 * half16:16 * (half16 + 1)]
                             * scale[:, s, None] - minv[:, s, None])
    return out.reshape(-1)


def _pack_q3_scales(sc6: np.ndarray) -> np.ndarray:
    """16 six-bit scales -> 12 bytes (inverse of the kmask decode,
    ggml-quants.c:2341-2364). sc6: [nb, 16] uint8 in 0..63."""
    nb = sc6.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    out[:, 0:4] = (sc6[:, 0:4] & 0xF) | ((sc6[:, 8:12] & 0xF) << 4)
    out[:, 4:8] = (sc6[:, 4:8] & 0xF) | ((sc6[:, 12:16] & 0xF) << 4)
    out[:, 8:12] = ((sc6[:, 0:4] >> 4) | ((sc6[:, 4:8] >> 4) << 2)
                    | ((sc6[:, 8:12] >> 4) << 4) | ((sc6[:, 12:16] >> 4) << 6))
    return out


def _unpack_q3_scales(b12: np.ndarray) -> np.ndarray:
    """12 bytes -> 16 six-bit scale codes [nb, 16] (0..63)."""
    lo = np.concatenate([b12[..., 0:4] & 0xF, b12[..., 4:8] & 0xF,
                         b12[..., 0:4] >> 4, b12[..., 4:8] >> 4], axis=-1)
    t = b12[..., 8:12]
    hi = np.concatenate([(t >> 0) & 3, (t >> 2) & 3,
                         (t >> 4) & 3, (t >> 6) & 3], axis=-1)
    return (lo | (hi << 4)).astype(np.uint8)


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    """float -> Q3_K: 16 sub-blocks of 16, 6-bit signed scales vs fp16
    superscale, 3-bit signed quants; x = d*(sc-32)*q, q in [-4, 3]."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    idx = np.argmax(np.abs(sub), axis=2)
    amax = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]
    s16 = amax / -4.0
    d = np.abs(s16).max(axis=1) / 31.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    sc6 = np.clip(np.round(s16 * inv_d[:, None]) + 32, 0, 63).astype(np.uint8)
    d16 = d.astype(np.float16)
    eff = d16.astype(np.float32)[:, None] * (sc6.astype(np.float32) - 32)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1.0, eff), 0.0)
    q = np.clip(np.round(sub * inv_s[:, :, None]), -4, 3).astype(np.int8)
    v = (q + 4).astype(np.uint8)  # stored code 0..7
    qs = np.zeros((nb, 2, 32), np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    for h in range(2):
        for j in range(4):
            lo16 = v[:, 8 * h + 2 * j]
            hi16 = v[:, 8 * h + 2 * j + 1]
            run = np.concatenate([lo16, hi16], axis=1)  # [nb, 32]
            qs[:, h] |= (run & 3) << (2 * j)
            # hmask bit SET means "do not subtract 4" (code >= 4)
            hmask |= (run >> 2) << (4 * h + j)
    out = np.empty((nb, 110), np.uint8)
    out[:, :32] = hmask
    out[:, 32:96] = qs.reshape(nb, 64)
    out[:, 96:108] = _pack_q3_scales(sc6)
    out[:, 108:110] = d16[:, None].view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def dequantize_q3_k(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:2341 (dequantize_row_q3_K)."""
    blocks = payload.reshape(-1, 110)
    nb = blocks.shape[0]
    hmask = blocks[:, :32]
    qs = blocks[:, 32:96].reshape(nb, 2, 32)
    sc6 = _unpack_q3_scales(blocks[:, 96:108]).astype(np.float32) - 32
    d = blocks[:, 108:110].copy().view(np.float16).astype(np.float32)
    scale = d * sc6  # [nb, 16]
    out = np.empty((nb, 16, 16), np.float32)
    for h in range(2):
        for j in range(4):
            q2 = (qs[:, h] >> (2 * j)) & 3  # [nb, 32]
            hbit = (hmask >> (4 * h + j)) & 1
            run = q2.astype(np.int32) - np.where(hbit > 0, 0, 4)
            for half16 in range(2):
                s = 8 * h + 2 * j + half16
                out[:, s] = (run[:, 16 * half16:16 * (half16 + 1)]
                             * scale[:, s, None])
    return out.reshape(-1)


# non-linear 4-bit codebook (ggml-quants.c:3754)
KVALUES_IQ4NL = np.array([-127, -104, -83, -65, -49, -35, -22, -10,
                          1, 13, 25, 38, 53, 69, 89, 113], np.float32)


def _nearest_iq4(x: np.ndarray) -> np.ndarray:
    """Indices of the nearest KVALUES_IQ4NL entry (x pre-scaled)."""
    return np.abs(x[..., None] - KVALUES_IQ4NL).argmin(axis=-1).astype(np.uint8)


def quantize_iq4_nl(x: np.ndarray) -> np.ndarray:
    """float -> IQ4_NL: 32-block fp16 scale + non-linear 4-bit codes;
    x = d * table[q] (nearest-entry fit)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0  # table spans [-127, 113]
    d16 = d.astype(np.float16)
    df = d16.astype(np.float32)
    inv = np.where(df > 0, 1.0 / np.where(df == 0, 1.0, df), 0.0)
    q = _nearest_iq4(x * inv[:, None])  # [nb, 32]
    out = np.empty((nb, 18), np.uint8)
    out[:, :2] = d16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_iq4_nl(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:3756 (dequantize_row_iq4_nl)."""
    blocks = payload.reshape(-1, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return (KVALUES_IQ4NL[q] * d).reshape(-1)


def quantize_iq4_xs(x: np.ndarray) -> np.ndarray:
    """float -> IQ4_XS: 256-superblock, per-32 6-bit scales vs fp16
    superscale over the IQ4 non-linear codebook; x = d*(ls-32)*table[q]."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    amax = np.abs(sub).max(axis=2)
    s = amax / 127.0  # per-32 fp scale onto the table's range
    d = s.max(axis=1) / 31.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    ls = np.clip(np.round(s * inv_d[:, None]) + 32, 0, 63).astype(np.uint8)
    d16 = d.astype(np.float16)
    eff = d16.astype(np.float32)[:, None] * (ls.astype(np.float32) - 32)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1.0, eff), 0.0)
    q = _nearest_iq4(sub * inv_s[:, :, None])  # [nb, 8, 32]
    qs = (q[:, :, :16] | (q[:, :, 16:] << 4)).reshape(nb, 128)
    ls_l = ls & 0xF  # [nb, 8]
    ls_h = (ls >> 4).astype(np.uint16)  # 2 bits each
    scales_h = np.zeros(nb, np.uint16)
    for ib in range(8):
        scales_h |= ls_h[:, ib] << (2 * ib)
    out = np.empty((nb, 136), np.uint8)
    out[:, :2] = d16[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = scales_h[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = ls_l[:, 0::2] | (ls_l[:, 1::2] << 4)
    out[:, 8:] = qs
    return out.reshape(-1)


def dequantize_iq4_xs(payload: np.ndarray) -> np.ndarray:
    """ggml-quants.c:3774 (dequantize_row_iq4_xs)."""
    blocks = payload.reshape(-1, 136)
    nb = blocks.shape[0]
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    scales_h = blocks[:, 2:4].copy().view(np.uint16)[:, 0]
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:].reshape(nb, 8, 16)
    ib = np.arange(8)
    ls_l = np.where(ib[None, :] % 2 == 0,
                    scales_l[:, ib // 2] & 0xF, scales_l[:, ib // 2] >> 4)
    ls_h = (scales_h[:, None] >> (2 * ib)) & 3
    ls = (ls_l | (ls_h << 4)).astype(np.float32) - 32  # [nb, 8]
    scale = d * ls
    q = np.concatenate([qs & 0xF, qs >> 4], axis=2)  # [nb, 8, 32]
    return (KVALUES_IQ4NL[q] * scale[:, :, None]).reshape(-1)


def dequantize(payload: np.ndarray, ggml_type: int) -> np.ndarray:
    """Dispatch dequant of a raw uint8 payload to float32 (flat)."""
    t = GGMLType(ggml_type)
    if t == GGMLType.F32:
        return payload.copy().view(np.float32)
    if t == GGMLType.F16:
        return payload.copy().view(np.float16).astype(np.float32)
    if t == GGMLType.BF16:
        u = payload.copy().view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    if t == GGMLType.Q4_0:
        return dequantize_q4_0(payload)
    if t == GGMLType.Q4_1:
        return dequantize_q4_1(payload)
    if t == GGMLType.Q5_0:
        return dequantize_q5_0(payload)
    if t == GGMLType.Q5_1:
        return dequantize_q5_1(payload)
    if t == GGMLType.Q8_0:
        return dequantize_q8_0(payload)
    if t == GGMLType.Q2_K:
        return dequantize_q2_k(payload)
    if t == GGMLType.Q3_K:
        return dequantize_q3_k(payload)
    if t == GGMLType.Q4_K:
        return dequantize_q4_k(payload)
    if t == GGMLType.Q5_K:
        return dequantize_q5_k(payload)
    if t == GGMLType.Q6_K:
        return dequantize_q6_k(payload)
    if t == GGMLType.IQ4_NL:
        return dequantize_iq4_nl(payload)
    if t == GGMLType.IQ4_XS:
        return dequantize_iq4_xs(payload)
    if t == GGMLType.I32:
        return payload.copy().view(np.int32).astype(np.float32)
    raise NotImplementedError(f"dequantize for ggml type {t}")


def quantize(x: np.ndarray, ggml_type: int) -> np.ndarray:
    t = GGMLType(ggml_type)
    if t == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8).reshape(-1)
    if t == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float16).view(np.uint8).reshape(-1)
    if t == GGMLType.Q4_0:
        return quantize_q4_0(x)
    if t == GGMLType.Q4_1:
        return quantize_q4_1(x)
    if t == GGMLType.Q5_0:
        return quantize_q5_0(x)
    if t == GGMLType.Q8_0:
        return quantize_q8_0(x)
    if t == GGMLType.Q2_K:
        return quantize_q2_k(x)
    if t == GGMLType.Q3_K:
        return quantize_q3_k(x)
    if t == GGMLType.Q4_K:
        return quantize_q4_k(x)
    if t == GGMLType.Q5_K:
        return quantize_q5_k(x)
    if t == GGMLType.Q6_K:
        return quantize_q6_k(x)
    if t == GGMLType.IQ4_NL:
        return quantize_iq4_nl(x)
    if t == GGMLType.IQ4_XS:
        return quantize_iq4_xs(x)
    raise NotImplementedError(f"quantize for ggml type {t}")


# ---------------------------------------------------------------------------
# repacking to the [K, N] kernel layout
# ---------------------------------------------------------------------------

@dataclass
class QuantizedTensor:
    """Kernel-layout weight: y = x @ dequant(q) with K on rows, N on cols.

    dequant(q)[k, n] = q[k, n] * scales[k // 32, n] - (bias[k // 32, n] if bias)
    q holds signed values with zero-point pre-subtracted (Q4_0: q-8;
    Q4_K: unsigned 0..15 with the min folded into bias).
    """

    q: np.ndarray  # int8 [K, N]
    scales: np.ndarray  # float32 [K//32, N]
    bias: np.ndarray | None  # float32 [K//32, N] or None
    ggml_type: int

    @property
    def k(self) -> int:
        return self.q.shape[0]

    @property
    def n(self) -> int:
        return self.q.shape[1]

    def dequant(self) -> np.ndarray:
        w = self.q.astype(np.float32) * np.repeat(self.scales, QK, axis=0)
        if self.bias is not None:
            w = w - np.repeat(self.bias, QK, axis=0)
        return w


def repack_gguf_tensor(payload: np.ndarray, ggml_type: int,
                       shape: tuple[int, int]) -> QuantizedTensor:
    """GGUF weight payload (numpy-order shape [N_out, K_in], quant blocks
    along K within each output row) -> transposed kernel layout [K, N_out]."""
    n_out, k_in = shape
    t = GGMLType(ggml_type)
    if t == GGMLType.Q4_0:
        blocks = payload.reshape(n_out, k_in // QK, 18)
        d = blocks[:, :, :2].copy().view(np.float16).astype(np.float32)[..., 0]
        qs = blocks[:, :, 2:]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        q = np.concatenate([lo, hi], axis=2)  # [N, KB, 32]
        q = q.reshape(n_out, k_in).T.copy()  # [K, N]
        scales = d.T.copy()  # [K//32, N]
        return QuantizedTensor(q, scales, None, ggml_type)
    if t == GGMLType.Q8_0:
        blocks = payload.reshape(n_out, k_in // QK, 34)
        d = blocks[:, :, :2].copy().view(np.float16).astype(np.float32)[..., 0]
        q = blocks[:, :, 2:].view(np.int8).reshape(n_out, k_in).T.copy()
        return QuantizedTensor(q, d.T.copy(), None, ggml_type)
    if t == GGMLType.Q4_K:
        blocks = payload.reshape(n_out, k_in // QK_K, 144)
        nsb = k_in // QK_K
        d = blocks[:, :, 0:2].copy().view(np.float16).astype(np.float32)[..., 0]
        dmin = blocks[:, :, 2:4].copy().view(np.float16).astype(np.float32)[..., 0]
        sc6, mn6 = _unpack_k_scales(blocks[:, :, 4:16])  # [N, nsb, 8]
        qs = blocks[:, :, 16:].reshape(n_out, nsb, 4, 32)
        lo = (qs & 0x0F).astype(np.int8)
        hi = (qs >> 4).astype(np.int8)
        q = np.stack([lo, hi], axis=3).reshape(n_out, k_in)  # [N, K]
        scales = (d[:, :, None] * sc6).reshape(n_out, k_in // QK)  # per-32 scale
        bias = (dmin[:, :, None] * mn6).reshape(n_out, k_in // QK)
        return QuantizedTensor(q.T.copy(), scales.T.copy(), bias.T.copy(), ggml_type)
    if t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.Q4_1,
             GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q2_K, GGMLType.Q3_K,
             GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.IQ4_NL,
             GGMLType.IQ4_XS):
        # exact dequant + per-32 int8 requant on load so every format
        # shares the Q8_0 kernel path. int8/32-block resolution sits well
        # inside Q4_1/Q5/Q6's own quantization error (real llama.cpp
        # Q4_K_M files carry Q6_K output/ffn_down tensors — reference
        # decodes the full zoo, libs/ggml/include/ggml.h:398-412).
        w = dequantize(payload, t).reshape(n_out, k_in)
        amax = np.abs(w.reshape(n_out, k_in // QK, QK)).max(axis=2)
        d = (amax / 127.0).astype(np.float32)
        inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
        q = np.clip(np.round(w.reshape(n_out, k_in // QK, QK) * inv[:, :, None]),
                    -127, 127).astype(np.int8).reshape(n_out, k_in)
        return QuantizedTensor(q.T.copy(), d.T.copy(), None, GGMLType.Q8_0)
    raise NotImplementedError(f"repack for ggml type {t}")


def choose_pack_group(k: int, max_group: int = 2048) -> int:
    """Largest group G <= max_group with K % G == 0 and G % 64 == 0.

    The fused kernel K-tiles at the pack-group granularity: within each
    group, low nibbles hold the first half of the group's k range and
    high nibbles the second half, so the in-kernel unpack of one tile is
    a single concat (no interleave, no reshape). G % 64 keeps the halves
    aligned to 32-element scale blocks."""
    for g in range(min(max_group, k), 63, -64):
        if k % g == 0 and g % 64 == 0:
            return g
    raise ValueError(f"K={k} has no 64-aligned pack group")


def pack_nib4(q: np.ndarray, group: int | None = None,
              signed_bias: bool = False) -> np.ndarray:
    """int8 [K, N] -> uint8 [K//2, N], packed per group of `group` rows:
    within group g, output row o (o < group/2) packs k = g*group + o
    (low nibble) and k = g*group + group/2 + o (high nibble).

    signed_bias=True: values are signed [-8, 7] and stored BIASED as
    q+8 (0..15) so the kernel's dequant is affine (w = nib*s - 8s) —
    two's-complement nibbles are not affine-decodable."""
    k, n = q.shape
    group = group or choose_pack_group(k)
    qi = q.astype(np.int16) + (8 if signed_bias else 0)
    u = (qi & 0xF).astype(np.uint8)
    ug = u.reshape(k // group, group, n)
    half = group // 2
    return (ug[:, :half] | (ug[:, half:] << 4)).reshape(k // 2, n)
