// Shared pieces of the port's Hopper kernels: the quantized weight
// descriptor, the dequant of one 32-row scale block for four adjacent
// output columns, and small numeric helpers.
//
// Weight layout (powerserve_tpu_torch/core/quant.py, ops/qmatmul.py):
//   q       packed: uint8 [K/2, N], nibbles in pack groups of G rows —
//           within group g, byte row g*G/2 + i holds k = g*G + i in its
//           low nibble and k = g*G + G/2 + i in its high nibble;
//           unpacked: int8 [K, N]
//   scales  f32 or bf16 [K/32, N]
//   bias    same type [K/32, N] (Q4_K per-block minimum) or null
//   w[k, n] = (val(k, n) - offset) * scales[k/32, n] - bias[k/32, n]
// where offset is 8 for signed packed nibbles (stored +8) and 0 otherwise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PS_EXPORT extern "C" __attribute__((visibility("default")))

#define PS_NEG_INF (-1e30f)

struct QWeight {
  const uint8_t* q;
  const void* scales;
  const void* bias;  // may be null
  int K;
  int N;
  int packed;  // 1: nibble-packed in groups of `group` rows
  int group;
  int offset;  // subtracted from every stored value (8 or 0)
  int scale_bf16;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float ld_scale(const void* p, long idx, int bf16) {
  if (bf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[idx]);
  return reinterpret_cast<const float*>(p)[idx];
}

// First stored row of scale block kb and the nibble shift that selects
// it (0 low, 4 high); an unpacked weight stores row k at row k.
__device__ __forceinline__ long block_row(const QWeight& w, int kb, int* shift) {
  int k0 = kb * 32;
  if (!w.packed) {
    *shift = 0;
    return k0;
  }
  int half = w.group / 2;
  int g = k0 / w.group;
  int r = k0 - g * w.group;
  *shift = r < half ? 0 : 4;
  return (long)g * half + (r < half ? r : r - half);
}

// Four bytes of stored row `row` at columns n0..n0+3; columns past N
// read as zero. vec: N % 4 == 0, so the word load is aligned.
__device__ __forceinline__ uint32_t ld_row4(const uint8_t* q, long row, int n0,
                                            int N, bool vec) {
  const uint8_t* p = q + row * (long)N + n0;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n0 + j < N) v |= (uint32_t)__ldg(p + j) << (8 * j);
  return v;
}

__device__ __forceinline__ float dequant_byte(uint32_t word, int j, int shift,
                                              const QWeight& w, float s,
                                              float b) {
  int val;
  if (w.packed)
    val = (int)((word >> (8 * j + shift)) & 15u) - w.offset;
  else
    val = (int)(int8_t)((word >> (8 * j)) & 255u);
  return (float)val * s - b;
}

// acc[m][j] += sum over the 32 rows k of block kb of
//   x[m, k] * w[k, n0 + j]  (m < M, x bf16 with row stride x_stride;
//   x may point to global or shared memory).
template <int MT>
__device__ __forceinline__ void gemv_block(const QWeight& w, int kb, int n0,
                                           bool vec,
                                           const __nv_bfloat16* x,
                                           long x_stride, int M,
                                           float (&acc)[MT][4]) {
  float s[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int n = n0 + j;
    bool ok = n < w.N;
    long idx = (long)kb * w.N + n;
    s[j] = ok ? ld_scale(w.scales, idx, w.scale_bf16) : 0.f;
    b[j] = (ok && w.bias) ? ld_scale(w.bias, idx, w.scale_bf16) : 0.f;
  }
  int shift;
  long row0 = block_row(w, kb, &shift);
  const __nv_bfloat16* xk = x + kb * 32;
  // all 32 row loads are issued before any is used, so each thread keeps
  // 128 bytes of weights in flight (the decode GEMV is latency-bound on
  // these loads otherwise)
  uint32_t words[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) words[i] = ld_row4(w.q, row0 + i, n0, w.N, vec);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t word = words[i];
    float wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = dequant_byte(word, j, shift, w, s[j], b[j]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float xv = __bfloat162float(xk[m * x_stride + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
  }
}
