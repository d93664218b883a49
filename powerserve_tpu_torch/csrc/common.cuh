// Shared pieces of the port's Hopper kernels: the quantized weight
// descriptor, the tensor-core and copy primitives (mma.sync m16n8k16
// bf16 -> f32, ldmatrix, cp.async, wgmma operand descriptors and
// fences, the TMA tensor-map encoder) and small numeric helpers.
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

#include <cuda.h>
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes 0 and 2 of v as signed int8 values in two bf16 halves, exactly,
// without a conversion instruction: a byte h * 128 + m (m its low seven
// bits) is m - 128 h; (0x4300 | m) is 128 + m and (0x4300 | h << 7) is
// 128 (h = 0) or 256 (h = 1), so one bf16x2 subtraction gives the value.
__device__ __forceinline__ uint32_t i8_even_bf16x2(uint32_t v) {
  uint32_t a = (v & 0x007F007Fu) | 0x43004300u;
  uint32_t b = (v & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b (no accumulator input)
__device__ __forceinline__ void mma_16816_zero(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// valid ? 16 bytes : zeros; the L2 fetches the 128-byte line around a
// miss
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// valid ? 4 bytes : zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// lanes 0-7 address the rows of the first matrix, 8-15 the second's, ...
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 2^x by the special function unit (ex2.approx: 2 ulp, subnormals flushed)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lanes 0-7 address the rows of the first matrix, 8-15 the second's
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ float ld_scale(const void* p, long idx, int bf16) {
  if (bf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[idx]);
  return reinterpret_cast<const float*>(p)[idx];
}

// A wgmma operand in shared memory. swizzle 0: 8 x 16-byte core matrices
// (128 contiguous bytes), lbo the byte stride between core matrices
// along K, sbo along M or N (K-major and MN-major alike); swizzle 2: rows
// of 64 bytes under the 64-byte swizzle, sbo the stride of 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo,
                                              int swizzle = 0) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled (a TMA tensor map), looked up at run time: the
// library links the CUDA runtime alone.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The SMs of the current device (looked up once).
static inline int sm_count() {
  static int n = 0;
  if (!n) {
    int d = 0;
    cudaGetDevice(&d);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d);
  }
  return n;
}
