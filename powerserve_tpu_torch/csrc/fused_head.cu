// Fused decode head: rms-norm prologue + dequant matmul + optional
// greedy argmax, for M <= 16 rows.
//
//   xn[m, k] = bf16( (x[m, k] * rsqrt(mean_k x[m]^2 + eps)) * nw[k] )
//   y[m, n]  = sum_k xn[m, k] * w[k, n]          (f32 dequant, f32 sum)
//   out      = y (f32 [M, N])  or  argmax_n y[m, n] (int32 [M], first
//              occurrence on ties, as jnp.argmax)
//
// Replaces the TPU kernel powerserve_tpu/ops/fused.py::_fused_pallas
// (body _make_fused_kernel) in its "norm" prologue scope, with and
// without the argmax epilogue — the decode lm_head of the main path.
//
// What bounds it on an H100: weight bytes. The 8B head (K = 4096,
// N = 128256, Q4_K with bf16 scales and mins) reads ~0.33 GB, ~98 us at
// 3.35 TB/s. The design: every block recomputes the tiny prologue (the
// row sums of squares over K, then the normalized bf16 rows into shared
// memory, M * K * 2 bytes), then runs the same four-columns-per-thread
// GEMV as the qmatmul kernel over its 128 columns, the eight warps
// splitting K. N / 128 = 1002 blocks keep every SM busy without a K
// split. The TPU kernel carries the running argmax across its
// sequential grid in scratch; GPU blocks run in no order, so each block
// writes its (max, first index) pair per row and a second tiny pass
// reduces the pairs, preferring the smaller index on equal values.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kWarps = 8;

__device__ __forceinline__ float ld_x(const void* x, long i, int bf16) {
  return ld_scale(x, i, bf16);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int MT>
__global__ __launch_bounds__(256) void fused_head_kernel(
    QWeight w, const void* xin, int x_bf16, int M, const float* norm_w,
    float eps, float* logits, float* best_val, int* best_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float red[kWarps][kCols];
  __shared__ float rstd[MT];
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + lane;
  const int K = w.K, N = w.N;

  // prologue: per-row rms over K, then the bf16 normalized rows
  for (int m = 0; m < M; ++m) {
    float ss = 0.f;
    for (int k = tid; k < K; k += 256) {
      float a = ld_x(xin, (long)m * K + k, x_bf16);
      ss = fmaf(a, a, ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) red[0][ty] = ss;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
#pragma unroll
      for (int t = 0; t < kWarps; ++t) tot += red[0][t];
      rstd[m] = rsqrtf(tot / (float)K + eps);  // as torch.rsqrt on CUDA
    }
    __syncthreads();
  }
  for (int e = tid; e < M * K; e += 256) {
    int m = e / K, k = e - m * K;
    float a = ld_x(xin, e, x_bf16);
    xn[e] = __float2bfloat16(a * rstd[m] * norm_w[k]);
  }
  __syncthreads();

  const int n0 = (blockIdx.x * 32 + lane) * 4;
  const bool vec = (N % 4) == 0;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  if (n0 < N)
    for (int kb = ty; kb < K / 32; kb += kWarps)
      gemv_block<MT>(w, kb, n0, vec, xn, K, M, acc);

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty][lane * 4 + j] = acc[m][j];
      __syncthreads();
      if (ty == 0) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = 0.f;
#pragma unroll
          for (int t = 0; t < kWarps; ++t) v[j] += red[t][lane * 4 + j];
        }
        if (logits) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < N) logits[(long)m * N + n0 + j] = v[j];
        } else {
          float bv = -INFINITY;
          int bi = INT_MAX;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < N && better(v[j], n0 + j, bv, bi)) {
              bv = v[j];
              bi = n0 + j;
            }
#pragma unroll
          for (int o = 16; o; o >>= 1) {
            float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (better(ov, oi, bv, bi)) {
              bv = ov;
              bi = oi;
            }
          }
          if (lane == 0) {
            best_val[(long)blockIdx.x * M + m] = bv;
            best_idx[(long)blockIdx.x * M + m] = bi;
          }
        }
      }
      __syncthreads();
    }
  }
}

// one block per row: reduce the per-block (max, index) pairs
__global__ __launch_bounds__(256) void argmax_reduce_kernel(
    const float* best_val, const int* best_idx, int nblk, int M, int* out) {
  __shared__ float sv[8];
  __shared__ int si[8];
  const int m = blockIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
    float v = best_val[(long)b * M + m];
    int i = best_idx[(long)b * M + m];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 1; t < (int)(blockDim.x / 32); ++t)
      if (better(sv[t], si[t], bv, bi)) {
        bv = sv[t];
        bi = si[t];
      }
    out[m] = bi == INT_MAX ? 0 : bi;
  }
}

template <int MT>
int launch_head(const QWeight& w, const void* x, int x_bf16, int M,
                const float* nw, float eps, float* logits, float* bval,
                int* bidx, cudaStream_t stream) {
  const size_t smem = (size_t)M * w.K * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_head_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w.N + kCols - 1) / kCols);
  dim3 block(32, kWarps);
  fused_head_kernel<MT><<<grid, block, smem, stream>>>(w, x, x_bf16, M, nw, eps,
                                                       logits, bval, bidx);
  return 0;
}

}  // namespace

// x f32/bf16 [M, K] (M <= 16); norm_w f32 [K]. logits f32 [M, N] when
// out_idx is null; else best_val/best_idx [ceil(N/128), M] scratch and
// out_idx int32 [M]. Returns a CUDA error code (0 on success).
PS_EXPORT int ps_fused_head(const void* x, int x_bf16, const void* norm_w,
                            float eps, const void* q, const void* scales,
                            const void* bias, int M, int K, int N, int packed,
                            int group, int offset, int scale_bf16,
                            void* logits, void* best_val, void* best_idx,
                            void* out_idx, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, bias, K, N,
            packed, group, offset, scale_bf16};
  const float* nw = reinterpret_cast<const float*>(norm_w);
  float* lg = out_idx ? nullptr : reinterpret_cast<float*>(logits);
  float* bv = reinterpret_cast<float*>(best_val);
  int* bi = reinterpret_cast<int*>(best_idx);
  int rc;
  if (M <= 1)
    rc = launch_head<1>(w, x, x_bf16, M, nw, eps, lg, bv, bi, stream);
  else if (M <= 2)
    rc = launch_head<2>(w, x, x_bf16, M, nw, eps, lg, bv, bi, stream);
  else if (M <= 4)
    rc = launch_head<4>(w, x, x_bf16, M, nw, eps, lg, bv, bi, stream);
  else if (M <= 8)
    rc = launch_head<8>(w, x, x_bf16, M, nw, eps, lg, bv, bi, stream);
  else
    rc = launch_head<16>(w, x, x_bf16, M, nw, eps, lg, bv, bi, stream);
  if (rc) return rc;
  if (out_idx) {
    const int nblk = (N + kCols - 1) / kCols;
    argmax_reduce_kernel<<<M, 256, 0, stream>>>(bv, bi, nblk, M,
                                                reinterpret_cast<int*>(out_idx));
  }
  return (int)cudaGetLastError();
}
