// Fused linear: prologue + dequant matmul + epilogue, for M <= 16 rows.
//
//   x[m, k]  = prologue (one of)
//     x:       bf16(a0[m, k])
//     norm:    a = a0 + a1 + a2 (f32, the operands given, in order);
//              bf16( (a[m, k] * rsqrt(mean_k a[m]^2 + eps)) * nw[k] )
//     glu:     g = gu[m, k], u = gu[m, K + k] (gu f32 [M, 2K]);
//              bf16( (g * (1 / (1 + exp(-g)))) * u )
//     concat2: bf16([a0 | a1][m, k]) (a0 [M, K1], a1 [M, K - K1])
//   y[m, n]  = sum_k x[m, k] * w[k, n]          (f32 dequant, f32 sum)
//   y       += bias[n];  y = (r0[m, n] + r1[m, n]) + y   (as given)
//   out      = y (f32 [M, N])  or  argmax_n y[m, n] (int32 [M], first
//              occurrence on ties, as jnp.argmax)
//
// Replaces the TPU kernel powerserve_tpu/ops/fused.py::_fused_pallas
// (body _make_fused_kernel): all four prologues, the bias and residual
// epilogues and the argmax epilogue — the lm_head of every decode step,
// and the fused decode-layer chain and factored head of speculative
// drafts.
//
// What bounds it on an H100: weight bytes (the 8B head, K = 4096,
// N = 128256 Q4_K with bf16 scales and mins, ~0.33 GB, ~98 us at
// 3.35 TB/s; the glu down-projection, K = 14336, N = 4096, ~33 MB). The
// design: a block per 128 output columns (N / 128 blocks keep the SMs
// busy without a K split), eight warps splitting K into 32-row scale
// blocks, each lane four adjacent columns — the qmatmul GEMV body. The
// TPU kernel builds the whole prologue row in VMEM (glu per pack group);
// staging a whole [M, K] bf16 row in shared memory does not fit the glu
// down-projection (16 x 14336 x 2 bytes is past the 227 KB a block may
// have), so each warp forms the prologue of the 32 k it is about to
// multiply, for all M rows, into its own 32-wide shared slice: lane i
// computes k = 32 kb + i, the warp syncs, then runs the GEMV on the
// slice. The norm's per-row mean square is the one whole-row quantity;
// every block computes it first (a sum over K of the operand sum). The
// TPU kernel carries the running argmax across its sequential grid in
// scratch; GPU blocks run in no order, so each block writes its (max,
// first index) pair per row and a second tiny pass reduces the pairs,
// preferring the smaller index on equal values.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kWarps = 8;

enum Prologue { kX = 0, kNorm = 1, kGlu = 2, kConcat2 = 3 };

struct Operand {
  const void* p;
  int bf16;
};

struct FusedArgs {
  Operand pro[3];
  int n_pro;
  int mode;
  int k1;  // concat2: width of the first part
  const float* nw;
  float eps;
  const float* bias;  // f32 [N] or null
  Operand res[2];
  int n_res;
  int M;
  float* logits;  // f32 [M, N], or null for argmax
  float* best_val;
  int* best_idx;
};

__device__ __forceinline__ float ld(const Operand& o, long i) {
  return ld_scale(o.p, i, o.bf16);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float norm_sum(const FusedArgs& a, long i) {
  float s = ld(a.pro[0], i);
  for (int j = 1; j < a.n_pro; ++j) s += ld(a.pro[j], i);
  return s;
}

// the prologue value of row m, column k, before the bf16 rounding
__device__ __forceinline__ float prologue(const FusedArgs& a, int K, int m,
                                          int k, const float* rstd) {
  switch (a.mode) {
    case kNorm:
      return norm_sum(a, (long)m * K + k) * rstd[m] * a.nw[k];
    case kGlu: {
      const float g = ld(a.pro[0], (long)m * 2 * K + k);
      const float u = ld(a.pro[0], (long)m * 2 * K + K + k);
      return g * (1.f / (1.f + expf(-g))) * u;
    }
    case kConcat2:
      return k < a.k1 ? ld(a.pro[0], (long)m * a.k1 + k)
                      : ld(a.pro[1], (long)m * (K - a.k1) + k - a.k1);
    default:
      return ld(a.pro[0], (long)m * K + k);
  }
}

template <int MT>
__global__ __launch_bounds__(256) void fused_linear_kernel(QWeight w,
                                                           FusedArgs a) {
  __shared__ __align__(16) __nv_bfloat16 slice[kWarps][MT * 32];
  __shared__ float red[kWarps][kCols];
  __shared__ float rstd[MT];
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + lane;
  const int K = w.K, N = w.N, M = a.M;

  // norm: per-row rms of the operand sum over K
  if (a.mode == kNorm) {
    for (int m = 0; m < M; ++m) {
      float ss = 0.f;
      for (int k = tid; k < K; k += 256) {
        const float s = norm_sum(a, (long)m * K + k);
        ss = fmaf(s, s, ss);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) red[0][ty] = ss;
      __syncthreads();
      if (tid == 0) {
        float tot = 0.f;
#pragma unroll
        for (int t = 0; t < kWarps; ++t) tot += red[0][t];
        rstd[m] = rsqrtf(tot / (float)K + a.eps);  // as torch.rsqrt on CUDA
      }
      __syncthreads();
    }
  }

  const int n0 = (blockIdx.x * 32 + lane) * 4;
  const bool vec = (N % 4) == 0;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  __nv_bfloat16* xs = slice[ty];
  for (int kb = ty; kb < K / 32; kb += kWarps) {
    const int k = kb * 32 + lane;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) xs[m * 32 + lane] = __float2bfloat16(prologue(a, K, m, k, rstd));
    __syncwarp();
    if (n0 < N) gemv_block_at<MT>(w, kb, n0, vec, xs, 32, M, acc);
    __syncwarp();
  }

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
          const int n = n0 + j;
          if (n < N) {
            if (a.bias) v[j] += a.bias[n];
            if (a.n_res) {
              float rs = ld(a.res[0], (long)m * N + n);
              if (a.n_res > 1) rs += ld(a.res[1], (long)m * N + n);
              v[j] = rs + v[j];
            }
          }
        }
        if (a.logits) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j < N) a.logits[(long)m * N + n0 + j] = v[j];
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
            a.best_val[(long)blockIdx.x * M + m] = bv;
            a.best_idx[(long)blockIdx.x * M + m] = bi;
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
void launch(const QWeight& w, const FusedArgs& a, cudaStream_t stream) {
  dim3 grid((w.N + kCols - 1) / kCols);
  dim3 block(32, kWarps);
  fused_linear_kernel<MT><<<grid, block, 0, stream>>>(w, a);
}

}  // namespace

// mode: 0 x, 1 norm, 2 glu, 3 concat2; p0..p2 the prologue operands
// (n_pro of them; bit i of pro_bf16 set when operand i is bf16, else
// f32), [M, K] each except glu ([M, 2K]) and concat2 ([M, k1], [M, K -
// k1]); norm_w f32 [K] (norm only). bias f32 [N] or null; r0, r1 the
// n_res residuals [M, N] (bit i of res_bf16: bf16). logits f32 [M, N]
// when out_idx is null; else best_val/best_idx [ceil(N/128), M] scratch
// and out_idx int32 [M]. Returns a CUDA error code (0 on success).
PS_EXPORT int ps_fused_linear(int mode, int n_pro, const void* p0,
                              const void* p1, const void* p2, int pro_bf16,
                              int k1, const void* norm_w, float eps,
                              const void* q, const void* scales,
                              const void* wmin, int M, int K, int N,
                              int packed, int group, int offset,
                              int scale_bf16, const void* bias, int n_res,
                              const void* r0, const void* r1, int res_bf16,
                              void* logits, void* best_val, void* best_idx,
                              void* out_idx, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, wmin, K, N,
            packed, group, offset, scale_bf16};
  FusedArgs a{};
  const void* ps[3] = {p0, p1, p2};
  for (int i = 0; i < 3; ++i) a.pro[i] = Operand{ps[i], (pro_bf16 >> i) & 1};
  a.n_pro = n_pro;
  a.mode = mode;
  a.k1 = k1;
  a.nw = reinterpret_cast<const float*>(norm_w);
  a.eps = eps;
  a.bias = reinterpret_cast<const float*>(bias);
  a.res[0] = Operand{r0, res_bf16 & 1};
  a.res[1] = Operand{r1, (res_bf16 >> 1) & 1};
  a.n_res = n_res;
  a.M = M;
  a.logits = out_idx ? nullptr : reinterpret_cast<float*>(logits);
  a.best_val = reinterpret_cast<float*>(best_val);
  a.best_idx = reinterpret_cast<int*>(best_idx);
  if (M <= 1)
    launch<1>(w, a, stream);
  else if (M <= 2)
    launch<2>(w, a, stream);
  else if (M <= 4)
    launch<4>(w, a, stream);
  else if (M <= 8)
    launch<8>(w, a, stream);
  else
    launch<16>(w, a, stream);
  if (out_idx) {
    const int nblk = (N + kCols - 1) / kCols;
    argmax_reduce_kernel<<<M, 256, 0, stream>>>(
        a.best_val, a.best_idx, nblk, M, reinterpret_cast<int*>(out_idx));
  }
  return (int)cudaGetLastError();
}
