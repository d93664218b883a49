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
// product is the decode GEMV of csrc/gemv.cuh, the one csrc/qmatmul.cu
// runs: every packed weight byte read once by 16-byte cp.async, the
// tensor cores on the exact integer values, the scale and minimum folded
// once per 32-row block, K split over a cluster whose ranks add in a
// fixed order. The design:
//  - The prologue is formed once, by a first small pass that writes the
//    bf16 rows x [M, K] (at most 16 x 14336 x 2 bytes = 458 KB, read
//    back from the L2) and, in norm mode, the rms of each row once: the
//    GEMV's loader reads x rows from global memory, so its main loop runs
//    unchanged. The TPU kernel builds the whole prologue row in VMEM;
//    forming it in each block instead (one launch) would recompute a
//    K range of it in every one of the N / 128 column tiles (1002 at the
//    head, each norm tile also rereading the row for its rms), and the
//    GEMV's ring would have to read x from another place than global
//    memory: a second main loop. chip_smoke.py times the pair beside the
//    plain GEMV on the same weight and rows; the difference is the pass
//    and its launch (PERF.md). An x prologue whose operand is already
//    bf16 skips the pass.
//  - The epilogue runs where the cluster adds its K splits: the rank
//    that writes a column adds the bias and the residuals in the order
//    above.
//  - Argmax: that rank reduces its row's 128 columns to (max, first
//    index) per column tile; a second tiny pass reduces the tiles,
//    preferring the smaller index on equal values (the TPU kernel carries
//    a running argmax across its sequential grid instead).
#include "gemv.cuh"

namespace {

enum Prologue { kX = 0, kNorm = 1, kGlu = 2, kConcat2 = 3 };

struct ProArgs {
  Operand pro[3];
  int n_pro;
  int mode;
  int k1;  // concat2: width of the first part
  const float* nw;
  float eps;
  int K;
};

__device__ __forceinline__ float ld(const Operand& o, long i) {
  return ld_scale(o.p, i, o.bf16);
}

__device__ __forceinline__ float norm_sum(const ProArgs& a, long i) {
  float s = ld(a.pro[0], i);
  for (int j = 1; j < a.n_pro; ++j) s += ld(a.pro[j], i);
  return s;
}

// the prologue value of row m, column k, before the bf16 rounding
__device__ __forceinline__ float prologue(const ProArgs& a, int m, int k,
                                          float rstd) {
  const int K = a.K;
  switch (a.mode) {
    case kNorm:
      return norm_sum(a, (long)m * K + k) * rstd * a.nw[k];
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

// x [M, K] bf16, one element a thread: grid (K / 256, M); the norm takes
// one block of 1024 threads per row, which keeps its first 8192 operand
// sums in registers between the row's sum of squares and the writes
constexpr int kProThreads = 256;
constexpr int kNormThreads = 1024;
constexpr int kKeep = 8;

__global__ __launch_bounds__(kNormThreads) void prologue_kernel(
    ProArgs a, __nv_bfloat16* x) {
  __shared__ float red[kNormThreads / 32];
  __shared__ float rstd_s;
  // the GEMV may launch now: it waits for this grid before reading x
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int m = blockIdx.y, tid = threadIdx.x;
  const int K = a.K;
  const long row = (long)m * K;
  if (a.mode != kNorm) {
    const int k = blockIdx.x * blockDim.x + tid;
    if (k < K) x[row + k] = __float2bfloat16(prologue(a, m, k, 0.f));
    return;
  }
  float keep[kKeep], ss = 0.f;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int k = tid + j * kNormThreads;
    keep[j] = k < K ? norm_sum(a, row + k) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kKeep; ++j) ss = fmaf(keep[j], keep[j], ss);
  for (int k = tid + kKeep * kNormThreads; k < K; k += kNormThreads) {
    const float v = norm_sum(a, row + k);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int t = 0; t < kNormThreads / 32; ++t) tot += red[t];
    rstd_s = rsqrtf(tot / (float)K + a.eps);  // as torch.rsqrt on CUDA
  }
  __syncthreads();
  const float rstd = rstd_s;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    const int k = tid + j * kNormThreads;
    if (k < K) x[row + k] = __float2bfloat16(keep[j] * rstd * a.nw[k]);
  }
  for (int k = tid + kKeep * kNormThreads; k < K; k += kNormThreads)
    x[row + k] = __float2bfloat16(prologue(a, m, k, rstd));
}

// one block per row: reduce the per-tile (max, index) pairs
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

}  // namespace

// mode: 0 x, 1 norm, 2 glu, 3 concat2; p0..p2 the prologue operands
// (n_pro of them; bit i of pro_bf16 set when operand i is bf16, else
// f32), [M, K] each except glu ([M, 2K]) and concat2 ([M, k1], [M, K -
// k1]); norm_w f32 [K] (norm only); x bf16 [M, K] scratch for the
// prologue. bias f32 [N] or null; r0, r1 the n_res residuals [M, N]
// (bit i of res_bf16: bf16). logits f32 [M, N] when out_idx is null;
// else best_val/best_idx [ceil(N/128), M] scratch and out_idx int32 [M].
// Returns a CUDA error code (0 on success).
PS_EXPORT int ps_fused_linear(int mode, int n_pro, const void* p0,
                              const void* p1, const void* p2, int pro_bf16,
                              int k1, const void* norm_w, float eps,
                              void* x, const void* q, const void* scales,
                              const void* wmin, int M, int K, int N,
                              int packed, int group, int offset,
                              int scale_bf16, const void* bias, int n_res,
                              const void* r0, const void* r1, int res_bf16,
                              void* logits, void* best_val, void* best_idx,
                              void* out_idx, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (M <= 0 || M > 16) return (int)cudaErrorInvalidValue;
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, wmin, K, N,
            packed, group, offset, scale_bf16};
  ProArgs a{};
  const void* ps[3] = {p0, p1, p2};
  for (int i = 0; i < 3; ++i) a.pro[i] = Operand{ps[i], (pro_bf16 >> i) & 1};
  a.n_pro = n_pro;
  a.mode = mode;
  a.k1 = k1;
  a.nw = reinterpret_cast<const float*>(norm_w);
  a.eps = eps;
  a.K = K;
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const bool direct =
      mode == kX && (pro_bf16 & 1) && ((uintptr_t)p0 & 15) == 0;
  if (direct) {
    xb = reinterpret_cast<const __nv_bfloat16*>(p0);  // already the rows
  } else {
    const bool norm = mode == kNorm;
    const dim3 grid(norm ? 1 : (K + kProThreads - 1) / kProThreads, M);
    prologue_kernel<<<grid, norm ? kNormThreads : kProThreads, 0, stream>>>(
        a, reinterpret_cast<__nv_bfloat16*>(x));
  }
  GemvEpilogue ep{};
  ep.bias = reinterpret_cast<const float*>(bias);
  ep.res[0] = Operand{r0, res_bf16 & 1};
  ep.res[1] = Operand{r1, (res_bf16 >> 1) & 1};
  ep.n_res = n_res;
  if (out_idx) {
    ep.best_val = reinterpret_cast<float*>(best_val);
    ep.best_idx = reinterpret_cast<int*>(best_idx);
  }
  const Slabs sl{nullptr, 1, 0, 0};
  const cudaError_t e = launch_gemv(w, sl, xb, M, 1,
                                    reinterpret_cast<float*>(logits), ep,
                                    stream, !direct);
  if (e != cudaSuccess) return (int)e;
  if (out_idx) {
    const int nblk = (N + kBlockCols - 1) / kBlockCols;
    argmax_reduce_kernel<<<M, 256, 0, stream>>>(
        ep.best_val, ep.best_idx, nblk, M, reinterpret_cast<int*>(out_idx));
  }
  return (int)cudaGetLastError();
}
