// Dequant matmul y[M, N] = x[M, K] @ w[K, N] over the port's quantized
// weights (Q4_0 / Q4_K nibble-packed, Q8_0 and 4-bit values unpacked as
// int8; f32 or bf16 scales; optional per-block minimum), bf16 x, f32
// dequant and f32 accumulation, f32 out. Rows beyond 16 (prefill) round
// the dequantized weight to bf16 for the tensor cores, as the TPU
// kernel's bf16 MXU dots do above its decode-sized M.
//
// Replaces the TPU kernel powerserve_tpu/ops/qmatmul.py::_qmatmul_pallas
// (body _make_kernel), which K-tiles one (bm, bn) block per grid step
// and carries an f32 accumulator in VMEM scratch across the sequential
// K axis.
//
// What bounds it on an H100:
//  - decode (M <= 16): weight bytes. 4096 x 14336 Q4_K with bf16 scales
//    and mins is ~36.7 MB, ~11 us at 3.35 TB/s; the activations are a
//    few KB. The design is a split-K GEMV: each thread owns four
//    adjacent columns (one 32-bit load per stored row, a warp reads 128
//    contiguous bytes), the eight warps of a block split the block's K
//    range, and enough K splits are launched to put ~4 blocks on every
//    SM. Partial sums go to a [splits, M, N] buffer and a second pass
//    adds them in a fixed order, so results do not depend on timing.
//  - prefill (M = 512): operations, 2 * M * N * K at 989 TFLOP/s bf16.
//    A 128 x 128 output tile per block, 32-row K steps (one scale block):
//    the x tile is copied to shared memory, the weight tile dequantized
//    in f32 and stored as bf16 [n][k], and eight warps run mma.sync
//    m16n8k16 bf16 -> f32 on it. No cp.async pipeline, ldmatrix or
//    wgmma yet: those, and TMA, are the next steps.
// Ragged M, N are masked in both; K is a multiple of 32 by format.
//
// Grouped mode (ps_qmatmul_grouped) replaces the same TPU kernel called
// with `tile_ids` (qmatmul_grouped, the MoE expert FFN): the weights are
// a stack of E slabs [E, ...], rows [i * tile_m, (i + 1) * tile_m) of x
// multiply slab tile_ids[i]. Each block reads its tile's slab index from
// device memory (the TPU's scalar prefetch) and offsets its weight
// pointers; ids are clipped into the stack, so padding tiles read in
// bounds. tile_m <= 16 runs the GEMV with f32 weights (one grid z per
// tile), tile_m = 128 the tensor-core tile with bf16 weights (one block
// row per tile): numerics follow the tile, not the total row count. The
// bound counts the bytes of the distinct slabs the ids name.
#include "common.cuh"

namespace {

// Where the expert stack's slabs lie; tile_ids null for a plain weight.
struct Slabs {
  const int* tile_ids;
  int n_slabs;
  long q_stride;  // bytes between slabs of q
  long s_stride;  // elements between slabs of scales (and bias)
};

__device__ __forceinline__ QWeight pick_slab(QWeight w, const Slabs& sl,
                                             int tile) {
  if (!sl.tile_ids) return w;
  const int e = min(max(sl.tile_ids[tile], 0), sl.n_slabs - 1);
  const long sb = (long)e * sl.s_stride * (w.scale_bf16 ? 2 : 4);
  w.q += (long)e * sl.q_stride;
  w.scales = reinterpret_cast<const char*>(w.scales) + sb;
  if (w.bias) w.bias = reinterpret_cast<const char*>(w.bias) + sb;
  return w;
}

constexpr int kGemvCols = 128;  // 32 lanes x 4 columns
constexpr int kGemvWarps = 8;

// M rows per tile (grid z), P rows in all; out (or the split-K partial
// buffer) is [gridDim.y, P, N].
template <int MT>
__global__ __launch_bounds__(256) void qmm_gemv_kernel(QWeight w, Slabs sl,
                                                       const __nv_bfloat16* x,
                                                       int M, long P,
                                                       float* out,
                                                       int kb_per_split) {
  const int tile = blockIdx.z;
  w = pick_slab(w, sl, tile);
  x += (long)tile * M * w.K;
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + lane) * 4;
  const int KB = w.K / 32;
  const int kb_begin = blockIdx.y * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);
  const bool vec = (w.N % 4) == 0;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  if (n0 < w.N)
    for (int kb = kb_begin + ty; kb < kb_end; kb += kGemvWarps)
      gemv_block<MT>(w, kb, n0, vec, x, w.K, M, acc);

  __shared__ float red[kGemvWarps][kGemvCols];
  float* o = out + ((long)blockIdx.y * P + (long)tile * M) * w.N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty][lane * 4 + j] = acc[m][j];
      __syncthreads();
      if (ty == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.f;
#pragma unroll
          for (int t = 0; t < kGemvWarps; ++t) v += red[t][lane * 4 + j];
          if (n0 + j < w.N) o[(long)m * w.N + n0 + j] = v;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void splitk_reduce_kernel(const float* part, int splits, long mn,
                                     float* out) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[(long)s * mn + i];
  out[i] = v;
}

constexpr int TBM = 128;
constexpr int TBN = 128;
constexpr int TBK = 32;
constexpr int TPITCH = TBK + 8;  // bf16 per staged row (80 bytes): the
                                 // fragment loads of a warp hit 32 banks

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// 128 x 128 output tile per block, 8 warps as 2 (M) x 4 (N), each warp
// 64 x 32 = 4 x 4 mma tiles. Per 32-row K step (one scale block): the
// x tile is copied to shared memory as is, the weight tile is
// dequantized in f32 and stored as bf16 [n][k], then two k16 mma steps.
__global__ __launch_bounds__(256) void qmm_mma_kernel(QWeight w, Slabs sl,
                                                      const __nv_bfloat16* x,
                                                      int M, float* out) {
  w = pick_slab(w, sl, blockIdx.y);  // grouped: one 128-row tile per slab
  __shared__ __align__(16) __nv_bfloat16 As[TBM][TPITCH];
  __shared__ __align__(16) __nv_bfloat16 Bs[TBN][TPITCH];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int m_base = blockIdx.y * TBM, n_base = blockIdx.x * TBN;
  const int K = w.K, N = w.N;
  const bool vec = (N % 4) == 0;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // this thread's share of the weight tile: 4 columns x 4 k rows
  const int n4 = (tid % 32) * 4, kr = (tid / 32) * 4;
  const int nw = n_base + n4;

  for (int kb = 0; kb < K / TBK; ++kb) {
    const int k0 = kb * TBK;
    for (int e = tid; e < TBM * TBK / 8; e += 256) {
      const int r = e / (TBK / 8), c = (e % (TBK / 8)) * 8;
      const int m = m_base + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        v = __ldg(reinterpret_cast<const uint4*>(x + (long)m * K + k0 + c));
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    {
      int shift;
      const long row0 = block_row(w, kb, &shift);
      float s[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nw + j;
        const bool ok = n < N;
        const long idx = (long)kb * N + n;
        s[j] = ok ? ld_scale(w.scales, idx, w.scale_bf16) : 0.f;
        b[j] = (ok && w.bias) ? ld_scale(w.bias, idx, w.scale_bf16) : 0.f;
      }
      uint32_t words[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        words[i] = nw < N ? ld_row4(w.q, row0 + kr + i, nw, N, vec) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = dequant_byte(words[i], j, shift, w, s[j], b[j]);
        *reinterpret_cast<uint2*>(&Bs[n4 + j][kr]) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        const int c = ks + t4 * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        const int c = ks + t4 * 2;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r0 = m_base + wm * 64 + mt * 16 + g;
      const int c0 = n_base + wn * 32 + nt * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + half * 8;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (c0 + j < N) out[(long)r * N + c0 + j] = acc[mt][nt][half * 2 + j];
      }
    }
  }
}

template <int MT>
void launch_gemv(const QWeight& w, const Slabs& sl, const __nv_bfloat16* x,
                 int M, int tiles, float* dst, int splits,
                 cudaStream_t stream) {
  const int KB = w.K / 32;
  const int kb_per_split = (KB + splits - 1) / splits;
  dim3 grid((w.N + kGemvCols - 1) / kGemvCols, splits, tiles);
  dim3 block(32, kGemvWarps);
  qmm_gemv_kernel<MT><<<grid, block, 0, stream>>>(w, sl, x, M,
                                                  (long)M * tiles, dst,
                                                  kb_per_split);
}

// M rows per tile, `tiles` tiles (1 for a plain weight).
int run_qmatmul(const QWeight& w, const Slabs& sl, const __nv_bfloat16* xb,
                int M, int tiles, float* o, float* partial, int splits,
                cudaStream_t stream) {
  if (M <= 16) {
    float* dst = splits > 1 ? partial : o;
    if (M <= 1)
      launch_gemv<1>(w, sl, xb, M, tiles, dst, splits, stream);
    else if (M <= 2)
      launch_gemv<2>(w, sl, xb, M, tiles, dst, splits, stream);
    else if (M <= 4)
      launch_gemv<4>(w, sl, xb, M, tiles, dst, splits, stream);
    else if (M <= 8)
      launch_gemv<8>(w, sl, xb, M, tiles, dst, splits, stream);
    else
      launch_gemv<16>(w, sl, xb, M, tiles, dst, splits, stream);
    if (splits > 1) {
      long mn = (long)M * tiles * w.N;
      splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
          dst, splits, mn, o);
    }
  } else {
    dim3 grid((w.N + TBN - 1) / TBN, (M * tiles + TBM - 1) / TBM);
    qmm_mma_kernel<<<grid, 256, 0, stream>>>(w, sl, xb, M * tiles, o);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] (16-byte aligned); out f32 [M, N]; partial f32 [splits, M, N] when M <= 16
// and splits > 1 (else unused). Returns cudaGetLastError().
PS_EXPORT int ps_qmatmul(const void* x, const void* q, const void* scales,
                         const void* bias, void* out, void* partial, int M,
                         int K, int N, int packed, int group, int offset,
                         int scale_bf16, int splits, void* stream_ptr) {
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, bias, K, N,
            packed, group, offset, scale_bf16};
  Slabs sl{nullptr, 1, 0, 0};
  return run_qmatmul(w, sl, reinterpret_cast<const __nv_bfloat16*>(x), M, 1,
                     reinterpret_cast<float*>(out),
                     reinterpret_cast<float*>(partial), splits,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Grouped: x bf16 [P, K] with P = tiles * tile_m; q, scales, bias stacks
// of n_slabs slabs; tile_ids int32 [tiles]; tile_m <= 16 or 128; out f32
// [P, N]; partial f32 [splits, P, N] when tile_m <= 16 and splits > 1.
PS_EXPORT int ps_qmatmul_grouped(const void* x, const void* q,
                                 const void* scales, const void* bias,
                                 const void* tile_ids, void* out,
                                 void* partial, int P, int K, int N,
                                 int packed, int group, int offset,
                                 int scale_bf16, int n_slabs, int tile_m,
                                 int splits, void* stream_ptr) {
  if (tile_m <= 0 || P % tile_m || (tile_m > 16 && tile_m != TBM))
    return (int)cudaErrorInvalidValue;
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, bias, K, N,
            packed, group, offset, scale_bf16};
  const long q_rows = packed ? K / 2 : K;
  Slabs sl{reinterpret_cast<const int*>(tile_ids), n_slabs, q_rows * N,
           (long)(K / 32) * N};
  return run_qmatmul(w, sl, reinterpret_cast<const __nv_bfloat16*>(x),
                     tile_m, P / tile_m, reinterpret_cast<float*>(out),
                     reinterpret_cast<float*>(partial), splits,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}
