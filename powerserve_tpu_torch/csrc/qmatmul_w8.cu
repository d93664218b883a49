// W8 matmul y[M, N] = sx[M] * sum_b s[b, N] * (x8[M, b] . q[b, N]) over
// 128-deep blocks b: int8 activations x8 [M, K] with one f32 scale per
// row (quantized outside the kernel, ops/qmatmul.py:quantize_activations),
// symmetric int8 weights q [K, N] with f32 scales s [K/128, N]. Each
// 128-deep int8 dot is summed exactly in int32 (at most 128 * 128 * 127 <
// 2^24, so an f32 twin is exact too), then takes one f32 multiply-add by
// its block's scale; f32 out.
//
// Replaces the TPU kernel powerserve_tpu/ops/qmatmul.py::_qmatmul_pallas_mxu8
// (a8=True, body _make_mxu8_kernel), whose int8 MXU dots produce one int32
// partial sum per 128-deep block, scaled into an f32 VMEM accumulator.
//
// What bounds it on an H100:
//  - decode (M <= 16): weight bytes, 1 byte per weight plus 4 per 128
//    (4096 x 28672 is ~118 MB, ~35 us at 3.35 TB/s). The design is the
//    split-K GEMV of csrc/qmatmul.cu: each thread owns four adjacent
//    columns (one 32-bit load per row, a warp reads 128 contiguous bytes),
//    a warp takes whole 128-deep blocks, and 32 row loads are in flight
//    per thread. Four rows of four columns are transposed in registers
//    (__byte_perm) into four k-quads, each the operand of one __dp4a
//    against four activations.
//  - prefill (M > 16): operations, 2 * M * N * K at 1,979 TOP/s int8. A
//    128 x 128 output tile per block; per 128-deep block the x tile is
//    copied into shared memory as is, the weight tile transposed to
//    [n][k], and eight warps run mma.sync m16n8k32 s8.s8.s32 on it; each
//    block's int32 fragments are scaled into f32 accumulators. No
//    cp.async pipeline, ldmatrix or wgmma yet.
// Ragged M, N are masked; K is a multiple of 128 by format.
#include "common.cuh"

namespace {

constexpr int kW8Block = 128;  // scale group = depth of one exact int8 dot
constexpr int kGemvCols = 128;
constexpr int kGemvWarps = 8;

// rows r0..r3 of four columns (byte j of word i = row i, column j) ->
// column j as a k-quad (byte i = row i)
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <int MT>
__global__ __launch_bounds__(256) void w8_gemv_kernel(
    const int8_t* __restrict__ x8, const float* __restrict__ sx,
    const uint8_t* __restrict__ q, const float* __restrict__ s, int M, int K,
    int N, float* out, int kb_per_split) {
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int n0 = (blockIdx.x * 32 + lane) * 4;
  const int KB = K / kW8Block;
  const int kb_begin = blockIdx.y * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);
  const bool vec = (N % 4) == 0;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  if (n0 < N) {
    for (int kb = kb_begin + ty; kb < kb_end; kb += kGemvWarps) {
      int isum[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) isum[m][j] = 0;
#pragma unroll 1
      for (int c = 0; c < kW8Block; c += 32) {
        const long row0 = (long)kb * kW8Block + c;
        uint32_t words[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) words[i] = ld_row4(q, row0 + i, n0, N, vec);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const uint32_t rows[4] = {words[4 * g], words[4 * g + 1],
                                    words[4 * g + 2], words[4 * g + 3]};
          uint32_t col[4];
          transpose4(rows, col);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < M) {
              const int xw = __ldg(reinterpret_cast<const int*>(
                  x8 + (long)m * K + row0 + 4 * g));
#pragma unroll
              for (int j = 0; j < 4; ++j)
                isum[m][j] = __dp4a((int)col[j], xw, isum[m][j]);
            }
          }
        }
      }
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[j] = n0 + j < N ? __ldg(s + (long)kb * N + n0 + j) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] = fmaf((float)isum[m][j], sc[j], acc[m][j]);
    }
  }

  __shared__ float red[kGemvWarps][kGemvCols];
  const bool split = gridDim.y > 1;  // partial sums: the row scale waits
  float* o = out + (long)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty][lane * 4 + j] = acc[m][j];
      __syncthreads();
      if (ty == 0) {
        const float rs = split ? 1.f : sx[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.f;
#pragma unroll
          for (int t = 0; t < kGemvWarps; ++t) v += red[t][lane * 4 + j];
          if (n0 + j < N) o[(long)m * N + n0 + j] = v * rs;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void w8_splitk_reduce_kernel(const float* part, int splits,
                                        const float* sx, int N, long mn,
                                        float* out) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int t = 0; t < splits; ++t) v += part[(long)t * mn + i];
  out[i] = v * sx[i / N];
}

constexpr int TBM = 128;
constexpr int TBN = 128;
constexpr int TPITCH = kW8Block + 16;  // bytes per staged row (36 words):
                                       // fragment loads hit 32 banks

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 warps as 2 (M) x 4 (N), each warp 64 x 32 = 4 x 4 mma tiles.
__global__ __launch_bounds__(256) void w8_mma_kernel(
    const int8_t* __restrict__ x8, const float* __restrict__ sx,
    const uint8_t* __restrict__ q, const float* __restrict__ s, int M, int K,
    int N, float* out) {
  __shared__ __align__(16) int8_t As[TBM][TPITCH];
  __shared__ __align__(16) int8_t Bs[TBN][TPITCH];
  __shared__ float Ss[TBN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int m_base = blockIdx.y * TBM, n_base = blockIdx.x * TBN;
  const bool vec = (N % 4) == 0;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // this thread's share of the weight tile: 4 columns x 4 k rows, 4 times
  const int n4 = (tid % 32) * 4, kq = (tid / 32) * 4;
  const int nw = n_base + n4;

  for (int kb = 0; kb < K / kW8Block; ++kb) {
    const long k0 = (long)kb * kW8Block;
    for (int e = tid; e < TBM * kW8Block / 16; e += 256) {
      const int r = e / (kW8Block / 16), c = (e % (kW8Block / 16)) * 16;
      const int m = m_base + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) v = __ldg(reinterpret_cast<const uint4*>(x8 + (long)m * K + k0 + c));
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
#pragma unroll
    for (int it = 0; it < kW8Block / 32; ++it) {
      const int k = it * 32 + kq;
      uint32_t rows[4], col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rows[i] = nw < N ? ld_row4(q, k0 + k + i, nw, N, vec) : 0u;
      transpose4(rows, col);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[n4 + j][k]) = col[j];
    }
    if (tid < TBN)
      Ss[tid] = n_base + tid < N ? __ldg(s + (long)kb * N + n_base + tid) : 0.f;
    __syncthreads();
    int isum[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) isum[i][j][c] = 0;
#pragma unroll
    for (int ks = 0; ks < kW8Block; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        const int c = ks + t4 * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 16]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 16]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        const int c = ks + t4 * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 16]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16832(isum[mt][nt], af[mt], bf[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c0 = wn * 32 + nt * 8 + t4 * 2;
      const float s0 = Ss[c0], s1 = Ss[c0 + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][nt][0] = fmaf((float)isum[mt][nt][0], s0, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf((float)isum[mt][nt][1], s1, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf((float)isum[mt][nt][2], s0, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf((float)isum[mt][nt][3], s1, acc[mt][nt][3]);
      }
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
        const float rs = sx[r];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (c0 + j < N) out[(long)r * N + c0 + j] = acc[mt][nt][half * 2 + j] * rs;
      }
    }
  }
}

template <int MT>
void launch_w8_gemv(const int8_t* x8, const float* sx, const uint8_t* q,
                    const float* s, int M, int K, int N, float* dst,
                    int splits, cudaStream_t stream) {
  const int KB = K / kW8Block;
  const int kb_per_split = (KB + splits - 1) / splits;
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  dim3 block(32, kGemvWarps);
  w8_gemv_kernel<MT><<<grid, block, 0, stream>>>(x8, sx, q, s, M, K, N, dst,
                                                 kb_per_split);
}

}  // namespace

// x8 int8 [M, K] (16-byte aligned), sx f32 [M], q int8 [K, N], s f32
// [K/128, N]; out f32 [M, N]; partial f32 [splits, M, N] when M <= 16 and
// splits > 1 (else unused). Returns cudaGetLastError().
PS_EXPORT int ps_qmatmul_w8(const void* x8, const void* sx, const void* q,
                            const void* s, void* out, void* partial, int M,
                            int K, int N, int splits, void* stream_ptr) {
  if (K % kW8Block) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int8_t* xa = reinterpret_cast<const int8_t*>(x8);
  const float* xs = reinterpret_cast<const float*>(sx);
  const uint8_t* qw = reinterpret_cast<const uint8_t*>(q);
  const float* sw = reinterpret_cast<const float*>(s);
  float* o = reinterpret_cast<float*>(out);
  if (M <= 16) {
    float* dst = splits > 1 ? reinterpret_cast<float*>(partial) : o;
    if (M <= 1)
      launch_w8_gemv<1>(xa, xs, qw, sw, M, K, N, dst, splits, stream);
    else if (M <= 2)
      launch_w8_gemv<2>(xa, xs, qw, sw, M, K, N, dst, splits, stream);
    else if (M <= 4)
      launch_w8_gemv<4>(xa, xs, qw, sw, M, K, N, dst, splits, stream);
    else if (M <= 8)
      launch_w8_gemv<8>(xa, xs, qw, sw, M, K, N, dst, splits, stream);
    else
      launch_w8_gemv<16>(xa, xs, qw, sw, M, K, N, dst, splits, stream);
    if (splits > 1) {
      long mn = (long)M * N;
      w8_splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
          dst, splits, xs, N, mn, o);
    }
  } else {
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    w8_mma_kernel<<<grid, 256, 0, stream>>>(xa, xs, qw, sw, M, K, N, o);
  }
  return (int)cudaGetLastError();
}
