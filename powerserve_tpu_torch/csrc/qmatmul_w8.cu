// W8 matmul y[M, N] = sx[M] * sum_b s[b, N] * (x8[M, b] . q[b, N]) over
// 128-deep blocks b, on bf16 rows x [M, K]: one C call runs two
// kernels. First a quantize pass turns each row into int8 codes x8 with
// one f32 scale sx (bit-equal to ops/qmatmul.py:quantize_activations, the
// JAX package's _quantize_activations) in scratch the wrapper allocates;
// then the product, launched as the pass's programmatic dependent, takes
// symmetric int8 weights q [K, N] with f32 scales s [K/128, N]. Each
// 128-deep int8 dot is summed exactly in int32 (at most 128 * 128 * 128 <
// 2^24, so an f32 twin is exact too), then takes one f32 multiply-add by
// its block's scale; the row scale comes last; f32 out.
//
// Replaces the TPU kernel powerserve_tpu/ops/qmatmul.py::_qmatmul_pallas_mxu8
// (a8=True, body _make_mxu8_kernel), whose int8 MXU dots produce one int32
// partial sum per 128-deep block, scaled into an f32 VMEM accumulator.
//
// What bounds it on an H100:
//  - the pass: x's bytes, read twice (the second time from the L1), the
//    codes written once; a few microseconds at M <= 1024. Its product
//    launches as soon as every pass block has started, and streams its
//    first weights while the pass runs.
//  - decode (M <= 16 rows, dense or a grouped tile): weight bytes, 1
//    byte per weight plus 4 per 128 (4096 x 28672 is ~118 MB, ~35 us at
//    3.35 TB/s), whatever the row count. The product runs on the tensor
//    cores: int8 mma.sync m16n8k32 (s8.s8.s32) with 16 weight columns x
//    32 k as A and x8 as B (rows 0-7; a second mma for rows 8-15), so a
//    tile of 16 rows costs what one row costs, padding rows included. A
//    block owns 128 columns and its threads fill a ring of eight units
//    of 32 k (two 128-deep blocks) by cp.async, a warp instruction
//    copying four whole 128-byte weight rows; a warp takes 32 columns of
//    each unit. mma's A is K-major and the weights are stored [K, N]:
//    each unit's rows are staged in a permuted order (staged_k) so that
//    ldmatrix.trans and two byte permutes give the K-major quads, with no
//    transpose pass. A 128-deep block's four mmas chain in s32, exactly,
//    then take one f32 multiply-add by the block's scale. The K splits of
//    a column tile form one cluster (at most 8, as many as fill one wave
//    of resident blocks) and add their partials in rank order through
//    distributed shared memory: the same bits on every run, no partial
//    buffer, no reduce launch. The first seven units' weights are copied
//    before griddepcontrol.wait, while the quantize pass runs. The body
//    it replaced ran one __dp4a per row for every 4 x 4 byte quad, so its
//    work grew with the tile's rows, padding rows too. Tried on the card and slower: each warp its own ring
//    over its 32 columns (a warp instruction then touched 16 rows x 32
//    bytes; slower at every shape, and slower than the __dp4a body at
//    one-row tiles), rings of 4 and 12 units, and 48-byte padded rows in
//    place of the swizzle. Not tried: bf16 m16n8k16 on x8's codes through
//    gemv.cuh's body (exact too, but at half the int8 rate, and its pass
//    would write the codes in twice the bytes). One-row products take
//    this body too: it was faster there than the __dp4a body in one call.
//  - prefill (M > 16): operations, 2 * M * N * K at 1,979 TOP/s int8
//    (4096 x 28672 at M = 512: 0.061 ms). int8 wgmma (m64n128k32
//    s8.s8.s32) at a 128 x 128 output tile, two warpgroups, one block an
//    SM (64 s32 and 64 f32 accumulators a thread). int8 wgmma takes both
//    operands K-major, and the weights are stored [K, N]: x8 comes by TMA
//    (128-byte swizzle, three stages), the weight bytes and scales by
//    cp.async four units ahead, and each 128-deep unit is transposed once
//    per block by byte permutes into K-major core matrices, the next one
//    while the tensor cores run this one; one barrier a unit. The s32
//    sums of a unit are then scaled into the f32 accumulators. Its time
//    goes, in order, to the wgmma loop itself (each unit waited for
//    before its scaling), the loads, the transpose and the scaling. Tried
//    on the card and slower: a producer warpgroup with two consumer
//    warpgroups on mbarriers, two s32 sets so one unit is scaled while
//    the next runs (ptxas serializes the wgmma), x multicast across a
//    two-block cluster, a 128 x 192 tile (255 registers), the weights
//    loaded straight into registers, deeper rings, and int to float by
//    2^23 arithmetic in place of the conversion. The weight layout stays
//    [K, N]: the twin, dequant, requantize_w8 and the parameter tools
//    read it; stored [N, K] the transpose would go.
// Ragged M, N are masked; K is a multiple of 128 by format.
//
// Grouped mode (ps_qmatmul_w8_grouped): the weights are a stack of E
// slabs, q int8 [E, K, N] and s f32 [E, K/128, N] (the MoE expert FFN in
// W8), and rows [i * block_m, (i + 1) * block_m) of x multiply slab
// tile_ids[i] (device int32, clipped into the stack). The quantize pass
// runs over all rows as above; each block of the product reads its
// tile's slab index and moves its weight and scale bases there, and
// nothing else changes: block_m 1..16 runs the GEMV with one grid layer
// per tile, block_m 128 the GEMM with one 128-row tile per slab (the x8
// tensor map as it is). The JAX package has no grouped W8 kernel: its
// W8 expert slabs go through XLA (ops/qmatmul.py::_qmatmul_xla_grouped,
// a scan that dequantizes one slab per tile). Bound: the routed slabs'
// bytes at decode-sized tiles, their int8 operations at block_m 128.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kW8Block = 128;  // scale group = depth of one exact int8 dot
constexpr int kGemvWarps = 4;
constexpr int kGemvCols = 32 * kGemvWarps;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kPassThreads = 256;

// Eight bf16 values of x from element e (e % 8 == 0) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* x, long e,
                                      float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + e));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

// The quantize pass, one block a row of bf16 x: the row's f32 absmax, then
// sx = absmax / 127, inv = sx > 0 ? 1 / sx : 0 and codes clamp(rint(x *
// inv), -127, 127), with the twin's roundings (ops/qmatmul.py:
// quantize_activations): IEEE division and reciprocal, one f32 multiply,
// halves to even. The row is read twice (the second time from the L1).
__global__ __launch_bounds__(kPassThreads) void w8_quantize_kernel(
    const __nv_bfloat16* x, int K, int8_t* x8, float* sx) {
  // the product may launch now: it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float wmax[kPassThreads / 32];
  const long row = (long)blockIdx.x * K;
  float amax = 0.f;
  for (int c = threadIdx.x * 8; c < K; c += kPassThreads * 8) {
    float v[8];
    load8(x, row + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = wmax[0];
#pragma unroll
  for (int w = 1; w < kPassThreads / 32; ++w) amax = fmaxf(amax, wmax[w]);
  const float s = __fdiv_rn(amax, 127.f);
  const float inv = s > 0.f ? __frcp_rn(s) : 0.f;
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  for (int c = threadIdx.x * 8; c < K; c += kPassThreads * 8) {
    float v[8];
    load8(x, row + c, v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = min(max(__float2int_rn(__fmul_rn(v[j], inv)), -127), 127);
      w[j >> 2] |= (uint32_t)(q & 0xFF) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(x8 + row + c) = make_uint2(w[0], w[1]);
  }
}

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

// ---- decode GEMV (M <= 16): int8 mma.sync (the design note at the top) ----
//
// A block is four warps over 128 output columns; a warp owns 32 of them
// (two groups of 16, each the A operand of an m16n8k32 mma). The block
// walks its K split in units of 32 k through a ring of kRing stages that
// all its threads fill by cp.async, a warp instruction four whole
// 128-byte rows: the unit's 32 weight rows x 128 columns, its rows of x8
// (rows past M are not copied and read as zeros) and, in the last unit of
// a 128-deep block, that block's 128 scales. One barrier a unit. A unit's
// slot modulo 4 is its index in its 128-deep block, so every offset is a
// constant.
constexpr int kRing = 8;  // units of 32 k: two 128-deep blocks

// Staged weight rows are 128 bytes, their 16-byte chunk j stored at j ^
// (row % 8): ldmatrix's eight rows hit 32 distinct banks. Staged x8 rows
// are 32 bytes, their halves swapped in rows with bit 2 set: a warp's B
// loads hit 32 distinct banks.
__device__ __forceinline__ int swz_w(int row, int chunk) {
  return row * kGemvCols + 16 * (chunk ^ (row & 7));
}
__device__ __forceinline__ int swz_x(int row, int half) {
  return row * 32 + 16 * (half ^ ((row >> 2) & 1));
}

template <int MT>
struct GemvStage {
  static constexpr int X = 32 * kGemvCols;  // x8 rows [MT][32 k]
  static constexpr int S = X + MT * 32;     // a 128-deep block's scales
  static constexpr int BYTES = S + kGemvCols * 4;
};

// Staged row p of a unit holds its k row staged_k(p): rows p = 0-7 are k
// {0, 1, 4, 5, 8, 9, 12, 13}, 8-15 k {2, 3, 6, 7, ...}, and 16-31 the same
// plus 16. ldmatrix.trans over staged rows 0-7 then hands lane (g, t4)
// columns 2g, 2g + 1 at k 4 t4 and 4 t4 + 1, over rows 8-15 the same
// columns at k 4 t4 + 2 and 4 t4 + 3: two byte permutes make the K-major
// quads of A rows g (column 2g) and g + 8 (column 2g + 1).
__device__ __forceinline__ int staged_k(int p) {
  return (p & 16) + 4 * ((p & 7) >> 1) + (p & 1) + 2 * ((p >> 3) & 1);
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 sums (exact here)
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A thread's two weight chunks and scale chunk element by element, for
// weights whose rows are not 16-byte aligned (columns past N read as
// zero); out of line, so the loader's state stays in registers.
__device__ __noinline__ void w8_load_slow(const uint8_t* w0,
                                          const uint8_t* w1, int col, int N,
                                          uint8_t* d0, uint8_t* d1,
                                          const float* sp, int scol,
                                          float* sd) {
  for (int b = 0; b < 16; ++b) {
    d0[b] = col + b < N ? w0[b] : 0;
    d1[b] = col + b < N ? w1[b] : 0;
  }
  if (sp)
    for (int j = 0; j < 4; ++j) sd[j] = scol + j < N ? sp[j] : 0.f;
}

// One layer of the grid (blockIdx.z) per tile of M <= MT rows; with
// tile_ids, tile z reads slab tile_ids[z] of the stack (the grouped mode).
// gridDim.y K splits of whole 128-deep blocks, one cluster per column
// tile and tile when gridDim.y > 1. vec: N % 16 == 0 and q, s 16-byte
// aligned.
template <int MT>
__global__ __launch_bounds__(32 * kGemvWarps) void w8_gemv_kernel(
    const int8_t* __restrict__ x8, const float* __restrict__ sx,
    const uint8_t* __restrict__ q, const float* __restrict__ s, int M, int K,
    int N, float* out, int vec, const int* tile_ids, int n_slabs) {
  constexpr int RB = MT > 8 ? 2 : 1;  // B tiles of 8 rows
  using St = GemvStage<MT>;
  extern __shared__ __align__(128) uint8_t smem[];
  // written before the quantize pass started: readable before the wait
  const int tile = blockIdx.z;
  if (tile_ids) {
    const long e = min(max(tile_ids[tile], 0), n_slabs - 1);
    q += e * K * N;
    s += e * (K / kW8Block) * N;
  }
  x8 += (long)tile * M * K;
  sx += (long)tile * M;
  out += (long)tile * M * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kGemvCols;
  const int KB = K / kW8Block, splits = gridDim.y;
  const int kb0 = (int)((long)blockIdx.y * KB / splits);
  const int units = ((int)((long)(blockIdx.y + 1) * KB / splits) - kb0) *
                    (kW8Block / 32);

  // this thread's copies of a unit: weight chunks tid and tid + 128
  // (staged rows tid / 8 and tid / 8 + 16, 16 columns from 16 (tid % 8)),
  // x8 chunk tid (row tid / 2 < M), scale chunk tid < 32 (columns 4 tid ..
  // + 3)
  const int p0 = tid >> 3, ch = tid & 7;
  const int col = n0 + 16 * ch;
  const bool col_ok = col < N;
  const uint8_t* wsrc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    wsrc[i] = q + ((long)kb0 * kW8Block + staged_k(p0 + 16 * i)) * N + col;
  const int xr = tid >> 1, xh = tid & 1;
  const bool x_ok = xr < M && xr < MT;
  const int8_t* xsrc = x8 + (long)(x_ok ? xr : 0) * K +
                       (long)kb0 * kW8Block + 16 * xh;
  const int scol = n0 + 4 * tid;
  const bool s_ok = tid < kGemvCols / 4 && scol < N;
  const float* ssrc = s + (long)kb0 * N + (s_ok ? scol : 0);
  const long wstep = 32L * N;

  auto load = [&](uint8_t* st, bool scales, bool with_w, bool with_x) {
    if (with_w) {
      if (vec) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          cp_async16(st + swz_w(p0 + 16 * i, ch), col_ok ? wsrc[i] : q,
                     col_ok);
        if (scales && tid < kGemvCols / 4)
          cp_async16(st + St::S + 16 * tid, s_ok ? ssrc : s, s_ok);
      } else {
        w8_load_slow(wsrc[0], wsrc[1], col, N, st + swz_w(p0, ch),
                     st + swz_w(p0 + 16, ch),
                     scales && tid < kGemvCols / 4 ? ssrc : nullptr, scol,
                     reinterpret_cast<float*>(st + St::S) + 4 * tid);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) wsrc[i] += wstep;
      if (scales) ssrc += N;
    }
    if (with_x) {
      if (x_ok) cp_async16(st + St::X + swz_x(xr, xh), xsrc, true);
      xsrc += 32;
    }
  };

  int isum[2][RB][4];
  float acc[2][RB][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int i = 0; i < 4; ++i) isum[c][rb][i] = 0, acc[c][rb][i] = 0.f;

  // launched as the quantize pass's dependent: the first units' weights
  // stream while the pass runs, their rows of x8 once it is done (stage
  // 0's commit group holds all those weights)
#pragma unroll
  for (int u = 0; u < kRing - 1; ++u)
    if (u < units) load(smem + u * St::BYTES, u % 4 == 3, true, false);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int u = 0; u < kRing - 1; ++u) {
    if (u < units) load(smem + u * St::BYTES, false, false, true);
    cp_async_commit();
  }
  for (int base = 0; base < units; base += kRing) {
#pragma unroll
    for (int slot = 0; slot < kRing; ++slot) {
      if (base + slot >= units) break;
      cp_async_wait<kRing - 2>();
      // this unit has landed, and every warp is done with the one before
      __syncthreads();
      const int ahead = (slot + kRing - 1) % kRing;
      if (base + slot + kRing - 1 < units)
        load(smem + ahead * St::BYTES, ahead % 4 == 3, true, true);
      cp_async_commit();
      const uint8_t* st = smem + slot * St::BYTES;
      uint32_t a[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t r[4];
        ldsm_x4_trans(r, st + swz_w(lane, 2 * warp + c));
        a[c][0] = __byte_perm(r[0], r[1], 0x6420);  // column 2g
        a[c][1] = __byte_perm(r[0], r[1], 0x7531);  // column 2g + 1
        a[c][2] = __byte_perm(r[2], r[3], 0x6420);
        a[c][3] = __byte_perm(r[2], r[3], 0x7531);
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        // rows past M read as zeros (their chunks are never copied)
        uint32_t b[2] = {0u, 0u};
        if (g + 8 * rb < M) {
          const uint8_t* xs = st + St::X + 4 * t4;
          b[0] = *reinterpret_cast<const uint32_t*>(xs + swz_x(g + 8 * rb, 0));
          b[1] = *reinterpret_cast<const uint32_t*>(xs + swz_x(g + 8 * rb, 1));
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) mma_s8_16832(isum[c][rb], a[c], b);
      }
      if (slot % 4 == 3) {
        // the 128-deep block's exact sums, scaled once per column
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float2 sv = *reinterpret_cast<const float2*>(
              st + St::S + (warp * 32 + 16 * c + 2 * g) * 4);
#pragma unroll
          for (int rb = 0; rb < RB; ++rb)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[c][rb][i] = fmaf((float)isum[c][rb][i], i < 2 ? sv.x : sv.y,
                                   acc[c][rb][i]);
              isum[c][rb][i] = 0;
            }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's partial [M, 128] into shared memory (sum i of a group:
  // column 2g + (i >> 1), row 2 t4 + (i & 1) + 8 rb); then the K splits of
  // the column tile (one cluster, rank = split) add theirs in rank order
  // through distributed shared memory, and the row scale comes last
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 2 * t4 + (i & 1) + 8 * rb;
        if (m < M)
          red[m * kGemvCols + warp * 32 + 16 * c + 2 * g + (i >> 1)] =
              acc[c][rb][i];
      }
  namespace cg = cooperative_groups;
  if (splits > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  for (int i = blockIdx.y * kGemvCols + tid; i < M * kGemvCols;
       i += splits * kGemvCols) {
    const int m = i / kGemvCols;
    const int n = n0 + i % kGemvCols;
    // every rank's partial read first, then added in rank order
    float part[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits)
        part[r] =
            (splits > 1 ? cg::this_cluster().map_shared_rank(red, r) : red)[i];
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) v += part[r];
    if (n < N) out[(long)m * N + n] = v * sx[m];
  }
  // keep this block's partial until every block of the cluster read it
  if (splits > 1) cg::this_cluster().sync();
}

// ---- prefill GEMM (M > 16): int8 wgmma (the design note at the top) ----
//
// Per block a 128 x 128 output tile, two warpgroups of 64 rows. A unit is
// one 128-deep scale block: four wgmma m64n128k32 a warpgroup, their s32
// sums started afresh (scale-d 0), then scaled by s[unit, n] into f32
// accumulators; sx[m] in the epilogue. The transposed weight tile is
// [k / 16][n / 8][n % 8][k % 16]: core matrices of 8 columns x 16 k.
constexpr int GBM = 128;
constexpr int GBN = 128;
constexpr int kGemmThreads = 256;
constexpr int kXStages = 3;  // x: unit u multiplied, u + 1 and u + 2 in flight
constexpr int kWStages = 4;  // weights: u + 1 transposed, 3 in flight
constexpr int X_TILE = GBM * kW8Block;     // [128 rows][128 k] int8
constexpr int X_SBO = 8 * kW8Block;        // 8-row groups of the swizzle
constexpr int W_TILE = kW8Block * GBN;     // [128 k][128 n] int8
constexpr int W_LBO = 128 * (GBN / 8);     // next 16 k (a row of core
constexpr int W_SBO = 128;                 // matrices); next 8 columns
constexpr int W_STAGE = W_TILE + GBN * 4;  // stored bytes, then scales

// the rings: x stages (1024-byte aligned), weight stages, the two
// transposed tiles, the two units' scales, the x stages' barriers
struct W8Smem {
  static constexpr int X0 = 0;
  static constexpr int W0 = X0 + kXStages * X_TILE;
  static constexpr int T0 = W0 + kWStages * W_STAGE;
  static constexpr int S0 = T0 + 2 * W_TILE;
  static constexpr int B0 = S0 + 2 * GBN * 4;
  static constexpr int BYTES = B0 + 8 * kXStages + 1024;  // + alignment
};

// d[64 x 128] (+)= a[64 x 32] * b[32 x 128], s8 in, s32 out, both
// operands K-major in shared memory; scale_d 0 ignores d's old values
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct W8GemmArgs {
  const float* sx;
  const uint8_t* q;
  const float* s;
  float* out;
  int M, K, N;
  int wvec;  // weight rows copy 16 bytes at a time (N % 16 == 0)
  int svec;  // scale rows copy 16 bytes at a time (N % 4 == 0)
  const int* tile_ids;  // grouped mode: M tile i reads slab tile_ids[i]
  int n_slabs;
};

__global__ __launch_bounds__(kGemmThreads, 1) void w8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx, W8GemmArgs a) {
  using L = W8Smem;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - ((uintptr_t)smem_raw & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_base = blockIdx.x * GBM, n_base = blockIdx.y * GBN;
  const int N = a.N, n_units = a.K / kW8Block;
  // this tile's slab (grouped mode): only the weight and scale bases move
  const uint8_t* wq = a.q;
  const float* ws_scale = a.s;
  if (a.tile_ids) {
    const long e = min(max(a.tile_ids[blockIdx.x], 0), a.n_slabs - 1);
    wq += e * a.K * N;
    ws_scale += e * n_units * N;
  }
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(smem + L::B0);

  // x of unit u into x slot u % kXStages by TMA (one thread); rows past M
  // read zeros; the slot's barrier completes on the bytes
  auto issue_x = [&](int u) {
    const uint32_t bar = bar0 + 8 * (u % kXStages);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
        smem + L::X0 + (u % kXStages) * X_TILE);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(X_TILE) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(dst), "l"((uint64_t)&tmx), "r"(u * kW8Block), "r"(m_base),
          "r"(bar) : "memory");
  };
  auto wait_x = [&](int u) {
    const uint32_t bar = bar0 + 8 * (u % kXStages);
    const uint32_t parity = (u / kXStages) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  };
  // unit u's stored weight rows [128 u, 128 u + 128) x 128 columns and
  // their scales into weight slot u % kWStages; columns past N read zeros
  auto issue_w = [&](int u) {
    uint8_t* ws = smem + L::W0 + (u % kWStages) * W_STAGE;
    const long row0 = (long)u * kW8Block;
    if (a.wvec) {
#pragma unroll
      for (int i = 0; i < W_TILE / 16 / kGemmThreads; ++i) {
        const int e = tid + kGemmThreads * i;
        const int r = e >> 3, c = (e & 7) * 16;
        const bool ok = n_base + c < N;
        cp_async16(ws + r * GBN + c,
                   wq + (ok ? (row0 + r) * N + n_base + c : 0), ok);
      }
    } else {
      for (int e = tid; e < W_TILE; e += kGemmThreads) {
        const int r = e >> 7, c = e & 127;
        ws[e] = n_base + c < N ? __ldg(wq + (row0 + r) * N + n_base + c) : 0;
      }
    }
    float* ss = reinterpret_cast<float*>(ws + W_TILE);
    const float* src = ws_scale + (long)u * N + n_base;
    if (a.svec) {
      if (tid < GBN / 4) {
        const bool ok = n_base + 4 * tid < N;
        cp_async16(ss + 4 * tid, ok ? src + 4 * tid : ws_scale, ok);
      }
    } else if (tid < GBN) {
      ss[tid] = n_base + tid < N ? __ldg(src + tid) : 0.f;
    }
  };
  // transpose unit u's stored bytes into K-major tile u % 2, and copy its
  // scales beside it. Warp w takes k rows 16 w .. 16 w + 15 (one core
  // matrix deep), a lane four columns: 16 row words (a warp reads whole
  // 128-byte rows), four 4 x 4 byte transposes, then one 16-byte core
  // matrix row per column. A lane pair's bytes are rotated by (lane / 2)
  // % 4 first, so the eight lanes of a store phase hit eight distinct
  // 16-byte bank groups.
  auto transpose = [&](int u) {
    const uint8_t* ws = smem + L::W0 + (u % kWStages) * W_STAGE;
    uint8_t* dst = smem + L::T0 + (u & 1) * W_TILE + warp * W_LBO;
    const int rot = (lane >> 1) & 3;
    const uint32_t sel = (0x32103210u >> (4 * rot)) & 0xFFFFu;
    uint32_t col[4][4];  // [k quad][column slot]
#pragma unroll
    for (int gq = 0; gq < 4; ++gq) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = __byte_perm(*reinterpret_cast<const uint32_t*>(
                               ws + (warp * 16 + gq * 4 + i) * GBN + 4 * lane),
                           0, sel);
      transpose4(w, col[gq]);
    }
    // slot j holds column 4 lane + (j + rot) % 4
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * lane + ((j + rot) & 3);
      *reinterpret_cast<uint4*>(dst + (n >> 3) * W_SBO + (n & 7) * 16) =
          make_uint4(col[0][j], col[1][j], col[2][j], col[3][j]);
    }
    if (tid < GBN / 4)
      reinterpret_cast<float4*>(smem + L::S0 + (u & 1) * GBN * 4)[tid] =
          reinterpret_cast<const float4*>(ws + W_TILE)[tid];
  };

  int isum[64];
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) isum[i] = 0, acc[i] = 0.f;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63

  constexpr int kWAhead = kWStages - 1;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kXStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(bar0 + 8 * i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the rings: while unit u is multiplied and unit u + 1 transposed, x of
  // units u + 1 and u + 2 (TMA) and the weights of units u + 2 .. u + 4
  // (cp.async, one commit group a unit) are in flight. The first weights
  // stream while the quantize pass finishes; x after it.
  for (int p = 0; p <= kWAhead; ++p) {
    if (p < n_units) issue_w(p);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0)
    for (int p = 0; p < kXStages - 1 && p < n_units; ++p) issue_x(p);
  cp_async_wait<kWAhead>();  // W0 has landed
  __syncthreads();
  transpose(0);
  for (int u = 0; u < n_units; ++u) {
    wait_x(u);                     // x(u) has landed
    cp_async_wait<kWAhead - 1>();  // W(u + 1) has landed
    fence_proxy_async();  // the transposed tile, to wgmma
    __syncthreads();      // unit u is transposed; unit u - 1 is done
    if (tid == 0 && u + kXStages - 1 < n_units) issue_x(u + kXStages - 1);
    if (u + 1 + kWAhead < n_units) issue_w(u + 1 + kWAhead);
    cp_async_commit();
    const uint8_t* xs =
        smem + L::X0 + (u % kXStages) * X_TILE + wg * 64 * kW8Block;
    const uint8_t* wt = smem + L::T0 + (u & 1) * W_TILE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kW8Block / 32; ++ks)
      wgmma_m64n128k32_s8(isum, smem_desc(xs + 32 * ks, 16, X_SBO, 1),
                          smem_desc(wt + ks * 2 * W_LBO, W_LBO, W_SBO, 0),
                          ks);
    wgmma_commit();
    if (u + 1 < n_units) transpose(u + 1);
    wgmma_wait0();
    // the sums exist from here on: no read of them moves above the wait
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(isum[i])::"memory");
    // accumulator i: column 8 (i / 4) + 2 t4 + (i & 1) of the tile
    const float* sc =
        reinterpret_cast<const float*>(smem + L::S0 + (u & 1) * GBN * 4);
    const int t4 = lane & 3;
#pragma unroll
    for (int nt = 0; nt < GBN / 8; ++nt) {
      const float2 s2 = *reinterpret_cast<const float2*>(sc + nt * 8 + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[4 * nt + i] = fmaf((float)isum[4 * nt + i],
                               (i & 1) ? s2.y : s2.x, acc[4 * nt + i]);
    }
  }
  cp_async_wait<0>();

  // accumulator i of a thread: row 16 (warp % 4) + g (+ 8 for i % 4 >= 2)
  // of its warpgroup, column 8 (i / 4) + 2 t4 (+ 1 for odd i)
  const int g = lane >> 2, t4 = lane & 3;
  const bool pair = (N & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m_base + wg * 64 + (warp & 3) * 16 + g + half * 8;
    if (r >= a.M) continue;
    const float rs = a.sx[r];
    float* o = a.out + (long)r * N;
#pragma unroll
    for (int nt = 0; nt < GBN / 8; ++nt) {
      const int c0 = n_base + nt * 8 + t4 * 2;
      const float v0 = acc[4 * nt + 2 * half] * rs;
      const float v1 = acc[4 * nt + 2 * half + 1] * rs;
      if (pair && c0 + 1 < N) {
        *reinterpret_cast<float2*>(o + c0) = make_float2(v0, v1);
      } else {
        if (c0 < N) o[c0] = v0;
        if (c0 + 1 < N) o[c0 + 1] = v1;
      }
    }
  }
}

// A launch as the programmatic dependent of the kernel before it on the
// stream (the quantize pass), in a cluster of (1, cluster_y, 1) blocks
// when cluster_y > 1.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             int smem, int cluster_y, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n_attr = 1;
  if (cluster_y > 1) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = 1;
    attr[1].val.clusterDim.y = cluster_y;
    attr[1].val.clusterDim.z = 1;
    ++n_attr;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// M rows a tile, `tiles` tiles (tile_ids null: one tile, one weight). K
// splits: as many as fill one wave of resident blocks without a second,
// at most a portable cluster and one 128-deep block each.
template <int MT>
cudaError_t launch_w8_gemv(const int8_t* x8, const float* sx,
                           const uint8_t* q, const float* s, int M, int K,
                           int N, float* out, int tiles, const int* tile_ids,
                           int n_slabs, cudaStream_t stream) {
  constexpr int smem = kRing * GemvStage<MT>::BYTES;
  static const cudaError_t attr_rc = cudaFuncSetAttribute(
      w8_gemv_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_rc != cudaSuccess) return attr_rc;
  static const int per_sm = [] {
    int n = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, w8_gemv_kernel<MT>,
                                                  32 * kGemvWarps, smem);
    return max(n, 1);
  }();
  const int blocks = (N + kGemvCols - 1) / kGemvCols * tiles;
  const int splits = max(
      1, min(min(per_sm * sm_count() / blocks, kMaxSplits), K / kW8Block));
  const auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = N % 16 == 0 && al(q) && al(s);
  return launch_dependent(w8_gemv_kernel<MT>,
                          dim3((N + kGemvCols - 1) / kGemvCols, splits, tiles),
                          dim3(32 * kGemvWarps), smem, splits, stream, x8, sx,
                          q, s, M, K, N, out, vec, tile_ids, n_slabs);
}

// The GEMV of M <= 16 rows a tile: one B tile of 8 rows, or two
cudaError_t launch_w8_gemv_rows(const int8_t* x8, const float* sx,
                                const uint8_t* q, const float* s, int M,
                                int K, int N, float* out, int tiles,
                                const int* tile_ids, int n_slabs,
                                cudaStream_t stream) {
  if (M <= 8)
    return launch_w8_gemv<8>(x8, sx, q, s, M, K, N, out, tiles, tile_ids,
                             n_slabs, stream);
  return launch_w8_gemv<16>(x8, sx, q, s, M, K, N, out, tiles, tile_ids,
                            n_slabs, stream);
}

cudaError_t launch_w8_gemm(const int8_t* x8, const float* sx,
                           const uint8_t* q, const float* s, int M, int K,
                           int N, float* out, const int* tile_ids,
                           int n_slabs, cudaStream_t stream) {
  static const cudaError_t attr_rc = cudaFuncSetAttribute(
      w8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W8Smem::BYTES);
  if (attr_rc != cudaSuccess) return attr_rc;
  // x8 [M, K] as 128 x 128 boxes under the 128-byte swizzle
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap tmx;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  cuuint64_t strides[1] = {(cuuint64_t)K};
  cuuint32_t box[2] = {kW8Block, GBM};
  cuuint32_t elem[2] = {1, 1};
  if (encode(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(x8), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const W8GemmArgs a{sx, q, s, out, M, K, N, N % 16 == 0 && al16(q),
                     N % 4 == 0 && al16(s), tile_ids, n_slabs};
  return launch_dependent(w8_wgmma_kernel,
                          dim3((M + GBM - 1) / GBM, (N + GBN - 1) / GBN),
                          dim3(kGemmThreads), W8Smem::BYTES, 1, stream, tmx,
                          a);
}

cudaError_t launch_quantize(const void* x, int8_t* x8, float* sx, int M,
                            int K, cudaStream_t stream) {
  w8_quantize_kernel<<<M, kPassThreads, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), K, x8, sx);
  return cudaGetLastError();
}

}  // namespace

// The quantize pass alone: x bf16 [M, K] (16-byte aligned) -> x8 int8
// [M, K], sx f32 [M]. Returns the launch's cudaError_t.
PS_EXPORT int ps_w8_quantize(const void* x, void* x8, void* sx, int M, int K,
                             void* stream_ptr) {
  if (K % kW8Block || M <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_quantize(x, reinterpret_cast<int8_t*>(x8),
                              reinterpret_cast<float*>(sx), M, K,
                              reinterpret_cast<cudaStream_t>(stream_ptr));
}

// One W8 product: the quantize pass of x bf16 [M, K] (16-byte aligned)
// into the scratch x8 int8 [M, K] (16-byte aligned) and sx f32 [M], then
// the product as its programmatic dependent (the GEMV at M <= 16, the
// GEMM above): q int8 [K, N], s f32 [K/128, N] -> out f32 [M, N]. Returns
// the first launch error.
PS_EXPORT int ps_qmatmul_w8(const void* x, void* x8, void* sx,
                            const void* q, const void* s, void* out, int M,
                            int K, int N, void* stream_ptr) {
  if (K % kW8Block || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  int8_t* xa = reinterpret_cast<int8_t*>(x8);
  float* xs = reinterpret_cast<float*>(sx);
  const uint8_t* qw = reinterpret_cast<const uint8_t*>(q);
  const float* sw = reinterpret_cast<const float*>(s);
  float* o = reinterpret_cast<float*>(out);
  cudaError_t e = launch_quantize(x, xa, xs, M, K, stream);
  if (e != cudaSuccess) return (int)e;
  const int8_t* xc = xa;
  const float* sc = xs;
  if (M <= 16)
    e = launch_w8_gemv_rows(xc, sc, qw, sw, M, K, N, o, 1, nullptr, 1, stream);
  else
    e = launch_w8_gemm(xc, sc, qw, sw, M, K, N, o, nullptr, 1, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The grouped mode: the quantize pass of x bf16 [P, K] (16-byte aligned)
// into the scratch x8 int8 [P, K] (16-byte aligned) and sx f32 [P], then
// the product: rows [i * block_m, (i + 1) * block_m) times slab
// tile_ids[i] (int32 [P / block_m], clipped to [0, n_slabs)) of q int8
// [n_slabs, K, N] with s f32 [n_slabs, K/128, N] -> out f32 [P, N];
// block_m 1..16 on the GEMV, 128 on the GEMM. Returns the first launch
// error.
PS_EXPORT int ps_qmatmul_w8_grouped(const void* x, void* x8, void* sx,
                                    const void* q, const void* s,
                                    const void* tile_ids, void* out, int P,
                                    int K, int N, int n_slabs, int block_m,
                                    void* stream_ptr) {
  if (K % kW8Block || P <= 0 || n_slabs <= 0 || block_m <= 0 ||
      P % block_m || (block_m > 16 && block_m != GBM) ||
      (block_m <= 16 && P / block_m > 65535))  // tiles on grid z
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  int8_t* xa = reinterpret_cast<int8_t*>(x8);
  float* xs = reinterpret_cast<float*>(sx);
  const uint8_t* qw = reinterpret_cast<const uint8_t*>(q);
  const float* sw = reinterpret_cast<const float*>(s);
  const int* ids = reinterpret_cast<const int*>(tile_ids);
  float* o = reinterpret_cast<float*>(out);
  cudaError_t e = launch_quantize(x, xa, xs, P, K, stream);
  if (e != cudaSuccess) return (int)e;
  if (block_m <= 16)
    e = launch_w8_gemv_rows(xa, xs, qw, sw, block_m, K, N, o, P / block_m,
                            ids, n_slabs, stream);
  else
    e = launch_w8_gemm(xa, xs, qw, sw, P, K, N, o, ids, n_slabs, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
