// The decode GEMV (M <= 16 rows) over the port's quantized weights,
// shared by csrc/qmatmul.cu (the plain product, dense and grouped) and
// csrc/fused_linear.cu (the same main loop behind a prologue pass, with
// the fused epilogue in the merge): one GEMV body.
//
//   y[m, n] = sum_k x[m, k] * w[k, n]   (x bf16 [M, K], f32 sums, f32 y)
//   then, per the epilogue: y += bias[n]; y = (r0 + r1)[m, n] + y; and
//   either y itself or, per 128-column tile and row, its (max, first
//   index) for an argmax
#pragma once

#include <cooperative_groups.h>

#include <climits>

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

// An f32 or bf16 operand.
struct Operand {
  const void* p;
  int bf16;
};

// What the merge does with a finished value (all null / 0: write y).
struct GemvEpilogue {
  const float* bias;  // f32 [N] or null
  Operand res[2];     // residuals [M, N], the first n_res of them
  int n_res;
  float* best_val;    // argmax: [N / 128 tiles][M] (max, first index) per
  int* best_idx;      // column tile and row, in place of y
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ---- decode GEMV (M <= 16) --------------------------------------------
//
// One warp owns 32 output columns, a block four warps (128 columns), and
// gridDim.y blocks split K; the splits of one column tile form a thread
// block cluster and add their partials through distributed shared memory
// in rank order (one launch, the same bits on every run). Per warp, a
// ring of kStages stages is filled by cp.async 16-byte copies; a stage is
// one "unit": 32 stored byte rows x the warp's 32 columns, the unit's
// scales (and minimums) and its rows of x. A packed unit's bytes hold two
// 32-row scale blocks, kb (low nibbles) and kb + G/64 (high nibbles), so
// every byte is read once and both halves are used; an unpacked (int8)
// unit is one block.
//
// The product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// out) with the weights' integer values as the A operand (16 columns x
// 16 k) and x as B (8 rows; a second mma for rows 8-15): nibbles and
// int8 values are exact in bf16, so the weights are not rounded.
// ldmatrix.trans hands each lane four bytes of two adjacent columns and
// two adjacent rows; the even column is A row g and the odd one A row
// g + 8 (a LOP3 with the 2^7 bf16 magic number and one bf16x2
// subtraction per two nibbles). Each block's f32 sums are then scaled
// once per column: s * sum(x * q) - b * sum(x), the TPU kernel's
// block-sum fold, with sum(x) from one more mma against a tile of ones.
// The f32 roundings are grouped otherwise than in the plain twin; the
// function is the same.
constexpr int kWarps = 4;
constexpr int kBlockCols = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kPitch = 48;  // bytes per staged weight row: ldmatrix rows
                            // hit 32 banks
constexpr int kTileBytes = 32 * kPitch;
constexpr int kScaleBytes = 4 * 128;  // s, b of up to two blocks, 32 f32 each
constexpr int kXPitch = 80;  // bytes per staged x row of 32 k: the B
                             // fragment loads of a warp hit 32 banks
constexpr int kMaxSplits = 8;  // the portable cluster size

__host__ __device__ constexpr int stage_bytes(int halves, int M) {
  return kTileBytes + kScaleBytes + halves * M * kXPitch;
}

// Bits 0-3 and 16-19 of v as two bf16 values, minus `sub` (0x43004300 |
// offset: 128 + offset in each half). 0x4300 | q is 128 + q exactly.
__device__ __forceinline__ uint32_t nib_pair(uint32_t v, uint32_t sub) {
  uint32_t t = (v & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t),
                             *reinterpret_cast<__nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// A lane's weight and scale chunks element by element, for weights whose
// rows are not 16-byte aligned (columns past N read as zero); out of line,
// so the loader's state stays in registers.
__device__ __noinline__ void load_slow(const uint8_t* w0, const uint8_t* w1,
                                       int c0, int c1, uint8_t* d0,
                                       uint8_t* d1, const char* sp, int scol,
                                       int esz, uint8_t* sd, int N) {
  for (int b = 0; b < 16; ++b) {
    d0[b] = c0 + b < N ? w0[b] : 0;
    d1[b] = c1 + b < N ? w1[b] : 0;
  }
  if (sp)
    for (int b = 0; b < 16; ++b) sd[b] = scol + b / esz < N ? sp[b] : 0;
}

// One lane's share of filling a stage with a unit: two 16-byte chunks of
// the unit's 32 byte rows (columns wc .. wc + 31 of the warp), one chunk
// of its scale or minimum rows, and chunks of its rows of x. The sources
// are computed once and stepped unit by unit; a packed unit's high-nibble
// block is half = G/2 rows after its low one, and at the end of a pack
// group the next unit's low block jumps past the group's high half.
template <int MT, bool PACKED, bool SBF16>
struct UnitLoader {
  static constexpr int kEsz = SBF16 ? 2 : 4;
  static constexpr int kPerArr = 2 * kEsz;  // 16-byte chunks of 32 columns
  static constexpr int kArrs = PACKED ? 4 : 2;  // s, b (low), s, b (high)
  static constexpr int kHalves = PACKED ? 2 : 1;
  static constexpr int kXChunks = kHalves * MT * 4 / 32;

  const uint8_t* wp[2];
  int wcol[2], wdst[2];
  const char* sp;
  int scol, sdst;
  bool sok;
  const __nv_bfloat16* xp[kXChunks];
  int xdst[kXChunks];
  bool xok[kXChunks];
  long wstep, sstep;
  int left, left_x, upg, half;

  __device__ __forceinline__ UnitLoader(const QWeight& w,
                                        const __nv_bfloat16* x, int M,
                                        int u0, int wc, int lane) {
    const int N = w.N;
    half = PACKED ? w.group / 2 : 0;
    upg = PACKED ? w.group / 64 : 1 << 30;
    int klo = 32 * u0;
    left = upg;
    if (PACKED) {
      const int g = u0 / upg, i = u0 - g * upg;
      klo = g * w.group + 32 * i;
      left = upg - i;
    }
    left_x = left;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = lane + 32 * i, row = ch >> 1;
      wcol[i] = wc + 16 * (ch & 1);
      wp[i] = w.q + (long)(32 * u0 + row) * N + wcol[i];
      wdst[i] = row * kPitch + 16 * (ch & 1);
    }
    wstep = 32L * N;
    const int arr = lane / kPerArr, ci = lane % kPerArr;
    const void* base = (arr & 1) ? w.bias : w.scales;
    sok = lane < kArrs * kPerArr && base != nullptr;
    scol = wc + ci * (16 / kEsz);
    sp = reinterpret_cast<const char*>(sok ? base : w.scales) +
         ((long)((arr < 2 ? klo : klo + half) / 32) * N + scol) * kEsz;
    sdst = kTileBytes + arr * 128 + ci * 16;
    sstep = (long)N * kEsz;
#pragma unroll
    for (int j = 0; j < kXChunks; ++j) {
      const int r = (lane >> 2) + 8 * j;  // x row h * MT + m of the stage
      const int h = r / MT, m = r % MT;
      xok[j] = m < M;
      xp[j] = x + (long)(xok[j] ? m : 0) * w.K + (h ? klo + half : klo) +
              8 * (lane & 3);
      xdst[j] = kTileBytes + kScaleBytes + r * kXPitch + 16 * (lane & 3);
    }
  }

  __device__ __forceinline__ void load(const QWeight& w, bool vec,
                                       uint8_t* st) const {
    load_w(w, vec, st);
    load_x(st);
  }

  // the unit's weight and scale chunks
  __device__ __forceinline__ void load_w(const QWeight& w, bool vec,
                                         uint8_t* st) const {
    if (vec) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cp_async16(st + wdst[i], wcol[i] < w.N ? wp[i] : w.q, wcol[i] < w.N);
      if (sok) cp_async16(st + sdst, scol < w.N ? sp : w.scales, scol < w.N);
    } else {
      load_slow(wp[0], wp[1], wcol[0], wcol[1], st + wdst[0], st + wdst[1],
                sok ? sp : nullptr, scol, kEsz, st + sdst, w.N);
    }
  }

  // the unit's rows of x
  __device__ __forceinline__ void load_x(uint8_t* st) const {
#pragma unroll
    for (int j = 0; j < kXChunks; ++j)
      if (xok[j]) cp_async16(st + xdst[j], xp[j], true);
  }

  __device__ __forceinline__ void next() {
    next_w();
    next_x();
  }

  __device__ __forceinline__ void next_w() {
#pragma unroll
    for (int i = 0; i < 2; ++i) wp[i] += wstep;
    sp += sstep;
    if (PACKED && --left == 0) {
      left = upg;
      sp += (long)(half / 32) * sstep;
    }
  }

  __device__ __forceinline__ void next_x() {
    int dk = 32;
    if (PACKED && --left_x == 0) {
      left_x = upg;
      dk += half;
    }
#pragma unroll
    for (int j = 0; j < kXChunks; ++j) xp[j] += dk;
  }
};

// acc[cg][rb][i]: column wc + 16 cg + 2 g + (i >> 1), row 2 t4 + (i & 1)
// + 8 rb.
template <int MT, bool PACKED, bool SBF16>
__device__ __forceinline__ void gemv_unit(const QWeight& w, const uint8_t* st,
                                          const uint8_t* zero, int M, int lane,
                                          float (&acc)[2][2][4]) {
  constexpr int RB = MT > 8 ? 2 : 1;
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t q[2][4];  // [k16 step][rows 0-7 | 8-15 x columns 0-15 | 16-31]
#pragma unroll
  for (int s = 0; s < 2; ++s)
    ldsm_x4_trans(q[s], st + (16 * s + (lane & 15)) * kPitch + (lane >> 4) * 16);
  const uint32_t sub = 0x43004300u | (uint32_t)w.offset * 0x00010001u;
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                            0x3F803F80u};
#pragma unroll
  for (int h = 0; h < (PACKED ? 2 : 1); ++h) {
    // lanes of rows M .. MT - 1 read a row of zeros
    const uint8_t* xs = st + kTileBytes + kScaleBytes + h * MT * kXPitch;
    uint32_t xb[RB][2][2];  // B fragments: [row block][k16 step]
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          xb[rb][s][r] = *reinterpret_cast<const uint32_t*>(
              (g + 8 * rb < M ? xs + (g + 8 * rb) * kXPitch : zero) +
              (16 * s + 8 * r + 2 * t4) * 2);
    float c[2][RB][4], xsum[RB][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (w.bias) {
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          if (s == 0)
            mma_16816_zero(xsum[rb], ones, xb[rb][s]);
          else
            mma_16816(xsum[rb], ones, xb[rb][s]);
        }
      }
#pragma unroll
      for (int cg = 0; cg < 2; ++cg) {
        const uint32_t lo = q[s][2 * cg], hi = q[s][2 * cg + 1];
        uint32_t a[4];
        if (PACKED) {
          a[0] = nib_pair(lo >> (4 * h), sub);
          a[1] = nib_pair(lo >> (4 * h + 8), sub);
          a[2] = nib_pair(hi >> (4 * h), sub);
          a[3] = nib_pair(hi >> (4 * h + 8), sub);
        } else {
          a[0] = i8_even_bf16x2(lo);
          a[1] = i8_even_bf16x2(lo >> 8);
          a[2] = i8_even_bf16x2(hi);
          a[3] = i8_even_bf16x2(hi >> 8);
        }
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          if (s == 0)
            mma_16816_zero(c[cg][rb], a, xb[rb][s]);
          else
            mma_16816(c[cg][rb], a, xb[rb][s]);
        }
      }
    }
    // scale once per block and column; fold the minimum through sum(x)
    const uint8_t* sc = st + kTileBytes + 2 * h * 128;
#pragma unroll
    for (int cg = 0; cg < 2; ++cg) {
      const int col = 16 * cg + 2 * g;
      float se, so, be = 0.f, bo = 0.f;
      if (SBF16) {
        const uint32_t sv = *reinterpret_cast<const uint32_t*>(sc + col * 2);
        se = bf_lo(sv), so = bf_hi(sv);
        if (w.bias) {
          const uint32_t bv =
              *reinterpret_cast<const uint32_t*>(sc + 128 + col * 2);
          be = bf_lo(bv), bo = bf_hi(bv);
        }
      } else {
        const float2 sv = *reinterpret_cast<const float2*>(sc + col * 4);
        se = sv.x, so = sv.y;
        if (w.bias) {
          const float2 bv = *reinterpret_cast<const float2*>(sc + 128 + col * 4);
          be = bv.x, bo = bv.y;
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        float* a = acc[cg][rb];
        const float* v = c[cg][rb];
        a[0] = fmaf(se, v[0], a[0]);
        a[1] = fmaf(se, v[1], a[1]);
        a[2] = fmaf(so, v[2], a[2]);
        a[3] = fmaf(so, v[3], a[3]);
        if (w.bias) {
          a[0] = fmaf(-be, xsum[rb][0], a[0]);
          a[1] = fmaf(-be, xsum[rb][1], a[1]);
          a[2] = fmaf(-bo, xsum[rb][0], a[2]);
          a[3] = fmaf(-bo, xsum[rb][1], a[3]);
        }
      }
    }
  }
}

// M rows per tile (grid z), out [tiles * M, N]; gridDim.y K splits, one
// cluster per column tile and tile when gridDim.y > 1. Dynamic shared
// memory: a ring of kStages stages and 64 bytes of zeros per warp.
template <int MT, bool PACKED, bool SBF16>
__global__ __launch_bounds__(32 * kWarps, MT > 8 ? 2 : 4) void
qmm_gemv_kernel(QWeight w, Slabs sl, const __nv_bfloat16* x, int M,
                float* out, int vec, GemvEpilogue ep, int dependent) {
  __shared__ float arg_v[kWarps];
  __shared__ int arg_i[kWarps];
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = blockIdx.z;
  w = pick_slab(w, sl, tile);
  x += (long)tile * M * w.K;
  out += (long)tile * M * w.N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc = blockIdx.x * kBlockCols + warp * 32;
  const int units = PACKED ? w.K / 64 : w.K / 32;
  const int splits = gridDim.y;
  const int u0 = (int)((long)blockIdx.y * units / splits);
  const int u1 = (int)((long)(blockIdx.y + 1) * units / splits);
  constexpr int sb = stage_bytes(PACKED ? 2 : 1, MT);
  uint8_t* ring = smem + warp * (kStages * sb + 64);
  uint8_t* zero = ring + kStages * sb;  // x rows past M read these zeros

  float acc[2][2][4];
#pragma unroll
  for (int cg = 0; cg < 2; ++cg)
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[cg][rb][i] = 0.f;

  if (lane < 16) reinterpret_cast<uint32_t*>(zero)[lane] = 0u;
  UnitLoader<MT, PACKED, SBF16> ld(w, x, M, u0, wc, lane);  // the next unit
  if (dependent) {
    // launched as a dependent of the prologue pass (fused_linear.cu): the
    // first stages' weights stream while that pass runs, their rows of x
    // once it is done; stage 0's group holds all those weights
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s)
      if (u0 + s < u1) {
        ld.load_w(w, vec, ring + s * sb);
        ld.next_w();
      }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (u0 + s < u1) {
        ld.load_x(ring + s * sb);
        ld.next_x();
      }
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (u0 + s < u1) {
        ld.load(w, vec, ring + s * sb);
        ld.next();
      }
      cp_async_commit();
    }
  }
  // the ring unrolled, so every stage's offset is a constant
  for (int base = u0; base < u1; base += kStages) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int u = base + s;
      if (u >= u1) break;
      cp_async_wait<kStages - 2>();
      __syncwarp();
      // the slot of the unit before this one is free: refill it
      if (u + kStages - 1 < u1) {
        ld.load(w, vec, ring + (s + kStages - 1) % kStages * sb);
        ld.next();
      }
      cp_async_commit();
      gemv_unit<MT, PACKED, SBF16>(w, ring + s * sb, zero, M, lane, acc);
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's partial [M, 128] into shared memory, then the splits of
  // the cluster add theirs in rank order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int cg = 0; cg < 2; ++cg)
#pragma unroll
    for (int rb = 0; rb < (MT > 8 ? 2 : 1); ++rb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 2 * t4 + (i & 1) + 8 * rb;
        const int col = warp * 32 + 16 * cg + 2 * g + (i >> 1);
        if (m < M) red[m * kBlockCols + col] = acc[cg][rb][i];
      }
  if (splits > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
  // with gridDim.y = the cluster's y extent, the rank is the split index;
  // every thread of a block takes the same row m in each pass
  for (int i = blockIdx.y * kBlockCols + threadIdx.x; i < M * kBlockCols;
       i += splits * kBlockCols) {
    const int m = i / kBlockCols;
    const int n = blockIdx.x * kBlockCols + i % kBlockCols;
    float v = 0.f;
    for (int r = 0; r < splits; ++r)
      v += (splits > 1 ? cooperative_groups::this_cluster().map_shared_rank(red, r)
                       : red)[i];
    if (n < w.N) {
      if (ep.bias) v += ep.bias[n];
      if (ep.n_res) {
        const long e = (long)m * w.N + n;
        float rs = ld_scale(ep.res[0].p, e, ep.res[0].bf16);
        if (ep.n_res > 1) rs += ld_scale(ep.res[1].p, e, ep.res[1].bf16);
        v = rs + v;
      }
    }
    if (!ep.best_val) {
      if (n < w.N) out[(long)m * w.N + n] = v;
      continue;
    }
    float bv = n < w.N ? v : -INFINITY;
    int bi = n < w.N ? n : INT_MAX;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
    }
    if ((threadIdx.x & 31) == 0) {
      arg_v[threadIdx.x >> 5] = bv;
      arg_i[threadIdx.x >> 5] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 1; t < kWarps; ++t)
        if (better(arg_v[t], arg_i[t], bv, bi)) bv = arg_v[t], bi = arg_i[t];
      ep.best_val[(long)blockIdx.x * M + m] = bv;
      ep.best_idx[(long)blockIdx.x * M + m] = bi;
    }
    __syncthreads();
  }
  // keep this block's partial until every block of the cluster read it
  if (splits > 1) cooperative_groups::this_cluster().sync();
}

// K splits: about three blocks per SM, at most a cluster's worth, at
// least one unit each.
int gemv_splits(const QWeight& w, int tiles) {
  const int units = w.packed ? w.K / 64 : w.K / 32;
  const long blocks = (long)((w.N + kBlockCols - 1) / kBlockCols) * tiles;
  const int want = (int)((3L * sm_count() + blocks - 1) / blocks);
  return max(1, min(min(want, kMaxSplits), units));
}

template <int MT, bool PACKED, bool SBF16>
cudaError_t launch_gemv_t(const QWeight& w, const Slabs& sl,
                          const __nv_bfloat16* x, int M, int tiles, float* out,
                          int vec, const GemvEpilogue& ep,
                          cudaStream_t stream, bool dependent) {
  const auto kernel = qmm_gemv_kernel<MT, PACKED, SBF16>;
  constexpr int smem =
      kWarps * (kStages * stage_bytes(PACKED ? 2 : 1, MT) + 64);
  static const cudaError_t attr_rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_rc != cudaSuccess) return attr_rc;
  const int splits = gemv_splits(w, tiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((w.N + kBlockCols - 1) / kBlockCols, splits, tiles);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n_attr = 0;
  if (splits > 1) {
    attr[n_attr].id = cudaLaunchAttributeClusterDimension;
    attr[n_attr].val.clusterDim.x = 1;
    attr[n_attr].val.clusterDim.y = splits;
    attr[n_attr].val.clusterDim.z = 1;
    ++n_attr;
  }
  if (dependent) {
    attr[n_attr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attr].val.programmaticStreamSerializationAllowed = 1;
    ++n_attr;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  return cudaLaunchKernelEx(&cfg, kernel, w, sl, x, M, out, vec, ep,
                            (int)dependent);
}

// x bf16 [tiles * M, K], rows 16-byte aligned; out f32 [tiles * M, N]
// (unused with an argmax epilogue). dependent: x comes from the kernel
// launched just before on the stream (programmatic dependent launch).
cudaError_t launch_gemv(const QWeight& w, const Slabs& sl,
                        const __nv_bfloat16* x, int M, int tiles, float* out,
                        const GemvEpilogue& ep, cudaStream_t stream,
                        bool dependent = false) {
  const int esz = w.scale_bf16 ? 2 : 4;
  const auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = w.N % 16 == 0 && al(w.q) && al(w.scales) &&
                  (!w.bias || al(w.bias)) && (w.N * esz) % 16 == 0;
#define PS_GEMV(MT, P, B) \
  return launch_gemv_t<MT, P, B>(w, sl, x, M, tiles, out, vec, ep, stream, \
                                 dependent)
  if (M <= 8) {
    if (w.packed) {
      if (w.scale_bf16) PS_GEMV(8, true, true);
      PS_GEMV(8, true, false);
    }
    if (w.scale_bf16) PS_GEMV(8, false, true);
    PS_GEMV(8, false, false);
  }
  if (w.packed) {
    if (w.scale_bf16) PS_GEMV(16, true, true);
    PS_GEMV(16, true, false);
  }
  if (w.scale_bf16) PS_GEMV(16, false, true);
  PS_GEMV(16, false, false);
#undef PS_GEMV
}

}  // namespace
