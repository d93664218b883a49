// Dequant matmul y[M, N] = x[M, K] @ w[K, N] over the port's quantized
// weights (Q4_0 / Q4_K nibble-packed, Q8_0 and 4-bit values unpacked as
// int8; f32 or bf16 scales; optional per-block minimum), bf16 x, f32
// weights and f32 accumulation, f32 out (the GEMV applies each block's
// scale and minimum to f32 sums over the block: the same function, its
// f32 roundings grouped otherwise). Rows beyond 16 (prefill) round the
// dequantized weight to bf16 for the tensor cores, as the TPU kernel's
// bf16 MXU dots do above its decode-sized M.
//
// Replaces the TPU kernel powerserve_tpu/ops/qmatmul.py::_qmatmul_pallas
// (body _make_kernel), which K-tiles one (bm, bn) block per grid step
// and carries an f32 accumulator in VMEM scratch across the sequential
// K axis.
//
// What bounds it on an H100:
//  - decode (M <= 16): weight bytes. 4096 x 28672 Q4_K with bf16 scales
//    and mins is ~73 MB, ~22 us at 3.35 TB/s; the activations are a few
//    KB. The GEMV (csrc/gemv.cuh, which csrc/fused_linear.cu runs too)
//    reads every packed byte once with 16-byte
//    cp.async copies through a per-warp ring, multiplies on the tensor
//    cores (the integer weight values are exact bf16 operands), folds
//    scale and minimum out of the inner loop once per 32-row block, and
//    adds its K splits inside one cluster in a fixed order: one launch,
//    the same bits on every run.
//  - prefill (M = 512): operations, 2 * M * N * K at 989 TFLOP/s bf16
//    (4096 -> 28672: 0.122 ms); in practice the bytes the SMs pull from
//    the L2, since every 128-column tile reads all of x again. A 128 x
//    128 output tile per block, two blocks an SM. K advances a unit of
//    two 32-deep scale blocks at a time: 32 packed byte rows (their low
//    and high nibbles are two blocks G / 2 apart in K, so a unit reads
//    its bytes once; nibbles travel at a quarter of bf16's bytes) or 64
//    int8 rows. x arrives by TMA (two 32 x 128 boxes a unit under the
//    64-byte swizzle, an mbarrier per stage; per-thread cp.async of x
//    could not keep the tensor cores fed); the weight bytes, scales and
//    minimums by cp.async, four units ahead. The block dequantizes the
//    next unit, each weight in f32 as qmatmul_reference does (value *
//    scale, then - minimum, each rounded; 2^23 + value built by a byte
//    permute rather than a quarter-rate int-to-float conversion) and to
//    bf16, into the other of two MN-major tiles, while the tensor cores
//    run the current unit: two warpgroups, each four wgmma m64n128k16
//    with both operands in shared memory. One barrier a unit.
//    Tried on the card and slower (PERF.md): mma.sync fed by ldmatrix, a
//    128 x 256 tile at one block an SM, producer and consumer
//    warpgroups, and x multicast across a two-block cluster.
// Ragged M, N are masked in both; K is a multiple of 32 by format.
//
// Grouped mode (ps_qmatmul_grouped) replaces the same TPU kernel called
// with `tile_ids` (qmatmul_grouped, the MoE expert FFN): the weights are
// a stack of E slabs [E, ...], rows [i * tile_m, (i + 1) * tile_m) of x
// multiply slab tile_ids[i]. Each block reads its tile's slab index from
// device memory (the TPU's scalar prefetch) and offsets its weight
// pointers; ids are clipped into the stack, so padding tiles read in
// bounds. tile_m <= 16 runs the GEMV (one grid z per tile), tile_m = 128
// the prefill GEMM with bf16 weights (one block row per tile): numerics
// follow the tile, not the total row count. The bound counts the bytes
// of the distinct slabs the ids name.
#include "gemv.cuh"

namespace {

// The prefill GEMM's tile: 128 x 128 outputs, two warpgroups of 64 x
// 128. Its K step (a unit) is two 32-deep scale blocks: 32 packed byte
// rows (their low and high nibbles: two blocks G / 2 apart in K) or 64
// unpacked rows.
constexpr int TBM = 128;
constexpr int TBN = 128;
constexpr int kThreads = 256;
constexpr int UK = 64;           // k values of a unit
constexpr int WP = TBN + 16;     // staged weight row pitch (bytes)
constexpr int kXStages = 2;  // x tiles: unit u multiplied, u + 1 in flight
constexpr int kWStages = 4;  // weight units: u + 1 dequantized, 3 in flight
// x as wgmma's A operand: each 32-deep block of 128 rows lands by TMA
// as [128][64 bytes] with the 64-byte swizzle (8-row groups 512 bytes
// apart); the dequantized weight as B, MN-major core matrices (8 rows x
// 16 bytes, no swizzle), [k / 8][n / 8][k % 8][n % 8]
constexpr int X_BOX = TBM * 32 * 2;  // one block of x: 8 KB
constexpr int X_SBO = 512;
constexpr int W_LBO = 128 * (TBN / 8), W_SBO = 128;

// Two rings: x stages (two TMA boxes, 1024-byte aligned), and weight
// stages (the unit's stored rows [32 or 64][WP], its scales and minimums
// [2 arrays][2 blocks][TBN], room for f32); then two dequantized units
// [UK x TBN] bf16, then the x stages' barriers.
template <bool PACKED>
struct GemmSmem {
  static constexpr int XS = 2 * X_BOX;
  static constexpr int WS = (PACKED ? 32 : 64) * WP;
  static constexpr int SS = 2 * 2 * TBN * 4;
  static constexpr int WSTAGE = WS + SS;
  static constexpr int WD = UK * TBN * 2;
  static constexpr int W0 = kXStages * XS;                // weight ring
  static constexpr int D0 = W0 + kWStages * WSTAGE;       // dequantized
  static constexpr int B0 = D0 + 2 * WD;                  // barriers
  static constexpr int BYTES = B0 + 8 * kXStages + 1024;  // + alignment
};

struct GemmArgs {
  QWeight w;
  Slabs sl;
  const __nv_bfloat16* x;
  float* out;
  int M;          // rows of x (all tiles)
  int wvec;       // weight rows copy 16 bytes at a time (N % 16 == 0)
  int svec;       // scale rows copy 16 bytes at a time
};

// Scale blocks (lo, hi) of unit u and its first stored row: packed, the
// low and high nibbles of stored rows [32 u, 32 u + 32); unpacked, rows
// [64 u, 64 u + 64) (hi = -1 past K).
template <bool PACKED>
__device__ __forceinline__ void unit_blocks(const QWeight& w, int u, int* lo,
                                            int* hi, int* row0) {
  if (PACKED) {
    const int half = w.group / 2;
    const int r0 = 32 * u, g = r0 / half, i0 = r0 - g * half;
    *lo = (g * w.group + i0) / 32;
    *hi = (g * w.group + half + i0) / 32;
    *row0 = r0;
  } else {
    *lo = 2 * u;
    *hi = 2 * u + 1 < w.K / 32 ? 2 * u + 1 : -1;
    *row0 = 64 * u;
  }
}

// d[64 x 128] += a[64 x 16] (K-major) * b[16 x 128] (MN-major), bf16 in,
// f32 accumulators in the mma.sync C layout per 8-column tile
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Byte j of v (< 256) as the float v_j - off, exactly: 2^23 + v_j built
// by a byte permute into the bits of 2^23, then one subtraction (no
// quarter-rate int-to-float conversion).
__device__ __forceinline__ float byte_value(uint32_t v, int j, float off) {
  const uint32_t b = __byte_perm(v, 0x4B000000u, 0x7440 | j);
  return __fsub_rn(__uint_as_float(b), 8388608.f + off);
}

// v * s - b in f32 with the twin's two roundings. A value (|v| < 256,
// 8 bits) times a bf16 scale (8 significant bits) is exact in f32, so
// one fused multiply-add rounds the same as the rounded product then
// the rounded difference; f32 scales need both steps.
template <bool SBF16>
__device__ __forceinline__ float scale_value(float v, float s, float b) {
  if (SBF16) return __fmaf_rn(v, s, -b);
  return __fsub_rn(__fmul_rn(v, s), b);
}

// Each block: one 128-row tile of x (blockIdx.x; in grouped mode one
// tile of one slab) against 128 columns of the weight (blockIdx.y). x
// streams by TMA (two stages), the weight's stored bytes, scales and
// minimums by cp.async (four stages). Each warpgroup issues a unit's
// four wgmma m64n128k16 (x and the dequantized weight both from shared
// memory), then, while they run, the block dequantizes the next unit
// into the other of two bf16 tiles, each weight in f32 exactly as
// qmatmul_reference does (value * scale, then - minimum, each rounded),
// then to bf16: one barrier a unit.
template <bool PACKED, bool SBF16>
__global__ __launch_bounds__(kThreads, 2) void qmm_mma_kernel(
    const __grid_constant__ CUtensorMap tmx, GemmArgs a) {
  using L = GemmSmem<PACKED>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - ((uintptr_t)smem_raw & 1023)) & 1023);
  const QWeight w = pick_slab(a.w, a.sl, blockIdx.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_base = blockIdx.x * TBM, n_base = blockIdx.y * TBN;
  const int K = w.K, N = w.N;
  const int n_units = PACKED ? K / 64 : (K + 63) / 64;
  constexpr int es = SBF16 ? 2 : 4;  // bytes of a scale
  constexpr int rows = PACKED ? 32 : 64;  // stored weight rows of a unit
  __nv_bfloat16* wd = reinterpret_cast<__nv_bfloat16*>(smem + L::D0);

  // x of unit u into x slot u % kXStages by TMA (one thread): its two
  // 32-deep blocks of the block's 128 rows; rows past the tensor and a
  // block past K read zeros. The slot's barrier completes on the bytes.
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(smem + L::B0);
  auto issue_x = [&](int u) {
    const int slot = u % kXStages;
    const uint32_t bar = bar0 + 8 * slot;
    const uint32_t dst =
        (uint32_t)__cvta_generic_to_shared(smem + slot * L::XS);
    int kb[2], row0;
    unit_blocks<PACKED>(w, u, &kb[0], &kb[1], &row0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(L::XS) : "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kb[h] >= 0 ? kb[h] * 32 : K;
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
          ::"r"(dst + h * X_BOX), "l"((uint64_t)&tmx), "r"(k), "r"(m_base),
            "r"(bar) : "memory");
    }
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
  // stage unit u's weight bytes, scales and minimums into weight slot
  // u % kWStages; columns past N and blocks past K read zeros
  auto issue_w = [&](int u) {
    uint8_t* ws = smem + L::W0 + (u % kWStages) * L::WSTAGE;
    uint8_t* ss = ws + L::WS;
    int kb[2], row0;
    unit_blocks<PACKED>(w, u, &kb[0], &kb[1], &row0);
    // weight bytes: the unit's stored rows, 128 columns
    const int rows_k = PACKED ? rows : (kb[1] >= 0 ? 64 : 32);
    if (a.wvec) {
#pragma unroll
      for (int i = 0; i < rows * (TBN / 16) / kThreads; ++i) {
        const int e = tid + kThreads * i;
        const int r = e / (TBN / 16), c = (e % (TBN / 16)) * 16;
        const bool ok = r < rows_k && n_base + c < N;
        const uint8_t* src = w.q + (ok ? (long)(row0 + r) * N + n_base + c : 0);
        cp_async16(ws + r * WP + c, src, ok);
      }
    } else {
      for (int e = tid; e < rows * TBN; e += kThreads) {
        const int r = e / TBN, c = e - r * TBN;
        const bool ok = r < rows_k && n_base + c < N;
        ws[r * WP + c] =
            ok ? __ldg(w.q + (long)(row0 + r) * N + n_base + c) : 0;
      }
    }
    // scales, then minimums: [2 blocks][128] of each
    for (int arr = 0; arr < (w.bias ? 2 : 1); ++arr) {
      const uint8_t* base =
          reinterpret_cast<const uint8_t*>(arr ? w.bias : w.scales);
      uint8_t* dst = ss + arr * 2 * TBN * 4;
      if (a.svec) {
        constexpr int per = TBN * es / 16;  // 16-byte copies per block row
        if (tid < 2 * per) {
          const int h = tid / per, c = (tid - h * per) * 16;
          const bool ok = kb[h] >= 0 && n_base + c / es < N;
          const uint8_t* src =
              base + (ok ? ((long)kb[h] * N + n_base) * es + c : 0);
          cp_async16(dst + h * TBN * es + c, src, ok);
        }
      } else {
        for (int e = tid; e < 2 * TBN; e += kThreads) {
          const int h = e / TBN, c = e - h * TBN;
          const bool ok = kb[h] >= 0 && n_base + c < N;
          const long idx = (long)kb[h] * N + n_base + c;
          if (SBF16)
            reinterpret_cast<uint16_t*>(dst)[h * TBN + c] =
                ok ? reinterpret_cast<const uint16_t*>(base)[idx] : 0;
          else
            reinterpret_cast<float*>(dst)[h * TBN + c] =
                ok ? reinterpret_cast<const float*>(base)[idx] : 0.f;
        }
      }
    }
  };

  // dequantize unit u into wd tile u % 2. A thread takes 8 columns and
  // stored rows r0 + 16 j (r0 = tid % 16): packed, rows r0 and r0 + 16,
  // their low nibbles k = row (block 0) and high nibbles k = 32 + row
  // (block 1); unpacked, rows r0 + 32 h + 16 j of block h. It unpacks a
  // block's 8 scales and minimums once for its rows; a warp's lanes store
  // 16 consecutive k of one column group (whole core-matrix rows).
  static_assert(TBN / 8 * 16 == kThreads, "one column group a half-warp");
  auto dequant = [&](int u) {
    const uint8_t* ws = smem + L::W0 + (u % kWStages) * L::WSTAGE;
    const uint8_t* ss = ws + L::WS;
    __nv_bfloat16* dst = wd + (u & 1) * (UK * TBN);
    const int r0 = tid & 15, n8 = (tid >> 4) * 8;
    const float o = PACKED ? (float)w.offset : 128.f;
    uint2 qp[2];
    if (PACKED)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        qp[j] = *reinterpret_cast<const uint2*>(ws + (r0 + 16 * j) * WP + n8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sc[8], mn[8];
#pragma unroll
      for (int arr = 0; arr < 2; ++arr) {
        float* v = arr ? mn : sc;
        if (arr && !w.bias) {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = 0.f;
          continue;
        }
        const uint8_t* src = ss + arr * 2 * TBN * 4 + (h * TBN + n8) * es;
        if (SBF16) {
          const uint4 t = *reinterpret_cast<const uint4*>(src);
          const uint32_t tw[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = __uint_as_float(tw[j] << 16);
            v[2 * j + 1] = __uint_as_float(tw[j] & 0xFFFF0000u);
          }
        } else {
          const float4 t0 = *reinterpret_cast<const float4*>(src);
          const float4 t1 = *reinterpret_cast<const float4*>(src + 16);
          v[0] = t0.x, v[1] = t0.y, v[2] = t0.z, v[3] = t0.w;
          v[4] = t1.x, v[5] = t1.y, v[6] = t1.z, v[7] = t1.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = PACKED ? r0 + 16 * j : r0 + 32 * h + 16 * j;
        const int k = PACKED ? 32 * h + row : row;
        uint32_t words[2];
        if (PACKED) {
          words[0] = (qp[j].x >> (4 * h)) & 0x0F0F0F0Fu;
          words[1] = (qp[j].y >> (4 * h)) & 0x0F0F0F0Fu;
        } else {  // int8 + 128, then 128 more in the offset
          const uint2 q = *reinterpret_cast<const uint2*>(ws + row * WP + n8);
          words[0] = q.x ^ 0x80808080u;
          words[1] = q.y ^ 0x80808080u;
        }
        uint32_t packed[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t wv = words[c >> 1];
          const int b0 = 2 * (c & 1);
          const float f0 = scale_value<SBF16>(byte_value(wv, b0, o),
                                              sc[2 * c], mn[2 * c]);
          const float f1 = scale_value<SBF16>(byte_value(wv, b0 + 1, o),
                                              sc[2 * c + 1], mn[2 * c + 1]);
          packed[c] = pack_bf16(f0, f1);
        }
        *reinterpret_cast<uint4*>(
            dst + ((k >> 3) * (TBN / 8) + (n8 >> 3)) * 64 + (k & 7) * 8) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63

  // the rings: while unit u is multiplied and unit u + 1 dequantized, x
  // of unit u + 1 (TMA) and the weights of units u + 2 .. u + 4
  // (cp.async, one commit group a unit) are in flight
  static_assert(kXStages == 2, "one x tile in flight");
  constexpr int kWAhead = kWStages - 1;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kXStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(bar0 + 8 * i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_units > 0) issue_x(0);
  for (int p = 0; p <= kWAhead; ++p) {
    if (p < n_units) issue_w(p);
    cp_async_commit();
  }
  cp_async_wait<kWAhead>();  // W0 has landed
  __syncthreads();
  if (n_units > 0) dequant(0);
  for (int u = 0; u < n_units; ++u) {
    wait_x(u);                     // x(u) has landed
    cp_async_wait<kWAhead - 1>();  // W(u + 1) has landed
    fence_proxy_async();  // the dequantized tile, to wgmma
    __syncthreads();      // unit u is dequantized; unit u - 1 is done
    if (tid == 0 && u + 1 < n_units) issue_x(u + 1);
    if (u + 1 + kWAhead < n_units) issue_w(u + 1 + kWAhead);
    cp_async_commit();
    const uint8_t* xs = smem + (u % kXStages) * L::XS + wg * 64 * 64;
    const uint8_t* wt =
        reinterpret_cast<const uint8_t*>(wd + (u & 1) * (UK * TBN));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < UK / 16; ++ks)
      wgmma_m64n128k16(
          acc, smem_desc(xs + (ks >> 1) * X_BOX + (ks & 1) * 32, 16, X_SBO, 2),
          smem_desc(wt + ks * 2 * W_LBO, W_LBO, W_SBO, 0));
    wgmma_commit();
    if (u + 1 < n_units) dequant(u + 1);
    wgmma_wait0();
  }
  cp_async_wait<0>();

  // accumulator i of a thread: row 16 (warp % 4) + g (+ 8 for i % 4 >= 2)
  // of its warpgroup, column 8 (i / 4) + 2 t4 (+ 1 for odd i)
  const int g = lane >> 2, t4 = lane & 3;
  const bool pair = (N & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int nt = 0; nt < TBN / 8; ++nt) {
    const int c0 = n_base + nt * 8 + t4 * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m_base + wg * 64 + (warp & 3) * 16 + g + half * 8;
      if (r >= a.M) continue;
      float* o = a.out + (long)r * N + c0;
      const float v0 = acc[4 * nt + 2 * half], v1 = acc[4 * nt + 2 * half + 1];
      if (pair && c0 + 1 < N) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (c0 < N) o[0] = v0;
        if (c0 + 1 < N) o[1] = v1;
      }
    }
  }
}

template <bool PACKED, bool SBF16>
cudaError_t launch_gemm_t(const CUtensorMap& tmx, const GemmArgs& a,
                          int m_tiles, cudaStream_t stream) {
  const auto kernel = qmm_mma_kernel<PACKED, SBF16>;
  constexpr int smem = GemmSmem<PACKED>::BYTES;
  static const cudaError_t attr_rc = [kernel] {
    // all of the SM's shared memory: two blocks of ~94 KB an SM
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  if (attr_rc != cudaSuccess) return attr_rc;
  dim3 grid(m_tiles, (a.w.N + TBN - 1) / TBN);
  kernel<<<grid, kThreads, smem, stream>>>(tmx, a);
  return cudaGetLastError();
}

// M rows per tile, `tiles` tiles (1 for a plain weight).
int run_qmatmul(const QWeight& w, const Slabs& sl, const __nv_bfloat16* xb,
                int M, int tiles, float* o, cudaStream_t stream) {
  if (M <= 16) {
    const cudaError_t e =
        launch_gemv(w, sl, xb, M, tiles, o, GemvEpilogue{}, stream);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
  }
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  GemmArgs a{w, sl, xb, o, M * tiles, 0, 0};
  const long es = w.scale_bf16 ? 2 : 4;
  a.wvec = w.N % 16 == 0 && al16(w.q);
  a.svec = (w.N * es) % 16 == 0 && al16(w.scales) && (!w.bias || al16(w.bias));
  const int m_tiles = (M * tiles + TBM - 1) / TBM;
  // x [M * tiles, K] bf16 as 32 x 128 boxes under the 64-byte swizzle
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tmx;
  cuuint64_t dims[2] = {(cuuint64_t)w.K, (cuuint64_t)M * tiles};
  cuuint64_t strides[1] = {(cuuint64_t)w.K * 2};
  cuuint32_t box[2] = {32, TBM};
  cuuint32_t elem[2] = {1, 1};
  if (encode(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<__nv_bfloat16*>(xb), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (w.packed)
    e = w.scale_bf16 ? launch_gemm_t<true, true>(tmx, a, m_tiles, stream)
                     : launch_gemm_t<true, false>(tmx, a, m_tiles, stream);
  else
    e = w.scale_bf16 ? launch_gemm_t<false, true>(tmx, a, m_tiles, stream)
                     : launch_gemm_t<false, false>(tmx, a, m_tiles, stream);
  return (int)e;
}

}  // namespace

// x bf16 [M, K] (16-byte aligned); out f32 [M, N]. Returns the launch's
// cudaError_t.
PS_EXPORT int ps_qmatmul(const void* x, const void* q, const void* scales,
                         const void* bias, void* out, int M, int K, int N,
                         int packed, int group, int offset, int scale_bf16,
                         void* stream_ptr) {
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, bias, K, N,
            packed, group, offset, scale_bf16};
  Slabs sl{nullptr, 1, 0, 0};
  return run_qmatmul(w, sl, reinterpret_cast<const __nv_bfloat16*>(x), M, 1,
                     reinterpret_cast<float*>(out),
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Grouped: x bf16 [P, K] with P = tiles * tile_m; q, scales, bias stacks
// of n_slabs slabs; tile_ids int32 [tiles]; tile_m <= 16 or 128; out f32
// [P, N].
PS_EXPORT int ps_qmatmul_grouped(const void* x, const void* q,
                                 const void* scales, const void* bias,
                                 const void* tile_ids, void* out, int P, int K,
                                 int N, int packed, int group, int offset,
                                 int scale_bf16, int n_slabs, int tile_m,
                                 void* stream_ptr) {
  if (tile_m <= 0 || P % tile_m || (tile_m > 16 && tile_m != TBM))
    return (int)cudaErrorInvalidValue;
  QWeight w{reinterpret_cast<const uint8_t*>(q), scales, bias, K, N,
            packed, group, offset, scale_bf16};
  const long q_rows = packed ? K / 2 : K;
  Slabs sl{reinterpret_cast<const int*>(tile_ids), n_slabs, q_rows * N,
           (long)(K / 32) * N};
  return run_qmatmul(w, sl, reinterpret_cast<const __nv_bfloat16*>(x),
                     tile_m, P / tile_m, reinterpret_cast<float*>(out),
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel: the floor under every kernel's time.
PS_EXPORT int ps_empty_launch(void* stream_ptr) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream_ptr)>>>();
  return (int)cudaGetLastError();
}

