// Prefill attention over the int8 KV cache with per-token scales and the
// visibility computed in the kernel:
//
//   vis[s, i, t] = (cache_mask[s, t] | 0 <= t - start[s] <= i) & t < T
//   s[r, t] = (bf16(q[r]) . kq[t]) * (ks[t] * scale), -1e30 where hidden
//   online softmax over t in 64-token chunks; p * vs[t] rounded to bf16
//   before the value product; out[r] = acc[r] / (l > 0 ? l : 1)
//
// i is the query row's index in the batch (not its cache position): the
// batch's real tokens sit at start[s] + i, padded lanes at its end.
// q [S, Tq, H, D] f32; kq/vq int8 [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T];
// cache_mask uint8 [S, T] (committed positions, before this batch);
// start int32 [S]; out f32 [S, Tq, H * D].
//
// Replaces the TPU kernel powerserve_tpu/ops/flash_prefill.py::
// flash_prefill_quant (body _kernel). The TPU kernel keeps a block of
// G * 128 query rows against 512-token chunks with (m, l, acc) in VMEM
// (512 x 128 f32 of accumulator alone is 256 KB, more than a Hopper block
// may hold in shared memory) and walks the chunks as its sequential grid
// axis.
//
// What bounds it on an H100: at the scheduler's bucket (S = 8, Tq = 128,
// T = 2048, all visible) ~68 MB of q, K/V and output (0.020 ms at 3.35
// TB/s) against 34 GFLOP (0.035 ms at 989 TFLOP/s): the tensor cores, once
// the chunks no row sees are skipped. The design: one block per (kv head,
// slot, block of BQ query positions); its G * BQ rows (~64: BQ = 16 at
// G = 4) are m16 tiles, one per warp, and both products run on mma.sync
// m16n8k16 bf16 with f32 accumulators in registers (the FlashAttention-2
// register layout: the score fragment of one chunk is the A operand of
// the value product). The int8 K/V chunks (64 tokens) are staged in
// shared memory by cp.async two chunks deep and widened to bf16 exactly
// as fragments are built, with a padded row pitch so a fragment's eight
// rows fall in distinct banks. Scales fold into the scores and the
// probabilities, so the cache is never dequantized in device memory.
// Before any K/V, a block reads the slot's mask bytes and, when every
// real row of the block sees at least one position, walks only the chunks
// holding a committed position or a position of the batch's causal range:
// a chunk no row sees adds exactly nothing (p = 0, or a state that the
// first visible score wipes with alpha = 0), so a 512-token prompt in a
// 2048-token cache costs its 512 positions. Masked scores use the finite
// -1e30 of the JAX reference, so a row that sees nothing averages V over
// the T positions; positions past T add nothing to any row.
// No wgmma/TMA yet: a later step.
#include "common.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kPad = 16;  // bytes added to each staged K/V row

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two adjacent int8 -> bf16x2 (exact)
__device__ __forceinline__ uint32_t i8x2_bf16(const int8_t* p) {
  return pack_bf16((float)p[0], (float)p[1]);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Smem {
  int *flags, *list, *misc;  // misc: [0] any committed bit, [1] list length
  int8_t* kv;                // [2 stages][K, V][kChunk][D + kPad]
  float* sc;                 // [2 stages][ks, vs][kChunk]
};

__host__ __device__ size_t smem_layout(int T, int D, char* base, Smem* s) {
  const int nch = (T + kChunk - 1) / kChunk;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  int* flags = (int*)take(sizeof(int) * nch);
  int* list = (int*)take(sizeof(int) * nch);
  int* misc = (int*)take(sizeof(int) * 4);
  int8_t* kv = (int8_t*)take((size_t)4 * kChunk * (D + kPad));
  float* sc = (float*)take(sizeof(float) * 4 * kChunk);
  if (s) *s = Smem{flags, list, misc, kv, sc};
  return off;
}

template <int D>
__global__ __launch_bounds__(256) void flash_prefill_kernel(
    const float* q, const int8_t* kq, const float* ks, const int8_t* vq,
    const float* vs, const uint8_t* cmask, const int* start, float* out,
    int Tq, int H, int Hkv, int T, int BQ, float scale) {
  constexpr int P = D + kPad;  // staged row pitch in bytes
  constexpr int KS = D / 16;   // k steps of the score product
  constexpr int NT = D / 8;    // n tiles of the value product
  const int h = blockIdx.x, s = blockIdx.y, qb = blockIdx.z;
  const int G = H / Hkv;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nch = (T + kChunk - 1) / kChunk;

  extern __shared__ __align__(16) char smem_raw[];
  Smem sm;
  smem_layout(T, D, smem_raw, &sm);

  // this warp's m16 tile: query head h * G + g, batch rows qbase + 0..15
  const int tiles_per_g = BQ / 16;
  const int g = warp / tiles_per_g;
  const int head = h * G + g;
  const int qbase = qb * BQ + (warp % tiles_per_g) * 16;
  const int r0 = lane / 4, cq = (lane % 4) * 2;
  const int qi0 = qbase + r0, qi1 = qbase + r0 + 8;  // the thread's rows
  const long st = start[s];
  const int q_first = qb * BQ;
  const int q_last = min(Tq, q_first + BQ) - 1;

  // the query fragments, rounded to bf16, for all D / 16 k steps
  uint32_t qa[KS][4];
  {
    const float* q0 = q + (((long)s * Tq + qi0) * H + head) * D;
    const float* q1 = q + (((long)s * Tq + qi1) * H + head) * D;
    const bool ok0 = qi0 < Tq, ok1 = qi1 < Tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + cq;
      qa[kk][0] = ok0 ? pack_bf16(q0[c], q0[c + 1]) : 0u;
      qa[kk][1] = ok1 ? pack_bf16(q1[c], q1[c + 1]) : 0u;
      qa[kk][2] = ok0 ? pack_bf16(q0[c + 8], q0[c + 9]) : 0u;
      qa[kk][3] = ok1 ? pack_bf16(q1[c + 8], q1[c + 9]) : 0u;
    }
  }

  // which chunks does any row see: committed bits first, then the causal
  // range [start, start + q_last] of the block's rows
  for (int c = tid; c < nch; c += nthreads) sm.flags[c] = 0;
  if (tid == 0) sm.misc[0] = 0;
  __syncthreads();
  const uint8_t* mrow = cmask + (long)s * T;
  for (int t = tid; t < T; t += nthreads) {
    if (mrow[t]) {
      sm.flags[t / kChunk] = 1;
      sm.misc[0] = 1;
    }
  }
  __syncthreads();
  if (tid == 0) {
    // row i sees something iff a committed bit or a t in [0, T) with
    // 0 <= t - start <= i; the block's first row is the hardest
    const bool all_see = sm.misc[0] || (st < T && st + q_first >= 0);
    const long lo = st > 0 ? st : 0;
    const long hi = min(st + q_last, (long)T - 1);
    int n = 0;
    for (int c = 0; c < nch; ++c) {
      const long t0 = (long)c * kChunk, t1 = min(t0 + kChunk, (long)T) - 1;
      const bool causal = lo <= hi && t0 <= hi && t1 >= lo;
      if (!all_see || sm.flags[c] || causal) sm.list[n++] = c;
    }
    sm.misc[1] = n;
  }
  __syncthreads();
  const int n_list = sm.misc[1];

  const long slab = ((long)s * Hkv + h) * T;
  const int8_t* kbase = kq + slab * D;
  const int8_t* vbase = vq + slab * D;
  const float* ksb = ks + slab;
  const float* vsb = vs + slab;

  auto issue = [&](int c, int stage) {
    const int t0 = c * kChunk, nt = min(kChunk, T - t0);
    int8_t* kb = sm.kv + (size_t)stage * 2 * kChunk * P;
    int8_t* vb = kb + kChunk * P;
    constexpr int per_row = D / 16;
    for (int e = tid; e < nt * per_row; e += nthreads) {
      const int t = e / per_row, part = (e - t * per_row) * 16;
      cp_async16(kb + t * P + part, kbase + (long)(t0 + t) * D + part);
      cp_async16(vb + t * P + part, vbase + (long)(t0 + t) * D + part);
    }
    float* kss = sm.sc + stage * 2 * kChunk;
    for (int t = tid; t < nt; t += nthreads) {
      cp_async4(kss + t, ksb + t0 + t);
      cp_async4(kss + kChunk + t, vsb + t0 + t);
    }
    cp_async_commit();
  };

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = PS_NEG_INF, m1 = PS_NEG_INF, l0 = 0.f, l1 = 0.f;

  if (n_list > 0) issue(sm.list[0], 0);
  for (int i = 0; i < n_list; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_list) {
      issue(sm.list[i + 1], stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = sm.list[i] * kChunk, nt = min(kChunk, T - t0);
    const int8_t* kb = sm.kv + (size_t)stage * 2 * kChunk * P;
    const int8_t* vb = kb + kChunk * P;
    const float* kss = sm.sc + stage * 2 * kChunk;
    const float* vss = kss + kChunk;

    // scores: 16 rows x 64 tokens as 8 n tiles
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* kr = kb + (j * 8 + r0) * P + kk * 16 + cq;
        mma_16816(sacc[j], qa[kk], i8x2_bf16(kr), i8x2_bf16(kr + 8));
      }
    }

    // scale, visibility, running max
    float mx0 = PS_NEG_INF, mx1 = PS_NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + cq + e;
        const int t = t0 + col;
        bool v0 = false, v1 = false;
        float kscl = 0.f;
        if (col < nt) {
          const long off = (long)t - st;
          const bool com = mrow[t] != 0;
          v0 = com || (off >= 0 && off <= qi0);
          v1 = com || (off >= 0 && off <= qi1);
          kscl = kss[col] * scale;
        }
        sacc[j][e] = v0 ? sacc[j][e] * kscl : PS_NEG_INF;
        sacc[j][2 + e] = v1 ? sacc[j][2 + e] * kscl : PS_NEG_INF;
        mx0 = fmaxf(mx0, sacc[j][e]);
        mx1 = fmaxf(mx1, sacc[j][2 + e]);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // probabilities: p sums into l; bf16(p * vs) is the value product's A
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + cq + e;
        const bool in = col < nt;
        const float p0 = in ? expf(sacc[j][e] - mn0) : 0.f;
        const float p1 = in ? expf(sacc[j][2 + e] - mn1) : 0.f;
        ls0 += p0;
        ls1 += p1;
        const float vsc = in ? vss[col] : 0.f;
        sacc[j][e] = in ? p0 * vsc : 0.f;
        sacc[j][2 + e] = in ? p1 * vsc : 0.f;
      }
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }

    // acc += bf16(p * vs) . vq: 4 k steps of 16 tokens, D / 8 n tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
      const int8_t* v0 = vb + (kk * 16 + cq) * P + r0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int8_t* vp = v0 + n * 8;
        const uint32_t b0 = pack_bf16((float)vp[0], (float)vp[P]);
        const uint32_t b1 = pack_bf16((float)vp[8 * P], (float)vp[9 * P]);
        mma_16816(oacc[n], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  // l is summed per thread over its columns; the quad holds the whole row
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const long HD = (long)H * D;
  float* o0 = out + ((long)s * Tq + qi0) * HD + (long)head * D;
  float* o1 = out + ((long)s * Tq + qi1) * HD + (long)head * D;
  const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + cq;
    if (qi0 < Tq)
      *reinterpret_cast<float2*>(o0 + d) =
          make_float2(oacc[n][0] / d0, oacc[n][1] / d0);
    if (qi1 < Tq)
      *reinterpret_cast<float2*>(o1 + d) =
          make_float2(oacc[n][2] / d1, oacc[n][3] / d1);
  }
}

template <int D>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* cmask, const void* start, void* out,
           int S, int Tq, int H, int Hkv, int T, float scale,
           cudaStream_t stream) {
  const int G = H / Hkv;
  const int BQ = 16 * (G >= 4 ? 1 : 4 / G);
  const int threads = 32 * G * BQ / 16;
  const size_t smem = smem_layout(T, D, nullptr, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, S, (Tq + BQ - 1) / BQ);
  flash_prefill_kernel<D><<<grid, threads, smem, stream>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const int8_t*>(kq),
      reinterpret_cast<const float*>(ks), reinterpret_cast<const int8_t*>(vq),
      reinterpret_cast<const float*>(vs),
      reinterpret_cast<const uint8_t*>(cmask),
      reinterpret_cast<const int*>(start), reinterpret_cast<float*>(out), Tq,
      H, Hkv, T, BQ, scale);
  return (int)cudaGetLastError();
}

}  // namespace

PS_EXPORT size_t ps_flash_prefill_smem(int T, int D) {
  return smem_layout(T, D, nullptr, nullptr);
}

// D must be 16, 32, 64 or 128 and G = H / Hkv at most 8 (checked by the
// wrapper). Returns a CUDA error code (0 on success), or -1 for a D the
// kernel is not built for.
PS_EXPORT int ps_flash_prefill(const void* q, const void* kq, const void* ks,
                               const void* vq, const void* vs,
                               const void* cmask, const void* start, void* out,
                               int S, int Tq, int H, int Hkv, int T, int D,
                               float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 16:
      return launch<16>(q, kq, ks, vq, vs, cmask, start, out, S, Tq, H, Hkv, T,
                        scale, stream);
    case 32:
      return launch<32>(q, kq, ks, vq, vs, cmask, start, out, S, Tq, H, Hkv, T,
                        scale, stream);
    case 64:
      return launch<64>(q, kq, ks, vq, vs, cmask, start, out, S, Tq, H, Hkv, T,
                        scale, stream);
    case 128:
      return launch<128>(q, kq, ks, vq, vs, cmask, start, out, S, Tq, H, Hkv,
                         T, scale, stream);
    default:
      return -1;
  }
}
