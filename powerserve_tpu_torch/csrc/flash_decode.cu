// Decode attention over the int8 KV cache with per-token scales.
//
//   s[r, t] = (bf16(q[r]) . kq[t]) * (ks[t] * scale), or -1e30 where the
//             visibility is false
//   online softmax over t in chunks; p * vs[t] rounded to bf16 before
//   the value product; out[r] = acc[r] / (l > 0 ? l : 1)
//
// q [S, Tq, H, D] f32; kq/vq int8 [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T];
// visibility uint8 [S, Tq, T]; out f32 [S, Tq, H * D]. Query row
// r = g * Tq + tq of kv head h is query head h * G + g (G = H / Hkv).
//
// Replaces the TPU kernel powerserve_tpu/ops/flash_decode.py::
// flash_decode_quant (body _kernel). The TPU kernel folds all kv heads
// into one grid instance with a block-diagonal head mask and walks the
// T chunks as its sequential grid axis, keeping (m, l, acc) in VMEM
// scratch.
//
// What bounds it on an H100: cache bytes (2 * D int8 plus 8 bytes of
// scales per visible token and kv head), ~0.6 us for S = 1, Hkv = 8,
// T = 1024, D = 128 at 3.35 TB/s. The design is one block per (slot, kv
// head, 256-token split of T) — flash-decoding: at S = 1 one block per
// kv head would leave most SMs idle. Inside a block the TPU's sequential
// chunk axis becomes a loop, the K and V chunks (64 tokens) are staged
// in shared memory by cp.async two chunks deep (the next chunk's copy
// overlaps this chunk's math), with a padded row pitch so the per-token
// dot products of one warp hit distinct banks, and the online-softmax
// state of the G * Tq query rows lives in shared memory. Scales fold into the scores and the
// probabilities, so the cache is never dequantized in device memory.
// A block first scans its visibility rows and, when every query row sees
// at least one position, skips the chunks no row sees: such a chunk adds
// exactly nothing (p = 0, or a state that the first visible score wipes
// with alpha = 0), so the result is bit-for-bit the same and a short
// sequence in a long cache costs its length, not the cache's.
// Each split writes its unnormalized (m, l, acc); a second small kernel
// merges the splits in order (weights exp(m_i - max m)) and normalizes.
// Masked scores use the same finite -1e30 as the JAX reference, so a
// row with no visible position averages V over the T positions instead
// of dividing by zero.
//
// Paged mode replaces powerserve_tpu/ops/flash_decode.py::
// flash_decode_paged, both outputs. The same kernel body: only the address of a staged row changes, from
// the slot's contiguous slab to pool page page_table[s, t / page], row
// t % page, token by token, so a 64-token chunk may span several pages
// (page = 8) or part of one (page = 128). Visibility stays in logical
// coordinates; chunks no row sees are skipped before their page-table
// entries are read, and an unallocated entry (= P) is clipped into the
// pool, as the TPU kernel clips it, for the hidden positions that may
// still be staged.
//
// State mode (flash_decode_paged(..., state=True), the committed part of
// flash_decode_paged_deferred): the combine pass merges the splits as
// above but skips the division by l and writes the partition itself —
// o [S, R, D] unnormalized, m and l [S, R] with R = (h, g, tq), tq
// minor, the TPU kernel's row order — for the caller to merge with the
// in-flight block's partition. A row that sees no committed position
// keeps m = -1e30 (<= -1e30 / 2), so that merge weighs it 0.
#include "common.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kSplitChunks = 4;  // chunks per T split (256 tokens)
constexpr int kThreads = 128;

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

struct Smem {
  float *qs, *acc, *sc, *m_run, *l_run, *alpha, *kss, *vss;
  int *flags, *list, *tq_any, *count;
  int8_t* kv;  // [2 stages][K, V][kChunk][pitch]
};

__host__ __device__ size_t smem_layout(int R, int Tq, int T, int D,
                                       char* base, Smem* s) {
  const int nch = (T + kChunk - 1) / kChunk;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  float* qs = (float*)take(sizeof(float) * R * D);
  float* acc = (float*)take(sizeof(float) * R * D);
  float* sc = (float*)take(sizeof(float) * R * kChunk);
  float* ml = (float*)take(sizeof(float) * 3 * R);
  float* scl = (float*)take(sizeof(float) * 4 * kChunk);
  int* flags = (int*)take(sizeof(int) * nch);
  int* list = (int*)take(sizeof(int) * nch);
  int* tq_any = (int*)take(sizeof(int) * (Tq + 1));
  int8_t* kv = (int8_t*)take((size_t)4 * kChunk * (D + 4));
  if (s) {
    *s = Smem{qs, acc, sc, ml, ml + R, ml + 2 * R, scl, scl + 2 * kChunk,
              flags, list, tq_any, tq_any + Tq, kv};
  }
  return off;
}

__global__ __launch_bounds__(kThreads) void flash_decode_kernel(
    const float* q, const int8_t* kq, const float* ks, const int8_t* vq,
    const float* vs, const uint8_t* vis, const int* page_table, int page,
    int n_pages, float* m_part, float* l_part, float* acc_part, int Tq, int H,
    int Hkv, int T, int D, float scale) {
  const int h = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
  const int G = H / Hkv, R = G * Tq;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kThreads / 32;
  const int pitch = D + 4;  // bytes per staged cache row
  const int nch = (T + kChunk - 1) / kChunk;
  const int c_lo = split * kSplitChunks;
  const int c_hi = min(nch, c_lo + kSplitChunks);

  extern __shared__ __align__(16) char smem_raw[];
  Smem sm;
  smem_layout(R, Tq, T, D, smem_raw, &sm);

  for (int e = tid; e < R * D; e += kThreads) {
    int r = e / D, d = e - r * D;
    int g = r / Tq, tq = r - g * Tq;
    long qi = (((long)s * Tq + tq) * H + h * G + g) * D + d;
    sm.qs[e] = bf16_round(q[qi]);
    sm.acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sm.m_run[r] = PS_NEG_INF;
    sm.l_run[r] = 0.f;
  }
  for (int c = tid; c < nch; c += kThreads) sm.flags[c] = 0;
  for (int i = tid; i < Tq; i += kThreads) sm.tq_any[i] = 0;
  __syncthreads();

  // which chunks does any query row see, and does every row see something
  const uint8_t* vis_s = vis + (long)s * Tq * T;
  for (int e = tid; e < Tq * T; e += kThreads) {
    if (vis_s[e]) {
      int tq = e / T;
      sm.flags[(e - tq * T) / kChunk] = 1;
      sm.tq_any[tq] = 1;
    }
  }
  __syncthreads();
  if (tid == 0) {
    bool all_see = true;
    for (int i = 0; i < Tq; ++i) all_see = all_see && sm.tq_any[i];
    int n = 0;
    for (int c = c_lo; c < c_hi; ++c)
      if (!all_see || sm.flags[c]) sm.list[n++] = c;
    *sm.count = n;
  }
  __syncthreads();
  const int n_list = *sm.count;

  // cache row (token row of kv head h) of logical position t: the slot's
  // contiguous slab, or through the page table (an entry P = unallocated
  // is clipped into the pool; only hidden positions can map there)
  const long slab = ((long)s * Hkv + h) * T;
  const int* pt_s = page_table ? page_table + (long)s * (T / page) : nullptr;
  auto row_of = [&](int t) -> long {
    if (!pt_s) return slab + t;
    const int pg = min(max(pt_s[t / page], 0), n_pages - 1);
    return ((long)pg * Hkv + h) * page + t % page;
  };

  auto issue = [&](int c, int stage) {
    const int t0 = c * kChunk, nt = min(kChunk, T - t0);
    int8_t* kb = sm.kv + (size_t)stage * 2 * kChunk * pitch;
    int8_t* vb = kb + kChunk * pitch;
    const int words = nt * D / 4;
    for (int e = tid; e < words; e += kThreads) {
      int t = (e * 4) / D, d = e * 4 - t * D;
      const long row = row_of(t0 + t) * D + d;
      cp_async4(kb + t * pitch + d, kq + row);
      cp_async4(vb + t * pitch + d, vq + row);
    }
    for (int t = tid; t < nt; t += kThreads) {
      const long row = row_of(t0 + t);
      cp_async4(sm.kss + stage * kChunk + t, ks + row);
      cp_async4(sm.vss + stage * kChunk + t, vs + row);
    }
    cp_async_commit();
  };

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
    const int8_t* kb = sm.kv + (size_t)stage * 2 * kChunk * pitch;
    const int8_t* vb = kb + kChunk * pitch;
    const float* kss = sm.kss + stage * kChunk;
    const float* vss = sm.vss + stage * kChunk;

    // scores: one warp per query row, lanes over tokens
    for (int r = warp; r < R; r += nwarps) {
      const int tq = r % Tq;
      const uint8_t* visr = vis_s + (long)tq * T + t0;
      const float* qr = sm.qs + r * D;
      for (int t = lane; t < nt; t += 32) {
        const int8_t* kr = kb + t * pitch;
        float dot = 0.f;
        for (int d = 0; d < D; d += 4) {
          int w4 = *reinterpret_cast<const int*>(kr + d);
          dot = fmaf(qr[d], (float)(int8_t)(w4), dot);
          dot = fmaf(qr[d + 1], (float)(int8_t)(w4 >> 8), dot);
          dot = fmaf(qr[d + 2], (float)(int8_t)(w4 >> 16), dot);
          dot = fmaf(qr[d + 3], (float)(int8_t)(w4 >> 24), dot);
        }
        sm.sc[r * kChunk + t] = visr[t] ? dot * (kss[t] * scale) : PS_NEG_INF;
      }
    }
    __syncthreads();

    // online softmax update, one warp per row
    for (int r = warp; r < R; r += nwarps) {
      float* sr = sm.sc + r * kChunk;
      float mc = -INFINITY;
      for (int t = lane; t < nt; t += 32) mc = fmaxf(mc, sr[t]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_prev = sm.m_run[r];
      const float m_new = fmaxf(m_prev, mc);
      float ls = 0.f;
      for (int t = lane; t < nt; t += 32) {
        float p = expf(sr[t] - m_new);
        ls += p;
        sr[t] = bf16_round(p * vss[t]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sm.alpha[r] = a;
        sm.l_run[r] = sm.l_run[r] * a + ls;
        sm.m_run[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v, one thread per head-dim column
    for (int d = tid; d < D; d += kThreads) {
      for (int r = 0; r < R; ++r) {
        const float* pr = sm.sc + r * kChunk;
        float a = sm.acc[r * D + d] * sm.alpha[r];
        for (int t = 0; t < nt; ++t)
          a = fmaf(pr[t], (float)vb[t * pitch + d], a);
        sm.acc[r * D + d] = a;
      }
    }
    __syncthreads();
  }

  // this split's unnormalized state
  const long part = ((long)s * Hkv + h) * gridDim.z + split;
  for (int e = tid; e < R * D; e += kThreads) acc_part[part * R * D + e] = sm.acc[e];
  for (int r = tid; r < R; r += kThreads) {
    m_part[part * R + r] = sm.m_run[r];
    l_part[part * R + r] = sm.l_run[r];
  }
}

// Merge the T splits of one (slot, kv head) in order and normalize; or,
// with m_out, write the unnormalized state in the TPU row order.
__global__ __launch_bounds__(kThreads) void flash_decode_combine_kernel(
    const float* m_part, const float* l_part, const float* acc_part,
    float* out, float* m_out, float* l_out, int Tq, int H, int Hkv, int D,
    int n_split) {
  const int h = blockIdx.x, s = blockIdx.y;
  const int G = H / Hkv, R = G * Tq;
  const long base = ((long)s * Hkv + h) * n_split;
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float m = PS_NEG_INF;
    for (int i = 0; i < n_split; ++i) m = fmaxf(m, m_part[(base + i) * R + r]);
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float wgt = expf(m_part[(base + i) * R + r] - m);
      l += l_part[(base + i) * R + r] * wgt;
      a += acc_part[((base + i) * R + r) * D + d] * wgt;
    }
    if (m_out) {
      const long row = ((long)s * Hkv + h) * R + r;  // (s, h, g, tq)
      out[row * D + d] = a;
      if (d == 0) {
        m_out[row] = m;
        l_out[row] = l;
      }
      continue;
    }
    const int g = r / Tq, tq = r - g * Tq;
    out[(((long)s * Tq + tq) * H + h * G + g) * D + d] = a / (l > 0.f ? l : 1.f);
  }
}

}  // namespace

PS_EXPORT size_t ps_flash_decode_smem(int R, int Tq, int T, int D) {
  return smem_layout(R, Tq, T, D, nullptr, nullptr);
}

PS_EXPORT int ps_flash_decode_splits(int T) {
  return ((T + kChunk - 1) / kChunk + kSplitChunks - 1) / kSplitChunks;
}

namespace {

int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* vis, const int* page_table, int page,
           int n_pages, void* m_part, void* l_part, void* acc_part, void* out,
           void* m_out, void* l_out, int S, int Tq, int H, int Hkv, int T,
           int D, float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int R = (H / Hkv) * Tq;
  const size_t smem = smem_layout(R, Tq, T, D, nullptr, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_split = ps_flash_decode_splits(T);
  float* mp = reinterpret_cast<float*>(m_part);
  float* lp = reinterpret_cast<float*>(l_part);
  float* ap = reinterpret_cast<float*>(acc_part);
  flash_decode_kernel<<<dim3(Hkv, S, n_split), kThreads, smem, stream>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const int8_t*>(kq),
      reinterpret_cast<const float*>(ks), reinterpret_cast<const int8_t*>(vq),
      reinterpret_cast<const float*>(vs), reinterpret_cast<const uint8_t*>(vis),
      page_table, page, n_pages, mp, lp, ap, Tq, H, Hkv, T, D, scale);
  flash_decode_combine_kernel<<<dim3(Hkv, S), kThreads, 0, stream>>>(
      mp, lp, ap, reinterpret_cast<float*>(out),
      reinterpret_cast<float*>(m_out), reinterpret_cast<float*>(l_out), Tq,
      H, Hkv, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// m_part/l_part f32 [S, Hkv, splits, G*Tq], acc_part f32
// [S, Hkv, splits, G*Tq, D] (splits from ps_flash_decode_splits).
// Returns a CUDA error code (0 on success).
PS_EXPORT int ps_flash_decode(const void* q, const void* kq, const void* ks,
                              const void* vq, const void* vs, const void* vis,
                              void* m_part, void* l_part, void* acc_part,
                              void* out, int S, int Tq, int H, int Hkv, int T,
                              int D, float scale, void* stream_ptr) {
  return launch(q, kq, ks, vq, vs, vis, nullptr, 1, 1, m_part, l_part,
                acc_part, out, nullptr, nullptr, S, Tq, H, Hkv, T, D, scale,
                stream_ptr);
}

// The paged pool: kq/vq int8 [P, Hkv, page, D], ks/vs f32 [P, Hkv, page],
// page_table int32 [S, max_pages] (P = unallocated), vis uint8
// [S, Tq, max_pages * page] over logical positions; scratch as above with
// T = max_pages * page. m_out null: out f32 [S, Tq, H * D] normalized;
// else the state mode: out f32 [S, R, D] unnormalized and m_out, l_out
// f32 [S, R], R = H * Tq in (h, g, tq) order.
PS_EXPORT int ps_flash_decode_paged(const void* q, const void* kq,
                                    const void* ks, const void* vq,
                                    const void* vs, const void* page_table,
                                    const void* vis, void* m_part,
                                    void* l_part, void* acc_part, void* out,
                                    void* m_out, void* l_out,
                                    int S, int Tq, int H, int Hkv,
                                    int max_pages, int page, int n_pages,
                                    int D, float scale, void* stream_ptr) {
  return launch(q, kq, ks, vq, vs, vis,
                reinterpret_cast<const int*>(page_table), page, n_pages,
                m_part, l_part, acc_part, out, m_out, l_out, S, Tq, H, Hkv,
                max_pages * page, D, scale, stream_ptr);
}
