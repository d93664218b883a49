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
// and walks the chunks as its sequential grid axis.
//
// What bounds it on an H100: at the scheduler's bucket (S = 8, Tq = 128,
// T = 2048) q and out in f32 and the visible K/V rows, ~38 MB (0.013 ms
// at 3.35 TB/s), against ~9 GFLOP on the visible positions (0.009 ms at
// 989 TFLOP/s). What sets the time is the tensor-core work of the walks,
// the longest walk first: one block of eight warps fills an SM (~220
// registers a thread), a chunk of 64 tokens costs two products a row,
// and the slot with 1900 committed positions walks 30 chunks. The
// design:
//  - A unit is (slot, kv head, query block of bq positions); its G * bq
//    rows (<= 128, eight warps at G = 4) are m16 tiles, one per warp, in
//    whole warpgroups (rows padded to a multiple of 64).
//    The query blocks that walk furthest launch first. A unit walks
//    chunks [0, nch_end): up to 1 + its last visible position, or all of
//    T when one of its rows sees nothing (that row then averages V over
//    T, as the JAX XLA reference does with its finite -1e30); it skips
//    the chunks no row of it sees, which adds exactly nothing (p = 0, or
//    a state the first visible score wipes with alpha = 0). In a walk of
//    all of T, such a chunk runs the value product alone (p = 1 for a row
//    that has seen nothing yet, else 0), on the warps holding such a row.
//  - One block walks its unit whole and writes its rows: one launch, no
//    atomics, the same bits on every run. A split of long walks over the
//    ranks of a cluster, merged in rank order through distributed shared
//    memory, was measured and removed (PERF.md): the shapes alone cannot
//    tell a long walk from a short one, and where one slot's walks are
//    short the split and its merge cost up to twice the unsplit time.
//  - The visibility is formed in shared memory once per block: the
//    committed positions of the slot as bits (each thread 32 mask bytes),
//    then per chunk and row a 64-bit word, the committed bits or the
//    causal interval [start, start + i] in the chunk; a chunk every row
//    sees whole takes no per-score test.
//  - K/V chunks and their scales stream into a four-stage ring by 16-byte
//    cp.async (int8, row pitch D + 16). Each chunk is widened to bf16 once
//    per block (8 bytes a thread by bit operations and one bf16x2
//    subtraction, exact) into one of two buffers of wgmma core matrices,
//    the next chunk's while this one is computed, one barrier a chunk.
//    Both products run on wgmma (bf16 in, f32 out) with A in registers:
//    m64n64k16 for the scores (q fragments, K as the K-major B), m64nDk16
//    for the value product (the score fragments, V as the MN-major B).
//  - log2 e is folded into the scale and the softmax runs on ex2.approx.
// The f32 softmax, the -1e30 masking and the bf16 rounding of p * vs are
// the twin's (ops/flash_prefill.py walks the same chunks); only the order
// of the f32 sums and exp2 against exp differ. Not yet: the next chunk's
// scores overlapped with this chunk's softmax.
//
// State mode (m_out non-null; a sequence-parallel rank's share of the
// cache, merged over the ranks by ops/attention.py gqa_attention_quant_sp):
// the same walk with the normalization skipped. It writes o [S, R, D]
// unnormalized, m and l [S, R] with R = (h, g, i), i minor (the decode
// state mode's order), m in natural units (the running max over log2 e).
// A unit walks only the chunks some row sees, never all of T, and a row
// that sees no position is written as m = -1e30, l = 0, o = 0. The key
// offset t0 makes the causal interval one of global positions: cache
// position t is global position t0 + t, so the interval's first cache
// position is start - t0, which may lie before 0 or past T (a chunk that
// starts or ends on another rank's slice).
#include "common.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kStages = 4;  // int8 chunks in flight, ahead of the bf16 pair
constexpr int kMaxWarps = 8;    // G * bq <= 128 rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHidden = 1 << 30;  // a walked chunk no row sees (list flag)

// one staged chunk: K rows, V rows (int8, pitch D + 16), ks, vs (f32)
__host__ __device__ inline int stage_bytes(int D) {
  return 2 * kChunk * (D + 16) + 2 * kChunk * 4;
}

struct Smem {
  uint32_t* bits;      // [2 * nch]: the slot's committed positions
  int* list;           // [nch]: the chunks the block walks
  int* misc;           // [0] list length, [1] 1 + the last committed position
  uint8_t* ring;       // [kStages][stage_bytes]
  __nv_bfloat16* kv;   // [2][K, V][kChunk x D]: two chunks in bf16, core
                       // matrices [t / 8][d / 8][t % 8][d % 8]
};

__host__ __device__ inline size_t smem_layout(int T, int D, uint8_t* base,
                                              Smem* s) {
  const int nch = (T + kChunk - 1) / kChunk;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    uint8_t* p = base ? base + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  Smem m;
  m.bits = (uint32_t*)take((size_t)8 * nch);
  m.list = (int*)take((size_t)4 * nch);
  m.misc = (int*)take(16);
  const size_t ring = (size_t)kStages * stage_bytes(D);
  m.ring = take(ring + (size_t)2 * 2 * kChunk * D * 2);
  m.kv = reinterpret_cast<__nv_bfloat16*>(m.ring + ring);
  if (s) *s = m;
  return off;
}

struct Args {
  const float* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const uint8_t* mask;
  const int* start;
  float* out;
  float *m_out, *l_out;  // non-null: the state mode
  int S, Tq, H, Hkv, T;
  int t0;                // global position of cache position 0
  int bq;
  float scale2;  // scale * log2 e
  int s_vec;     // scale rows may be copied 16 bytes at a time
  int m_vec;     // mask rows may be read 16 bytes at a time
};

// wgmma m64nNk16, bf16 in, f32 accumulators (the mma.sync C layout per
// 8-column tile), A from registers (the mma.sync A fragments of the
// warp's 16 rows), B from shared memory: 8 x 16-byte core matrices, no
// swizzle; tb 1 takes B MN-major (rows of k, N contiguous), 0 K-major.
// scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ra(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d, int tb);
template <>
__device__ __forceinline__ void wgmma_ra<16>(float (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d,
                                             int tb) {
  if (tb)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, "
        "{%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, "
        "{%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ra<32>(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d,
                                             int tb) {
  if (tb)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ra<64>(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d,
                                             int tb) {
  if (tb)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ra<128>(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d,
                                             int tb) {
  if (tb)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
        "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
        "{%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// bits a..b (0 <= a, b <= 63) of a 64-bit word, none when a > b
__device__ __forceinline__ uint64_t bit_range(long a, long b) {
  a = a > 0 ? a : 0;
  b = b < 63 ? b : 63;
  if (a > b) return 0ull;
  return (~0ull >> (63 - b)) & (~0ull << a);
}

// one bit per byte of x: bit j set when byte j is nonzero
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

template <int D>
__global__ __launch_bounds__(32 * kMaxWarps, 1) void flash_prefill_kernel(
    Args a) {
  constexpr int KS = D / 16;  // k steps of the score product
  constexpr int NT = D / 8;   // n tiles of the value product
  constexpr int P8 = D + 16;  // staged int8 row pitch (bytes)
  constexpr int SB = 2 * kChunk * P8 + 2 * kChunk * 4;
  // blockIdx.x = ((n_qb - 1 - qb) * S + s) * Hkv + h: the query blocks
  // that walk furthest first, every slot's among them
  const int n_qb = (a.Tq + a.bq - 1) / a.bq;
  const int h = blockIdx.x % a.Hkv;
  const int s = (blockIdx.x / a.Hkv) % a.S;
  const int qb = n_qb - 1 - blockIdx.x / (a.Hkv * a.S);
  const int G = a.H / a.Hkv, R = G * a.bq, T = a.T;
  const int nch = (T + kChunk - 1) / kChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;
  const int g8 = lane >> 2, t4 = lane & 3;
  extern __shared__ __align__(16) uint8_t smem[];
  Smem sm;
  smem_layout(T, D, smem, &sm);

  // this warp's m16 tile: query head h * G + gh, batch rows qi0, qi1 of
  // this thread; its q rows (read now, rounded to bf16 A fragments once
  // the walk is known)
  const int wq = a.bq / 16;
  const int gh = warp / wq;
  const bool pad = warp * 16 >= R;  // a warp that fills the last warpgroup
  const int head = pad ? 0 : h * G + gh;
  const int q_first = qb * a.bq;
  const int qi0 = pad ? a.Tq : q_first + (warp - gh * wq) * 16 + g8;
  const int qi1 = qi0 + 8;
  float2 qraw[KS][4];
  {
    const float* q0 = a.q + (((long)s * a.Tq + qi0) * a.H + head) * D + 2 * t4;
    const float* q1 = a.q + (((long)s * a.Tq + qi1) * a.H + head) * D + 2 * t4;
    const bool ok0 = qi0 < a.Tq, ok1 = qi1 < a.Tq;
    const float2 z = make_float2(0.f, 0.f);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2* p0 = reinterpret_cast<const float2*>(q0 + 16 * ks);
      const float2* p1 = reinterpret_cast<const float2*>(q1 + 16 * ks);
      qraw[ks][0] = ok0 ? p0[0] : z;
      qraw[ks][1] = ok1 ? p1[0] : z;
      qraw[ks][2] = ok0 ? p0[4] : z;  // dims + 8
      qraw[ks][3] = ok1 ? p1[4] : z;
    }
  }

  // the slot's committed positions as bits (32 a thread), and 1 + the
  // last of them
  if (tid == 0) sm.misc[1] = 0;
  __syncthreads();
  const uint8_t* mrow = a.mask + (long)s * T;
  int last = 0;
  for (int w = tid; w < 2 * nch; w += nthr) {
    const int t = 32 * w;
    uint32_t bits = 0;
    if (a.m_vec && t + 32 <= T) {
      const uint4 x0 = *reinterpret_cast<const uint4*>(mrow + t);
      const uint4 x1 = *reinterpret_cast<const uint4*>(mrow + t + 16);
      const uint32_t x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) bits |= nonzero4(x[i]) << (4 * i);
    } else {
      for (int i = 0; i < 32 && t + i < T; ++i)
        if (mrow[t + i]) bits |= 1u << i;
    }
    sm.bits[w] = bits;
    if (bits) last = t + 32 - __clz(bits);
  }
  if (last) atomicMax(&sm.misc[1], last);
  __syncthreads();

  // the unit's walk: the chunks of [0, nch_end) that some row sees (all
  // of them when a row sees nothing). Row i sees the committed bits and
  // [start, start + i] (t >= 0, t < T); the unit's first row sees least.
  const bool state = a.m_out != nullptr;
  const long st = (long)a.start[s] - a.t0;
  const int q_last = min(a.Tq, q_first + a.bq) - 1;
  const int lastc = sm.misc[1];
  const long lo = st > 0 ? st : 0;
  const long hi = min(st + q_last, (long)T - 1);
  const bool causal = lo <= hi;
  const bool all_see = state || lastc > 0 || (st < T && st + q_first >= 0);
  const long end = max((long)lastc, causal ? hi + 1 : 0L);
  const int nch_end = all_see ? (int)((end + kChunk - 1) / kChunk) : nch;
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < nch_end; i0 += 32) {
      const int c = i0 + lane;
      bool need = false, seen = false;
      if (c < nch_end) {
        const long t0 = (long)c * kChunk, t1 = t0 + kChunk - 1;
        seen = (sm.bits[2 * c] | sm.bits[2 * c + 1]) != 0u ||
               (causal && t0 <= hi && t1 >= lo);
        need = seen || !all_see;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, need);
      if (need)
        sm.list[n + __popc(bal & ((1u << lane) - 1u))] =
            c | (seen ? 0 : kHidden);
      n += __popc(bal);
    }
    if (lane == 0) sm.misc[0] = n;
  }
  __syncthreads();
  const int n_list = sm.misc[0];

  const long slab = ((long)s * a.Hkv + h) * T;
  const int8_t* kbase = a.kq + slab * D;
  const int8_t* vbase = a.vq + slab * D;
  const float* ksb = a.ks + slab;
  const float* vsb = a.vs + slab;
  // stage chunk c into ring slot `slot`; positions past T read zeros
  auto issue = [&](int c, int slot) {
    uint8_t* stg = sm.ring + (size_t)slot * SB;
    const int t0 = c * kChunk;
    constexpr int cpr = D / 16;  // 16-byte pieces per row
    for (int e = tid; e < 2 * kChunk * cpr; e += nthr) {
      const int row = e / cpr, part = e - row * cpr;
      const int arr = row / kChunk, t = row - arr * kChunk;
      const bool ok = t0 + t < T;
      const int8_t* src =
          (arr ? vbase : kbase) + (ok ? (long)(t0 + t) * D + part * 16 : 0);
      cp_async16(stg + row * P8 + part * 16, src, ok);
    }
    float* sc = reinterpret_cast<float*>(stg + 2 * kChunk * P8);
    if (a.s_vec) {
      for (int e = tid; e < 2 * kChunk / 4; e += nthr) {
        const int arr = e / (kChunk / 4), t = (e - arr * (kChunk / 4)) * 4;
        const bool ok = t0 + t < T;
        cp_async16(sc + arr * kChunk + t, (arr ? vsb : ksb) + (ok ? t0 + t : 0),
                   ok);
      }
    } else {
      for (int e = tid; e < 2 * kChunk; e += nthr) {
        const int arr = e / kChunk, t = e - arr * kChunk;
        const bool ok = t0 + t < T;
        cp_async4(sc + arr * kChunk + t, (arr ? vsb : ksb) + (ok ? t0 + t : 0),
                  ok);
      }
    }
  };

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      qa[ks][u] = pack_bf16(qraw[ks][u].x, qraw[ks][u].y);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {PS_NEG_INF, PS_NEG_INF}, l_run[2] = {0.f, 0.f};

  // the bf16 chunk: K then V, core matrices [t / 8][d / 8][t % 8][d % 8],
  // so K is wgmma's K-major B of the scores (n = t, k = d) and V its
  // MN-major B of the value product (k = t, n = d)
  constexpr int KV = 2 * kChunk * D;  // one bf16 chunk (elements)
  constexpr int CM = 128 * (D / 8);   // bytes between 8-token groups
  // K and V of a staged chunk to bf16, once for the block: 8 int8 a
  // thread become 8 bf16 (exact) by bit operations; 8 lanes fill the 8
  // rows of one core matrix
  auto widen = [&](int i) {
    const uint8_t* stg = sm.ring + (size_t)(i % kStages) * SB;
    __nv_bfloat16* dst = sm.kv + (i & 1) * KV;
    constexpr int ppr = D / 8;  // 8-byte pieces per row
    const int e0 = sm.list[i] & kHidden ? kChunk * ppr : 0;  // V rows alone
    for (int e = e0 + tid; e < 2 * kChunk * ppr; e += nthr) {
      const int grp = e >> 3;  // (row group of 8, piece)
      const int row = ((grp / ppr) << 3) + (e & 7), part = grp % ppr;
      const uint2 w =
          *reinterpret_cast<const uint2*>(stg + row * P8 + part * 8);
      const uint32_t e0 = i8_even_bf16x2(w.x), o0 = i8_even_bf16x2(w.x >> 8);
      const uint32_t e1 = i8_even_bf16x2(w.y), o1 = i8_even_bf16x2(w.y >> 8);
      *reinterpret_cast<uint4*>(dst + ((row >> 3) * ppr + part) * 64 +
                                (row & 7) * 8) =
          make_uint4(__byte_perm(e0, o0, 0x5410), __byte_perm(e0, o0, 0x7632),
                     __byte_perm(e1, o1, 0x5410), __byte_perm(e1, o1, 0x7632));
    }
    fence_proxy_async();  // the chunk, to wgmma
  };

  // the pipeline: int8 chunks i + 1 .. i + kStages - 1 in flight while
  // chunk i + 1 is widened and chunk i computed, one barrier a chunk
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_list) issue(sm.list[p] & (kHidden - 1), p);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // chunk 0 has landed
  __syncthreads();
  if (n_list > 0) widen(0);
  for (int i = 0; i < n_list; ++i) {
    cp_async_wait<kStages - 3>();  // chunk i + 1 has landed
    __syncthreads();  // chunk i is widened; chunk i - 1's slot and kv free
    const int ahead = i + kStages - 1;
    if (ahead < n_list) issue(sm.list[ahead] & (kHidden - 1), ahead % kStages);
    cp_async_commit();
    if (i + 1 < n_list) widen(i + 1);
    const uint8_t* stg = sm.ring + (size_t)(i % kStages) * SB;
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(sm.kv + (i & 1) * KV);
    const uint8_t* vb = kb + kChunk * D * 2;
    const int c = sm.list[i] & (kHidden - 1);
    const float* kss = reinterpret_cast<const float*>(stg + 2 * kChunk * P8);
    const float* vss = kss + kChunk;
    const int t0 = c * kChunk;
    const int nt = min(kChunk, T - t0);

    float sc[8][4];
    if (sm.list[i] & kHidden) {
      // no row sees the chunk (walked for a row that sees nothing): every
      // score is -1e30 (past T: -inf), so alpha = 1 and p = 1 where a row
      // has seen nothing yet (m = -1e30), else 0 — the general path's
      // numbers
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 vsc =
            *reinterpret_cast<const float2*>(vss + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const float p = col < nt && m_run[e >> 1] == PS_NEG_INF ? 1.f : 0.f;
          l_run[e >> 1] += p;
          sc[j][e] = p * ((e & 1) ? vsc.y : vsc.x);
        }
      }
    } else {
      // scores: the warpgroup's 64 rows x 64 tokens, sc[j] the 8-token
      // tile j of this thread's rows
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_ra<64>(sc, qa[ks], smem_desc(kb + ks * 256, 128, CM), ks > 0,
                     0);
      wgmma_commit();
      wgmma_wait0();

      // visibility (bits of the chunk per row), scale in log2 units, and
      // the running max of rows g8 (hr = 0) and g8 + 8 (hr = 1); positions
      // past T take no part
      const uint64_t valid = nt >= kChunk ? ~0ull : (1ull << nt) - 1ull;
      const uint64_t cb = (uint64_t)sm.bits[2 * c] |
                          ((uint64_t)sm.bits[2 * c + 1] << 32);
      const long o0 = st - t0;  // column of position start
      const uint64_t vis0 = (cb | bit_range(o0, o0 + qi0)) & valid;
      const uint64_t vis1 = (cb | bit_range(o0, o0 + qi1)) & valid;
      float2 ksc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ksc[j] = *reinterpret_cast<const float2*>(kss + 8 * j + 2 * t4);
        ksc[j].x *= a.scale2;
        ksc[j].y *= a.scale2;
      }
      if (__all_sync(0xffffffffu, (vis0 & vis1) == ~0ull)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[j][0] *= ksc[j].x;
          sc[j][1] *= ksc[j].y;
          sc[j][2] *= ksc[j].x;
          sc[j][3] *= ksc[j].y;
        }
      } else {
        const uint64_t v0 = vis0 >> (2 * t4), v1 = vis1 >> (2 * t4);
        const uint64_t ok = valid >> (2 * t4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int bit = 8 * j + (e & 1);
            const uint64_t v = (e >> 1) ? v1 : v0;
            const float hidden = (ok >> bit) & 1ull ? PS_NEG_INF : -INFINITY;
            sc[j][e] = (v >> bit) & 1ull
                           ? sc[j][e] * ((e & 1) ? ksc[j].y : ksc[j].x)
                           : hidden;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m_run[hr], mx[hr]);
        alpha[hr] = ex2_approx(m_run[hr] - m_new);
        m_run[hr] = m_new;
        l_run[hr] *= alpha[hr];
      }
      // a rescale by 1 changes nothing: skipped when no row's max moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }
      // probabilities: p sums into l; bf16(p * vs) is the value product's A
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 vsc =
            *reinterpret_cast<const float2*>(vss + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2_approx(sc[j][e] - m_run[e >> 1]);
          l_run[e >> 1] += p;
          sc[j][e] = p * ((e & 1) ? vsc.y : vsc.x);
        }
      }

    }

    // acc += bf16(p * vs) . V: 4 k steps of 16 tokens, the score tiles
    // as A in registers
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      wgmma_ra<D>(acc, pa, smem_desc(vb + kk * 2 * CM, CM, 128), 1, 1);
    }
    wgmma_commit();
    wgmma_wait0();
  }
  cp_async_wait<0>();

  // l is summed per thread over its columns; the quad holds the whole row.
  // acc[n][c] is dim 8 n + 2 t4 + (c & 1) of row g8 + 8 (c >> 1)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
  }
  const int qi[2] = {qi0, qi1};
  const long HD = (long)a.H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= a.Tq) continue;
    if (state) {
      const bool empty = m_run[hr] <= 0.5f * PS_NEG_INF;
      const long row = ((long)s * a.H + head) * a.Tq + qi[hr];
      float* o = a.out + row * D + 2 * t4;
#pragma unroll
      for (int nn = 0; nn < NT; ++nn)
        *reinterpret_cast<float2*>(o + 8 * nn) =
            empty ? make_float2(0.f, 0.f)
                  : make_float2(acc[nn][2 * hr], acc[nn][2 * hr + 1]);
      if (t4 == 0) {
        a.m_out[row] = empty ? PS_NEG_INF : m_run[hr] / kLog2e;
        a.l_out[row] = empty ? 0.f : l_run[hr];
      }
      continue;
    }
    const float inv = 1.f / (l_run[hr] > 0.f ? l_run[hr] : 1.f);
    float* o = a.out + ((long)s * a.Tq + qi[hr]) * HD + (long)head * D + 2 * t4;
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
      *reinterpret_cast<float2*>(o + 8 * nn) =
          make_float2(acc[nn][2 * hr] * inv, acc[nn][2 * hr + 1] * inv);
  }
}

template <int D>
cudaError_t launch_t(const Args& a, int S, size_t smem, cudaStream_t stream) {
  const auto kernel = flash_prefill_kernel<D>;
  static const cudaError_t attr_rc = [&] {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }();
  if (attr_rc != cudaSuccess) return attr_rc;
  const int n_qb = (a.Tq + a.bq - 1) / a.bq;
  // whole warpgroups: rows padded to a multiple of 64
  const int threads = 128 * (((a.H / a.Hkv) * a.bq + 63) / 64);
  flash_prefill_kernel<D><<<a.Hkv * S * n_qb, threads, smem, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

// Shared memory one launch takes (bytes), for the wrapper's check.
PS_EXPORT size_t ps_flash_prefill_smem(int T, int D) {
  return smem_layout(T, D, nullptr, nullptr);
}

// D must be 16, 32, 64 or 128; G = H / Hkv; bq a multiple of 16 with
// G * bq <= 128 (the wrapper's query block). m_out null: out f32
// [S, Tq, H * D] normalized; else the state mode: out f32 [S, R, D]
// unnormalized, m_out and l_out f32 [S, R], R = H * Tq in (h, g, i)
// order. t0: the global position of cache position 0 (start is global).
// Returns a CUDA error code (0 on success).
PS_EXPORT int ps_flash_prefill(const void* q, const void* kq, const void* ks,
                               const void* vq, const void* vs,
                               const void* cmask, const void* start, void* out,
                               void* m_out, void* l_out, int S, int Tq, int H,
                               int Hkv, int T, int D, int t0, float scale,
                               int bq, void* stream_ptr) {
  if (S <= 0 || Tq <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || bq <= 0 ||
      bq % 16 || (H / Hkv) * bq > 16 * kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  Args a{};
  a.q = reinterpret_cast<const float*>(q);
  a.kq = reinterpret_cast<const int8_t*>(kq);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vq = reinterpret_cast<const int8_t*>(vq);
  a.vs = reinterpret_cast<const float*>(vs);
  a.mask = reinterpret_cast<const uint8_t*>(cmask);
  a.start = reinterpret_cast<const int*>(start);
  a.out = reinterpret_cast<float*>(out);
  a.m_out = reinterpret_cast<float*>(m_out);
  a.l_out = reinterpret_cast<float*>(l_out);
  a.S = S, a.Tq = Tq, a.H = H, a.Hkv = Hkv, a.T = T;
  a.t0 = t0;
  a.bq = bq;
  a.scale2 = scale * kLog2e;
  a.s_vec = T % 4 == 0 && al16(ks) && al16(vs);
  a.m_vec = T % 16 == 0 && al16(cmask);
  const size_t smem = smem_layout(T, D, nullptr, nullptr);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  switch (D) {
    case 16: e = launch_t<16>(a, S, smem, stream); break;
    case 32: e = launch_t<32>(a, S, smem, stream); break;
    case 64: e = launch_t<64>(a, S, smem, stream); break;
    case 128: e = launch_t<128>(a, S, smem, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
