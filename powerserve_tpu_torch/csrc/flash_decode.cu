// Decode attention over the int8 KV cache with per-token scales.
//
//   s[r, t] = (bf16(q[r]) . kq[t]) * (ks[t] * scale), or -1e30 where
//             row r does not see position t
//   online softmax over t; p * vs[t] rounded to bf16 before the value
//   product; out[r] = acc[r] / (l > 0 ? l : 1)
//
// q [S, Tq, H, D] f32; kq/vq int8 [S, Hkv, T, D]; ks/vs f32 [S, Hkv, T];
// mask uint8 [S, T] (the cache's committed positions); positions int32
// [S, J] (where key nodes were written) or null; bits uint32 [Tq] or
// null; out f32 [S, Tq, H * D]. Query row r = g * Tq + tq of kv head h is
// query head h * G + g (G = H / Hkv). Row tq sees t when mask[s, t] is
// set or some key j with bit j of bits[tq] has positions[s, j] == t
// (build_visibility with an intra mask [Tq, J]; -1 and positions >= T
// match nothing). Without bits the rule is causal, J = Tq and bits[tq]
// the keys j <= tq: the new rows' own positions, as a decode step or a
// chain verify writes them. With bits (the tree mode, J <= 32) a token
// tree's verify passes J = Tq nodes and each node's ancestors-or-self,
// and a draft level J nodes and its own rows' ancestors-or-self.
//
// Replaces the TPU kernel powerserve_tpu/ops/flash_decode.py::
// flash_decode_quant (body _kernel), which folds all kv heads into one
// grid instance with a block-diagonal head mask, walks the T chunks as
// its sequential grid axis with (m, l, acc) in VMEM scratch, and takes
// the visibility as an [S, Tq, T] operand built outside.
//
// What bounds it on an H100: cache bytes (2 * D int8 plus 8 bytes of
// scales per visible token and kv head), ~0.6 us for S = 1, Hkv = 8,
// T = 1024, D = 128 at 3.35 TB/s: a few MB, so latency and the launch
// itself set the time. The design:
//  - One launch. Grid (splits, Hkv, S); the splits of one (slot, kv
//    head) form a thread block cluster (up to 8 ranks, portable) and
//    merge their softmax states through distributed shared memory in rank
//    order: the same bits on every run. The splits aim at no more than
//    128 blocks of eight warps (S = 1: 64 blocks; S = 8: two splits a
//    slot), so that the grid's clusters are resident at once: a grid of
//    256 four-block clusters did not fit in one wave on the card, nor
//    eight clusters of 16 (the card held 7).
//  - The visibility is formed in the kernel: a block reads its slot's
//    mask row once (16-byte cp.async) and the slot's J key positions, and
//    keeps one byte per token of its range: the first key j written
//    there, or a committed one's mark (causal: 0, the first row that
//    sees it; tree mode: kMask). In the tree mode a lane holds the keys
//    its two rows see as 32 bits each (the bit rows with every key folded
//    onto the first key of its position, so a position that two keys
//    share is seen through either), and a score is kept where its byte is
//    kMask or names a key of the row; causal, where the byte is <= tq
//    (the two rules are two instantiations of the kernel, so the causal
//    one runs none of the tree mode's set-up). A
//    slot walks only [0, end), end = 1 + the last position a row sees,
//    so a short sequence in a long cache costs its length, split over
//    all the cluster's blocks. Steps no row sees are skipped
//    (a skipped step adds exactly nothing: p = 0, or a state the first
//    visible score wipes with alpha = 0); in the normalized output, a
//    slot with a row that sees nothing walks all of T, so that row
//    averages V over T as the JAX XLA reference does (the masked scores
//    are a finite -1e30).
//  - The block's range is cut into token groups of 16-token steps; a
//    warp owns one token group, with its own online softmax, and one
//    16-row tile of the G * Tq query rows, or both tiles of 17 to 32 rows
//    (a tree's verify or draft level, a chain's verify): it loads and
//    widens each staged K and V word once for both tiles' mma, and a
//    block keeps eight token groups, as at one tile (33 to 128 rows: a
//    tile a warp, two or one token groups). Scores and the value product
//    run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out):
//    q . K^T with q rows as A and the int8 K rows, exact in bf16, as B
//    (the head dim permuted alike in both operands, so one 32-bit load
//    of four K bytes feeds both B registers; a byte pair becomes bf16x2
//    by two bit operations and one bf16x2 subtraction, not by the
//    quarter-rate conversion instructions); P . V with P taken from the
//    score fragments in registers (rounded to bf16 after the scale vs)
//    and V through ldmatrix.trans on 16-bit column pairs: even columns
//    feed one n tile and odd columns another (the GEMV's trick in
//    csrc/gemv.cuh). Head sizes pad to a multiple of 16 in shared
//    memory. q is staged as bf16 in the mma's k order and read by
//    ldmatrix: held in registers for one tile, read again each step for
//    two (whose f32 accumulators take 128 registers at D = 128).
//  - The set-up: one warp forms the keys' state (positions moved by t0,
//    the tree mode's folding of keys that share a position, the keys each
//    row sees) with ballots, matches and shuffles, beside the other warps'
//    scan of the mask row; one block barrier follows. Each warp builds
//    its own list of the steps some row sees, so none follows that.
//  - K/V rows and their scales stream into shared memory by cp.async
//    (16 bytes where rows allow), two or three steps in flight.
// The f32 softmax, the -1e30 masking and the bf16 rounding of p * vs are
// the twin's; only the order of the f32 sums differs. The plain twin
// (ops/flash_decode.py) walks the same 16-token steps over the same
// per-warp token ranges, so the running maxima at each rounding match.
//
// Paged mode replaces powerserve_tpu/ops/flash_decode.py::
// flash_decode_paged, both outputs. Only the address of a staged row
// changes: logical position t of slot s is pool page page_table[s,
// t / page], row t % page, token by token, so a step may span pages
// (page = 8) or part of one (page = 128). An unallocated entry (= P) is
// clipped into the pool, as the TPU kernel clips it, for hidden positions
// that may still be staged.
//
// State mode (flash_decode_paged(..., state=True), the committed part of
// flash_decode_paged_deferred; flash_decode_quant(..., state=True), a
// sequence-parallel rank's share of the dense cache): the merge skips the
// division by l and writes the partition itself — o [S, R, D]
// unnormalized, m and l [S, R] with R = (h, g, tq), tq minor, the TPU
// kernel's row order — for the caller to merge with another partition
// (the in-flight block's, or the other ranks' time slices). Steps no row
// sees are always skipped, so an empty slot reads no K/V, and a row that
// sees no position (m <= -1e30 / 2) is written as m = -1e30, l = 0,
// o = 0: a merge weighs it 0, and no average of V leaks into it. The
// dense state mode takes a key offset t0: cache position t is global
// position t0 + t, and the new rows' positions are global (each is moved
// by -t0 as it is read; one outside [0, T) matches nothing), which
// replaces the JAX forward's remap of an sp shard's cache positions
// (models/llama.py, sp_axis).
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSub = 16;        // tokens per warp step (one mma k / two n tiles)
constexpr int kMaxSplits = 8;   // cluster ranks per (slot, kv head): portable
constexpr int kTargetBlocks = 128;  // fewer splits when S * Hkv is large
constexpr int kMaxStages = 3;
constexpr int kMaxWarps = 8;    // warps (and token groups) a block
constexpr int kMaxRows = 128;   // G * Tq query rows per kv head
constexpr uint8_t kHidden = 255;  // no row sees the position
constexpr uint8_t kPast = 254;    // past the slot's walked span: no score
constexpr uint8_t kMask = 253;    // committed: every row sees it
constexpr int kMaxKeys = 32;      // keys of the tree mode (bits a row)

// The launch geometry, from the shapes alone (host and device). A slot
// walks [0, end) of T, end = 1 + its last visible position (T where a
// row sees nothing in the normalized output): ws(end) tokens per warp
// state, tg states per block, n_split blocks in the cluster; ws, bs and
// n_steps here are the largest, at end = T.
struct Geo {
  int R, n_mt, tg, warps;  // rows, 16-row tiles, token groups, warps
  int mpw, wpg;            // 16-row tiles a warp, warps a token group
  int ws, bs, n_split;     // tokens per warp range, per block; splits
  int n_steps, stages;     // 16-token steps per token group; ring depth
  int Dp, pitch, qpitch;   // padded head dim; staged K/V row bytes; q row bf16s
  int apitch;              // a state row's f32s
  int sub_bytes;           // one staged step of one token group
};

__host__ __device__ inline int warp_span(int end, int tg, int n_split) {
  const int steps = (end + kSub - 1) / kSub;
  const int per = n_split * tg;
  return end > 0 ? kSub * ((steps + per - 1) / per) : kSub;
}

__host__ __device__ inline Geo geometry(int G, int Tq, int T, int D,
                                        int slots_heads) {
  Geo g;
  g.R = G * Tq;
  g.n_mt = (g.R + 15) / 16;
  // up to 32 rows a warp holds both tiles; eight warps a block where the
  // row tiles allow: tg a power of two
  g.mpw = g.n_mt == 2 ? 2 : 1;
  g.wpg = g.n_mt / g.mpw;
  g.tg = g.wpg == 1 ? 8 : g.wpg <= 4 ? 2 : 1;
  g.warps = g.wpg * g.tg;
  // at most ~kTargetBlocks blocks, so that the grid's clusters are
  // resident at once
  const int want = slots_heads < kTargetBlocks ? kTargetBlocks / slots_heads : 1;
  const int most = want < kMaxSplits ? want : kMaxSplits;
  g.ws = warp_span(T, g.tg, most);
  g.bs = g.tg * g.ws;
  g.n_split = (T + g.bs - 1) / g.bs;
  g.n_steps = g.ws / kSub;
  const int db = (D + 15) / 16;
  g.Dp = 16 * (db <= 1 ? 1 : db <= 2 ? 2 : db <= 4 ? 4 : 8);
  g.pitch = g.Dp + 16;
  g.qpitch = g.Dp + 8;  // 16-byte rows, the 8 of an ldmatrix on other banks
  // 64 bytes apart mod 128: the rows g and g + 1 of a quarter warp's
  // float4 stores of its state on other banks
  g.apitch = g.Dp + 16 - g.Dp % 32;
  g.sub_bytes = 2 * kSub * g.pitch + 2 * kSub * 4;
  // two to three steps in flight, within ~64 KB of ring or the space the
  // states take after it
  const int states = 4 * g.tg * 16 * g.n_mt * g.apitch;
  const int fit = (states > (64 << 10) ? states : 64 << 10) / (g.tg * g.sub_bytes);
  g.stages = g.n_steps < 2 || fit < 2 ? 2
             : g.n_steps < kMaxStages && g.n_steps < fit ? g.n_steps
             : fit < kMaxStages ? fit : kMaxStages;
  return g;
}

struct Smem {
  __nv_bfloat16* qs;  // [n_mt * 16][qpitch]
  uint8_t* ring;      // [stages][tg][K rows | V rows | ks | vs]
  float* st_acc;      // [tg][Rp][apitch] (over the ring once it is drained)
  float *st_m, *st_l;  // [tg][Rp]
  float *blk_m, *blk_l;  // [Rp]: the block's merged state
  float* w;           // [tg][Rp]: the token groups' merge weights
  int* pos;           // [J]: key positions (this cache's)
  int* misc;          // key end, each, seen (tree mode); a warp's last mask bit
  int* first;         // [32]: the first key at the same position (tree mode)
  uint32_t *bits, *kbits;  // [Tq]: the keys a row sees, as given and folded
  int *flags, *list;  // [n_steps]; [warps][n_steps]: the steps some row sees,
                      // a warp's copy
  int* pages;         // [T / page]: the slot's page table, clipped
  uint8_t* mask;      // [T]: the slot's mask row
  uint8_t* vf;        // [bs]: first row that sees the token
};

__host__ __device__ inline size_t smem_layout(const Geo& g, int Tq, int J,
                                              int T, int n_pt, uint8_t* base,
                                              Smem* s) {
  const int Rp = 16 * g.n_mt;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    uint8_t* p = base ? base + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  Smem m;
  m.qs = (__nv_bfloat16*)take((size_t)2 * Rp * g.qpitch);
  const size_t ring = (size_t)g.stages * g.tg * g.sub_bytes;
  const size_t states = (size_t)4 * g.tg * Rp * g.apitch;
  m.ring = take(ring > states ? ring : states);
  m.st_acc = (float*)m.ring;
  m.st_m = (float*)take((size_t)4 * g.tg * Rp);
  m.st_l = (float*)take((size_t)4 * g.tg * Rp);
  m.blk_m = (float*)take((size_t)4 * Rp);
  m.blk_l = (float*)take((size_t)4 * Rp);
  m.w = (float*)take((size_t)4 * g.tg * Rp);
  m.pos = (int*)take((size_t)4 * (J > 0 ? J : 1));
  m.misc = (int*)take(4 * (3 + kMaxWarps));
  m.first = (int*)take(4 * kMaxKeys);
  m.bits = (uint32_t*)take((size_t)4 * Tq);
  m.kbits = (uint32_t*)take((size_t)4 * Tq);
  m.flags = (int*)take((size_t)4 * g.n_steps);
  m.list = (int*)take((size_t)4 * g.warps * g.n_steps);
  m.pages = (int*)take((size_t)4 * n_pt);
  m.mask = take(T);
  m.vf = take(g.bs);
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
  const int* pos;         // [S, J] key positions; null: the mask alone
  const uint32_t* bits;   // [Tq] keys each row sees; null: causal (J = Tq)
  const int* page_table;  // null: the dense cache
  int page, n_pages;
  float* out;
  float *m_out, *l_out;   // non-null: the state mode
  int S, Tq, J, H, Hkv, T, D;
  int t0;                 // global position of cache position 0
  float scale;
  int kv_vec, s_vec, mask_vec;
};

// cp.async.wait_group with a run-time depth of 0 to 2
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// One warp's 16-token step for its MT 16-row tiles: scores, online
// softmax, P . V into acc. kt: the step's staged K rows, then V rows, then
// ks, vs; each K and V word is loaded and widened to bf16 once and feeds
// every tile's mma. q: one tile's A fragments in registers (MT = 1), or
// read by ldmatrix from the lane's row of sm.qs each step (qld; MT = 2,
// whose accumulators take the registers). kTree: a token's byte names a
// key that a row sees when its bit in the row's kb is set (kMask: every
// row); else the causal rule, the byte the first row that sees it.
template <int DB, int MT, bool kTree>
__device__ __forceinline__ void warp_step(
    const Args& a, const Geo& geo, const Smem& sm, const uint8_t* kt, int tl0,
    const uint32_t (&qa)[MT == 1 ? DB : 1][4], const __nv_bfloat16* qld,
    const int (&tq)[MT][2], const uint32_t (&kb)[MT][2], int lane,
    float (&m_run)[MT][2], float (&l_run)[MT][2], float (&acc)[MT][DB][2][4]) {
  const int g = lane >> 2, t4 = lane & 3;
  const int pitch = geo.pitch;
  const uint8_t* vt = kt + kSub * pitch;
  const float* kss = reinterpret_cast<const float*>(kt + 2 * kSub * pitch);
  const float* vss = kss + kSub;

  // scores [16 rows][16 tokens] a tile as two n tiles of 8 tokens; head dim
  // d of k16 step ks at mma k 2 t4 + j (j < 2) is 16 ks + 4 t4 + 2 j, at
  // 2 t4 + 8 + j it is 16 ks + 4 t4 + 1 + 2 j
  float sc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[mt][j][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DB; ++ks) {
    uint32_t bf[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          kt + (8 * j + g) * pitch + 16 * ks + 4 * t4);
      bf[j][0] = i8_even_bf16x2(w);
      bf[j][1] = i8_even_bf16x2(w >> 8);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (MT == 1) {
        mma_16816(sc[0][0], qa[ks], bf[0]);
        mma_16816(sc[0][1], qa[ks], bf[1]);
      } else {
        uint32_t af[4];
        ldsm_x4(af, qld + mt * 16 * geo.qpitch + 16 * ks);
        mma_16816(sc[mt][0], af, bf[0]);
        mma_16816(sc[mt][1], af, bf[1]);
      }
    }
  }

  // mask, scale and the running max of each tile's rows g (h = 0) and
  // g + 8 (h = 1)
  float alpha[MT][2];
  bool moved = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = 8 * j + 2 * t4 + (c & 1), h = c >> 1;
        const uint8_t v = sm.vf[tl0 + t];
        float x;
        if (v == kPast)
          x = -INFINITY;
        else if (kTree ? v == kMask || (v < kMaxKeys && (kb[mt][h] >> v) & 1u)
                       : tq[mt][h] >= v)
          x = sc[mt][j][c] * (kss[t] * a.scale);
        else
          x = PS_NEG_INF;
        sc[mt][j][c] = x;
        mx[h] = fmaxf(mx[h], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[mt][h], mx[h]);
      alpha[mt][h] = expf(m_run[mt][h] - m_new);
      m_run[mt][h] = m_new;
      l_run[mt][h] *= alpha[mt][h];
      moved = moved || alpha[mt][h] != 1.f;
    }
  }
  // a rescale by 1 changes nothing: skipped when no row's max moved
  const bool rescale = __any_sync(0xffffffffu, moved);
  // the score fragments as the A operand: rows g, g + 8; tokens 2 t4 (+1),
  // 8 + 2 t4 (+1)
  uint32_t pa[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float pf[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = 8 * j + 2 * t4 + (c & 1), h = c >> 1;
        const float p = expf(sc[mt][j][c] - m_run[mt][h]);
        l_run[mt][h] += p;
        pf[j][c] = p * vss[t];
      }
    pa[mt][0] = pack_bf16(pf[0][0], pf[0][1]);
    pa[mt][1] = pack_bf16(pf[0][2], pf[0][3]);
    pa[mt][2] = pack_bf16(pf[1][0], pf[1][1]);
    pa[mt][3] = pack_bf16(pf[1][2], pf[1][3]);
  }
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    uint32_t r[2];  // tokens 0-7, 8-15 of columns 16 db .. 16 db + 15
    ldsm_x2_trans(r, vt + (lane & 15) * pitch + 16 * db);
    const uint32_t be[2] = {i8_even_bf16x2(r[0]), i8_even_bf16x2(r[1])};
    const uint32_t bo[2] = {i8_even_bf16x2(r[0] >> 8),
                            i8_even_bf16x2(r[1] >> 8)};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (rescale)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* c = acc[mt][db][e];
          c[0] *= alpha[mt][0];
          c[1] *= alpha[mt][0];
          c[2] *= alpha[mt][1];
          c[3] *= alpha[mt][1];
        }
      mma_16816(acc[mt][db][0], pa[mt], be);
      mma_16816(acc[mt][db][1], pa[mt], bo);
    }
  }
}

// MT: 16-row tiles a warp (geo.mpw). kTree: the tree mode (bit rows
// given); else the causal rule, or the mask alone without positions
template <int DB, int MT, bool kTree>
__global__ __launch_bounds__(32 * kMaxWarps, 1) void flash_decode_kernel(
    Args a) {
  namespace cg = cooperative_groups;
  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int G = a.H / a.Hkv;
  const Geo geo = geometry(G, a.Tq, a.T, a.D, a.S * a.Hkv);
  const int Rp = 16 * geo.n_mt, Dp = geo.Dp, AP = geo.apitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;
  const bool state = a.m_out != nullptr;
  const int n_pt = a.page_table ? a.T / a.page : 0;
  extern __shared__ __align__(16) uint8_t smem[];
  Smem sm;
  smem_layout(geo, a.Tq, a.J, a.T, n_pt, smem, &sm);

  // every load of the set-up at once, by cp.async: q rows (f32, staged
  // in the ring's space), the slot's mask row, page table, positions and
  // bit rows
  float* qf = reinterpret_cast<float*>(sm.ring);
  const int d4 = a.D / 4;
  for (int e = tid; e < geo.R * d4; e += nthr) {
    const int r = e / d4, d = 4 * (e - r * d4);
    const int g = r / a.Tq, tq = r - g * a.Tq;
    cp_async16(qf + r * a.D + d,
               a.q + (((long)s * a.Tq + tq) * a.H + h * G + g) * a.D + d,
               true);
  }
  const uint8_t* mrow = a.mask + (long)s * a.T;
  if (a.mask_vec) {
    for (int i = 16 * tid; i < a.T; i += 16 * nthr)
      cp_async16(sm.mask + i, mrow + i, true);
  } else {
    for (int i = tid; i < a.T; i += nthr) sm.mask[i] = mrow[i];
  }
  for (int i = tid; i < n_pt; i += nthr)
    cp_async4(sm.pages + i, a.page_table + (long)s * n_pt + i, true);
  for (int j = tid; j < a.J; j += nthr) {
    if (a.pos)
      cp_async4(sm.pos + j, a.pos + (long)s * a.J + j, true);
    else
      sm.pos[j] = -1;
  }
  if (kTree)
    for (int r = tid; r < a.Tq; r += nthr) cp_async4(sm.bits + r, a.bits + r, true);
  for (int i = tid; i < geo.n_steps; i += nthr) sm.flags[i] = 0;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q rows as bf16, zeros past R and D, each 16 columns in the order of
  // the mma's k (ldmatrix then gives the A fragments whose k 2 t4 (+1)
  // hold head dims 4 t4 (+2) and k 2 t4 + 8 (+1) dims 4 t4 + 1 (+2): the
  // order of a K word's bytes (0, 2) and (1, 3) in the B fragments)
  for (int e = tid; e < Rp * (Dp / 4); e += nthr) {
    const int r = e / (Dp / 4), d = 4 * (e - r * (Dp / 4));
    uint32_t lo = 0u, hi = 0u;
    if (r < geo.R && d < a.D) {
      const float4 f = *reinterpret_cast<const float4*>(qf + r * a.D + d);
      lo = pack_bf16(f.x, f.z);
      hi = pack_bf16(f.y, f.w);
    }
    uint32_t* q16 = reinterpret_cast<uint32_t*>(sm.qs + r * geo.qpitch + (d & ~15));
    q16[(d & 15) / 4] = lo;
    q16[4 + (d & 15) / 4] = hi;
  }
  // 1 + the last committed position, a warp's share each
  int last = 0;
  for (int i = 4 * tid; i < a.T; i += 4 * nthr) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < a.T && sm.mask[i + j]) w |= 1u << (8 * j);
    if (w) last = i + (31 - __clz(w)) / 8 + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) sm.misc[3 + warp] = last;
  // the keys, by warp 0 beside the others' share of the above: positions
  // moved to this cache's, 1 + the last one a row sees, whether every row
  // sees one; in the tree mode (a lane a key, J <= 32) each key folded
  // onto the first key at its position, the keys each row sees (kbits)
  // and those some row sees
  if (warp == 0) {
    int key_end = 0;
    for (int j = lane; j < a.J; j += 32) {
      const int p = sm.pos[j] - (a.pos ? a.t0 : 0);
      sm.pos[j] = p;
      if (p >= 0 && p < a.T) key_end = max(key_end, p + 1);
    }
    __syncwarp();
    const auto valid = [&](int j) { return sm.pos[j] >= 0 && sm.pos[j] < a.T; };
    bool each;  // every row sees some key
    uint32_t seen = 0;
    if (kTree) {
      const bool ok = lane < a.J && valid(lane);
      const unsigned vmask = __ballot_sync(0xffffffffu, ok);
      // lanes past J match nothing: a value that no position takes
      const unsigned same = __match_any_sync(
          0xffffffffu, lane < a.J ? sm.pos[lane] : (int)(0x80000000u + lane));
      const int first = __ffs(same) - 1;
      sm.first[lane] = first;
      __syncwarp();
      bool mine = true;
      for (int r = lane; r < a.Tq; r += 32) {
        uint32_t b = sm.bits[r] & vmask, k = 0;
        while (b) {
          k |= 1u << sm.first[__ffs(b) - 1];
          b &= b - 1;
        }
        sm.kbits[r] = k;
        seen |= k;
        mine = mine && k != 0u;
      }
      seen = __reduce_or_sync(0xffffffffu, seen);
      each = __all_sync(0xffffffffu, mine);
      key_end = ok && (seen >> first) & 1u ? sm.pos[lane] + 1 : 0;
    } else {
      // causal: rows see more as tq grows, and the last row every key
      each = valid(0);
    }
    key_end = __reduce_max_sync(0xffffffffu, key_end);
    if (lane == 0) {
      sm.misc[0] = key_end;
      sm.misc[1] = each;
      sm.misc[2] = (int)seen;
    }
  }
  __syncthreads();
  // the span this slot walks, the same in every block of the cluster
  int end = 0;
  for (int w = 0; w < geo.warps; ++w) end = max(end, sm.misc[3 + w]);
  const bool all_rows = end > 0 || sm.misc[1];  // every row sees something
  const uint32_t seen = (uint32_t)sm.misc[2];   // tree mode: keys some row sees
  end = max(end, sm.misc[0]);
  const bool walk_all = !state && !all_rows;
  if (walk_all) end = a.T;
  const int ws = warp_span(end, geo.tg, geo.n_split);
  const int bs = geo.tg * ws, n_steps = ws / kSub;
  const int b0 = split * bs;  // first token of the block's range
  for (int t = tid; t < bs; t += nthr) {
    const int tt = b0 + t;
    uint8_t v = kPast;
    if (tt < end) {
      v = sm.mask[tt] ? (kTree ? kMask : 0) : kHidden;
      for (int j = 0; j < a.J && v == kHidden; ++j)
        if (sm.pos[j] == tt) v = (uint8_t)j;
    }
    sm.vf[t] = v;
    const bool seen_v = kTree ? v == kMask || (v < kMaxKeys && (seen >> v) & 1u)
                              : v < a.Tq;
    if (walk_all ? v != kPast : seen_v) sm.flags[(t % ws) / kSub] = 1;
  }
  __syncthreads();
  // the steps some row sees, in order: each warp its own copy of the list
  int* list = sm.list + warp * geo.n_steps;
  int n_list = 0;
  for (int i0 = 0; i0 < n_steps; i0 += 32) {
    const int i = i0 + lane;
    const bool need = i < n_steps && sm.flags[i];
    const unsigned bal = __ballot_sync(0xffffffffu, need);
    if (need) list[n_list + __popc(bal & ((1u << lane) - 1u))] = i;
    n_list += __popc(bal);
  }
  __syncwarp();

  // cache row (token row of kv head h) of logical position t < T: the
  // slot's contiguous slab, or through the page table
  const long slab = ((long)s * a.Hkv + h) * a.T;
  auto row_of = [&](int t) -> long {
    if (!a.page_table) return slab + t;
    const int pg = min(max(sm.pages[t / a.page], 0), a.n_pages - 1);
    return ((long)pg * a.Hkv + h) * a.page + t % a.page;
  };
  // stage step `step` of every token group into ring slot `slot`: each
  // thread copies one column chunk of some of the 2 * tg * 16 K/V rows;
  // positions past the walked span read zeros
  const int cb = a.kv_vec ? 16 : 4;
  const int cpr = a.D / cb;  // chunks per row
  const int rows_pp = nthr / cpr, my_c = tid % cpr;
  const int tg_shift = 31 - __clz(geo.tg);  // tg is a power of two
  const int sg = a.s_vec ? 4 : 1;   // tokens per scale copy
  auto issue = [&](int step, int slot) {
    uint8_t* st = sm.ring + (size_t)slot * geo.tg * geo.sub_bytes;
    if (tid < rows_pp * cpr)
      for (int row = tid / cpr; row < 2 * geo.tg * kSub; row += rows_pp) {
        const int t = row & (kSub - 1), ag = row >> 4;
        const int grp = ag & (geo.tg - 1), arr = ag >> tg_shift;
        const int tt = b0 + grp * ws + step * kSub + t;
        const bool ok = tt < end;
        uint8_t* dst = st + grp * geo.sub_bytes + (arr * kSub + t) * geo.pitch +
                       my_c * cb;
        const int8_t* src =
            (arr ? a.vq : a.kq) + (ok ? row_of(tt) * a.D + my_c * cb : 0);
        if (cb == 16)
          cp_async16(dst, src, ok);
        else
          cp_async4(dst, src, ok);
      }
    const int per_s = kSub / sg;
    for (int e = tid; e < 2 * geo.tg * per_s; e += nthr) {
      const int ag = e / per_s, t = (e - ag * per_s) * sg;
      const int grp = ag & (geo.tg - 1), arr = ag >> tg_shift;
      const int tt = b0 + grp * ws + step * kSub + t;
      float* dst = reinterpret_cast<float*>(st + grp * geo.sub_bytes +
                                            2 * kSub * geo.pitch) +
                   arr * kSub + t;
      const bool ok = tt < end;
      const float* src = (arr ? a.vs : a.ks) + (ok ? row_of(tt) : 0);
      if (sg == 4)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
    }
  };

  // this warp's tiles mt0 .. mt0 + MT - 1 and its token group
  const int mt0 = (warp % geo.wpg) * MT, grp = warp / geo.wpg;
  int tq[MT][2];
  uint32_t kb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tq[mt][hh] = ((mt0 + mt) * 16 + (lane >> 2) + 8 * hh) % a.Tq;
      kb[mt][hh] = kTree ? sm.kbits[tq[mt][hh]] : 0u;
    }
  // the lane's ldmatrix row of the first tile: rows 0-15 at k 0-7, then
  // at k 8-15
  const __nv_bfloat16* qld =
      sm.qs + (mt0 * 16 + (lane & 15)) * geo.qpitch + (lane >> 4) * 8;
  uint32_t qa[MT == 1 ? DB : 1][4];
  if constexpr (MT == 1) {
#pragma unroll
    for (int ks = 0; ks < DB; ++ks) ldsm_x4(qa[ks], qld + 16 * ks);
  }
  float m_run[MT][2], l_run[MT][2];
  float acc[MT][DB][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[mt][hh] = PS_NEG_INF;
      l_run[mt][hh] = 0.f;
    }
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][db][e][c] = 0.f;
  }

  // the ring: the steps ahead are issued once every warp is past the
  // step whose slot they take
  for (int p = 0; p < geo.stages - 1; ++p) {
    if (p < n_list) issue(list[p], p);
    cp_async_commit();
  }
  for (int i = 0; i < n_list; ++i) {
    cp_async_wait_n(geo.stages - 2);  // step i's copies have landed
    __syncthreads();
    const int ahead = i + geo.stages - 1;
    if (ahead < n_list) issue(list[ahead], ahead % geo.stages);
    cp_async_commit();
    const int tl0 = grp * ws + list[i] * kSub;  // block-relative
    const uint8_t* kt =
        sm.ring + ((size_t)(i % geo.stages) * geo.tg + grp) * geo.sub_bytes;
    if (b0 + tl0 < end)
      warp_step<DB, MT, kTree>(a, geo, sm, kt, tl0, qa, qld, tq, kb, lane,
                               m_run, l_run, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its space holds the states now

  // this warp's state: rows (mt0 + mt) * 16 + g (+ 8); acc[mt][db][e][c]
  // is column 16 db + 4 t4 + 2 (c & 1) + e
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float l = l_run[mt][hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = (mt0 + mt) * 16 + g + 8 * hh;
        if (t4 == 0) {
          sm.st_m[grp * Rp + r] = m_run[mt][hh];
          sm.st_l[grp * Rp + r] = l;
        }
        float* dst = sm.st_acc + ((size_t)grp * Rp + r) * AP + 4 * t4;
#pragma unroll
        for (int db = 0; db < DB; ++db)
          *reinterpret_cast<float4*>(dst + 16 * db) = make_float4(
              acc[mt][db][0][2 * hh], acc[mt][db][1][2 * hh],
              acc[mt][db][0][2 * hh + 1], acc[mt][db][1][2 * hh + 1]);
      }
  }
  __syncthreads();
  // merge the token groups into group 0's slots: the weights, a lane a
  // (row, group) with the row's groups in neighbouring lanes (tg divides
  // 32; whole warps, past R idle), then the rows' columns
  for (int e = tid; e < (geo.R * geo.tg + 31) / 32 * 32; e += nthr) {
    const int r = e >> tg_shift, q = e & (geo.tg - 1);
    const bool ok = r < geo.R;
    const float mq = ok ? sm.st_m[q * Rp + r] : PS_NEG_INF;
    float m = mq;
    for (int o = 1; o < geo.tg; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float wgt = expf(mq - m);
    float l = ok ? sm.st_l[q * Rp + r] * wgt : 0.f;
    for (int o = 1; o < geo.tg; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (ok) {
      sm.w[q * Rp + r] = wgt;
      if (q == 0) {
        sm.blk_m[r] = m;
        sm.blk_l[r] = l;
      }
    }
  }
  if (geo.tg > 1) {
    __syncthreads();
    for (int e = tid; e < geo.R * d4; e += nthr) {
      const int r = e / d4, i = r * AP + 4 * (e - r * d4);
      float4 x[kMaxWarps];  // every group's loads at once, then summed in order
      float wgt[kMaxWarps];
#pragma unroll
      for (int q = 0; q < kMaxWarps; ++q)
        if (q < geo.tg) {
          x[q] = *reinterpret_cast<const float4*>(sm.st_acc + (size_t)q * Rp * AP + i);
          wgt[q] = sm.w[q * Rp + r];
        }
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kMaxWarps; ++q)
        if (q < geo.tg) {
          v.x += x[q].x * wgt[q], v.y += x[q].y * wgt[q];
          v.z += x[q].z * wgt[q], v.w += x[q].w * wgt[q];
        }
      *reinterpret_cast<float4*>(sm.st_acc + i) = v;
    }
  }

  // merge the splits of the cluster in rank order, each rank a share of
  // the outputs: all ranks' (m, l, acc) of an output read at once
  const int n = geo.n_split;
  if (n > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  auto peer = [&](float* p, int q) -> const float* {
    return n > 1 ? cg::this_cluster().map_shared_rank(p, q) : p;
  };
  const int total = geo.R * d4, share = (total + n - 1) / n;
  const int e1 = min(total, (split + 1) * share);
  for (int e = split * share + tid; e < e1; e += nthr) {
    const int r = e / d4, d = 4 * (e - r * d4);
    float mv[kMaxSplits], lv[kMaxSplits];
    float4 av[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < n) {
        mv[q] = peer(sm.blk_m, q)[r];
        lv[q] = peer(sm.blk_l, q)[r];
        av[q] = *reinterpret_cast<const float4*>(peer(sm.st_acc, q) + r * AP + d);
      }
    float M = mv[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < n) M = fmaxf(M, mv[q]);
    float L = 0.f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < n) {
        const float wgt = expf(mv[q] - M);
        L += lv[q] * wgt;
        v.x += av[q].x * wgt, v.y += av[q].y * wgt;
        v.z += av[q].z * wgt, v.w += av[q].w * wgt;
      }
    const int g = r / a.Tq, tq = r - g * a.Tq;
    if (state && M <= 0.5f * PS_NEG_INF) {  // the row saw no position
      M = PS_NEG_INF;
      L = 0.f;
      v = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (state) {
      const long row = ((long)s * a.H + h * G) * a.Tq + r;  // (s, h, g, tq)
      *reinterpret_cast<float4*>(a.out + row * a.D + d) = v;
      if (d == 0) {
        a.m_out[row] = M;
        a.l_out[row] = L;
      }
    } else {
      const float inv = L > 0.f ? L : 1.f;
      *reinterpret_cast<float4*>(
          a.out + (((long)s * a.Tq + tq) * a.H + h * G + g) * a.D + d) =
          make_float4(v.x / inv, v.y / inv, v.z / inv, v.w / inv);
    }
  }
  // keep this block's state until every rank has read it
  if (n > 1) cg::this_cluster().sync();
}

// the kernel's attributes, set once: all of the SM's shared memory, so
// that a whole grid of clusters is resident at once
template <int DB, int MT, bool kTree>
cudaError_t prepare() {
  const auto kernel = flash_decode_kernel<DB, MT, kTree>;
  static const cudaError_t attr_rc = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }();
  return attr_rc;
}

// grid (splits, Hkv, S), the splits of a (slot, kv head) one cluster
cudaLaunchConfig_t launch_config(const Geo& geo, int S, int Hkv, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.n_split, Hkv, S);
  cfg.blockDim = dim3(32 * geo.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = geo.n_split > 1 ? 1 : 0;
  return cfg;
}

template <int DB, int MT, bool kTree>
cudaError_t launch_t(const Args& a, const Geo& geo, int S, size_t smem,
                     cudaStream_t stream) {
  const cudaError_t e = prepare<DB, MT, kTree>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(geo, S, a.Hkv, smem, stream, attr);
  return cudaLaunchKernelEx(&cfg, flash_decode_kernel<DB, MT, kTree>, a);
}

// clusters of this launch's size and shared memory that the card holds
// at once
template <int DB, int MT, bool kTree>
cudaError_t max_clusters(const Geo& geo, int S, int Hkv, size_t smem,
                         int* n) {
  const cudaError_t e = prepare<DB, MT, kTree>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(geo, S, Hkv, smem, nullptr, attr);
  cfg.numAttrs = 1;  // a cluster of one where there is one split
  return cudaOccupancyMaxActiveClusters(
      n, (const void*)flash_decode_kernel<DB, MT, kTree>, &cfg);
}

// f(DB, MT, kTree) as integral constants, for the geometry's head size
// and tiles a warp
template <int DB, typename F>
cudaError_t dispatch_t(int mpw, bool tree, F&& f) {
  using std::integral_constant;
  using D = integral_constant<int, DB>;
  if (mpw == 2)
    return tree ? f(D{}, integral_constant<int, 2>{}, std::true_type{})
                : f(D{}, integral_constant<int, 2>{}, std::false_type{});
  return tree ? f(D{}, integral_constant<int, 1>{}, std::true_type{})
              : f(D{}, integral_constant<int, 1>{}, std::false_type{});
}

template <typename F>
cudaError_t dispatch(const Geo& geo, bool tree, F&& f) {
  switch (geo.Dp / 16) {
    case 1:
      return dispatch_t<1>(geo.mpw, tree, f);
    case 2:
      return dispatch_t<2>(geo.mpw, tree, f);
    case 4:
      return dispatch_t<4>(geo.mpw, tree, f);
    default:
      return dispatch_t<8>(geo.mpw, tree, f);
  }
}

int launch(Args a, int S, void* stream_ptr) {
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int G = a.H / a.Hkv;
  if (!a.pos) a.bits = nullptr;  // the mask alone: J = Tq keys at -1
  if (!a.bits) a.J = a.Tq;
  if (S <= 0 || a.Tq <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.D % 4 ||
      a.D > 128 || G * a.Tq > kMaxRows ||
      (a.bits && (a.J <= 0 || a.J > kMaxKeys)))
    return (int)cudaErrorInvalidValue;
  a.S = S;
  const Geo geo = geometry(G, a.Tq, a.T, a.D, S * a.Hkv);
  const int n_pt = a.page_table ? a.T / a.page : 0;
  const size_t smem = smem_layout(geo, a.Tq, a.J, a.T, n_pt, nullptr, nullptr);
  a.kv_vec = a.D % 16 == 0 && al16(a.kq) && al16(a.vq);
  const int rows4 = a.page_table ? a.page % 4 == 0 : a.T % 4 == 0;
  a.s_vec = rows4 && al16(a.ks) && al16(a.vs);
  a.mask_vec = a.T % 16 == 0 && al16(a.mask);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const cudaError_t e =
      dispatch(geo, a.bits != nullptr, [&](auto db, auto mt, auto tree) {
        return launch_t<decltype(db)::value, decltype(mt)::value,
                        decltype(tree)::value>(a, geo, S, smem, stream);
      });
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// Shared memory one launch takes (bytes), for the wrapper's check.
PS_EXPORT size_t ps_flash_decode_smem(int S, int Hkv, int G, int Tq, int J,
                                      int T, int D, int page) {
  return smem_layout(geometry(G, Tq, T, D, S * Hkv), Tq, J, T,
                     page ? T / page : 0, nullptr, nullptr);
}

// The launch geometry at these shapes, for a measurement's record: out[0]
// splits (the cluster's size), [1] token groups a block, [2] warps a
// block, [3] 16-row tiles a warp, [4] shared memory bytes, [5] the clusters
// of this size and shared memory the card holds at once
// (cudaOccupancyMaxActiveClusters; of `splits` blocks where splits > 0),
// [6] the grid's clusters (S * Hkv). Returns a CUDA error code.
PS_EXPORT int ps_flash_decode_geometry(int S, int Hkv, int G, int Tq, int J,
                                       int T, int D, int page, int tree,
                                       int splits, int* out) {
  Geo geo = geometry(G, Tq, T, D, S * Hkv);
  const size_t smem = smem_layout(geo, Tq, tree ? J : Tq, T,
                                  page ? T / page : 0, nullptr, nullptr);
  out[0] = geo.n_split;
  out[1] = geo.tg;
  out[2] = geo.warps;
  out[3] = geo.mpw;
  out[4] = (int)smem;
  out[6] = S * Hkv;
  if (splits > 0) geo.n_split = splits;
  return (int)dispatch(geo, tree != 0, [&](auto db, auto mt, auto t) {
    return max_clusters<decltype(db)::value, decltype(mt)::value,
                        decltype(t)::value>(geo, S, Hkv, smem, out + 5);
  });
}

// positions int32 [S, J] or null; bits uint32 [Tq] or null (causal:
// positions [S, Tq], J ignored). m_out null: out f32 [S, Tq, H * D]
// normalized; else the state mode: out f32 [S, R, D] unnormalized and
// m_out, l_out f32 [S, R], R = H * Tq in (h, g, tq) order. t0: the global
// position of cache position 0 (positions are global). Returns a CUDA
// error code (0 on success).
PS_EXPORT int ps_flash_decode(const void* q, const void* kq, const void* ks,
                              const void* vq, const void* vs,
                              const void* mask, const void* positions,
                              const void* bits, void* out, void* m_out,
                              void* l_out, int S, int Tq, int J, int H,
                              int Hkv, int T, int D, int t0, float scale,
                              void* stream_ptr) {
  Args a{};
  a.q = reinterpret_cast<const float*>(q);
  a.kq = reinterpret_cast<const int8_t*>(kq);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vq = reinterpret_cast<const int8_t*>(vq);
  a.vs = reinterpret_cast<const float*>(vs);
  a.mask = reinterpret_cast<const uint8_t*>(mask);
  a.pos = reinterpret_cast<const int*>(positions);
  a.bits = reinterpret_cast<const uint32_t*>(bits);
  a.page = 1;
  a.n_pages = 1;
  a.out = reinterpret_cast<float*>(out);
  a.m_out = reinterpret_cast<float*>(m_out);
  a.l_out = reinterpret_cast<float*>(l_out);
  a.Tq = Tq, a.J = J, a.H = H, a.Hkv = Hkv, a.T = T, a.D = D;
  a.t0 = t0;
  a.scale = scale;
  return launch(a, S, stream_ptr);
}

// The paged pool: kq/vq int8 [P, Hkv, page, D], ks/vs f32 [P, Hkv, page],
// page_table int32 [S, max_pages] (P = unallocated), mask uint8
// [S, max_pages * page] over logical positions, positions int32 [S, J]
// and bits as ps_flash_decode's. m_out null: out f32 [S, Tq, H * D]
// normalized; else the state mode: out f32 [S, R, D] unnormalized and
// m_out, l_out f32 [S, R], R = H * Tq in (h, g, tq) order.
PS_EXPORT int ps_flash_decode_paged(const void* q, const void* kq,
                                    const void* ks, const void* vq,
                                    const void* vs, const void* page_table,
                                    const void* mask, const void* positions,
                                    const void* bits, void* out, void* m_out,
                                    void* l_out, int S, int Tq, int J, int H,
                                    int Hkv, int max_pages, int page,
                                    int n_pages, int D, float scale,
                                    void* stream_ptr) {
  Args a{};
  a.q = reinterpret_cast<const float*>(q);
  a.kq = reinterpret_cast<const int8_t*>(kq);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vq = reinterpret_cast<const int8_t*>(vq);
  a.vs = reinterpret_cast<const float*>(vs);
  a.mask = reinterpret_cast<const uint8_t*>(mask);
  a.pos = reinterpret_cast<const int*>(positions);
  a.bits = reinterpret_cast<const uint32_t*>(bits);
  a.page_table = reinterpret_cast<const int*>(page_table);
  a.page = page;
  a.n_pages = n_pages;
  a.out = reinterpret_cast<float*>(out);
  a.m_out = reinterpret_cast<float*>(m_out);
  a.l_out = reinterpret_cast<float*>(l_out);
  a.Tq = Tq, a.J = J, a.H = H, a.Hkv = Hkv, a.T = max_pages * page;
  a.D = D, a.scale = scale;
  return launch(a, S, stream_ptr);
}
