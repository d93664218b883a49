// The sampler's draws on the card, from per-slot Philox4x32-10 streams:
// one categorical draw per row of a distribution (mode 0), uniforms in
// [0, 1) (mode 1) or Gumbel(0, 1) noise (mode 2).
//
// Replaces no TPU kernel: the JAX package draws with jax.random
// (categorical, uniform, gumbel) inside its jitted steps. PyTorch has no
// draw that is seeded per row and that a CUDA graph can replay with
// per-slot seeds changing between requests, so the port keeps each
// slot's stream in two int64 device buffers: seed[s] (the Philox key,
// set at admission) and counter[s] (the slot's draws so far). Row r of a
// call belongs to slot r / m (m rows a slot: a tree's nodes, or every
// row of a one-slot engine) and makes draw number counter[s] + r % m;
// after the draw kernel a second kernel adds m to every slot's counter,
// so each replay of a captured step draws anew with no host involvement.
// Element e of a draw is word e % 4 of the Philox block with counter
// (e / 4 low, e / 4 high, draw low, draw high) and key (seed low, seed
// high); a uniform is (word >> 8) * 2^-24, exact in f32; Gumbel noise
// is -log(-log(max(u, 1e-20))). ops/sample.py's plain twin computes the
// same words in int64 torch ops, so uniforms and Gumbel noise are
// bit-equal to it.
//
// What bounds it on an H100: the bytes of the distribution, read once
// (8 x 152,064 f32 is 4.9 MB, 1.5 us at 3.35 TB/s), and for the noise
// modes the bytes written. The categorical mode runs one 1024-thread
// block a row: a block sum of the row, then the inverse CDF over tiles
// of 4096 values (each thread's 4 adjacent values summed in order, a
// block scan of the thread sums), stopping at the first tile where the
// running CDF exceeds u * total at an index with mass (past the last
// CDF value, by rounding: the last index with mass, or 0 for a row
// without any). With one block a row only R SMs work,
// so the kernel is far from that bound at R = 8; it stays simple here.
// The scan's order is not torch.cumsum's: a token may differ from the
// twin's where u * total lies within rounding of a CDF boundary.
#include "common.cuh"

namespace {

constexpr int kCatThreads = 1024;
constexpr int kCatItems = 4;
constexpr int kCatTile = kCatThreads * kCatItems;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 draw_block(int64_t seed, int64_t draw,
                                            int64_t block) {
  const uint64_t b = (uint64_t)block, d = (uint64_t)draw, s = (uint64_t)seed;
  return philox4x32_10(
      make_uint4((uint32_t)b, (uint32_t)(b >> 32), (uint32_t)d,
                 (uint32_t)(d >> 32)),
      make_uint2((uint32_t)s, (uint32_t)(s >> 32)));
}

__device__ __forceinline__ float unit_float(uint32_t x) {
  return (float)(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float gumbel(float u) {
  return -logf(-logf(fmaxf(u, 1e-20f)));
}

// Noise: thread t of the grid-stride loop takes one Philox block, the
// 4 values e = 4 b .. 4 b + 3 of row r.
__global__ void noise_kernel(float* __restrict__ out,
                             const int64_t* __restrict__ seed,
                             const int64_t* __restrict__ counter, int R,
                             int n, int m, int mode) {
  const int64_t nblk = (n + 3) / 4;
  const int64_t total = (int64_t)R * nblk;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(t / nblk);
    const int64_t b = t - (int64_t)r * nblk;
    const int s = r / m;
    const uint4 w = draw_block(seed[s], counter[s] + r % m, b);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    float* row = out + (int64_t)r * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = 4 * b + j;
      if (e < n) {
        const float u = unit_float(words[j]);
        row[e] = mode == 2 ? gumbel(u) : u;
      }
    }
  }
}

// Inclusive block scan of one float a thread (1024 threads): warp
// shuffles, then the warp totals in shared memory. Returns the thread's
// exclusive prefix; *tile_total gets the block's sum.
__device__ __forceinline__ float block_exclusive_scan(float v, float* warp_sums,
                                                      float* tile_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const float before = warp ? warp_sums[warp - 1] : 0.f;
  *tile_total = warp_sums[31];
  return before + incl - v;
}

__global__ void __launch_bounds__(kCatThreads)
    categorical_kernel(const float* __restrict__ dist, int64_t* __restrict__ out,
                       const int64_t* __restrict__ seed,
                       const int64_t* __restrict__ counter, int V, int m) {
  __shared__ float warp_sums[32];
  __shared__ float red[32];
  __shared__ int found;
  const int r = blockIdx.x, s = r / m;
  const float* row = dist + (int64_t)r * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the row's total
  float part = 0.f;
  for (int i = threadIdx.x; i < V; i += kCatThreads) part += row[i];
#pragma unroll
  for (int o = 16; o; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) red[warp] = part;
  if (threadIdx.x == 0) found = V;
  __syncthreads();
  float total = 0.f;
#pragma unroll 1
  for (int w = 0; w < 32; ++w) total += red[w];
  const float u = unit_float(draw_block(seed[s], counter[s] + r % m, 0).x);
  const float target = u * total;

  // the inverse CDF, tile by tile
  float running = 0.f;
  for (int base = 0; base < V; base += kCatTile) {
    const int i0 = base + threadIdx.x * kCatItems;
    float p[kCatItems], mine = 0.f;
#pragma unroll
    for (int j = 0; j < kCatItems; ++j) {
      p[j] = i0 + j < V ? row[i0 + j] : 0.f;
      mine += p[j];
    }
    float tile_total;
    float cdf = running + block_exclusive_scan(mine, warp_sums, &tile_total);
    int first = V;
#pragma unroll
    for (int j = 0; j < kCatItems; ++j) {
      cdf += p[j];
      // an index without mass is never taken, whatever the rounding of
      // the prefix it starts from
      if (first == V && p[j] > 0.f && cdf > target) first = i0 + j;
    }
    if (first < V) atomicMin(&found, first);
    running += tile_total;
    __syncthreads();
    if (found < V) break;
  }
  int pick = found;
  if (pick == V) {
    __syncthreads();
    if (threadIdx.x == 0) found = -1;
    __syncthreads();
    int last = -1;
    for (int i = threadIdx.x; i < V; i += kCatThreads)
      if (row[i] > 0.f) last = i;
    if (last >= 0) atomicMax(&found, last);
    __syncthreads();
    pick = found < 0 ? 0 : found;
  }
  if (threadIdx.x == 0) out[r] = pick;
}

__global__ void advance_kernel(int64_t* __restrict__ counter, int n_slots,
                               int m) {
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) counter[s] += m;
}

}  // namespace

// mode 0: out int64 [R] from dist f32 [R, n]; modes 1 (uniform) and 2
// (Gumbel): out f32 [R, n], dist unused. R = n_slots * m. Advances
// counter[0 .. n_slots) by m.
PS_EXPORT int ps_sample(int mode, const float* dist, void* out, int64_t* seed,
                        int64_t* counter, int R, int n, int m, int n_slots,
                        void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (mode == 0) {
    categorical_kernel<<<R, kCatThreads, 0, stream>>>(
        dist, reinterpret_cast<int64_t*>(out), seed, counter, n, m);
  } else {
    const int64_t work = (int64_t)R * ((n + 3) / 4);
    const int grid = (int)((work + 255) / 256 < 4096 ? (work + 255) / 256
                                                      : 4096);
    noise_kernel<<<grid, 256, 0, stream>>>(reinterpret_cast<float*>(out),
                                           seed, counter, R, n, m, mode);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  advance_kernel<<<1, 256, 0, stream>>>(counter, n_slots, m);
  return (int)cudaGetLastError();
}
