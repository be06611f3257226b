// K2 half-list: the neighbour-list artifact at the search radius.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_list_half_kernel and
// ::_list_half_kernel_grouped (same bits; one kernel covers both). Output,
// unchanged: masks (5, words, R, mc, 3*cap) i32 where bit i of word w at
// (k, row, x, lane l) says own slot 32*w + i of cell (row, x) has window lane
// l of offset row k within the radius, and counts (R, mc, cap) i32, the
// per-slot number of set bits.
//
// One block per own cell, one thread per window lane. The own cell's cap
// positions sit in shared memory; a thread keeps its partner's position in
// registers, walks the own slots and ORs the hit bits into `words` 32-bit
// registers, so no packing reduction exists at all (the TPU body packs with
// f32-weighted sublane sums because it has no per-lane bit registers). The
// per-own-slot count is a sum across lanes: one warp ballot + popcount per
// own slot, kept by lane (i % 32) of each warp, then summed over the warps
// through shared memory. Integers throughout, so the result is exact.
//
// W is the number of mask-word registers a thread holds. For cap <= 128 it is
// the word count itself (W = 1..4, every loop bound known to the compiler);
// above, the W = 11 form serves every word count up to the 11 of cap = 341
// and takes the real count at run time.
//
// Above cap = kLaneCap (3*cap > 1024, 11 or more words) the `_strided` kernel
// takes over: blocks of kStridedThreads threads walk the window in chunks of
// blockDim lanes, and for each lane the own slots in chunks of kChunkWords
// words (the W = 11 registers), writing each chunk's words before the next.
// The counts then live in shared memory, one counter per warp and own slot
// that only lane (i % 32) of that warp touches, as in the half-count kernel.
// One body for every cap (both chunk loops, counts in shared memory) ran 4-6 %
// slower at cap = 40 (NVIDIA H100 80GB HBM3 at 700 W, tools/port_ab.py),
// hence two.
//
// Bound: the mask write, 5*words*3 words per slot against 3 floats read; the
// ~15*cap distance tests per slot (9 flops each) come second on this card.
// Mask stores run along l and coalesce.
#include "geom.cuh"

namespace mdnl {

template <int W>
__global__ void MDNL_BLOCK_BOUND
lists_half_kernel(const float* __restrict__ pos, int* __restrict__ masks,
                  int* __restrict__ counts, int mc, int cap, float L,
                  float r2cut, int words_rt) {
  const int words = W <= 4 ? W : words_rt;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  int* scnt = (int*)(sz + cap);  // [warps][cap]
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t R = (size_t)mc * mc;
  const size_t S = R * mc * cap;
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  __syncthreads();

  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const bool active = l < 3 * cap;
  int cnt[W];
#pragma unroll
  for (int w = 0; w < W; ++w) cnt[w] = 0;

  for (int k = 0; k < 5; ++k) {
    float xj = 0.f, yj = 0.f, zj = 0.f;
    if (active) load_partner(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
    uint32_t bits[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      bits[w] = 0u;
      const int n = min(32, cap - 32 * w);  // <= 0 beyond the last word
      for (int b = 0; b < n; ++b) {
        const int i = 32 * w + b;
        float dx, dy, dz;
        const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
        const bool hit = active && half_keep(k, l, i, cap) && r2 < r2cut;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (lane == b) cnt[w] += __popc(ballot);
        bits[w] |= (uint32_t)hit << b;
      }
    }
    if (active) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w < words) {
          const size_t o =
              ((((size_t)k * words + w) * R + c.row) * mc + c.x) * (3 * cap) + l;
          masks[o] = (int)bits[w];  // bit 31 is the sign bit: same 32 bits
        }
      }
    }
  }

#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int i = 32 * w + lane;
    if (i < cap) scnt[warp * cap + i] = cnt[w];
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    int total = 0;
    for (int w = 0; w < warps; ++w) total += scnt[w * cap + i];
    counts[(size_t)c.cell * cap + i] = total;
  }
}

constexpr int kChunkWords = 11;

__global__ void MDNL_STRIDED_BOUND
lists_half_kernel_strided(const float* __restrict__ pos,
                          int* __restrict__ masks, int* __restrict__ counts,
                          int mc, int cap, float L, float r2cut) {
  const int words = (cap + 31) / 32;
  const int warps = blockDim.x >> 5;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  int* scnt = (int*)(sz + cap);  // [warps][cap]
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t R = (size_t)mc * mc;
  const size_t S = R * mc * cap;
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  for (int e = threadIdx.x; e < warps * cap; e += blockDim.x) scnt[e] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int* mine = scnt + (threadIdx.x >> 5) * cap;
  for (int base = 0; base < 3 * cap; base += blockDim.x) {  // block-uniform
    const int l = base + threadIdx.x;
    const bool active = l < 3 * cap;
    for (int k = 0; k < 5; ++k) {
      float xj = 0.f, yj = 0.f, zj = 0.f;
      if (active) load_partner(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
      for (int w0 = 0; w0 < words; w0 += kChunkWords) {
        uint32_t bits[kChunkWords];
#pragma unroll
        for (int w = 0; w < kChunkWords; ++w) {
          bits[w] = 0u;
          const int n = min(32, cap - 32 * (w0 + w));  // <= 0 past the end
          for (int b = 0; b < n; ++b) {
            const int i = 32 * (w0 + w) + b;
            float dx, dy, dz;
            const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
            const bool hit = active && half_keep(k, l, i, cap) && r2 < r2cut;
            const unsigned ballot = __ballot_sync(0xffffffffu, hit);
            if (lane == b) mine[i] += __popc(ballot);
            bits[w] |= (uint32_t)hit << b;
          }
        }
        if (active) {
#pragma unroll
          for (int w = 0; w < kChunkWords; ++w) {
            if (w0 + w < words) {
              const size_t o =
                  ((((size_t)k * words + w0 + w) * R + c.row) * mc + c.x) *
                      (3 * cap) + l;
              masks[o] = (int)bits[w];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    int total = 0;
    for (int w = 0; w < warps; ++w) total += scnt[w * cap + i];
    counts[(size_t)c.cell * cap + i] = total;
  }
}

}  // namespace mdnl

extern "C" int mdnl_lists_half(const void* pos, void* masks, void* counts,
                               int mc, int cap, float L, float r2cut,
                               void* stream) {
  using namespace mdnl;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const int blocks = mc * mc * mc;
  if (cap > kLaneCap) {
    const size_t smem = (size_t)cap * (3 * sizeof(float) +
                                       (kStridedThreads / 32) * sizeof(int));
    const cudaError_t err = fit_shared(lists_half_kernel_strided, smem);
    if (err != cudaSuccess) return (int)err;
    lists_half_kernel_strided<<<blocks, kStridedThreads, smem,
                                (cudaStream_t)stream>>>(
        (const float*)pos, (int*)masks, (int*)counts, mc, cap, L, r2cut);
    return (int)cudaGetLastError();
  }
  const int threads = round_up32(3 * cap);
  const size_t smem = (size_t)cap * (3 * sizeof(float) + (threads / 32) * sizeof(int));
  const int words = (cap + 31) / 32;
  auto kernel = lists_half_kernel<11>;  // 5..11 words, cap <= 341
  switch (words) {
    case 1: kernel = lists_half_kernel<1>; break;
    case 2: kernel = lists_half_kernel<2>; break;
    case 3: kernel = lists_half_kernel<3>; break;
    case 4: kernel = lists_half_kernel<4>; break;
  }
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (int*)masks, (int*)counts, mc, cap, L, r2cut, words);
  return (int)cudaGetLastError();
}
