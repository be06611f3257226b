// K5 half-count: per-slot half neighbour counts at the search radius, the
// list kernel's counts without its masks.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_count_half_kernel.
// Output: counts (R, mc, cap) i32, every unordered pair attributed once, to
// the own slot of the half sweep — bitwise the `counts` of the list kernel
// (lists_half.cu) and the per-slot popcount of its masks. The TPU body sums
// hits as f32 and casts; here everything is an integer.
//
// One block per own cell, one thread per window lane (the list kernel's
// first design): for each own slot one warp ballot + popcount, added by lane
// (i % 32) into that warp's counter of the slot in shared memory (only that
// lane of that warp ever touches the entry, so no atomics), then summed over
// the warps. No validity input: the half sweep relies on the park invariant.
//
// Above cap = kLaneCap the `_strided` kernel runs the same sweep in blocks of
// kStridedThreads threads: the block walks the window in chunks of blockDim
// lanes (every thread takes part in every ballot) and a warp keeps adding into
// its own counters. It is a separate body: folding the chunk loop into the
// body above, even as a loop of one trip, made it 6 % slower at cap = 40
// (NVIDIA H100 80GB HBM3 at 700 W, by tools/port_ab.py).
//
// Bound: operations (about 15*cap distance tests per slot); it reads 3 floats
// and writes one int per slot.
#include "geom.cuh"

namespace mdnl {

__device__ __forceinline__ void
count_half_body(const float* __restrict__ pos, int* __restrict__ counts,
                int mc, int cap, float L, float r2cut) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  int* scnt = (int*)(sz + cap);  // [warps][cap]
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const int warps = blockDim.x >> 5;
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  for (int e = threadIdx.x; e < warps * cap; e += blockDim.x) scnt[e] = 0;
  __syncthreads();

  const int l = threadIdx.x;
  const int lane = l & 31;
  int* mine = scnt + (l >> 5) * cap;
  const bool active = l < 3 * cap;
  for (int k = 0; k < 5; ++k) {
    float xj = 0.f, yj = 0.f, zj = 0.f;
    if (active) load_partner(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
    for (int i = 0; i < cap; ++i) {
      float dx, dy, dz;
      const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
      const bool hit = active && half_keep(k, l, i, cap) && r2 < r2cut;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == (i & 31)) mine[i] += __popc(ballot);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    int total = 0;
    for (int w = 0; w < warps; ++w) total += scnt[w * cap + i];
    counts[(size_t)c.cell * cap + i] = total;
  }
}

__global__ void MDNL_NARROW
count_half_kernel(const float* __restrict__ pos, int* __restrict__ counts,
                  int mc, int cap, float L, float r2cut) {
  count_half_body(pos, counts, mc, cap, L, r2cut);
}

__global__ void MDNL_BLOCK_BOUND
count_half_kernel_wide(const float* __restrict__ pos, int* __restrict__ counts,
                       int mc, int cap, float L, float r2cut) {
  count_half_body(pos, counts, mc, cap, L, r2cut);
}

__global__ void MDNL_STRIDED_BOUND
count_half_kernel_strided(const float* __restrict__ pos,
                          int* __restrict__ counts, int mc, int cap, float L,
                          float r2cut) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  int* scnt = (int*)(sz + cap);  // [warps][cap]
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const int warps = blockDim.x >> 5;
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
      for (int i = 0; i < cap; ++i) {
        float dx, dy, dz;
        const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
        const bool hit = active && half_keep(k, l, i, cap) && r2 < r2cut;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (lane == (i & 31)) mine[i] += __popc(ballot);
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

extern "C" int mdnl_count_half(const void* pos, void* counts, int mc, int cap,
                               float L, float r2cut, void* stream) {
  using namespace mdnl;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (cap > kLaneCap) {
    const size_t smem = (size_t)cap * (3 * sizeof(float) +
                                       (kStridedThreads / 32) * sizeof(int));
    const cudaError_t err = fit_shared(count_half_kernel_strided, smem);
    if (err != cudaSuccess) return (int)err;
    count_half_kernel_strided<<<mc * mc * mc, kStridedThreads, smem,
                                (cudaStream_t)stream>>>(
        (const float*)pos, (int*)counts, mc, cap, L, r2cut);
    return (int)cudaGetLastError();
  }
  const int threads = round_up32(3 * cap);
  const size_t smem =
      (size_t)cap * (3 * sizeof(float) + (threads / 32) * sizeof(int));
  const auto kernel =
      cap <= kNarrowCap ? count_half_kernel : count_half_kernel_wide;
  kernel<<<mc * mc * mc, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (int*)counts, mc, cap, L, r2cut);
  return (int)cudaGetLastError();
}
