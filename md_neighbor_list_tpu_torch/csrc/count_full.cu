// K7 full count: per-slot neighbour counts at the search radius over all 27
// neighbour cells, every pair counted at both partners (pair count = sum / 2).
// The symmetric parity pass that the half-sweep pair count is held against.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_count_kernel (with the
// window array and the (mc, mc, 3) k-revisited grid around it: here a block
// reads the (3, R, mc, cap) state and `valid` directly and applies the image
// shifts itself). Output: counts (R, mc, cap) i32, exact integers; slots with
// valid == 0 count nothing and are counted by nobody.
//
// The sweep is geom.cuh's full sweep: one block per own cell, a thread per
// (z-group, own slot) that walks its three rows' windows, staged in shared
// memory, keeping its count in a register; the three groups' counts of a slot
// are added at the end. The self pair is excluded on the centre cell's
// diagonal only.
//
// Above cap = kLaneCap the `_strided` kernel takes over: a thread per own
// slot (i, i + blockDim, ...), the nine rows staged one at a
// time, each slot's count kept in shared memory by the thread that serves it.
// One body for every cap (the 27-row staging with a strided (z-group, slot)
// loop) ran 3-5 % slower at cap = 40 (NVIDIA H100 80GB HBM3 at 700 W,
// tools/port_ab.py), hence two.
//
// Bound: operations (27*cap distance tests per slot) against 13 bytes read
// and 4 written per slot.
#include "geom.cuh"

namespace mdnl {

__global__ void MDNL_BLOCK_BOUND
count_full_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ valid,
                  int* __restrict__ counts, int mc, int cap, float L,
                  float r2cut) {
  extern __shared__ float smem[];
  const int W = 3 * cap;
  float* sx = smem;
  float* sy = sx + 3 * W;
  float* sz = sy + 3 * W;
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const int t = threadIdx.x;
  const int g = t / cap, i = t - g * cap;
  const size_t own = (size_t)c.cell * cap + i;
  const bool sweeps = t < W && valid[own];
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (sweeps) { xi = pos[own]; yi = pos[S + own]; zi = pos[2 * S + own]; }

  int cnt = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    __syncthreads();  // the previous rows have been swept
    stage_rows_full(pos, valid, S, mc, cap, L, c, dy, sx, sy, sz);
    __syncthreads();
    if (sweeps) {
      const float* px = sx + g * W;
      const float* py = sy + g * W;
      const float* pz = sz + g * W;
      const int self = self_lane(g, dy, i, cap);
      for (int l = 0; l < W; ++l) {
        float dx, dyv, dz;
        const float r2 = pair_r2(xi, yi, zi, px[l], py[l], pz[l], dx, dyv, dz);
        cnt += (r2 < r2cut && l != self) ? 1 : 0;
      }
    }
  }
  __syncthreads();
  int* part = (int*)smem;  // [3][cap], over the staged rows
  if (t < W) part[t] = cnt;
  __syncthreads();
  if (t < cap) counts[own] = part[t] + part[cap + t] + part[2 * cap + t];
}

__global__ void MDNL_STRIDED_BOUND
count_full_kernel_strided(const float* __restrict__ pos,
                          const unsigned char* __restrict__ valid,
                          int* __restrict__ counts, int mc, int cap, float L,
                          float r2cut) {
  extern __shared__ float smem[];
  const int W = 3 * cap;
  float* sx = smem;  // one staged row
  float* sy = sx + W;
  float* sz = sy + W;
  float* ox = sz + W;  // own positions
  float* oy = ox + cap;
  float* oz = oy + cap;
  int* acc = (int*)(oz + cap);  // [cap]
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const size_t cell0 = (size_t)c.cell * cap;
  load_own(pos, S, cap, c.cell, ox, oy, oz);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) acc[i] = 0;

  for (int dy = -1; dy <= 1; ++dy) {
    for (int g = 0; g < 3; ++g) {
      __syncthreads();  // the previous row has been swept
      stage_row_full(pos, valid, S, mc, cap, L, c, g - 1, dy, sx, sy, sz);
      __syncthreads();
      for (int i = threadIdx.x; i < cap; i += blockDim.x) {
        if (!valid[cell0 + i]) continue;
        const int self = self_lane(g, dy, i, cap);
        int cnt = 0;
        for (int l = 0; l < W; ++l) {
          float dx, dyv, dz;
          const float r2 =
              pair_r2(ox[i], oy[i], oz[i], sx[l], sy[l], sz[l], dx, dyv, dz);
          cnt += (r2 < r2cut && l != self) ? 1 : 0;
        }
        acc[i] += cnt;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) counts[cell0 + i] = acc[i];
}

}  // namespace mdnl

extern "C" int mdnl_count_full(const void* pos, const void* valid,
                               void* counts, int mc, int cap, float L,
                               float r2cut, void* stream) {
  using namespace mdnl;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (cap > kLaneCap) {
    const size_t smem = (size_t)cap * 13 * sizeof(float);
    const cudaError_t err = fit_shared(count_full_kernel_strided, smem);
    if (err != cudaSuccess) return (int)err;
    count_full_kernel_strided<<<mc * mc * mc, kStridedThreads, smem,
                                (cudaStream_t)stream>>>(
        (const float*)pos, (const unsigned char*)valid, (int*)counts, mc, cap,
        L, r2cut);
    return (int)cudaGetLastError();
  }
  const int threads = round_up32(3 * cap);
  const size_t smem = (size_t)cap * 27 * sizeof(float);
  count_full_kernel<<<mc * mc * mc, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const unsigned char*)valid, (int*)counts, mc, cap, L,
      r2cut);
  return (int)cudaGetLastError();
}
