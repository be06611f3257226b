// K6 full force: Lennard-Jones forces at the cutoff rc over all 27 neighbour
// cells, every pair evaluated at both partners and no reaction, with the
// per-slot shifted potential when asked (counted at both partners: total
// PE = 0.5 * sum over valid slots).
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_force_kernel (with the
// window array and the (mc, mc, 3) k-revisited grid around it: here a block
// reads the (3, R, mc, cap) state and `valid` directly and applies the image
// shifts itself). Slots with valid == 0 receive exactly zero and act on
// nobody, whatever position they hold.
//
// The sweep is geom.cuh's full sweep: one block per own cell, a thread per
// (z-group, own slot) that walks its three rows' windows, staged in shared
// memory, and keeps its sums in registers; the three groups' sums of a slot
// are added at the end, (g0 + g1) + g2. Every sum stays inside the block and
// has a fixed order: no atomics, and the result is bitwise the same from run
// to run — the deterministic yardstick for the half-force kernel, whose
// atomics are not. Against the plain version, which sums in another order,
// it agrees to rounding.
//
// The reciprocal is an exact division in both forms (the TPU hot form takes
// an approximate reciprocal with two Newton steps to save vector operations;
// a division costs little here).
//
// Above cap = kLaneCap (3*cap > 1024) the `_strided` kernel takes over: blocks
// of kStridedThreads threads, each serving own slots i, i + blockDim, ...; the
// nine rows are staged one at a time (3*cap floats a channel) and each row's
// sums of a slot are added into that slot's shared-memory total by the one
// thread that serves it, in the fixed row order (dy, then dz). Still no
// atomics and bitwise the same from run to run. One body for every cap (the
// 27-row staging with a strided (z-group, slot) loop) ran 0.4-2.3 % slower
// at cap = 40 (NVIDIA H100 80GB HBM3 at 700 W, tools/port_ab.py), hence two.
//
// Bound: operations (27*cap distance tests per slot, 9 flops each, plus about
// 16 per hit) against 13 bytes read and 12 or 16 written per slot.
#include "geom.cuh"

namespace mdnl {

template <bool WANT_PE>
__global__ void MDNL_BLOCK_BOUND
force_full_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ force, float* __restrict__ pe, int mc,
                  int cap, float L, float r2cut, float ushift) {
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

  float fx = 0.f, fy = 0.f, fz = 0.f, u = 0.f;
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
        if (r2 < r2cut && l != self) {
          const float s2 = __fdiv_rn(1.0f, r2);
          const float s6 = s2 * s2 * s2;
          const float f = 24.0f * s6 * (2.0f * s6 - 1.0f) * s2;
          fx += f * dx;
          fy += f * dyv;
          fz += f * dz;
          if (WANT_PE) u += 4.0f * (s6 * s6 - s6) - ushift;
        }
      }
    }
  }
  __syncthreads();
  float* part = smem;  // [4][3][cap], over the staged rows
  if (t < W) {
    part[t] = fx;
    part[W + t] = fy;
    part[2 * W + t] = fz;
    if (WANT_PE) part[3 * W + t] = u;
  }
  __syncthreads();
  if (t < cap) {
    const float* p = part + t;
    force[own] = (p[0] + p[cap]) + p[2 * cap];
    p += W;
    force[S + own] = (p[0] + p[cap]) + p[2 * cap];
    p += W;
    force[2 * S + own] = (p[0] + p[cap]) + p[2 * cap];
    p += W;
    if (WANT_PE) pe[own] = (p[0] + p[cap]) + p[2 * cap];
  }
}

template <bool WANT_PE>
__global__ void MDNL_STRIDED_BOUND
force_full_kernel_strided(const float* __restrict__ pos,
                          const unsigned char* __restrict__ valid,
                          float* __restrict__ force, float* __restrict__ pe,
                          int mc, int cap, float L, float r2cut,
                          float ushift) {
  extern __shared__ float smem[];
  const int W = 3 * cap;
  float* sx = smem;  // one staged row
  float* sy = sx + W;
  float* sz = sy + W;
  float* ox = sz + W;  // own positions
  float* oy = ox + cap;
  float* oz = oy + cap;
  float* acc = oz + cap;  // [4][cap]: fx, fy, fz, pe per own slot
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const size_t cell0 = (size_t)c.cell * cap;
  load_own(pos, S, cap, c.cell, ox, oy, oz);
  for (int e = threadIdx.x; e < 4 * cap; e += blockDim.x) acc[e] = 0.f;

  for (int dy = -1; dy <= 1; ++dy) {
    for (int g = 0; g < 3; ++g) {
      __syncthreads();  // the previous row has been swept
      stage_row_full(pos, valid, S, mc, cap, L, c, g - 1, dy, sx, sy, sz);
      __syncthreads();
      for (int i = threadIdx.x; i < cap; i += blockDim.x) {
        if (!valid[cell0 + i]) continue;
        const int self = self_lane(g, dy, i, cap);
        float fx = 0.f, fy = 0.f, fz = 0.f, u = 0.f;
        for (int l = 0; l < W; ++l) {
          float dx, dyv, dz;
          const float r2 =
              pair_r2(ox[i], oy[i], oz[i], sx[l], sy[l], sz[l], dx, dyv, dz);
          if (r2 < r2cut && l != self) {
            const float s2 = __fdiv_rn(1.0f, r2);
            const float s6 = s2 * s2 * s2;
            const float f = 24.0f * s6 * (2.0f * s6 - 1.0f) * s2;
            fx += f * dx;
            fy += f * dyv;
            fz += f * dz;
            if (WANT_PE) u += 4.0f * (s6 * s6 - s6) - ushift;
          }
        }
        acc[i] += fx;
        acc[cap + i] += fy;
        acc[2 * cap + i] += fz;
        if (WANT_PE) acc[3 * cap + i] += u;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    force[cell0 + i] = acc[i];
    force[S + cell0 + i] = acc[cap + i];
    force[2 * S + cell0 + i] = acc[2 * cap + i];
    if (WANT_PE) pe[cell0 + i] = acc[3 * cap + i];
  }
}

}  // namespace mdnl

namespace {

template <bool WANT_PE>
int launch_force_full(const void* pos, const void* valid, void* force,
                      void* pe, int mc, int cap, float L, float r2cut,
                      float ushift, void* stream) {
  using namespace mdnl;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (cap > kLaneCap) {
    const size_t smem = (size_t)cap * 16 * sizeof(float);
    const auto kernel = force_full_kernel_strided<WANT_PE>;
    const cudaError_t err = fit_shared(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<mc * mc * mc, kStridedThreads, smem, (cudaStream_t)stream>>>(
        (const float*)pos, (const unsigned char*)valid, (float*)force,
        (float*)pe, mc, cap, L, r2cut, ushift);
    return (int)cudaGetLastError();
  }
  const int threads = round_up32(3 * cap);
  const size_t smem = (size_t)cap * 27 * sizeof(float);
  force_full_kernel<WANT_PE>
      <<<mc * mc * mc, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const unsigned char*)valid, (float*)force,
      (float*)pe, mc, cap, L, r2cut, ushift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdnl_force_full(const void* pos, const void* valid, void* force,
                               int mc, int cap, float L, float r2cut,
                               void* stream) {
  return launch_force_full<false>(pos, valid, force, nullptr, mc, cap, L,
                                  r2cut, 0.f, stream);
}

extern "C" int mdnl_force_full_pe(const void* pos, const void* valid,
                                  void* force, void* pe, int mc, int cap,
                                  float L, float r2cut, float ushift,
                                  void* stream) {
  return launch_force_full<true>(pos, valid, force, pe, mc, cap, L, r2cut,
                                 ushift, stream);
}
