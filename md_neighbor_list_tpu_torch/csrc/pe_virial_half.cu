// K4 pe/virial: per-slot shifted pair potential and pair virial
// w = dr . F = 24*(2*s6^2 - s6), each attributed once per pair to the own
// slot of the half sweep, with an exact division.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_pe_virial_half_kernel.
// The sweep is the half-force kernel's (one block per own cell, one thread
// per window lane, own slots walked staggered, hits added into per-slot
// shared-memory accumulators) without the reaction: nothing leaves the block
// but its own cap slots, so both outputs are fully written and no global
// atomics are needed. The order of the f32 additions inside a slot varies
// from run to run; totals agree with the plain version to rounding.
//
// Above cap = kLaneCap the `_strided` kernel runs the same sweep in blocks of
// kStridedThreads threads, each serving window lanes l, l + blockDim, ... It
// is a separate body: folding the lane loop into the body above, even as a
// loop of one trip, made it 6 % slower at cap = 40 (NVIDIA H100 80GB HBM3 at
// 700 W, by tools/port_ab.py).
//
// Bound: operations (15*cap distance tests per slot), as for the force kernel.
#include "geom.cuh"

namespace mdnl {

__device__ __forceinline__ void
pe_virial_half_body(const float* __restrict__ pos, float* __restrict__ pe,
                    float* __restrict__ vir, int mc, int cap, float L,
                    float r2cut, float ushift) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* spe = sz + cap;
  float* svir = spe + cap;
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    spe[i] = 0.f;
    svir[i] = 0.f;
  }
  __syncthreads();

  const int l = threadIdx.x;
  if (l < 3 * cap) {
    const int i0 = l % cap;
    for (int k = 0; k < 5; ++k) {
      float xj, yj, zj;
      load_partner(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
      int i = i0;
      for (int step = 0; step < cap; ++step) {
        float dx, dy, dz;
        const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
        if (half_keep(k, l, i, cap) && r2 < r2cut) {
          const float s2 = __fdiv_rn(1.0f, r2);
          const float s6 = s2 * s2 * s2;
          atomicAdd(&spe[i], 4.0f * (s6 * s6 - s6) - ushift);
          atomicAdd(&svir[i], 24.0f * s6 * (2.0f * s6 - 1.0f));
        }
        if (++i == cap) i = 0;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const size_t g = (size_t)c.cell * cap + i;
    pe[g] = spe[i];
    vir[g] = svir[i];
  }
}

__global__ void MDNL_NARROW
pe_virial_half_kernel(const float* __restrict__ pos, float* __restrict__ pe,
                      float* __restrict__ vir, int mc, int cap, float L,
                      float r2cut, float ushift) {
  pe_virial_half_body(pos, pe, vir, mc, cap, L, r2cut, ushift);
}

__global__ void MDNL_BLOCK_BOUND
pe_virial_half_kernel_wide(const float* __restrict__ pos,
                           float* __restrict__ pe, float* __restrict__ vir,
                           int mc, int cap, float L, float r2cut,
                           float ushift) {
  pe_virial_half_body(pos, pe, vir, mc, cap, L, r2cut, ushift);
}

__global__ void MDNL_STRIDED_BOUND
pe_virial_half_kernel_strided(const float* __restrict__ pos,
                              float* __restrict__ pe, float* __restrict__ vir,
                              int mc, int cap, float L, float r2cut,
                              float ushift) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* spe = sz + cap;
  float* svir = spe + cap;
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    spe[i] = 0.f;
    svir[i] = 0.f;
  }
  __syncthreads();

  for (int l = threadIdx.x; l < 3 * cap; l += blockDim.x) {
    for (int k = 0; k < 5; ++k) {
      float xj, yj, zj;
      load_partner(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
      int i = l % cap;
      for (int step = 0; step < cap; ++step) {
        float dx, dy, dz;
        const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
        if (half_keep(k, l, i, cap) && r2 < r2cut) {
          const float s2 = __fdiv_rn(1.0f, r2);
          const float s6 = s2 * s2 * s2;
          atomicAdd(&spe[i], 4.0f * (s6 * s6 - s6) - ushift);
          atomicAdd(&svir[i], 24.0f * s6 * (2.0f * s6 - 1.0f));
        }
        if (++i == cap) i = 0;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const size_t g = (size_t)c.cell * cap + i;
    pe[g] = spe[i];
    vir[g] = svir[i];
  }
}

}  // namespace mdnl

extern "C" int mdnl_pe_virial_half(const void* pos, void* pe, void* vir,
                                   int mc, int cap, float L, float r2cut,
                                   float ushift, void* stream) {
  using namespace mdnl;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cap * 5 * sizeof(float);
  if (cap > kLaneCap) {
    const cudaError_t err = fit_shared(pe_virial_half_kernel_strided, smem);
    if (err != cudaSuccess) return (int)err;
    pe_virial_half_kernel_strided<<<mc * mc * mc, kStridedThreads, smem,
                                    (cudaStream_t)stream>>>(
        (const float*)pos, (float*)pe, (float*)vir, mc, cap, L, r2cut, ushift);
    return (int)cudaGetLastError();
  }
  const int threads = round_up32(3 * cap);
  const auto kernel =
      cap <= kNarrowCap ? pe_virial_half_kernel : pe_virial_half_kernel_wide;
  kernel<<<mc * mc * mc, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (float*)pe, (float*)vir, mc, cap, L, r2cut, ushift);
  return (int)cudaGetLastError();
}
