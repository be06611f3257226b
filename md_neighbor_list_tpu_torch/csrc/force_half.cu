// K3 half-force: Newton-3 half-sweep Lennard-Jones forces at the cutoff rc,
// with the once-per-pair shifted potential when asked.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_force_half_kernel (and
// the _fold_rxn / partner-row output maps / caller-side sums around it).
// Every unordered pair is evaluated once: the own slot i receives +f*d, the
// partner slot receives -f*d, d = own - partner.
//
// One block per own cell, one thread per window lane l. The thread keeps its
// partner's position and the running reaction on that partner in registers;
// after each offset row it adds the reaction into the force array at the
// partner's slot with an f32 atomicAdd (the partner lives in another block's
// cell, and the TPU body's fold onto partner cells is this same sum). The
// own-slot force is a sum across lanes: each hit adds into a shared-memory
// accumulator for slot i, and the threads of a warp walk the own slots
// staggered (i = (step + l) % cap) so that they address different slots at a
// time. At the end the block adds its own-slot sums into the force array,
// again atomically, since neighbouring blocks add their reactions there.
//
// Choice for the reaction sum: atomics, not a scratch array and a second
// folding kernel. It is the simpler kernel and moves fewer bytes; the price
// is that the order of the f32 additions varies from run to run, so forces
// agree with the plain version to rounding (about 1e-6 relative per term),
// not bitwise. Nothing is ever added for a non-hit, so parked slots keep an
// exactly zero force. The caller zeroes `force` before the launch; `pe` is
// fully written.
//
// The reciprocal is an exact division in both forms (the TPU hot path's
// approximate reciprocal with two Newton steps saved vector operations
// there; a division costs little here).
//
// Above cap = kLaneCap (3*cap > 1024) the `_strided` kernel runs the same
// sweep in blocks of kStridedThreads threads, each serving window lanes
// l, l + blockDim, ... in turn. It is a separate body: folding the lane loop
// into the body above, even as a loop of one trip, made the want_pe form 3 %
// slower at cap = 40 (NVIDIA H100 80GB HBM3 at 700 W, by tools/port_ab.py).
//
// The slab forms (ZWRAP = false, entries mdnl_forces_half_slab[_pe]) replace
// the same kernel as md_neighbor_list_tpu/ops/slab_kernels.py reaches it
// (slab_forces_half, slab_forces_interior, slab_forces_boundary): the grid
// walks the first nz_grid layers of an array of nz_arr, and `force` has the
// array's layers. The reactions onto the layer past the grid land in that
// layer, which the caller reads as the seam (or the interior pass's top
// reaction); the TPU kernel's reaction output maps are this same sum. `pe`
// has the grid's layers.
//
// Bound: operations. About 15*cap distance tests per slot (9 flops) plus
// ~20 flops per hit on the fp32 cores; the state read is tiny beside that.
#include "geom.cuh"

namespace mdnl {

template <bool WANT_PE, bool ZWRAP>
__device__ __forceinline__ void
force_half_body(const float* __restrict__ pos, float* __restrict__ force,
                float* __restrict__ pe, int mc, int cap, float L, float r2cut,
                float ushift, int nz_arr) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* sfx = sz + cap;
  float* sfy = sfx + cap;
  float* sfz = sfy + cap;
  float* spe = sfz + cap;
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = state_slots<ZWRAP>(mc, cap, nz_arr);
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    sfx[i] = 0.f; sfy[i] = 0.f; sfz[i] = 0.f;
    if (WANT_PE) spe[i] = 0.f;
  }
  __syncthreads();

  const int l = threadIdx.x;
  if (l < 3 * cap) {
    const int i0 = l % cap;
    for (int k = 0; k < 5; ++k) {
      float xj, yj, zj;
      const int pj =
          load_partner<ZWRAP>(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
      float rx = 0.f, ry = 0.f, rz = 0.f;
      bool any = false;
      int i = i0;
      for (int step = 0; step < cap; ++step) {
        float dx, dy, dz;
        const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
        if (half_keep(k, l, i, cap) && r2 < r2cut) {
          const float s2 = __fdiv_rn(1.0f, r2);
          const float s6 = s2 * s2 * s2;
          const float f = 24.0f * s6 * (2.0f * s6 - 1.0f) * s2;
          const float px = f * dx, py = f * dy, pz = f * dz;
          atomicAdd(&sfx[i], px);
          atomicAdd(&sfy[i], py);
          atomicAdd(&sfz[i], pz);
          if (WANT_PE) atomicAdd(&spe[i], 4.0f * (s6 * s6 - s6) - ushift);
          rx += px; ry += py; rz += pz;
          any = true;
        }
        if (++i == cap) i = 0;
      }
      if (any) {
        atomicAdd(&force[pj], -rx);
        atomicAdd(&force[S + pj], -ry);
        atomicAdd(&force[2 * S + pj], -rz);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const size_t g = (size_t)c.cell * cap + i;
    if (sfx[i] != 0.f || sfy[i] != 0.f || sfz[i] != 0.f) {
      atomicAdd(&force[g], sfx[i]);
      atomicAdd(&force[S + g], sfy[i]);
      atomicAdd(&force[2 * S + g], sfz[i]);
    }
    if (WANT_PE) pe[g] = spe[i];
  }
}

template <bool WANT_PE, bool ZWRAP>
__global__ void MDNL_NARROW
force_half_kernel(const float* __restrict__ pos, float* __restrict__ force,
                  float* __restrict__ pe, int mc, int cap, float L,
                  float r2cut, float ushift, int nz_arr) {
  force_half_body<WANT_PE, ZWRAP>(pos, force, pe, mc, cap, L, r2cut, ushift,
                                  nz_arr);
}

template <bool WANT_PE, bool ZWRAP>
__global__ void MDNL_BLOCK_BOUND
force_half_kernel_wide(const float* __restrict__ pos,
                       float* __restrict__ force, float* __restrict__ pe,
                       int mc, int cap, float L, float r2cut, float ushift,
                       int nz_arr) {
  force_half_body<WANT_PE, ZWRAP>(pos, force, pe, mc, cap, L, r2cut, ushift,
                                  nz_arr);
}

template <bool WANT_PE, bool ZWRAP>
__global__ void MDNL_STRIDED_BOUND
force_half_kernel_strided(const float* __restrict__ pos,
                          float* __restrict__ force, float* __restrict__ pe,
                          int mc, int cap, float L, float r2cut,
                          float ushift, int nz_arr) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* sfx = sz + cap;
  float* sfy = sfx + cap;
  float* sfz = sfy + cap;
  float* spe = sfz + cap;
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = state_slots<ZWRAP>(mc, cap, nz_arr);
  load_own(pos, S, cap, c.cell, sx, sy, sz);
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    sfx[i] = 0.f; sfy[i] = 0.f; sfz[i] = 0.f;
    if (WANT_PE) spe[i] = 0.f;
  }
  __syncthreads();

  for (int l = threadIdx.x; l < 3 * cap; l += blockDim.x) {
    for (int k = 0; k < 5; ++k) {
      float xj, yj, zj;
      const int pj =
          load_partner<ZWRAP>(pos, S, mc, cap, L, c, k, l, xj, yj, zj);
      float rx = 0.f, ry = 0.f, rz = 0.f;
      bool any = false;
      int i = l % cap;
      for (int step = 0; step < cap; ++step) {
        float dx, dy, dz;
        const float r2 = pair_r2(sx[i], sy[i], sz[i], xj, yj, zj, dx, dy, dz);
        if (half_keep(k, l, i, cap) && r2 < r2cut) {
          const float s2 = __fdiv_rn(1.0f, r2);
          const float s6 = s2 * s2 * s2;
          const float f = 24.0f * s6 * (2.0f * s6 - 1.0f) * s2;
          const float px = f * dx, py = f * dy, pz = f * dz;
          atomicAdd(&sfx[i], px);
          atomicAdd(&sfy[i], py);
          atomicAdd(&sfz[i], pz);
          if (WANT_PE) atomicAdd(&spe[i], 4.0f * (s6 * s6 - s6) - ushift);
          rx += px; ry += py; rz += pz;
          any = true;
        }
        if (++i == cap) i = 0;
      }
      if (any) {
        atomicAdd(&force[pj], -rx);
        atomicAdd(&force[S + pj], -ry);
        atomicAdd(&force[2 * S + pj], -rz);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const size_t g = (size_t)c.cell * cap + i;
    if (sfx[i] != 0.f || sfy[i] != 0.f || sfz[i] != 0.f) {
      atomicAdd(&force[g], sfx[i]);
      atomicAdd(&force[S + g], sfy[i]);
      atomicAdd(&force[2 * S + g], sfz[i]);
    }
    if (WANT_PE) pe[g] = spe[i];
  }
}

}  // namespace mdnl

namespace {

// The grid: one block per own cell of the first nz_grid layers.
template <bool WANT_PE, bool ZWRAP>
int launch_force_half(const void* pos, void* force, void* pe, int mc, int cap,
                      float L, float r2cut, float ushift, int nz_grid,
                      int nz_arr, void* stream) {
  using namespace mdnl;
  if (cap < 1 || nz_grid < 1 || (!ZWRAP && nz_grid >= nz_arr))
    return (int)cudaErrorInvalidValue;
  const int blocks = nz_grid * mc * mc;
  const size_t smem = (size_t)cap * 7 * sizeof(float);
  if (cap > kLaneCap) {
    const auto kernel = force_half_kernel_strided<WANT_PE, ZWRAP>;
    const cudaError_t err = fit_shared(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kStridedThreads, smem, (cudaStream_t)stream>>>(
        (const float*)pos, (float*)force, (float*)pe, mc, cap, L, r2cut,
        ushift, nz_arr);
    return (int)cudaGetLastError();
  }
  const int threads = round_up32(3 * cap);
  const auto kernel = cap <= kNarrowCap ? force_half_kernel<WANT_PE, ZWRAP>
                                        : force_half_kernel_wide<WANT_PE, ZWRAP>;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (float*)force, (float*)pe, mc, cap, L, r2cut, ushift,
      nz_arr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdnl_forces_half(const void* pos, void* force, int mc, int cap,
                                float L, float r2cut, void* stream) {
  return launch_force_half<false, true>(pos, force, nullptr, mc, cap, L, r2cut,
                                        0.f, mc, mc, stream);
}

extern "C" int mdnl_forces_half_pe(const void* pos, void* force, void* pe,
                                   int mc, int cap, float L, float r2cut,
                                   float ushift, void* stream) {
  return launch_force_half<true, true>(pos, force, pe, mc, cap, L, r2cut,
                                       ushift, mc, mc, stream);
}

// Slab forms: pos and force (3, nz_arr*mc, mc, cap), pe (nz_grid*mc, mc, cap).
extern "C" int mdnl_forces_half_slab(const void* pos, void* force, int mc,
                                     int cap, float L, float r2cut,
                                     int nz_grid, int nz_arr, void* stream) {
  return launch_force_half<false, false>(pos, force, nullptr, mc, cap, L,
                                         r2cut, 0.f, nz_grid, nz_arr, stream);
}

extern "C" int mdnl_forces_half_slab_pe(const void* pos, void* force, void* pe,
                                        int mc, int cap, float L, float r2cut,
                                        float ushift, int nz_grid, int nz_arr,
                                        void* stream) {
  return launch_force_half<true, false>(pos, force, pe, mc, cap, L, r2cut,
                                        ushift, nz_grid, nz_arr, stream);
}
