// K4 pe/virial: per-slot shifted pair potential and pair virial
// w = dr . F = 24*(2*s6^2 - s6), each attributed once per pair to the own
// slot of the half sweep, with a correctly rounded 1/r2.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_pe_virial_half_kernel.
// The sweep is the half-force kernel's (half_sweep.cuh: occupied slots only,
// warp-private own-slot sums, a branch-free pair term) without the reaction:
// nothing leaves the block but its own cap slots, written with plain stores
// (zeros on parked slots), so no atomic is needed at all and the sums are
// folded in a fixed order: the result is the same from run to run and
// agrees with the plain version to rounding.
//
// Bound: operations, as for the force kernel (the distance tests between
// occupied slots). What bounded the first kernel (every slot tested, two
// shared-memory atomicAdds per hit: 1.336-1.352 ms at N = 1M, cap = 40) and
// what the body does about it: force_half.cu. This one takes 0.556-0.562 ms
// there (NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
#include "half_sweep.cuh"

namespace mdnl {

__global__ void __launch_bounds__(32 * kHalfWarps)
pe_virial_half_kernel(const float* __restrict__ pos, float* __restrict__ pe,
                      float* __restrict__ vir, int mc, int cap, float L,
                      float r2cut, float ushift, float occupied_below,
                      int pass_len) {
  half_sweep_body<kPeVirial, true>(pos, nullptr, pe, vir, mc, cap, L, r2cut,
                                   ushift, mc, occupied_below, pass_len);
}

}  // namespace mdnl

// occupied_below: as in force_half.cu.
extern "C" int mdnl_pe_virial_half(const void* pos, void* pe, void* vir,
                                   int mc, int cap, float L, float r2cut,
                                   float ushift, float occupied_below,
                                   void* stream) {
  using namespace mdnl;
  int warps, pass_len;
  if (cap < 1 || !half_sweep_plan(cap, warps, pass_len))
    return (int)cudaErrorInvalidValue;
  const size_t smem = half_sweep_shared(cap, warps, pass_len);
  const cudaError_t err = fit_shared(pe_virial_half_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pe_virial_half_kernel<<<mc * mc * mc, 32 * warps, smem,
                          (cudaStream_t)stream>>>(
      (const float*)pos, (float*)pe, (float*)vir, mc, cap, L, r2cut, ushift,
      occupied_below, pass_len);
  return (int)cudaGetLastError();
}
