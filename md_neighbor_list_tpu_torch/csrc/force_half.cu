// K3 half-force, the cell sweep: Newton-3 half-sweep Lennard-Jones forces at
// the cutoff rc, with the once-per-pair shifted potential when asked.
//
// The NVE step's force between rebuilds reads the half list of the last
// rebuild instead (force_list.cu, whose kernel keeps the trace name
// force_half_kernel<0, true>); this sweep, force_sweep_kernel, serves every
// caller that holds no fresh list: the forces with PE (energies), the slab
// forms, the API's and the smoke's checks, and the step of a configuration
// that rebuilds every step.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_force_half_kernel (and
// the _fold_rxn / partner-row output maps / caller-side sums around it).
// Every unordered pair is evaluated once: the own slot i receives +f*d, the
// partner slot receives -f*d, d = own - partner. The caller zeroes `force`;
// `pe` is fully written, zeros on parked slots; a parked slot gets exactly
// zero force (nothing is added for a non-hit, and parked slots are never
// staged).
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
// Bound: operations. The distance tests between occupied slots (9 flops
// each, 317,303,122 at N = 1M) and ~20 flops per hit on the fp32 cores; the
// state read is tiny beside that. pair_r2 rounds every step (no FMA), so the
// tests reach at most half of the 67 TFLOP/s the bound assumes.
//
// What bounded the first kernel (a thread per window lane testing every slot,
// 1.658-1.681 ms at N = 1M, cap = 40): three times the needed tests (42 % of
// the slots are parked), 3-4 shared-memory f32 atomicAdds per hit, each an
// ATOMS.CAST.SPIN compare-and-swap loop on sm_90a, and a hit path that
// diverged in 69 % of warp-steps. The body in half_sweep.cuh tests occupied
// slots only, keeps every sum in registers or warp-private shared memory (no
// atomic inside the block; only the reactions and own-slot sums that cross
// blocks go out by global atomicAdd), and computes the pair term without a
// branch: 0.612-0.617 ms (0.686-0.693 with PE, the slab forms 0.619-0.624 and
// 0.677-0.693) on an NVIDIA H100 80GB HBM3 at 700 W; each design step's
// share: PERF.md.
//
// The order of the f32 additions into a slot (global atomics from several
// blocks) varies from run to run, so forces agree with the plain version to
// rounding, not bitwise. 1/r2 is correctly rounded (__frcp_rn) in both forms
// (the TPU hot path's approximate reciprocal with two Newton steps saved
// vector operations there).
#include "half_sweep.cuh"

namespace mdnl {

template <int KIND, bool ZWRAP>
__global__ void __launch_bounds__(32 * kHalfWarps)
force_sweep_kernel(const float* __restrict__ pos, float* __restrict__ force,
                  float* __restrict__ pe, int mc, int cap, float L,
                  float r2cut, float ushift, int nz_arr, float occupied_below,
                  int pass_len) {
  half_sweep_body<KIND, ZWRAP>(pos, force, pe, nullptr, mc, cap, L, r2cut,
                               ushift, nz_arr, occupied_below, pass_len);
}

}  // namespace mdnl

namespace {

// The grid: one block per own cell of the first nz_grid layers.
template <bool WANT_PE, bool ZWRAP>
int launch_force_half(const void* pos, void* force, void* pe, int mc, int cap,
                      float L, float r2cut, float ushift, int nz_grid,
                      int nz_arr, float occupied_below, void* stream) {
  using namespace mdnl;
  int warps, pass_len;
  if (cap < 1 || nz_grid < 1 || (!ZWRAP && nz_grid >= nz_arr) ||
      !half_sweep_plan(cap, warps, pass_len))
    return (int)cudaErrorInvalidValue;
  const size_t smem = half_sweep_shared(cap, warps, pass_len);
  const auto kernel = force_sweep_kernel<WANT_PE ? kForcePe : kForce, ZWRAP>;
  const cudaError_t err = fit_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nz_grid * mc * mc, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (float*)force, (float*)pe, mc, cap, L, r2cut, ushift,
      nz_arr, occupied_below, pass_len);
  return (int)cudaGetLastError();
}

}  // namespace

// occupied_below: a slot whose stored x is below it holds a particle (half
// the park base, ops/dense_cells.py::PARK_BASE).
extern "C" int mdnl_forces_half(const void* pos, void* force, int mc, int cap,
                                float L, float r2cut, float occupied_below,
                                void* stream) {
  return launch_force_half<false, true>(pos, force, nullptr, mc, cap, L, r2cut,
                                        0.f, mc, mc, occupied_below, stream);
}

extern "C" int mdnl_forces_half_pe(const void* pos, void* force, void* pe,
                                   int mc, int cap, float L, float r2cut,
                                   float ushift, float occupied_below,
                                   void* stream) {
  return launch_force_half<true, true>(pos, force, pe, mc, cap, L, r2cut,
                                       ushift, mc, mc, occupied_below, stream);
}

// Slab forms: pos and force (3, nz_arr*mc, mc, cap), pe (nz_grid*mc, mc, cap).
extern "C" int mdnl_forces_half_slab(const void* pos, void* force, int mc,
                                     int cap, float L, float r2cut,
                                     int nz_grid, int nz_arr,
                                     float occupied_below, void* stream) {
  return launch_force_half<false, false>(pos, force, nullptr, mc, cap, L,
                                         r2cut, 0.f, nz_grid, nz_arr,
                                         occupied_below, stream);
}

extern "C" int mdnl_forces_half_slab_pe(const void* pos, void* force, void* pe,
                                        int mc, int cap, float L, float r2cut,
                                        float ushift, int nz_grid, int nz_arr,
                                        float occupied_below, void* stream) {
  return launch_force_half<true, false>(pos, force, pe, mc, cap, L, r2cut,
                                        ushift, nz_grid, nz_arr,
                                        occupied_below, stream);
}
