// Shared device code of the sweep kernels: the window geometry of the dense
// cell layout.
//
// State arrays are channel-leading (3, R, mc, cap) f32 with R = mc*mc rows
// (z, y), axis 2 the x-cell and axis 3 the slot. For own cell (z, y, x), a
// neighbour row (dz, dy) with dz, dy in {-1, 0, 1} and window lane l in
// [0, 3*cap): the partner is slot l % cap of x-cell (x + l/cap - 1) mod mc in
// row ((z+dz) % mc, (y+dy) % mc), moved by -L/+L along every axis on which the
// neighbour wrapped around the box, so d = own - partner is the nearest image.
// The half sweep visits the five rows HALF_OFFSETS5[k]; the full sweep visits
// all nine, every pair from both partners.
//
// The slab forms of the half sweep (template argument ZWRAP = false) read an
// array of nz_arr z-layers (3, nz_arr*mc, mc, cap) and walk the first nz_grid
// of them, nz_grid < nz_arr: the partner layer is z + dz itself, with no wrap
// and no z image shift (the caller has moved the z of a layer that lies across
// the box's face). x and y wrap as in the cube. The cube is ZWRAP = true with
// nz_grid = nz_arr = mc.
//
// r2 is computed with explicit round-to-nearest multiplies and adds in the
// association (dx*dx + dy*dy) + dz*dz. The compiler would otherwise contract
// the sum into fused multiply-adds, and a pair within one ulp of the cutoff
// would then differ from the plain PyTorch version, which rounds each step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mdnl {

// Shared memory a block may take after the opt-in (`fit_shared`).
constexpr size_t kMaxShared = 227 * 1024;
// Shared memory the list, half-count, full-force and full-count kernels plan
// a block for: half of it, so that two blocks share an SM at any cap (past it
// they stage their partners in passes; cap 40 needs 10 to 20 KB).
constexpr size_t kPassShared = kMaxShared / 2;

// Allow `kernel` the dynamic shared memory `bytes`: above 48 KB a block may
// take it only after this opt-in, up to 227 KB (beyond, the call fails and
// the launch is not made).
template <typename Kernel>
inline cudaError_t fit_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct CellId {
  int z, y, x, row, cell;
};

__device__ __forceinline__ CellId cell_of_block(int cell, int mc) {
  CellId c;
  c.cell = cell;
  c.x = cell % mc;
  c.row = cell / mc;
  c.y = c.row % mc;
  c.z = c.row / mc;
  return c;
}

// HALF_OFFSETS5 = (0,0), (0,1), (1,-1), (1,0), (1,1)
__device__ __forceinline__ void half_offset(int k, int& dz, int& dy) {
  dz = k >= 2 ? 1 : 0;
  dy = k == 0 ? 0 : (k == 1 ? 1 : k - 3);
}

// Cell index c + d along one axis, wrapped into [0, mc); returns the image
// shift (-L, 0 or +L) that goes with the wrap.
__device__ __forceinline__ float wrap_cell(int& c, int mc, float L) {
  if (c >= mc) { c -= mc; return L; }
  if (c < 0) { c += mc; return -L; }
  return 0.f;
}

// Flat slot index (cell * cap + slot, in the (R, mc, cap) arrays) of window
// lane l of neighbour row (dz, dy), and the image shift (xs, ys, zs) to add
// to its position. ZWRAP = false: layer z + dz as it is (slab forms).
template <bool ZWRAP = true>
__device__ __forceinline__ int partner_slot(int mc, int cap, float L,
                                            const CellId& c, int dz, int dy,
                                            int l, float& xs, float& ys,
                                            float& zs) {
  int zz = c.z + dz, yy = c.y + dy;
  const int seg = l / cap;
  int xx = c.x + seg - 1;
  zs = ZWRAP ? wrap_cell(zz, mc, L) : 0.f;
  ys = wrap_cell(yy, mc, L);
  xs = wrap_cell(xx, mc, L);
  return ((zz * mc + yy) * mc + xx) * cap + (l - seg * cap);
}

// Slots of the state array a half-sweep kernel reads: the cube's mc layers,
// or a slab form's nz_arr.
template <bool ZWRAP>
__device__ __forceinline__ size_t state_slots(int mc, int cap, int nz_arr) {
  return (size_t)(ZWRAP ? mc : nz_arr) * mc * mc * cap;
}

__device__ __forceinline__ float pair_r2(float xi, float yi, float zi,
                                         float xj, float yj, float zj,
                                         float& dx, float& dy, float& dz) {
  dx = __fsub_rn(xi, xj);
  dy = __fsub_rn(yi, yj);
  dz = __fsub_rn(zi, zj);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace mdnl
