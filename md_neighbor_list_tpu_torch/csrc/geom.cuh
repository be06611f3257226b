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

// Slots per cell up to which a block of the count kernels (K5, K7) has one
// thread per window lane, 3*cap <= 1024 threads. Above it each of them
// launches its lane-strided form: blocks of kStridedThreads threads, each
// serving window lanes (or own slots) t, t + blockDim, ..., so any cap runs
// whose shared memory fits a block (`fit_shared`, 227 KB): the half-count
// kernel takes the most, 76 bytes a slot, so it runs up to 3,058 slots per
// cell (the full count up to 3,632). The list, half-force, pe/virial and
// full-force kernels (K2, K3, K4, K6) have one body for every cap that
// stages occupied slots only, in passes where the shared memory is short.
constexpr int kLaneCap = 341;
constexpr int kStridedThreads = 512;
// Shared memory a block may take after the opt-in (`fit_shared`).
constexpr size_t kMaxShared = 227 * 1024;
// Shared memory the list and full-force kernels plan a block for: half of
// it, so that two blocks share an SM at any cap (past it they stage their
// partners in passes; cap 40 needs 12 and 20 KB).
constexpr size_t kPassShared = kMaxShared / 2;
// Blocks of up to 1024 threads need a launch bound (64 registers a thread).
// The full-count kernel carries it at every cap. The half-count
// kernel (K5) is compiled in two forms over one body: for cap <= kNarrowCap
// (blocks of at most 384 threads) with no bound, so registers are
// unconstrained, and a `_wide` form with the bound for the caps above,
// because under the bound it ran 18 % slower at N = 1M, cap = 40 (NVIDIA
// H100 80GB HBM3 at 700 W, by tools/port_ab.py).
constexpr int kNarrowCap = 128;
#ifndef MDNL_NARROW_BOUND  // -DMDNL_NARROW_BOUND=<threads> bounds the narrow
#define MDNL_NARROW        // form too: the measurement behind the split
#else
#define MDNL_NARROW __launch_bounds__(MDNL_NARROW_BOUND)
#endif
#define MDNL_BLOCK_BOUND __launch_bounds__(1024)
#define MDNL_STRIDED_BOUND __launch_bounds__(kStridedThreads)

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

// Load the image-shifted position of window lane l of neighbour row (dz, dy);
// returns the partner's flat slot index.
template <bool ZWRAP = true>
__device__ __forceinline__ int load_partner_at(const float* __restrict__ pos,
                                               size_t S, int mc, int cap,
                                               float L, const CellId& c,
                                               int dz, int dy, int l,
                                               float& xj, float& yj,
                                               float& zj) {
  float xs, ys, zs;
  const int idx = partner_slot<ZWRAP>(mc, cap, L, c, dz, dy, l, xs, ys, zs);
  xj = __fadd_rn(pos[idx], xs);
  yj = __fadd_rn(pos[S + idx], ys);
  zj = __fadd_rn(pos[2 * S + idx], zs);
  return idx;
}

// The same for half offset row k.
template <bool ZWRAP = true>
__device__ __forceinline__ int load_partner(const float* __restrict__ pos,
                                            size_t S, int mc, int cap, float L,
                                            const CellId& c, int k, int l,
                                            float& xj, float& yj, float& zj) {
  int dz, dy;
  half_offset(k, dz, dy);
  return load_partner_at<ZWRAP>(pos, S, mc, cap, L, c, dz, dy, l, xj, yj, zj);
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

// Newton-3 dedup inside the own row (k == 0): the dx = -1 segment is left to
// the neighbour cell's sweep, and in the own cell only slot j > i is kept.
__device__ __forceinline__ bool half_keep(int k, int l, int i, int cap) {
  return k != 0 || l >= 2 * cap || (l >= cap && l - cap > i);
}

// Stage the own cell's positions: sx/sy/sz each hold cap floats.
__device__ __forceinline__ void load_own(const float* __restrict__ pos,
                                         size_t S, int cap, int cell,
                                         float* sx, float* sy, float* sz) {
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const size_t g = (size_t)cell * cap + i;
    sx[i] = pos[g];
    sy[i] = pos[S + g];
    sz[i] = pos[2 * S + g];
  }
}

// ---- full 27-cell sweep of the full-count kernel (K7) ---------------------
// One block per own cell, 3*cap threads: thread t serves own slot t % cap in
// z-group g = t / cap, which sweeps the three rows (dz = g - 1, dy = -1, 0, 1)
// lane by lane in a fixed order. A slot whose `valid` byte is 0 is absent on
// both sides: as a partner it is staged at +infinity (r2 = inf passes no
// cutoff and makes no NaN against a finite own position), as an own slot its
// thread sweeps nothing and its outputs are zero.

// Stage, for one dy, the windows of rows (dz = -1, 0, 1; dy): sx/sy/sz hold
// [3][3*cap] floats, group g's window at offset g * 3*cap.
__device__ __forceinline__ void stage_rows_full(
    const float* __restrict__ pos, const unsigned char* __restrict__ valid,
    size_t S, int mc, int cap, float L, const CellId& c, int dy, float* sx,
    float* sy, float* sz) {
  const int W = 3 * cap;
  for (int e = threadIdx.x; e < 3 * W; e += blockDim.x) {
    const int g = e / W;
    float xj, yj, zj;
    const int idx =
        load_partner_at(pos, S, mc, cap, L, c, g - 1, dy, e - g * W, xj, yj, zj);
    sx[e] = valid[idx] ? xj : __int_as_float(0x7f800000);
    sy[e] = yj;
    sz[e] = zj;
  }
}

// Stage one row (dz, dy) of the full sweep: sx/sy/sz hold 3*cap floats. The
// lane-strided full-count kernel stages the nine rows one at a time.
__device__ __forceinline__ void stage_row_full(
    const float* __restrict__ pos, const unsigned char* __restrict__ valid,
    size_t S, int mc, int cap, float L, const CellId& c, int dz, int dy,
    float* sx, float* sy, float* sz) {
  for (int l = threadIdx.x; l < 3 * cap; l += blockDim.x) {
    float xj, yj, zj;
    const int idx = load_partner_at(pos, S, mc, cap, L, c, dz, dy, l, xj, yj, zj);
    sx[l] = valid[idx] ? xj : __int_as_float(0x7f800000);
    sy[l] = yj;
    sz[l] = zj;
  }
}

// The window lane that is own slot i itself: lane cap + i of the centre row
// (dz = 0, dy = 0) and no lane of any other row.
__device__ __forceinline__ int self_lane(int g, int dy, int i, int cap) {
  return (g == 1 && dy == 0) ? cap + i : -1;
}

__host__ __device__ inline int round_up32(int n) { return (n + 31) / 32 * 32; }

}  // namespace mdnl
