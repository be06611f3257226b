// K6 full force: Lennard-Jones forces at the cutoff rc over all 27 neighbour
// cells, every pair evaluated at both partners and no reaction, with the
// per-slot shifted potential when asked (counted at both partners: total
// PE = 0.5 * sum over valid slots).
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_force_kernel (with the
// window array and the (mc, mc, 3) k-revisited grid around it: here a block
// reads the (3, R, mc, cap) state and `valid` directly and applies the image
// shifts itself). A slot is present when its `valid` byte is not 0, wherever
// it sits in its cell: slots with valid == 0 receive exactly zero and act on
// nobody, whatever position they hold.
//
// One block of kFullThreads threads per own cell:
//
//  1. Staging. The block compacts its own cell's valid slots into shared
//     memory, each as (x, y, z, slot), and the valid slots of the nine rows
//     of three cells around it into one partner list, each image-shifted and
//     tagged with its slot in the own cell (-1 in every other cell), so that
//     an own slot leaves out itself by slot identity, not by r2 == 0. Past
//     the shared memory of one block the list is staged in passes.
//  2. The walk. The work is (own slot, partner chunk) units: with `no` valid
//     own slots, the partner list is cut into G = blockDim / no contiguous
//     chunks (one, and own slots t, t + blockDim, ..., when no exceeds the
//     block), and thread t takes unit t: own slot t % no against chunk
//     t / no, its position and sums in registers, one shared partner load
//     (a broadcast to the lanes of one chunk) per test (two or four own
//     slots a thread, to share that load, ran no faster). The pair term is
//     branch-free: a non-hit's 1/r2 is replaced by 0, and 1/r2 is
//     `rcp_rn` (correctly rounded, as the division it replaces).
//  3. Each unit's sums go to shared memory, and the block adds a slot's
//     chunks in chunk order. Every sum has a fixed order and stays inside
//     the block: no atomics, and the result is bitwise the same from run to
//     run — the deterministic yardstick for the half-force kernel, whose
//     atomics are not. Against the plain version, which sums in another
//     order, it agrees to rounding.
//
// One body serves every cap: the host sizes the partner passes so that the
// shared memory fits (`force_full_plan`). It replaces the first kernel's two
// (a thread per (z-group, own slot) testing every staged lane, valid or not,
// with a divergent pair term, and a lane-strided form above cap 341).
//
// On an NVIDIA H100 80GB HBM3 at 700 W, N = 1M, cap = 40 (PERF.md): the
// branch-free term with `rcp_rn` ran 10 % faster than the same body with the
// term behind a branch and __fdiv_rn; staging through a table of the 27
// cells (no integer division a lane) 9 % faster than computing each lane's
// cell. The walk is about 70 % of the time, the staging the rest.
//
// Bound: operations (the distance tests between valid slots, 9 flops each,
// plus about 13 per hit) against 13 bytes read and 12 or 16 written per slot.
//
// K7 full count (entry mdnl_count_full, kind kFullCount) is this body with an
// integer count in place of the force: it replaces md_neighbor_list_tpu/ops/
// pallas_force.py::_count_kernel (with its window array and grid, as above)
// and returns counts (R, mc, cap) i32, every pair counted at both partners
// (pair count = sum / 2), exact. The staging and the units are the force's;
// a unit adds r2 < r2cut into an int, with no reciprocal, no pair term and
// no tag test: the self pair is counted too, and step 4 takes it off once
// per own slot, by the same test of the slot against itself. That is exact
// for any position: a valid own slot is staged once among its partners, at
// its own position (shift 0), so the walk meets it once at that r2 (0 when
// finite). Two distinct particles at r2 = 0 count at both partners. Invalid
// own slots get their 0 at staging. Bound: the distance tests against 13
// bytes read and 4 written per slot.
//
// On an NVIDIA H100 80GB HBM3 at 700 W, N = 1M, cap = 40 (PERF.md): leaving
// the tag test out of the walk made K7 3 % faster, and the launch bound of
// at least 10 blocks an SM (48 registers) 3 % more; the staging is about
// half of its time.
#include "half_sweep.cuh"

namespace mdnl {

// What a full-sweep block sums: forces, forces and PE, or counts (K7).
enum FullKind { kFullForce = 0, kFullForcePe = 1, kFullCount = 2 };

constexpr int kFullThreads = 128;
constexpr int kFullRowsLanes = 27;  // window lanes of the nine rows, per cap
// Window lanes a thread stages per prefix count: 9 * 128 covers the 1,080
// lanes of cap 40 in one round; it ran 2-5 % faster than half_sweep.cuh's 5
// (PERF.md).
constexpr int kFullStageItems = 9;
// Blocks an SM should hold at once, K7 only: at 10 its 48 registers spill 24
// bytes and it ran 3 % faster than with K6's bound alone (64 registers); 12
// (40 registers, 128 bytes spilled) ran no faster than none (PERF.md).
constexpr int kFullCountMinBlocks = 10;

// Shared memory of one block: own slots, the units' sums (K7's counts are
// ints in their first quarter) and `pass_len` staged partners, all float4.
__host__ __device__ inline int full_units(int cap) {
  return cap > kFullThreads ? cap : kFullThreads;
}

__host__ __device__ inline size_t force_full_shared(int cap, int pass_len) {
  return ((size_t)cap + full_units(cap) + pass_len) * 16;
}

// The partner pass length for `cap`: all 27*cap window lanes where the
// shared memory allows, else the most that fit, within kPassShared where that
// leaves room and kMaxShared beyond.
inline bool force_full_plan(int cap, int& pass_len) {
  for (const size_t budget : {kPassShared, kMaxShared}) {
    const size_t limit = budget - 256;  // the static shared words
    const size_t fixed = force_full_shared(cap, 0);
    if (fixed >= limit) continue;
    const size_t room = (limit - fixed) / 16 / 32 * 32;
    pass_len = (int)(room < (size_t)kFullRowsLanes * cap
                         ? room : (size_t)kFullRowsLanes * cap);
    if (pass_len >= 32) return true;
  }
  return false;
}

template <int KIND>
__device__ __forceinline__ void full_sweep(
    const float* __restrict__ pos, const unsigned char* __restrict__ valid,
    float* __restrict__ force, float* __restrict__ pe,
    int* __restrict__ counts, int mc, int cap, float L, float r2cut,
    float ushift, int pass_len) {
  constexpr bool WANT_PE = KIND == kFullForcePe;
  constexpr bool COUNT = KIND == kFullCount;
  extern __shared__ float4 smem4[];
  __shared__ int warp_sums[32];
  // the 27 cells around: first slot, and the image shift
  __shared__ int cell_slot0[kFullRowsLanes];
  __shared__ float4 cell_shift[kFullRowsLanes];
  float4* own = smem4;                 // [cap]
  float4* acc = own + cap;             // [full_units(cap)]
  int* acc_n = (int*)acc;              // COUNT: [full_units(cap)]
  float4* part = acc + full_units(cap);  // [pass_len]
  const int T = blockDim.x;
  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const size_t own0 = (size_t)c.cell * cap;

  // cell pc = 3*r + seg holds window lanes [pc*cap, (pc+1)*cap) of the nine
  // rows, row r = 3*(dz+1) + dy+1; the own cell is pc = 13
  if (threadIdx.x < kFullRowsLanes) {
    const int pc = threadIdx.x, r = pc / 3, seg = pc - 3 * r;
    float xs, ys, zs;
    cell_slot0[pc] = partner_slot(mc, cap, L, c, r / 3 - 1, r % 3 - 1,
                                  seg * cap, xs, ys, zs);
    cell_shift[pc] = make_float4(xs, ys, zs, 0.f);
  }
  const float inv_cap = 1.0f / cap;

  // 1. the own cell's valid slots; invalid ones get their zeros here
  int no = 0;
  for (int base = 0; base < cap; base += T) {
    const int i = base + threadIdx.x;
    float x = 0.f, y = 0.f, z = 0.f;
    bool occ = false;
    if (i < cap) {
      x = pos[own0 + i];
      y = pos[S + own0 + i];
      z = pos[2 * S + own0 + i];
      occ = valid[own0 + i] != 0;
      if (COUNT && !occ) counts[own0 + i] = 0;
      if (!COUNT && !occ) {
        force[own0 + i] = 0.f;
        force[S + own0 + i] = 0.f;
        force[2 * S + own0 + i] = 0.f;
        if (WANT_PE) pe[own0 + i] = 0.f;
      }
    }
    int before;
    const int total = block_prefix(occ ? 1 : 0, before, warp_sums);
    if (occ) own[no + before] = make_float4(x, y, z, __int_as_float(i));
    no += total;
  }
  if (no == 0) return;  // block-uniform: outputs written

  // the units: G chunks of the partner list for each own slot
  const int G = no < T ? T / no : 1;
  const int units = G * no;
  const int lanes = kFullRowsLanes * cap;
  for (int v0 = 0; v0 < lanes; v0 += pass_len) {
    const int v1 = v0 + pass_len < lanes ? v0 + pass_len : lanes;
    // 2. the valid partners of window lanes [v0, v1) of the nine rows,
    //    kFullStageItems lanes a thread per prefix count
    int n = 0;
    for (int base = v0; base < v1; base += kFullStageItems * T) {
      float4 e[kFullStageItems];
      bool occ[kFullStageItems];
      int cnt = 0;
#pragma unroll
      for (int it = 0; it < kFullStageItems; ++it) {
        const int v = base + it * T + threadIdx.x;
        occ[it] = false;
        e[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v < v1) {
          int slot;
          const int pc = div_rem(v, cap, inv_cap, slot);
          const float4 sh = cell_shift[pc];
          const int idx = cell_slot0[pc] + slot;
          const float x = pos[idx], y = pos[S + idx], z = pos[2 * S + idx];
          occ[it] = valid[idx] != 0;
          // the own cell's slots carry their slot: no self pair
          const int tag = pc == 13 ? slot : -1;
          e[it] = make_float4(__fadd_rn(x, sh.x), __fadd_rn(y, sh.y),
                              __fadd_rn(z, sh.z), __int_as_float(tag));
        }
        cnt += occ[it] ? 1 : 0;
      }
      int at;
      const int total = block_prefix(cnt, at, warp_sums);
      at += n;
#pragma unroll
      for (int it = 0; it < kFullStageItems; ++it)
        if (occ[it]) part[at++] = e[it];
      n += total;
    }
    __syncthreads();

    // 3. the walk: unit u is own entry u % no against chunk u / no
    for (int u = threadIdx.x; u < units; u += T) {
      const int g = u / no;
      const float4 o = own[u - g * no];
      const int slot = __float_as_int(o.w);
      const int j0 = (int)((long long)g * n / G);
      const int j1 = (int)((long long)(g + 1) * n / G);
      if constexpr (COUNT) {  // the self pair too: taken off in step 4
        int hits = v0 == 0 ? 0 : acc_n[u];
        for (int j = j0; j < j1; ++j) {
          const float4 p = part[j];
          float dx, dy, dz;
          const float r2 = pair_r2(o.x, o.y, o.z, p.x, p.y, p.z, dx, dy, dz);
          hits += r2 < r2cut ? 1 : 0;
        }
        acc_n[u] = hits;
        continue;
      }
      float4 a = v0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : acc[u];
      for (int j = j0; j < j1; ++j) {
        const float4 p = part[j];
        float dx, dy, dz;
        const float r2 = pair_r2(o.x, o.y, o.z, p.x, p.y, p.z, dx, dy, dz);
        const bool hit = r2 < r2cut && __float_as_int(p.w) != slot;
        // a non-hit gets s2 = s6 = 0, so its force is 0
        const float s2 = hit ? rcp_rn(r2) : 0.f;
        const float s6 = s2 * s2 * s2;
        const float f = 24.0f * s6 * (2.0f * s6 - 1.0f) * s2;
        a.x += f * dx;
        a.y += f * dy;
        a.z += f * dz;
        if (WANT_PE) a.w += hit ? 4.0f * (s6 * s6 - s6) - ushift : 0.f;
      }
      acc[u] = a;
    }
    __syncthreads();  // the partner list is staged anew by the next pass
  }

  // 4. each own slot's sums: its chunks in chunk order
  for (int i = threadIdx.x; i < no; i += T) {
    const size_t o = own0 + __float_as_int(own[i].w);
    if constexpr (COUNT) {
      // the self pair, counted by the walk where it passes the test
      const float4 q = own[i];
      float dx, dy, dz;
      const float r2 = pair_r2(q.x, q.y, q.z, q.x, q.y, q.z, dx, dy, dz);
      int t = r2 < r2cut ? -1 : 0;
      for (int g = 0; g < G; ++g) t += acc_n[g * no + i];
      counts[o] = t;
      continue;
    }
    float4 t = acc[i];
    for (int g = 1; g < G; ++g) {
      const float4 a = acc[g * no + i];
      t.x += a.x; t.y += a.y; t.z += a.z; t.w += a.w;
    }
    force[o] = t.x;
    force[S + o] = t.y;
    force[2 * S + o] = t.z;
    if (WANT_PE) pe[o] = t.w;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kFullThreads)
force_full_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ force, float* __restrict__ pe,
                  int* __restrict__ counts, int mc, int cap, float L,
                  float r2cut, float ushift, int pass_len) {
  full_sweep<KIND>(pos, valid, force, pe, counts, mc, cap, L, r2cut, ushift,
                   pass_len);
}

__global__ void __launch_bounds__(kFullThreads, kFullCountMinBlocks)
count_full_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ force, float* __restrict__ pe,
                  int* __restrict__ counts, int mc, int cap, float L,
                  float r2cut, float ushift, int pass_len) {
  full_sweep<kFullCount>(pos, valid, force, pe, counts, mc, cap, L, r2cut,
                         ushift, pass_len);
}

// The kernel of one kind: K7 has its own launch bound.
template <int KIND>
constexpr auto full_kernel() {
  if constexpr (KIND == kFullCount) return count_full_kernel;
  else return force_full_kernel<KIND>;
}

}  // namespace mdnl

namespace {

template <int KIND>
int launch_force_full(const void* pos, const void* valid, void* force,
                      void* pe, void* counts, int mc, int cap, float L,
                      float r2cut, float ushift, void* stream) {
  using namespace mdnl;
  int pass_len;
  if (cap < 1 || !force_full_plan(cap, pass_len))
    return (int)cudaErrorInvalidValue;
  const size_t smem = force_full_shared(cap, pass_len);
  const auto kernel = full_kernel<KIND>();
  const cudaError_t err = fit_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<mc * mc * mc, kFullThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const unsigned char*)valid, (float*)force,
      (float*)pe, (int*)counts, mc, cap, L, r2cut, ushift, pass_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdnl_force_full(const void* pos, const void* valid, void* force,
                               int mc, int cap, float L, float r2cut,
                               void* stream) {
  return launch_force_full<mdnl::kFullForce>(pos, valid, force, nullptr,
                                             nullptr, mc, cap, L, r2cut, 0.f,
                                             stream);
}

extern "C" int mdnl_force_full_pe(const void* pos, const void* valid,
                                  void* force, void* pe, int mc, int cap,
                                  float L, float r2cut, float ushift,
                                  void* stream) {
  return launch_force_full<mdnl::kFullForcePe>(pos, valid, force, pe, nullptr,
                                               mc, cap, L, r2cut, ushift,
                                               stream);
}

// K7: pos, valid -> counts (R, mc, cap) i32.
extern "C" int mdnl_count_full(const void* pos, const void* valid,
                               void* counts, int mc, int cap, float L,
                               float r2cut, void* stream) {
  return launch_force_full<mdnl::kFullCount>(pos, valid, nullptr, nullptr,
                                             counts, mc, cap, L, r2cut, 0.f,
                                             stream);
}
