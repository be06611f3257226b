// K3 on the half list: the NVE step's Newton-3 Lennard-Jones forces at the
// cutoff rc over the pairs of the half list at rs = rc + skin that the last
// rebuild built (list_sparse.cu builds it).
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_force_half_kernel as
// the JAX engine's step launches it (the cube form without PE). The cell
// sweep (force_half.cu, half_sweep.cuh) stays for every caller that holds no
// fresh list.
//
// THE PAIR SET. The list holds the pairs within rs of the state of the last
// rebuild that K2 (lists_half.cu) would find in the ten sparse cells: own
// slot i of cell c has window lane v when K2 would set bit i of its mask
// word at v (the same test, list_sparse.cu). Between rebuilds the slots and the image
// shifts stay those of that rebuild (positions drift unwrapped), and the
// step rebuilds before any particle has moved more than skin/2 from where
// it was then (the vote 4 * max|d|^2 > skin^2). So a pair within rc now was
// within rc + 2 * skin/2 = rs then, and is in the list: the list's pairs
// within rc are the sweep's pairs. Only a pair within a few ulps of a cutoff
// can fall differently, as between any two sweeps that round r2 step by step
// (ROADMAP C.1). Every pair is evaluated exactly as the sweep does it (the
// partner's image shift added by __fadd_rn, r2 rounded step by step, 1/r2
// correctly rounded by rcp_rn, float32 throughout); the sums run in another
// order.
//
// The list's layout (per flat slot cell * cap + i of the (R, mc, cap)
// arrays): nsparse, how many of the slot's partners lie in the ten sparse
// cells (below); start, the first entry of those partners (an exclusive
// prefix sum of nsparse, clipped at the capacity); lanes, those partners
// from the slot's start on, int16 window lanes v in [0, 14 * cap) in the
// numbering of half_sweep.cuh::half_row_lane (the own row's cells x and
// x+1, then cells x-1, x, x+1 of rows 1-4: partner cell pc = v / cap, slot
// v % cap), in lane order. So a cell's entries are one contiguous range,
// and the list holds the sparse cells' pairs only (29 % of them). The four
// dense cells' pairs are not stored: the force sweeps those cells. Nothing
// is dropped silently: a list that would pass its capacity raises the
// carry's sticky overflow flag (ops/dense_force.py::build_half_list), which
// rolls the chunk back and grows the cells.
//
// WHAT BOUNDS IT, AND THE DESIGN (PERF.md, section 6: each step measured on
// an NVIDIA H100 80GB HBM3 at 700 W, N = 1M, cap 40). In the liquid K2
// finds 44.4M pairs within rs, 32.9M within rc; the sweep tests 317M slot
// pairs. A listed pair costs more than a tested one: its partner is
// gathered by index and its reaction scattered to the partner's slot,
// where the sweep keeps 4 partners a lane in registers against a broadcast
// own slot. A warp per own slot over all 14 cells' entries took 0.58 ms,
// its per-pair global atomics alone 0.28 and the staging 0.16;
// warp-private shared copies of the window's reactions (no atomic in the
// block) 0.70, one shared copy with shared atomics 0.74. So the
// work is split by where the pairs lie. The own cell and its three face
// neighbours (x+1 of the own row, x of rows 1 and 3: pc 0, 1, 3, 9) hold
// 71 % of the pairs within rs (76 % within rc), about 40 % of their slot
// pairs: there the block sweeps, as half_sweep.cuh does, over those four
// cells only. The ten edge and corner cells hold 29 % of the pairs, under
// 10 % of their slot pairs: there the block walks the list.
//
// What bounds the kernel is how many blocks an SM holds and what each
// block's threads spill and store, not the latency of its global loads.
// It runs 12 blocks an SM at 40 registers a thread: 8 blocks of
// 64 registers ran 7 % slower, and every byte of shared memory or spilled
// register a block adds costs time. Measured against the 0.44 ms of the
// form before (H100, c4, by CUDA events):
//  - a persistent kernel, a resident block a run of cells with each cell's
//    whole window staged in a ring of two stages by asynchronous copies
//    (bulk copies on an mbarrier, or cp.async), ran 0.54-0.63 ms: the ring
//    took the SM from 12 blocks to 8, and one static run a block (the old
//    kernel's body looped over runs) ran 9 % slower on its own, SMs idle
//    while the slowest runs ended; prefetching the next cell of a run into
//    L1 ran 10-14 % slower, staging it in shared memory by cp.async 20 %;
//  - without the dense walk's store of the own-slot sums it ran 12 %
//    faster, without the sparse walk's reactions 7 %;
//  - one sparse round read ahead (kPre) instead of four, two staging items
//    a thread instead of five and 2 KB of staged list entries a block
//    instead of 8 took the spills from 92 bytes to 4 and the kernel from
//    0.442 to 0.384 ms (0.935 to 0.787 at lammps_lj).
//
// The force (force_half_kernel<kForce, true>, K3's trace name): one block
// of 32*W threads per own cell.
//  1. Staging (half_sweep.cuh's): the own cell's occupied slots compacted
//     in slot order with every slot's start and listed count, then the
//     cell's list entries (one contiguous range, 16-byte loads) and the
//     occupied slots of the four dense cells, image-shifted, with the own
//     cell's keep bound (j > i).
//  2. The dense walk: half_sweep.cuh's, partners along the lanes (one a
//     lane, reactions in registers), own-slot sums in warp-private shared
//     copies walked with a stagger; no atomic inside the block.
//  3. The sparse walk: a warp takes four own slots at a time, 8 lanes each,
//     over the slots' listed partners; a lane loads its partners from
//     global memory (the first of each of kPre rounds before the walk;
//     their cells' slots are read by the neighbouring blocks too, through
//     L1) and image-shifts them; a
//     partner's reaction goes out by one global f32 atomicAdd per component
//     where the pair is within rc; the own sum is reduced over the 8 lanes
//     by shuffles.
//  4. Out of the block: the dense partners' reactions by one atomicAdd per
//     component and partner (after the dense walk), the own-slot sums
//     folded in a fixed order and added by atomicAdd (neighbouring blocks
//     add there too). The caller zeroes `force`; a parked slot is never
//     staged nor listed and gets exactly zero. The order of the atomics
//     varies from run to run, so the forces agree with the plain version to
//     rounding, not bitwise.
//
#include "half_sweep.cuh"

namespace mdnl {

// Window lanes a thread loads per round of the dense cells' staging: 2 x
// 128 covers the 160 lanes of cap 40; 5 (half_sweep.cuh's) spilled and ran
// 3-4 % slower (PERF.md).
constexpr int kListItems = 2;
// Lanes the sparse walk gives one own slot (four own slots a warp): 16
// ran 11 % and 32 13 % slower (PERF.md).
constexpr int kSparseLanes = 8;
constexpr int kSlotsWarp = 32 / kSparseLanes;
// Partner columns a warp takes at a time in the dense walk: with 1 the
// dense cells' three columns or so spread over three warps; 2 and 4
// (half_sweep.cuh's) ran 1.5-20 % slower (PERF.md).
constexpr int kDenseB = 1;
// Own-slot rounds of the sparse walk whose first partners a lane loads at
// once: 2 and 4 kept more registers live across the walk (2.7 and 5 %
// slower, PERF.md).
constexpr int kPre = 1;
// Blocks an SM should hold: the bound caps a thread at 40 registers (4
// bytes spill); without it the kernel took 0.59 ms against 0.51 (PERF.md).
constexpr int kListMinBlocks = 12;
// List entries of one cell staged in shared memory (2 KB): about 300 a cell
// at cap 40 in the liquid, 515 at most; a longer cell reads the rest from
// global memory. 8 KB ran 2 % slower: the shared memory the 12 blocks of an
// SM take is not L1 for the sparse walk's gathers.
constexpr int kListStage = 1024;

// Shared memory of one force block: half_sweep.cuh's, with the four dense
// cells' lanes as its partners.
__host__ __device__ inline size_t list_force_shared(int cap, int warps) {
  return half_sweep_shared(cap, warps, kDenseCells * cap) + (size_t)cap * 8 +
         16 + (size_t)kListStage * 2 + (size_t)cap * 16;
}

// The block's warps for `cap`: kHalfWarps where the shared memory allows,
// else fewer (the dense partners are staged in one pass). Returns false if
// not even one warp fits.
inline bool list_force_plan(int cap, int& warps) {
  const size_t limit = kMaxShared - 512;  // the static shared words
  for (warps = kHalfWarps; warps >= 1; warps /= 2)
    if (list_force_shared(cap, warps) <= limit) return true;
  return false;
}

template <int KIND, bool ZWRAP>
__global__ void __launch_bounds__(32 * kHalfWarps, kListMinBlocks)
force_half_kernel(const float* __restrict__ pos,
                  const int* __restrict__ start,
                  const int* __restrict__ nsparse,
                  const short* __restrict__ lanes, float* __restrict__ force,
                  int mc, int cap, float L, float r2cut, float occupied_below,
                  int capacity) {
  static_assert(KIND == kForce && ZWRAP,
                "the list-driven K3 is the cube form without PE");
  extern __shared__ float4 smem4[];
  __shared__ int warp_sums[32];
  __shared__ int4 cell_i[kHalfRowsLanes];
  __shared__ float4 cell_shift[kHalfRowsLanes];
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int acc_len = half_acc_len(cap);
  const int dense = kDenseCells * cap;
  float4* own = smem4;                       // [cap]
  float4* acc = own + cap;                   // [W][acc_len]
  float4* part = acc + (size_t)W * acc_len;  // [4cap]
  int* part_slot = (int*)(part + dense);     // [4cap]
  int* own_start = part_slot + dense;        // [cap], by slot
  int* own_nsp = own_start + cap;            // [cap], by slot
  int4* ent4 = (int4*)(own_nsp + cap + ((-2 * cap) & 3));  // 16-byte aligned
  const short* ent = (const short*)ent4;     // [kListStage]
  float4* own_sp = (float4*)(ent4 + kListStage / 8);  // [cap]

  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t S = (size_t)mc * mc * mc * cap;
  const size_t own0 = (size_t)c.cell * cap;
  window_table(mc, cap, L, c, cell_i, cell_shift);
  for (int e = threadIdx.x; e < W * acc_len; e += blockDim.x)
    acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // 1. the own cell's occupied slots, in slot order, and every slot's
  //    sparse entries
  int no = 0;
  for (int base = 0; base < cap; base += blockDim.x) {
    const int i = base + threadIdx.x;
    float x = 0.f, y = 0.f, z = 0.f;
    if (i < cap) {
      x = pos[own0 + i];
      y = pos[S + own0 + i];
      z = pos[2 * S + own0 + i];
      const int s = start[own0 + i];
      own_start[i] = s;
      own_nsp[i] = min(nsparse[own0 + i], capacity - s);  // the stored ones
    }
    const bool occ = i < cap && x < occupied_below;
    int before;
    const int total = block_prefix(occ ? 1 : 0, before, warp_sums);
    if (occ) own[no + before] = make_float4(x, y, z, __int_as_float(i));
    no += total;
  }
  if (no == 0) return;  // block-uniform: the cell owns no pair

  //    then the cell's list entries (16-byte loads from the aligned entry
  //    below the first; the list's length is a multiple of 8), as many as
  //    kListStage holds, and the occupied slots of the four dense cells
  //    (dense cell d is window cell pack_cell(kSparseCells + d): 0, 1, 3, 9)
  const int first = own_start[0];
  const int g0 = first & ~7, skew = first - g0;
  const int staged = min(
      (skew + own_start[cap - 1] + own_nsp[cap - 1] - first + 7) & ~7,
      kListStage);
  for (int e = threadIdx.x; e < staged / 8; e += blockDim.x)
    ent4[e] = reinterpret_cast<const int4*>(lanes + g0)[e];
  const float inv_cap = 1.0f / cap;
  int n = 0;
  for (int base = 0; base < dense; base += kListItems * blockDim.x) {
    float4 e[kListItems];
    int slot_of[kListItems];
    bool occ[kListItems];
    int cnt = 0;
#pragma unroll
    for (int it = 0; it < kListItems; ++it) {
      const int d = base + it * blockDim.x + threadIdx.x;
      occ[it] = false;
      slot_of[it] = 0;
      e[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < dense) {
        int slot;
        const int pc = pack_cell(kSparseCells + div_rem(d, cap, inv_cap, slot));
        const int4 ci = cell_i[pc];
        const float4 sh = cell_shift[pc];
        const int idx = ci.x + slot;
        const float x = pos[idx], y = pos[S + idx], z = pos[2 * S + idx];
        const int bound = ci.w ? slot : 0x7fffffff;  // own cell: slot j > i
        occ[it] = x < occupied_below;
        e[it] = make_float4(__fadd_rn(x, sh.x), __fadd_rn(y, sh.y),
                            __fadd_rn(z, sh.z), __int_as_float(bound));
        slot_of[it] = idx;
      }
      cnt += occ[it] ? 1 : 0;
    }
    int at;
    const int total = block_prefix(cnt, at, warp_sums);
    at += n;
#pragma unroll
    for (int it = 0; it < kListItems; ++it)
      if (occ[it]) {
        part[at] = e[it];
        part_slot[at] = slot_of[it];
        ++at;
      }
    n += total;
  }
  __syncthreads();

  // lane groups of the stagger: p lanes a group, 32/p copies of the sums
  const int p = 1 << (31 - __clz(no < 32 ? no : 32));
  const int q = lane & (p - 1);
  float4* my_acc = acc + (size_t)w * acc_len + (lane / p) * no;

  // 2. the dense walk (half_sweep.cuh's): B columns of 32 partners per warp
  const float4 none = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
  for (int c0 = w * kDenseB; c0 * 32 < n; c0 += W * kDenseB) {
    float4 pj[kDenseB];
    float rx[kDenseB], ry[kDenseB], rz[kDenseB];
#pragma unroll
    for (int b = 0; b < kDenseB; ++b) {
      const int j = (c0 + b) * 32 + lane;
      pj[b] = j < n ? part[j] : none;  // bound -1: keeps no pair
      rx[b] = 0.f; ry[b] = 0.f; rz[b] = 0.f;
    }
    int r = q;
    for (int s = 0; s < no; ++s) {
      const float4 o = own[r];
      const int slot = __float_as_int(o.w);
      float4 a = my_acc[r];
#pragma unroll
      for (int b = 0; b < kDenseB; ++b) {
        float dx, dy, dz;
        const float r2 = pair_r2(o.x, o.y, o.z, pj[b].x, pj[b].y, pj[b].z,
                                 dx, dy, dz);
        const bool hit = slot < __float_as_int(pj[b].w) && r2 < r2cut;
        // a non-hit gets s2 = s6 = 0, so its force is 0
        const float s2 = hit ? rcp_rn(r2) : 0.f;
        const float s6 = s2 * s2 * s2;
        const float f = s6 * (48.0f * s6 - 24.0f) * s2;
        const float px = f * dx, py = f * dy, pz = f * dz;
        a.x += px; a.y += py; a.z += pz;
        rx[b] += px; ry[b] += py; rz[b] += pz;
      }
      my_acc[r] = a;
      __syncwarp();  // this add lands before the next lane reads slot r
      r = r + 1 == no ? 0 : r + 1;
    }
#pragma unroll
    for (int b = 0; b < kDenseB; ++b) {
      const int j = (c0 + b) * 32 + lane;
      if (j < n && (rx[b] != 0.f || ry[b] != 0.f || rz[b] != 0.f)) {
        const int g = part_slot[j];
        atomicAdd(&force[g], -rx[b]);
        atomicAdd(&force[S + g], -ry[b]);
        atomicAdd(&force[2 * S + g], -rz[b]);
      }
    }
  }

  // 3. the sparse walk: four own slots a warp, their listed partners along
  //    8 lanes each; the partners of kPre rounds are loaded at once
  const int h = lane / kSparseLanes, hl = lane % kSparseLanes;
  for (int base = kSlotsWarp * w; base < no; base += kSlotsWarp * W * kPre) {
    float4 pj[kPre];
    int gj[kPre];
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int r = base + k * kSlotsWarp * W + h;
      gj[k] = -1;
      pj[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < no) {
        const int slot_i = __float_as_int(own[r].w);
        if (hl < own_nsp[slot_i]) {
          const int e = own_start[slot_i] - first + hl;
          const int v = e + skew < staged ? ent[e + skew] : lanes[first + e];
          int slot;
          const int pc = div_rem(v, cap, inv_cap, slot);
          const int g = cell_i[pc].x + slot;
          const float4 sh = cell_shift[pc];
          gj[k] = g;
          pj[k] = make_float4(__fadd_rn(__ldg(pos + g), sh.x),
                              __fadd_rn(__ldg(pos + S + g), sh.y),
                              __fadd_rn(__ldg(pos + 2 * S + g), sh.z), 0.f);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int r = base + k * kSlotsWarp * W + h;
      if (base + k * kSlotsWarp * W >= no) break;  // warp-uniform
      float ax = 0.f, ay = 0.f, az = 0.f;
      if (r < no) {
        const float4 o = own[r];
        const int slot_i = __float_as_int(o.w);
        // each lane's first partner (8 a slot) was loaded above, the rest
        // here
        for (int t = hl; t < own_nsp[slot_i]; t += kSparseLanes) {
          float4 pt = pj[k];
          int g = gj[k];
          if (t != hl) {
            const int e = own_start[slot_i] - first + t;
            const int v = e + skew < staged ? ent[e + skew] : lanes[first + e];
            int slot;
            const int pc = div_rem(v, cap, inv_cap, slot);
            g = cell_i[pc].x + slot;
            const float4 sh = cell_shift[pc];
            pt = make_float4(__fadd_rn(__ldg(pos + g), sh.x),
                             __fadd_rn(__ldg(pos + S + g), sh.y),
                             __fadd_rn(__ldg(pos + 2 * S + g), sh.z), 0.f);
          }
          float dx, dy, dz;
          const float r2 =
              pair_r2(o.x, o.y, o.z, pt.x, pt.y, pt.z, dx, dy, dz);
          if (r2 < r2cut) {
            const float s2 = rcp_rn(r2);
            const float s6 = s2 * s2 * s2;
            const float f = s6 * (48.0f * s6 - 24.0f) * s2;
            const float px = f * dx, py = f * dy, pz = f * dz;
            ax += px; ay += py; az += pz;
            atomicAdd(&force[g], -px);
            atomicAdd(&force[S + g], -py);
            atomicAdd(&force[2 * S + g], -pz);
          }
        }
      }
#pragma unroll
      for (int d = kSparseLanes / 2; d >= 1; d >>= 1) {
        ax += __shfl_xor_sync(0xffffffffu, ax, d);
        ay += __shfl_xor_sync(0xffffffffu, ay, d);
        az += __shfl_xor_sync(0xffffffffu, az, d);
      }
      if (hl == 0 && r < no) own_sp[r] = make_float4(ax, ay, az, 0.f);
    }
  }
  __syncthreads();

  // 4. fold the copies of each own slot's sums in a fixed order, then the
  //    sparse walk's
  const int copies = 32 / p;
  for (int r = threadIdx.x; r < no; r += blockDim.x) {
    float4 t = own_sp[r];
    for (int v = 0; v < W; ++v)
      for (int hh = 0; hh < copies; ++hh) {
        const float4 a = acc[(size_t)v * acc_len + hh * no + r];
        t.x += a.x; t.y += a.y; t.z += a.z;
      }
    const size_t g = own0 + __float_as_int(own[r].w);
    if (t.x != 0.f || t.y != 0.f || t.z != 0.f) {
      atomicAdd(&force[g], t.x);
      atomicAdd(&force[S + g], t.y);
      atomicAdd(&force[2 * S + g], t.z);
    }
  }
}

}  // namespace mdnl

// pos (3, R, mc, cap); the list (start, nsparse, lanes); force (3, R, mc,
// cap), zeroed by the caller. occupied_below: a slot whose stored x is below
// it holds a particle (half the park base, ops/dense_cells.py::PARK_BASE).
extern "C" int mdnl_forces_list(const void* pos, const void* start,
                                const void* nsparse, const void* lanes,
                                void* force, int mc, int cap, float L,
                                float r2cut, float occupied_below,
                                int capacity, void* stream) {
  using namespace mdnl;
  int warps;
  if (cap < 1 || kHalfRowsLanes * cap > 32767 || !list_force_plan(cap, warps))
    return (int)cudaErrorInvalidValue;
  const size_t smem = list_force_shared(cap, warps);
  const auto kernel = force_half_kernel<kForce, true>;
  const cudaError_t err = fit_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<mc * mc * mc, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const int*)start, (const int*)nsparse,
      (const short*)lanes, (float*)force, mc, cap, L, r2cut, occupied_below,
      capacity);
  return (int)cudaGetLastError();
}
