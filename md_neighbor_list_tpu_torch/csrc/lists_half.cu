// K2 half-list: the neighbour-list artifact at the search radius.
//
// Replaces md_neighbor_list_tpu/ops/pallas_force.py::_list_half_kernel and
// ::_list_half_kernel_grouped (same bits; one kernel covers both). Output,
// unchanged: masks (5, words, R, mc, 3*cap) i32 where bit i of word w at
// (k, row, x, lane l) says own slot 32*w + i of cell (row, x) has window lane
// l of offset row k within the radius, and counts (R, mc, cap) i32, the
// per-slot number of set bits. Every mask word and count is written (the
// wrapper allocates them with torch.empty): words of parked lanes, of the own
// row's x-1 segment and bits of parked own slots are 0, counts of parked
// slots 0.
//
// The body follows the half sweep of half_sweep.cuh. One block of 32*W
// threads per own cell (W = 4 unless a large cap needs the shared memory):
//
//  1. Staging. The block compacts its own cell's occupied slots (stored
//     x < occupied_below; no prefix assumed) into shared memory in slot
//     order, each as (x, y, z, slot). Because the list is in slot order, the
//     occupied slots of mask word w are one contiguous range of it,
//     [wstart[w], wstart[w+1]). Then it compacts the occupied partners of the
//     14 partner cells of the five rows into one list, each with its image
//     shift, its keep bound (own slot i keeps it when i < bound: its slot in
//     the own cell, no bound elsewhere) and its row and window lane (k, l). A
//     lane that is parked writes its zero words while it is staged. Past the
//     shared memory of one block the list is staged in passes.
//  2. The walk. Partners lie along the lanes, 32 to a column, a warp taking
//     B columns at a time. For each mask word w a lane walks the own slots
//     of that word's range, every lane of the warp the same slot at the same
//     step (a shared-memory broadcast), and ORs each hit into one word
//     register per partner; then it stores the word at the partner's lane.
//     One register per partner serves any word count, with no dynamic
//     register indexing. Stores of a column run along l (compacted lanes in
//     window order) and coalesce.
//  3. Counts. At each own-slot step the warp adds its lanes' hits with one
//     `redux.sync` (__reduce_add_sync) and lane 0 adds that into the warp's
//     own row of counts in shared memory; at the end the block adds the
//     warps' rows in a fixed order. Integers, no atomics: exact.
//
// The hit test is geom.cuh's pair_r2 (each step rounded, no FMA) against
// r2cut, the partner image-shifted by the wrap (partner_slot): the same bits
// as the plain version and the TPU kernel.
//
// One body serves every cap: the host picks W and the pass length so that
// the shared memory fits (`lists_half_plan`). It replaces the first kernel's
// three (one thread per window lane testing every own slot, with a W = 11
// form above cap 128 and a lane-strided one above 341).
//
// K5 half-count (entry mdnl_count_half, MASKS = false) is this body without
// the masks: it replaces md_neighbor_list_tpu/ops/pallas_force.py::
// _count_half_kernel and returns counts (R, mc, cap) i32 only. It stages and
// walks as above, with no zero words, no partner lanes, no word ranges and
// no bit registers: every column walks the whole own list [0, no), and the
// counts are made and added as in step 3, so they are K2's counts by
// construction. Bound: the distance tests (9 flops each) against 3 floats
// read and one int written per slot.
//
// On an NVIDIA H100 80GB HBM3 at 700 W, N = 1M, cap = 40 (PERF.md): staging
// through a table of the 14 partner cells (no integer division a lane) made
// it 23 % faster than computing each lane's cell; the walk is about 40 % of
// the time, the staging and the zero words the rest, the mask stores of the
// walk under 1 %.
//
// The slab form (ZWRAP = false, entry mdnl_lists_half_slab) replaces the same
// kernels as md_neighbor_list_tpu/ops/slab_kernels.py::slab_lists_half runs
// them: the grid walks the first nz_grid layers of an array of nz_arr, and the
// masks and counts have the grid's nz_grid*mc rows.
//
// Bound: the mask write, 5*words*3 words per slot against 3 floats read; the
// distance tests between occupied slots (9 flops each) come second on this
// card.
#include "half_sweep.cuh"

namespace mdnl {

// Partners per lane in the walk (columns a warp takes at a time): with 4,
// K2 ran 2-3 % faster than with 2 and 6-8 % faster than with 1; 8 took 93
// registers and ran 35 % slower, and made the count form 30 % slower
// (PERF.md).
constexpr int kListB = 4;
constexpr int kListWarps = 4;  // warps per block, unless the cap needs fewer
// Blocks an SM should hold at once: the bound caps a thread at 48 registers
// (64 unbounded, 8 blocks), which spills a few bytes and made K2 5 % faster
// at N = 1M, cap = 40; 12 blocks (40 registers) gained less (PERF.md).
constexpr int kListMinBlocks = 10;
// The same for the count form: at 12 (40 registers, no spill) it ran 2 %
// faster than at 10 (48); 16 (32 registers, spilling) and none ran slower,
// none by 13 % (PERF.md).
constexpr int kCountMinBlocks = 12;

__host__ __device__ inline int mask_words(int cap) { return (cap + 31) / 32; }

// Shared memory of one block: own slots (float4), `pass_len` staged partners
// (float4, and with the masks their int window lane), W rows of own-slot
// counts and, with the masks, the word starts (int).
__host__ __device__ inline size_t lists_half_shared(int cap, int warps,
                                                    int pass_len, bool masks) {
  return (size_t)cap * 16 + (size_t)pass_len * (masks ? 20 : 16) +
         (size_t)warps * cap * 4 +
         (masks ? (size_t)(mask_words(cap) + 1) * 4 : 0);
}

// The block's warps and partner pass length for `cap`, as half_sweep_plan
// does it, within kPassShared where that fits and kMaxShared beyond.
inline bool lists_half_plan(int cap, bool masks, int& warps, int& pass_len) {
  const size_t per = masks ? 20 : 16;  // shared bytes a staged partner
  for (const size_t budget : {kPassShared, kMaxShared}) {
    const size_t limit = budget - 256;  // the static shared words
    for (warps = kListWarps; warps >= 1; warps /= 2) {
      const size_t fixed = lists_half_shared(cap, warps, 0, masks);
      if (fixed >= limit) continue;
      const size_t room = (limit - fixed) / per / 32 * 32;
      pass_len = (int)(room < (size_t)kHalfRowsLanes * cap
                           ? room : (size_t)kHalfRowsLanes * cap);
      if (pass_len == kHalfRowsLanes * cap || pass_len >= 32 * warps * kListB)
        return true;
    }
  }
  return false;
}

template <bool ZWRAP, bool MASKS>
__global__ void __launch_bounds__(32 * kListWarps,
                                  MASKS ? kListMinBlocks : kCountMinBlocks)
lists_half_kernel(const float* __restrict__ pos, int* __restrict__ masks,
                  int* __restrict__ counts, int mc, int cap, float L,
                  float r2cut, int nz_arr, float occupied_below,
                  int pass_len) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_sums[32];
  // the 14 partner cells: first slot, row k, first lane in the row, own cell
  __shared__ int4 cell_i[kHalfRowsLanes];
  __shared__ float4 cell_shift[kHalfRowsLanes];
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int words = mask_words(cap);
  const int win = 3 * cap;  // window lanes of one row
  float4* own = smem4;                          // [cap]
  float4* part = own + cap;                     // [pass_len]
  int* part_lane = (int*)(part + pass_len);     // masks: [pass_len], k<<24 | l
  int* wcnt = part_lane + (MASKS ? pass_len : 0);  // [W][cap], by own entry
  int* wstart = wcnt + (size_t)W * cap;         // masks: [words + 1]

  const CellId c = cell_of_block(blockIdx.x, mc);
  const size_t R = ZWRAP ? (size_t)mc * mc : (size_t)gridDim.x / mc;  // rows
  const size_t S = state_slots<ZWRAP>(mc, cap, nz_arr);
  const size_t own0 = (size_t)c.cell * cap;
  const size_t plane = R * mc * win;  // mask words of one (k, w)
  // word w of row k, window lane l: cell_masks[(k*words + w)*plane + l]
  int* cell_masks = MASKS ? masks + (size_t)c.cell * win : nullptr;

  // partner cell pc holds window lanes [pc*cap, (pc+1)*cap) of the five rows
  // taken as one list: cells x and x+1 of the own row, then x-1, x, x+1 of
  // rows 1-4 (half_row_lane's order)
  if (threadIdx.x < kHalfRowsLanes) {
    const int pc = threadIdx.x;
    const int k = pc < 2 ? 0 : 1 + (pc - 2) / 3;
    const int seg = pc < 2 ? pc + 1 : (pc - 2) % 3;
    int dz, dy;
    float xs, ys, zs;
    half_offset(k, dz, dy);
    const int slot0 =
        partner_slot<ZWRAP>(mc, cap, L, c, dz, dy, seg * cap, xs, ys, zs);
    cell_i[pc] = make_int4(slot0, k, seg * cap, pc == 0);
    cell_shift[pc] = make_float4(xs, ys, zs, 0.f);
  }
  const float inv_cap = 1.0f / cap;

  // the own row's x-1 segment is the neighbour cell's to sweep: zero words
  if constexpr (MASKS)
    for (int e = threadIdx.x; e < words * cap; e += blockDim.x) {
      const int ww = e / cap;
      cell_masks[(size_t)ww * plane + (e - ww * cap)] = 0;
    }
  for (int e = threadIdx.x; e < W * cap; e += blockDim.x) wcnt[e] = 0;

  // 1. the own cell's occupied slots, in slot order; parked own slots get
  //    their zero count here
  int no = 0;
  for (int base = 0; base < cap; base += blockDim.x) {
    const int i = base + threadIdx.x;
    float x = 0.f, y = 0.f, z = 0.f;
    if (i < cap) {
      x = pos[own0 + i];
      y = pos[S + own0 + i];
      z = pos[2 * S + own0 + i];
    }
    const bool occ = i < cap && x < occupied_below;
    if (i < cap && !occ) counts[own0 + i] = 0;
    int before;
    const int total = block_prefix(occ ? 1 : 0, before, warp_sums);
    if (occ) own[no + before] = make_float4(x, y, z, __int_as_float(i));
    no += total;
  }
  __syncthreads();
  // wstart[w]: the own list entries whose slot lies below 32*w
  if constexpr (MASKS)
    for (int ww = threadIdx.x; ww <= words; ww += blockDim.x) {
      int lo = 0, hi = no;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__float_as_int(own[mid].w) < 32 * ww) lo = mid + 1; else hi = mid;
      }
      wstart[ww] = lo;
    }

  const int lanes = kHalfRowsLanes * cap;
  for (int v0 = 0; v0 < lanes; v0 += pass_len) {
    const int v1 = v0 + pass_len < lanes ? v0 + pass_len : lanes;
    // 2. the occupied partners of window lanes [v0, v1) (all of them parked
    //    for an empty own cell); a parked lane writes its zero words
    int n = 0;
    for (int base = v0; base < v1; base += kStageItems * blockDim.x) {
      float4 e[kStageItems];
      int out[kStageItems];
      bool occ[kStageItems];
      int cnt = 0;
#pragma unroll
      for (int it = 0; it < kStageItems; ++it) {
        const int v = base + it * blockDim.x + threadIdx.x;
        occ[it] = false;
        out[it] = 0;
        e[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v < v1) {
          int slot;
          const int pc = div_rem(v, cap, inv_cap, slot);
          const int4 ci = cell_i[pc];
          const float4 sh = cell_shift[pc];
          const int idx = ci.x + slot, k = ci.y, l = ci.z + slot;
          const float x = pos[idx], y = pos[S + idx], z = pos[2 * S + idx];
          // own cell: slot j > i
          const int bound = ci.w ? slot : 0x7fffffff;
          occ[it] = no > 0 && x < occupied_below;
          e[it] = make_float4(__fadd_rn(x, sh.x), __fadd_rn(y, sh.y),
                              __fadd_rn(z, sh.z), __int_as_float(bound));
          out[it] = k << 24 | l;
          if (MASKS && !occ[it])
            for (int ww = 0; ww < words; ++ww)
              cell_masks[(size_t)(k * words + ww) * plane + l] = 0;
        }
        cnt += occ[it] ? 1 : 0;
      }
      int at;
      const int total = block_prefix(cnt, at, warp_sums);
      at += n;
#pragma unroll
      for (int it = 0; it < kStageItems; ++it)
        if (occ[it]) {
          part[at] = e[it];
          if (MASKS) part_lane[at] = out[it];
          ++at;
        }
      n += total;
    }
    __syncthreads();

    // 3. the walk: B columns of 32 partners per warp at a time, word by word
    //    (the count form: one range, the whole own list)
    const float4 none = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
    int* my_cnt = wcnt + (size_t)w * cap;
    for (int c0 = w * kListB; c0 * 32 < n; c0 += W * kListB) {
      float4 pj[kListB];
#pragma unroll
      for (int b = 0; b < kListB; ++b) {
        const int j = (c0 + b) * 32 + lane;
        pj[b] = j < n ? part[j] : none;  // bound -1: keeps no pair
      }
      for (int ww = 0; ww < (MASKS ? words : 1); ++ww) {
        uint32_t bits[kListB];
#pragma unroll
        for (int b = 0; b < kListB; ++b) bits[b] = 0u;
        const int s1 = MASKS ? wstart[ww + 1] : no;
        for (int s = MASKS ? wstart[ww] : 0; s < s1; ++s) {
          const float4 o = own[s];
          const int slot = __float_as_int(o.w);
          const uint32_t bit = 1u << (slot & 31);
          int hits = 0;
#pragma unroll
          for (int b = 0; b < kListB; ++b) {
            float dx, dy, dz;
            const float r2 = pair_r2(o.x, o.y, o.z, pj[b].x, pj[b].y, pj[b].z,
                                     dx, dy, dz);
            const bool hit = slot < __float_as_int(pj[b].w) && r2 < r2cut;
            if (MASKS) bits[b] |= hit ? bit : 0u;
            hits += hit ? 1 : 0;
          }
          const int total = __reduce_add_sync(0xffffffffu, hits);
          if (lane == 0) my_cnt[s] += total;
        }
        if constexpr (MASKS) {
#pragma unroll
          for (int b = 0; b < kListB; ++b) {
            const int j = (c0 + b) * 32 + lane;
            if (j < n) {
              const int ol = part_lane[j];
              // bit 31 is the sign bit: the same 32 bits
              cell_masks[(size_t)((ol >> 24) * words + ww) * plane +
                         (ol & 0xffffff)] = (int)bits[b];
            }
          }
        }
      }
    }
    __syncthreads();  // the partner list is staged anew by the next pass
  }

  // 4. each occupied own slot's count: the warps' rows in a fixed order
  for (int s = threadIdx.x; s < no; s += blockDim.x) {
    int total = 0;
    for (int v = 0; v < W; ++v) total += wcnt[v * cap + s];
    counts[own0 + __float_as_int(own[s].w)] = total;
  }
}

}  // namespace mdnl

namespace {

// The grid: one block per own cell of the first nz_grid layers; masks is
// not read without MASKS.
template <bool ZWRAP, bool MASKS>
int launch_lists_half(const void* pos, void* masks, void* counts, int mc,
                      int cap, float L, float r2cut, int nz_grid, int nz_arr,
                      float occupied_below, void* stream) {
  using namespace mdnl;
  int warps, pass_len;
  if (cap < 1 || nz_grid < 1 || (!ZWRAP && nz_grid >= nz_arr) ||
      !lists_half_plan(cap, MASKS, warps, pass_len))
    return (int)cudaErrorInvalidValue;
  const size_t smem = lists_half_shared(cap, warps, pass_len, MASKS);
  const auto kernel = lists_half_kernel<ZWRAP, MASKS>;
  const cudaError_t err = fit_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nz_grid * mc * mc, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (int*)masks, (int*)counts, mc, cap, L, r2cut, nz_arr,
      occupied_below, pass_len);
  return (int)cudaGetLastError();
}

}  // namespace

// occupied_below: a slot whose stored x is below it holds a particle (half
// the park base, ops/dense_cells.py::PARK_BASE).
extern "C" int mdnl_lists_half(const void* pos, void* masks, void* counts,
                               int mc, int cap, float L, float r2cut,
                               float occupied_below, void* stream) {
  return launch_lists_half<true, true>(pos, masks, counts, mc, cap, L, r2cut,
                                       mc, mc, occupied_below, stream);
}

// Slab form: pos (3, nz_arr*mc, mc, cap); masks (5, words, nz_grid*mc, mc,
// 3*cap) and counts (nz_grid*mc, mc, cap).
extern "C" int mdnl_lists_half_slab(const void* pos, void* masks, void* counts,
                                    int mc, int cap, float L, float r2cut,
                                    int nz_grid, int nz_arr,
                                    float occupied_below, void* stream) {
  return launch_lists_half<false, true>(pos, masks, counts, mc, cap, L, r2cut,
                                        nz_grid, nz_arr, occupied_below,
                                        stream);
}

// K5: the counts alone, (R, mc, cap).
extern "C" int mdnl_count_half(const void* pos, void* counts, int mc, int cap,
                               float L, float r2cut, float occupied_below,
                               void* stream) {
  return launch_lists_half<true, false>(pos, nullptr, counts, mc, cap, L,
                                        r2cut, mc, mc, occupied_below, stream);
}
