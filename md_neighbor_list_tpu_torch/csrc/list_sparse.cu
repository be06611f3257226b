// The NVE step's half list at rs in one kernel: each slot's partners in the
// ten sparse cells of its window, placed by a single-pass scan over cells.
//
// Replaces no TPU kernel: the JAX step sweeps every cell at every step and
// keeps no list. It was added for the list that the list-driven force
// (force_list.cu) reads, which took four stages before: K2's masks of all
// 14 window cells written to device memory, a count and a pack that read
// the sparse cells' words back, and an ATen prefix sum between them. The
// masks of the four dense cells were thrown away, and those of the ten
// sparse cells were made only to be read again; here the bits of one own
// cell stay in shared memory from the distance test to the list.
//
// The list (force_list.cu's layout, per flat slot cell * cap + i): nsparse,
// the slot's partners within rs in the sparse cells; start, the exclusive
// prefix sum of nsparse over flat slots, clipped at the capacity; lanes,
// each slot's partners from its start on, int16 window lanes v in list
// order (cell by cell of the sparse cells 2, 4-8, 10-13, slot by slot), the
// entries at or past the capacity not stored. The last cell's block writes
// the 0-d overflow flag: the list has more entries than the capacity. The
// pair test is K2's (lists_half.cu): occupied slots only (x <
// occupied_below), the partner image-shifted by __fadd_rn and
// geom.cuh::pair_r2 (rounded step by step) against r2cut; no keep bound,
// as the own cell is a dense cell. So the list is, bit for bit, K2's sparse
// bits counted and packed in that order.
//
// One block of 128 threads per own cell:
//  1. Staging. A ticket (an atomic counter) gives the block its cell, in
//     flat order, so that a block never waits on one that is not yet
//     resident. In one pass the block compacts into shared memory the
//     cell's occupied slots in slot order, then the occupied slots of the
//     ten sparse cells, image-shifted, in list order, each with its window
//     lane: every item's loads first, then a ballot an item and warp, and
//     one warp scan over those counts places them.
//  2. The walk. Partners along the lanes, 32 to a column, own slots
//     broadcast mask word by mask word; each test's hits of one column are
//     a warp ballot, kept by the lane whose own slot it is (lane == slot %
//     32). So after a word a lane holds, for its own slot, one 32-bit row a
//     column: the transposed bits, with no shuffle.
//  3. Counts and local offsets, by warp 0: each slot's popcounts, an
//     exclusive warp scan in slot order; the cell's total published at once.
//  4. The cell's global start by decoupled look-back (Merrill & Garland,
//     "Single-pass Parallel Prefix Scan with Decoupled Look-back"): warp 0
//     reads its predecessors' status words 32 at a time, adding aggregates
//     back to the first inclusive prefix, and publishes its own. A word
//     holds its flag and its value together, so one 64-bit access reads
//     both. The status words and the ticket are zeroed by a kernel of their
//     own just before (the launch sits in a replayed graph). Meanwhile the
//     other warps place the cell's entries, one contiguous range of the
//     list, in shared memory (over the staged slots, no longer read), a
//     (column, own slot) row a thread.
//  5. The writes: each slot's start, and the cell's entries by 16-byte
//     stores, the two ragged ends by 2-byte ones.
//
// Two forms, picked by the host from cap (list_sparse_plan). The one-walk
// form keeps the rows of every column in shared memory (columns split over
// the warps, two a warp at a time): 3.3 KB at cap 40, up to cap 192 within
// half the block's shared memory. Past it the two-walk form splits the mask
// words over the warps: each lane counts its slot's hits in a first walk,
// and after the look-back walks again, writing each slot's entries in
// order to device memory directly (the rows of cap 384 would take 184 KB).
//
// Bound: it reads 12 bytes a slot and writes 8 a slot and 2 an entry; its
// operations are the sparse cells' occupied slot-pair tests, 9 flops each.
// At cap 40 both are far below the card's peaks (at N = 2,048,000 about
// 126 MB and 403M tests, 3.6 GFLOP: 0.038 and 0.054 ms): the instructions
// and the latencies of a block's short phases bound it (on an NVIDIA H100
// 80GB HBM3 at 700 W, N = 2,048,000, cap 40: about 0.08 ms to launch the
// blocks and take the tickets, 0.26 the staging, 0.26 the walk, the rest
// the counts, the placing and the writes; PERF.md). So it tests only what
// the list keeps (no dense cell, no zero word) with one ballot and one
// select a test, stages in one pass with one scan, hides the look-back
// behind the placing, and keeps 16 blocks an SM.
#include "half_sweep.cuh"

namespace mdnl {

constexpr int kSparseWarps = 4;  // warps of a block
// a staging round's (item, warp) counts are scanned by one warp's lanes
static_assert(kStageItems * kSparseWarps <= 32, "one count a lane");
// Partner columns a warp takes at a time: at cap 40 the sparse cells hold
// about 7 columns of occupied slots, so 2 spread them over the four warps.
constexpr int kSparseB = 2;
// Blocks an SM should hold: the bound caps a thread at 32 registers (a few
// bytes spill); at 40 (12 blocks) the kernel took 3 % longer and at 56 (9
// blocks) 5-8 % longer at N = 2,048,000, cap 40 (PERF.md).
constexpr int kSparseMinBlocks = 16;
// Status words of the look-back: the flag in the top two bits (0: nothing
// yet, aggregate, inclusive prefix), the value below.
constexpr unsigned long long kLbAggregate = 1ull << 62;
constexpr unsigned long long kLbPrefix = 2ull << 62;
constexpr unsigned long long kLbValue = kLbAggregate - 1;
// Static shared memory of a block, with room to spare.
constexpr size_t kSparseStatic = 2048;

__host__ __device__ inline int sparse_words(int cap) { return (cap + 31) / 32; }
__host__ __device__ inline int sparse_cols(int cap) {
  return (kSparseCells * cap + 31) / 32;
}

// Shared memory of one block: the staged own slots and partners (float4),
// with one walk the rows (cols x 32 words, u32), each slot's offset and,
// with two walks, its count (int, 32 a word), with one walk each row's
// offset in its slot's entries (u16, cols x 32 words) and each staged
// entry's window lane (i16).
__host__ __device__ inline size_t list_sparse_shared(int cap, bool one_walk) {
  const size_t items = (size_t)(1 + kSparseCells) * cap;
  const size_t row = (size_t)32 * sparse_words(cap);
  return items * 16 + row * 4 * (one_walk ? 1 : 2) +
         (one_walk ? (size_t)sparse_cols(cap) * row * 6 + items * 2 : 0);
}

// The form for `cap`: one walk within half the shared memory (two blocks an
// SM at any cap), else two walks. Returns false if neither fits.
inline bool list_sparse_plan(int cap, bool& one_walk, size_t& smem) {
  one_walk = list_sparse_shared(cap, true) + kSparseStatic <= kPassShared;
  smem = list_sparse_shared(cap, one_walk);
  return smem + kSparseStatic <= kMaxShared;
}

// For own slots [s0, s1) (one mask word's) against the B partners a lane
// holds: h[b] of the lane whose own slot is 32w + lane gets the ballot of
// column b's hits, bit l for the partner of lane l.
template <int B>
__device__ __forceinline__ void word_hits(const float4* own, int s0, int s1,
                                          const float4 (&pj)[B], float r2cut,
                                          int lane, unsigned (&h)[B]) {
#pragma unroll
  for (int b = 0; b < B; ++b) h[b] = 0u;
  for (int s = s0; s < s1; ++s) {
    const float4 o = own[s];
    const bool mine = (__float_as_int(o.w) & 31) == lane;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float dx, dy, dz;
      const float r2 = pair_r2(o.x, o.y, o.z, pj[b].x, pj[b].y, pj[b].z, dx,
                               dy, dz);
      const unsigned hit = __ballot_sync(0xffffffffu, r2 < r2cut);
      h[b] = mine ? hit : h[b];
    }
  }
}

// Column c0 + b of the staged partners, a lane's own one; past the n staged
// ones a partner at infinity, which meets nothing.
template <int B>
__device__ __forceinline__ void load_columns(const float4* part, int n,
                                             int c0, int lane,
                                             float4 (&pj)[B]) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = (c0 + b) * 32 + lane;
    pj[b] = j < n ? part[j] : make_float4(inf, inf, inf, 0.f);
  }
}

// Publish tile `tile`'s aggregate `agg` (the first tile's is its prefix).
__device__ __forceinline__ void lookback_publish(unsigned long long* status,
                                                 int tile,
                                                 unsigned long long agg) {
  const unsigned long long flag = tile == 0 ? 2ull : 1ull;
  *(volatile unsigned long long*)(status + tile) = flag << 62 | agg;
}

// Warp-wide, after lookback_publish: the sum of the aggregates of tiles
// [0, tile); publishes the tile's inclusive prefix.
__device__ __forceinline__ unsigned long long lookback_prefix(
    unsigned long long* status, int tile, unsigned long long agg, int lane) {
  volatile unsigned long long* st = status;
  unsigned long long excl = 0;
  for (int pred = tile - 1; tile > 0; pred -= 32) {
    const int t = pred - lane;  // lane 0 the nearest predecessor
    unsigned long long s;
    do {  // tiles before the first are a prefix of 0
      s = kLbPrefix;
      if (t >= 0) s = st[t];
    } while (__any_sync(0xffffffffu, (s >> 62) == 0));
    const unsigned done = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    const int last = done ? __ffs(done) - 1 : 31;  // the nearest prefix
    unsigned long long v = lane <= last ? (s & kLbValue) : 0ull;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (done) break;
  }
  if (lane == 0 && tile > 0) st[tile] = kLbPrefix | (excl + agg);
  return excl;
}

__global__ void lookback_reset_kernel(unsigned long long* status, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) status[i] = 0ull;
}

// The cell's entries [lo, lo + room) into buf (entry p at buf[p - lo]),
// from the rows (rows[col][i]: own slot i's bits of column col, one a
// partner) at their places in the cell (slot_off[i] + row_off[col][i]); a
// (column, own slot) row a thread, `first` on by `step`.
__device__ __forceinline__ void place_rows(
    const unsigned* rows, const unsigned short* row_off, const int* slot_off,
    const short* part_v, int row, int ncols, int cap, float inv_cap, int lo,
    int room, short* buf, int first, int step) {
  for (int e = first; e < ncols * cap; e += step) {
    int i;
    const int col = div_rem(e, cap, inv_cap, i);
    int p = slot_off[i] + row_off[col * row + i] - lo;
    for (unsigned h = rows[col * row + i]; h != 0u; h &= h - 1u, ++p)
      if (p >= 0 && p < room) buf[p] = part_v[col * 32 + __ffs(h) - 1];
  }
}

// lanes [b, end) from buf (lanes entry g at buf[g - b]), 8 entries a thread
// from the multiple of 8 at or below b: whole groups by one 16-byte store,
// the ragged ends entry by entry.
__device__ __forceinline__ void store_lanes(const short* buf, long long b,
                                            long long end, short* lanes) {
  for (long long g = (b & ~7ll) + 8 * threadIdx.x; g < end;
       g += 8 * blockDim.x) {
    if (g >= b && g + 8 <= end) {
      const unsigned short* v = (const unsigned short*)buf + (g - b);
      unsigned u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = (unsigned)v[2 * k] | (unsigned)v[2 * k + 1] << 16;
      *reinterpret_cast<uint4*>(lanes + g) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      for (long long k = g < b ? b : g; k < g + 8 && k < end; ++k)
        lanes[k] = buf[k - b];
    }
  }
}

// status: (cells + 1) words zeroed just before, the last the ticket.
template <bool ONE_WALK>
__global__ void __launch_bounds__(32 * kSparseWarps, kSparseMinBlocks)
list_sparse_kernel(const float* __restrict__ pos, int* __restrict__ start,
                   int* __restrict__ nsparse, short* __restrict__ lanes,
                   unsigned long long* status,
                   unsigned char* __restrict__ overflow, int mc, int cap,
                   float L, float r2cut, float occupied_below, int capacity) {
  extern __shared__ float4 smem4[];
  __shared__ int4 cell_i[kHalfRowsLanes];
  __shared__ float4 cell_shift[kHalfRowsLanes];
  __shared__ int wstart[33];
  __shared__ int item_counts[32];  // a round's, (item, warp)
  __shared__ unsigned long long tile_first;
  __shared__ int cell_total;
  __shared__ int tile_of_block;
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int words = sparse_words(cap), row = 32 * words;
  const int nsp = kSparseCells * cap, items = cap + nsp;
  const int cols = sparse_cols(cap);
  float4* stage = smem4;                                // [items]
  unsigned* rows = (unsigned*)(stage + items);          // one walk: [cols][row]
  int* slot_off = (int*)(rows + (ONE_WALK ? (size_t)cols * row : 0));  // [row]
  int* slot_cnt = slot_off + row;                       // two walks: [row]
  unsigned short* row_off =  // one walk: [cols][row]
      (unsigned short*)(slot_cnt + (ONE_WALK ? 0 : row));
  short* stage_v =  // one walk: [items]
      (short*)(row_off + (ONE_WALK ? (size_t)cols * row : 0));
  short* buf = (short*)stage;  // one walk, after the walk: [8 items]
  const int room = 8 * items;

  // the ticket and its cell's window table, by warp 0
  const int cells = gridDim.x;
  const size_t S = (size_t)cells * cap;
  if (w == 0) {
    int t = 0;
    if (lane == 0) t = (int)atomicAdd(status + cells, 1ull);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (lane == 0) tile_of_block = t;
    window_table(mc, cap, L, cell_of_block(t, mc), cell_i, cell_shift);
  }
  __syncthreads();
  const int tile = tile_of_block;
  const CellId c = cell_of_block(tile, mc);
  const size_t own0 = (size_t)c.cell * cap;
  const float inv_cap = 1.0f / cap;

  // 1. staging: items [0, cap) are the own cell's slots, items cap + q the
  //    sparse cells' list position q; the occupied ones are compacted in
  //    that order (own slots [0, no), then partners). A round takes up to
  //    kStageItems items a thread, item it of thread x being base + it *
  //    blockDim + x: each warp's ballot of an item, then a scan over the
  //    round's (item, warp) counts (a warp's lanes, item-major) places it.
  int staged = 0;
  for (int base = 0; base < items; base += kStageItems * blockDim.x) {
    const int nit = min(kStageItems, (items - base + blockDim.x - 1) /
                                         (int)blockDim.x);  // block-uniform
    // every item's loads first, branch-free, then the ballots (a ballot
    // would wait for its item's loads)
    float4 e[kStageItems];
    bool occ[kStageItems];
#pragma unroll
    for (int it = 0; it < kStageItems; ++it) {
      if (it >= nit) break;
      const int o = base + it * blockDim.x + threadIdx.x;
      const bool mine = o < cap;  // own slot o, else list position o - cap
      int slot;
      const int q = mine ? 0 : min(o - cap, nsp - 1);
      const int pc = pack_cell(div_rem(q, cap, inv_cap, slot));
      const float4 sh = mine ? make_float4(0.f, 0.f, 0.f, 0.f) : cell_shift[pc];
      const int idx = mine ? (int)own0 + o : cell_i[pc].x + slot;
      float x = occupied_below, y = 0.f, z = 0.f;
      if (o < items) {
        x = pos[idx];
        y = pos[S + idx];
        z = pos[2 * S + idx];
      }
      occ[it] = x < occupied_below;
      e[it] = make_float4(__fadd_rn(x, sh.x), __fadd_rn(y, sh.y),
                          __fadd_rn(z, sh.z),
                          __int_as_float(mine ? o : pc * cap + slot));
    }
    unsigned ball[kStageItems];
#pragma unroll
    for (int it = 0; it < kStageItems; ++it) {
      if (it >= nit) break;
      ball[it] = __ballot_sync(0xffffffffu, occ[it]);
      if (lane == 0) item_counts[it * W + w] = __popc(ball[it]);
    }
    __syncthreads();
    const int cnt = lane < nit * W ? item_counts[lane] : 0;
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    const int excl = incl - cnt;
#pragma unroll
    for (int it = 0; it < kStageItems; ++it) {
      if (it >= nit) break;
      const int o = base + it * blockDim.x + threadIdx.x;
      const int at = staged + __shfl_sync(0xffffffffu, excl, it * W + w) +
                     __popc(ball[it] & ((1u << lane) - 1u));
      // wstart[w]: the own entries whose slot lies below 32*w; the last,
      // all of them
      if (o < cap ? (o & 31) == 0 : o == cap)
        wstart[o < cap ? o >> 5 : words] = at;
      if (ball[it] >> lane & 1u) {
        stage[at] = e[it];
        if (ONE_WALK) stage_v[at] = (short)__float_as_int(e[it].w);
      }
    }
    staged += __shfl_sync(0xffffffffu, incl, 31);
    __syncthreads();  // item_counts is written again by the next round
  }
  const int no = wstart[words], n = staged - no;
  const float4* own = stage;
  const float4* part = stage + no;
  const short* part_v = stage_v + no;
  const int ncols = (n + 31) >> 5;

  // 2. the walk (with two walks its first, each slot's count)
  if constexpr (ONE_WALK) {
    for (int c0 = w * kSparseB; c0 < ncols; c0 += W * kSparseB) {
      float4 pj[kSparseB];
      load_columns(part, n, c0, lane, pj);
      for (int ww = 0; ww < words; ++ww) {
        unsigned h[kSparseB];
        word_hits(own, wstart[ww], wstart[ww + 1], pj, r2cut, lane, h);
#pragma unroll
        for (int b = 0; b < kSparseB; ++b)
          if (c0 + b < ncols) rows[(c0 + b) * row + 32 * ww + lane] = h[b];
      }
    }
  } else {
    for (int ww = w; ww < words; ww += W) {
      int t = 0;
      for (int c0 = 0; c0 < ncols; c0 += kSparseB) {
        float4 pj[kSparseB];
        load_columns(part, n, c0, lane, pj);
        unsigned h[kSparseB];
        word_hits(own, wstart[ww], wstart[ww + 1], pj, r2cut, lane, h);
#pragma unroll
        for (int b = 0; b < kSparseB; ++b) t += __popc(h[b]);
      }
      slot_cnt[32 * ww + lane] = t;
    }
  }
  __syncthreads();

  // 3. by warp 0, 32 slots at a time: each slot's count out and its offset
  //    in the cell's range (a warp scan); the cell's total published at once
  if (w == 0) {
    int total = 0;
    for (int base = 0; base < cap; base += 32) {
      const int i = base + lane;
      int cnt = 0;
      if (i < cap) {
        if constexpr (ONE_WALK) {
          for (int col = 0; col < ncols; ++col) {
            row_off[col * row + i] = (unsigned short)cnt;
            cnt += __popc(rows[col * row + i]);
          }
        } else {
          cnt = slot_cnt[i];
        }
      }
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      if (i < cap) {
        slot_off[i] = total + incl - cnt;
        nsparse[own0 + i] = cnt;
      }
      total += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      cell_total = total;
      lookback_publish(status, tile, (unsigned long long)total);
    }
  }
  __syncthreads();
  const int total_cell = cell_total;

  // 4. the cell's first entry by warp 0; meanwhile, with one walk, the other
  //    warps place the cell's first `room` entries in buf
  if (w == 0) {
    const unsigned long long first =
        lookback_prefix(status, tile, (unsigned long long)total_cell, lane);
    if (lane == 0) {
      tile_first = first;
      if (tile == cells - 1)
        *overflow = first + total_cell > (unsigned long long)capacity;
    }
  } else if (ONE_WALK) {
    place_rows(rows, row_off, slot_off, part_v, row, ncols, cap, inv_cap, 0,
               room, buf, threadIdx.x - 32, blockDim.x - 32);
  }
  __syncthreads();
  const long long G = (long long)tile_first;

  // 5. the writes
  for (int i = threadIdx.x; i < cap; i += blockDim.x)
    start[own0 + i] = (int)min(G + slot_off[i], (long long)capacity);
  if constexpr (ONE_WALK) {
    // the cell's entries, `room` at a time (more than one pass only for a
    // cell with more entries than its staged slots have bytes for)
    for (int lo = 0;;) {
      const int hi = min(total_cell, lo + room);
      store_lanes(buf, G + lo, min(G + hi, (long long)capacity), lanes);
      if (hi == total_cell) break;  // block-uniform
      lo = hi;
      __syncthreads();  // buf is read before it is placed anew
      place_rows(rows, row_off, slot_off, part_v, row, ncols, cap, inv_cap,
                 lo, room, buf, threadIdx.x, blockDim.x);
      __syncthreads();
    }
  } else {
    // the second walk: each slot's entries in order, from its start
    for (int ww = w; ww < words; ww += W) {
      const int i = 32 * ww + lane;
      long long p = G + (i < cap ? slot_off[i] : 0);
      for (int c0 = 0; c0 < ncols; c0 += kSparseB) {
        float4 pj[kSparseB];
        load_columns(part, n, c0, lane, pj);
        unsigned h[kSparseB];
        word_hits(own, wstart[ww], wstart[ww + 1], pj, r2cut, lane, h);
#pragma unroll
        for (int b = 0; b < kSparseB; ++b)
          for (unsigned x = h[b]; x != 0u; x &= x - 1u, ++p)
            if (p < capacity)
              lanes[p] = (short)__float_as_int(
                  part[(c0 + b) * 32 + __ffs(x) - 1].w);
      }
    }
  }
}

}  // namespace mdnl

namespace {

// The reset of the look-back's words, then the list kernel: one block per
// own cell.
template <bool ONE_WALK>
int launch_list_sparse(const void* pos, void* start, void* nsparse,
                       void* lanes, void* status, void* overflow, int mc,
                       int cap, float L, float r2cut, float occupied_below,
                       int capacity, size_t smem, cudaStream_t stream) {
  using namespace mdnl;
  const int cells = mc * mc * mc;
  const auto kernel = list_sparse_kernel<ONE_WALK>;
  cudaError_t err = fit_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lookback_reset_kernel<<<(cells + 256) / 256, 256, 0, stream>>>(
      (unsigned long long*)status, cells + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<cells, 32 * kSparseWarps, smem, stream>>>(
      (const float*)pos, (int*)start, (int*)nsparse, (short*)lanes,
      (unsigned long long*)status, (unsigned char*)overflow, mc, cap, L,
      r2cut, occupied_below, capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// pos (3, R, mc, cap); writes start and nsparse (R, mc, cap) i32, lanes
// (capacity,) i16 (16-byte aligned) and overflow, a 0-d bool; status:
// mc^3 + 1 u64 of scratch. occupied_below: a slot whose stored x is below it
// holds a particle (half the park base, ops/dense_cells.py::PARK_BASE).
extern "C" int mdnl_list_sparse(const void* pos, void* start, void* nsparse,
                                void* lanes, void* status, void* overflow,
                                int mc, int cap, float L, float r2cut,
                                float occupied_below, int capacity,
                                void* stream) {
  using namespace mdnl;
  bool one_walk;
  size_t smem;
  if (cap < 1 || mc < 1 || kHalfRowsLanes * cap > 32767 ||
      sparse_words(cap) > 32 || !list_sparse_plan(cap, one_walk, smem))
    return (int)cudaErrorInvalidValue;
  const auto launch =
      one_walk ? launch_list_sparse<true> : launch_list_sparse<false>;
  return launch(pos, start, nsparse, lanes, status, overflow, mc, cap, L,
                r2cut, occupied_below, capacity, smem, (cudaStream_t)stream);
}
