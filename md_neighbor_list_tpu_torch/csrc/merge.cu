// K8 merge: the incremental rebuild's per-cell stitch of stayers and movers.
//
// Replaces md_neighbor_list_tpu/ops/incremental.py::_merge_kernel. For every
// cell: the stayers (stayer-side pid >= 0; the caller sets leavers and empty
// slots to -1) compacted to a prefix in slot order, then the cell's movers
// (the mover-side state from the expand kernel: a cell's movers in slots
// 0..m-1, in mover-stream order) behind them, movers past cap dropped (the
// caller's particle count detects the loss and grows cap). The slots left over
// get the park lattice, zero velocity and pid -1, as the expand kernel writes
// them, so the result needs no park pass.
//
// The TPU body builds the per-lane shifts with log-step lane rolls
// (_compact_left, _shift_right_uniform) because that chip has no scatter;
// here it is a scatter by rank. Pure data movement, so the result equals the
// plain version bitwise. pid stays i32 throughout (the TPU body carries it
// through f32, exact below 2^24).
//
// Bound: bytes. What the merge needs to read is each slot's stayer pid (4
// bytes a slot; a stayer's pid is not read again), each particle's pos and
// vel from the side it comes from (24 bytes a particle), each mover's pid and
// one end-of-movers pid per cell; it writes 28 bytes a slot. A warp per cell,
// one cell after another, would chain five dependent memory trips a cell
// (stayer pids, ballot, stayer copies, mover pids, mover copies) and keep
// little in flight. So one block of 512 threads takes a (z, y) row, every slot
// of it at once, in three steps with no dependent load per cell:
//  1. every index load of the row first: each slot's stayer pid and mover
//     pid (mover slot d - n_stay is always below cap, so the mover pids of
//     the cell's own slots are all that output slot d can need), kept as two
//     bit flags a slot in shared memory, one warp ballot per 32 slots;
//  2. one warp counts the stayers before each 32-slot word (a scan of the
//     word popcounts), so that the stayers in any slot range of the row are
//     two lookups and a popcount: a stayer's rank, a cell's n_stay;
//  3. the copies, a thread per slot t: the stayer in slot t (if any) goes to
//     its cell's slot of rank; output slot t, where t's slot in its cell is
//     d >= n_stay, takes mover slot d - n_stay or the park lattice.
// Every output slot is written exactly once. The flags take 12 bytes per 32
// slots, so any cap fits in shared memory (past 48 KB after the opt-in). At
// mc = 35, cap = 40 on the H100, 512 threads a block beat 128, 256 and 1024
// (0.045 ms against 0.050, 0.048 and 0.061), and copying two or four slots a
// thread at once, or a per-cell table of stayer counts, bought nothing.
#include "geom.cuh"

namespace mdnl {

constexpr int kMergeThreads = 512;
constexpr int kMergeWords = 4;  // flag words a warp builds at once in step 1

// Stayers in slots [0, u) of the row: those of the words before u's, and the
// set bits below u in its word.
__device__ __forceinline__ int stayers_below(const unsigned* stay,
                                             const int* before, int u) {
  return before[u >> 5] + __popc(stay[u >> 5] & ((1u << (u & 31)) - 1u));
}

__device__ __forceinline__ bool flag(const unsigned* bits, int u) {
  return (bits[u >> 5] >> (u & 31)) & 1u;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ spos, const float* __restrict__ svel,
             const int* __restrict__ spid, const float* __restrict__ mpos,
             const float* __restrict__ mvel, const int* __restrict__ mpid,
             float* __restrict__ pos, float* __restrict__ vel,
             int* __restrict__ pid, int rows, int mc, int cap, float step) {
  extern __shared__ unsigned flags[];
  const int nslot = mc * cap;
  const int nw = (nslot + 31) >> 5;  // words; word nw stands for the end
  unsigned* const stay = flags;            // bit: the slot holds a stayer
  unsigned* const mover = flags + nw + 1;  // bit: the mover slot holds one
  int* const before = (int*)(flags + 2 * (nw + 1));  // stayers before word w
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kMergeThreads / 32;
  const int r = blockIdx.x;
  const size_t S = (size_t)rows * nslot;
  const size_t row0 = (size_t)r * nslot;

  // 1. the flags, kMergeWords words a warp at a time, loads first
  for (int w0 = warp; w0 < nw; w0 += kMergeWords * kWarps) {
    int sp[kMergeWords], mp[kMergeWords];
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) {
      const int t = (w0 + u * kWarps) * 32 + lane;
      sp[u] = t < nslot ? spid[row0 + t] : -1;
      mp[u] = t < nslot ? mpid[row0 + t] : -1;
    }
#pragma unroll
    for (int u = 0; u < kMergeWords; ++u) {
      const int w = w0 + u * kWarps;  // warp-uniform
      const unsigned bs = __ballot_sync(0xffffffffu, sp[u] >= 0);
      const unsigned bm = __ballot_sync(0xffffffffu, mp[u] >= 0);
      if (lane == 0 && w < nw) {
        stay[w] = bs;
        mover[w] = bm;
      }
    }
  }
  if (threadIdx.x == 0) stay[nw] = mover[nw] = 0u;
  __syncthreads();

  // 2. stayers before each word: an exclusive scan of the word popcounts
  if (warp == 0) {
    int carry = 0;
    for (int w0 = 0; w0 <= nw; w0 += 32) {
      const int w = w0 + lane;
      const int c = w < nw ? __popc(stay[w]) : 0;
      int inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += n;
      }
      if (w <= nw) before[w] = carry + inc - c;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();

  // 3. the copies, a thread per slot
  const float base = 1.0e5f;
  const float park_y = __fadd_rn(base, __fmul_rn((float)r, step));
  for (int t = threadIdx.x; t < nslot; t += kMergeThreads) {
    const int c0 = t / cap * cap;
    const int first = stayers_below(stay, before, c0);
    const int n_stay = stayers_below(stay, before, c0 + cap) - first;
    const int m = t - c0 - n_stay;  // the mover slot output slot t takes
    const bool stayer = flag(stay, t);
    const bool moved = m >= 0 && flag(mover, c0 + m);
    float a[6], b[6];
    int pa = -1, pb = -1;
    if (stayer) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[c] = spos[c * S + row0 + t];
        a[3 + c] = svel[c * S + row0 + t];
      }
      pa = spid[row0 + t];
    }
    if (moved) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c] = mpos[c * S + row0 + c0 + m];
        b[3 + c] = mvel[c * S + row0 + c0 + m];
      }
      pb = mpid[row0 + c0 + m];
    } else {
      // park lattice, rounded step by step as the plain version rounds it
      b[0] = __fadd_rn(base, __fmul_rn((float)t, step));
      b[1] = park_y;
      b[2] = base;
      b[3] = b[4] = b[5] = 0.f;
    }
    if (stayer) {
      const size_t dst = row0 + c0 + stayers_below(stay, before, t) - first;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pos[c * S + dst] = a[c];
        vel[c * S + dst] = a[3 + c];
      }
      pid[dst] = pa;
    }
    if (m >= 0) {
      const size_t dst = row0 + t;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pos[c * S + dst] = b[c];
        vel[c * S + dst] = b[3 + c];
      }
      pid[dst] = pb;
    }
  }
}

}  // namespace mdnl

extern "C" int mdnl_merge(const void* spos, const void* svel, const void* spid,
                          const void* mpos, const void* mvel, const void* mpid,
                          void* pos, void* vel, void* pid, int rows, int mc,
                          int cap, float step, void* stream) {
  if (cap < 1 || rows < 1 || mc < 1) return (int)cudaErrorInvalidValue;
  const size_t nw = ((size_t)mc * cap + 31) / 32;
  const size_t smem = 3 * (nw + 1) * sizeof(unsigned);
  if (smem > mdnl::kMaxShared) return (int)cudaErrorInvalidValue;
  const cudaError_t err = mdnl::fit_shared(mdnl::merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mdnl::merge_kernel<<<rows, mdnl::kMergeThreads, smem,
                       (cudaStream_t)stream>>>(
      (const float*)spos, (const float*)svel, (const int*)spid,
      (const float*)mpos, (const float*)mvel, (const int*)mpid, (float*)pos,
      (float*)vel, (int*)pid, rows, mc, cap, step);
  return (int)cudaGetLastError();
}
