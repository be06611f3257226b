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
// here it is a scatter by rank. One block per (z, y) row, one warp per cell at
// a time: a stayer's destination is its rank, one ballot + popcount per 32
// slots; output slot d >= n_stay then pulls mover slot d - n_stay, or parks.
// Every output slot is written exactly once, pos, vel and pid in one launch
// (the JAX package makes two calls only to avoid a concat on the TPU). Pure
// data movement, so the result equals the plain version bitwise. pid stays
// i32 throughout (the TPU body carries it through f32, exact below 2^24).
//
// Bound: bytes. What the merge needs to read is each slot's stayer pid (4
// bytes a slot; a stayer's pid is not read again), each particle's pos and
// vel from the side it comes from (24 bytes a particle), each mover's pid and
// one end-of-movers pid per cell; it writes 28 bytes a slot. Reads and writes
// run along a cell's slots and coalesce, the stayer scatter within one cell.
#include "geom.cuh"

namespace mdnl {

__global__ void merge_kernel(const float* __restrict__ spos,
                             const float* __restrict__ svel,
                             const int* __restrict__ spid,
                             const float* __restrict__ mpos,
                             const float* __restrict__ mvel,
                             const int* __restrict__ mpid,
                             float* __restrict__ pos, float* __restrict__ vel,
                             int* __restrict__ pid, int rows, int mc, int cap,
                             float step) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t S = (size_t)rows * mc * cap;
  const float base = 1.0e5f;
  for (int x = threadIdx.x >> 5; x < mc; x += warps) {
    const size_t cell0 = ((size_t)r * mc + x) * cap;
    int n_stay = 0;
    for (int s0 = 0; s0 < cap; s0 += 32) {  // warp-uniform
      const int s = s0 + lane;
      const bool stay = s < cap && spid[cell0 + s] >= 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, stay);
      if (stay) {
        const size_t src = cell0 + s;
        const size_t dst = cell0 + n_stay + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pos[c * S + dst] = spos[c * S + src];
          vel[c * S + dst] = svel[c * S + src];
        }
        pid[dst] = spid[src];
      }
      n_stay += __popc(ballot);
    }
    for (int d = n_stay + lane; d < cap; d += 32) {
      const size_t dst = cell0 + d;
      const size_t src = cell0 + (d - n_stay);
      const int p = mpid[src];
      if (p >= 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pos[c * S + dst] = mpos[c * S + src];
          vel[c * S + dst] = mvel[c * S + src];
        }
        pid[dst] = p;
      } else {
        // park lattice, rounded step by step as the plain version rounds it
        const int t = x * cap + d;
        pos[dst] = __fadd_rn(base, __fmul_rn((float)t, step));
        pos[S + dst] = __fadd_rn(base, __fmul_rn((float)r, step));
        pos[2 * S + dst] = base;
        vel[dst] = 0.f;
        vel[S + dst] = 0.f;
        vel[2 * S + dst] = 0.f;
        pid[dst] = -1;
      }
    }
  }
}

}  // namespace mdnl

extern "C" int mdnl_merge(const void* spos, const void* svel, const void* spid,
                          const void* mpos, const void* mvel, const void* mpid,
                          void* pos, void* vel, void* pid, int rows, int mc,
                          int cap, float step, void* stream) {
  if (cap < 1 || rows < 1 || mc < 1) return (int)cudaErrorInvalidValue;
  mdnl::merge_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(
      (const float*)spos, (const float*)svel, (const int*)spid,
      (const float*)mpos, (const float*)mvel, (const int*)mpid, (float*)pos,
      (float*)vel, (int*)pid, rows, mc, cap, step);
  return (int)cudaGetLastError();
}
