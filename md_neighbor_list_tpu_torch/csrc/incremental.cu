// The incremental rebuild's two small stages as one kernel each
// (ops/incremental.py): the mover keys before the mover sort, and the window
// predicate with the engine's counts after it.
//
// Replaces no Pallas kernel: the JAX package (md_neighbor_list_tpu/ops/
// incremental.py) writes both as array expressions, which XLA fuses. Plain
// PyTorch runs the first as about 25 launches, each a pass over the slot
// arrays (remainder, the product, floor, conversion and clamp of the cell
// coordinates, the key's sums, the cell each slot belongs to, the compares,
// masks and wheres), and the second as about 12 launches on a few thousand
// numbers; in a captured build they were some 0.15 ms of a 0.88 ms graph.
//
//  mover_keys: per slot, the position wrapped into the box (fmod, then L
//    added where the remainder is negative, as torch.remainder computes it),
//    its cell from the f32 product with the reciprocal of the cell size,
//    floored and clamped (ops/dense_cells.py::cell_keys), and from that the
//    mover stream's key (a valid slot whose cell is not the one it sits in
//    keeps its cell's key; stayers and empty slots take the beyond-last key)
//    and the stayer-side pid (the pid of a stayer, else -1).
//  window_count: one block over the mover stream's row starts: the JAX
//    mover expand's window predicate (groups of `group` rows, each read from
//    its first row start rounded down to 128 through `window` records; the
//    predicate holds where a group's span from there exceeds it), written as
//    the engine's two branch flags (take the full rebuild, keep the merged
//    state), and the engine's device counts raised: the branch taken, and the
//    movers (the last row start).
//
// Bits: the products and sums are rounded one by one (`__fmul_rn`,
// `__fadd_rn`), so the compiler's contraction decides nothing, and the
// results equal the plain versions' bit for bit. Bound: bytes; mover_keys
// reads pos and pid (16 bytes) and writes the wrapped pos, the key and the
// stayer pid (20 bytes), 36 bytes a slot.
#include <cuda_runtime.h>

namespace mdnl {

constexpr int kKeyThreads = 256;
constexpr int kCountThreads = 256;

__global__ void __launch_bounds__(kKeyThreads)
mover_keys_kernel(const float* __restrict__ pos, const int* __restrict__ pid,
                  float* __restrict__ pos_w, int* __restrict__ keys,
                  int* __restrict__ spid, long long slots, int mc, int cap,
                  float L, float inv) {
  const long long s = blockIdx.x * (long long)kKeyThreads + threadIdx.x;
  if (s >= slots) return;
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float w = fmodf(pos[d * slots + s], L);
    if (w != 0.0f && ((L < 0.0f) != (w < 0.0f))) w = __fadd_rn(w, L);
    pos_w[d * slots + s] = w;
    const int k = static_cast<int>(floorf(__fmul_rn(w, inv)));
    c[d] = min(max(k, 0), mc - 1);
  }
  const int p = pid[s];
  const int key = c[0] + mc * (c[1] + mc * c[2]);
  const bool stay = p >= 0 && key == static_cast<int>(s / cap);
  keys[s] = (p >= 0 && !stay) ? key : mc * mc * mc;
  spid[s] = stay ? p : -1;
}

__global__ void __launch_bounds__(kCountThreads)
window_count_kernel(const int* __restrict__ row_start, bool* window,
                    long long* taken, long long* movers, int rows, int group,
                    int records) {
  __shared__ int warp_max[kCountThreads / 32];
  int m = 0;  // spans are never negative
  for (int g = threadIdx.x; g * group < rows; g += kCountThreads) {
    const int first = row_start[g * group];
    const int end = row_start[min(g * group + group, rows)];
    m = max(m, end - (first / 128) * 128);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCountThreads / 32; ++w) m = max(m, warp_max[w]);
    const bool over = m > records;
    window[0] = over;
    window[1] = !over;
    taken[0] += over ? 0 : 1;
    taken[1] += over ? 1 : 0;
    movers[0] += row_start[rows];
  }
}

}  // namespace mdnl

extern "C" int mdnl_mover_keys(const void* pos, const void* pid, void* pos_w,
                               void* keys, void* spid, int slots, int mc,
                               int cap, float L, float inv, void* stream_) {
  using namespace mdnl;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (slots <= 0) return cudaSuccess;
  const unsigned grid = (slots + kKeyThreads - 1) / kKeyThreads;
  mover_keys_kernel<<<grid, kKeyThreads, 0, stream>>>(
      static_cast<const float*>(pos), static_cast<const int*>(pid),
      static_cast<float*>(pos_w), static_cast<int*>(keys),
      static_cast<int*>(spid), slots, mc, cap, L, inv);
  return cudaGetLastError();
}

extern "C" int mdnl_window_count(const void* row_start, void* window,
                                 void* taken, void* movers, int rows,
                                 int group, int records, void* stream_) {
  using namespace mdnl;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  window_count_kernel<<<1, kCountThreads, 0, stream>>>(
      static_cast<const int*>(row_start), static_cast<bool*>(window),
      static_cast<long long*>(taken), static_cast<long long*>(movers), rows,
      group, records);
  return cudaGetLastError();
}
