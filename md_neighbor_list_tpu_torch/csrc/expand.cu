// K1 expand: key-sorted record stream -> dense cap-stride slots per cell.
//
// Replaces md_neighbor_list_tpu/ops/dense_cells.py::_expand_kernel. The TPU
// body realises out[c*cap + s] = rec[off_c + s] as log-step lane rolls over
// a DMA window because that chip has no gather; here it is the indexed copy
// itself. One block per (z, y) row: the first mc+1 threads binary-search the
// row's slice [row_start[r], row_start[r+1]) of the sorted keys for each cell's
// first record, then a thread per output slot copies its record or, where the
// cell's run is shorter than the slot index, writes the park lattice, zero
// velocity and pid -1. Runs longer than cap are truncated (the caller's
// particle count detects the loss).
//
// Cell keys start at key_base: 0 for the cube; mc*mc for a slab, whose sort
// stream also holds emigrants keyed below the owned range and foreign records
// above it (md_neighbor_list_tpu/ops/slab_kernels.py::slab_sort_expand). Row
// r's cells are keys key_base + r*mc + x; the row starts leave the records
// outside [key_base, key_base + rows*mc) out of every row, so none is read.
//
// Bound: bytes. Every record is read once (7 channels + key) and every slot
// written once (7 channels); no arithmetic to speak of. Reads along a cell's
// run and writes along a row are contiguous, so both coalesce.
#include "geom.cuh"

namespace mdnl {

__global__ void expand_kernel(const float* __restrict__ chans,
                              const int* __restrict__ pid_s,
                              const int* __restrict__ keys_s,
                              const int* __restrict__ row_start,
                              float* __restrict__ posvel,
                              int* __restrict__ pid_out, int M, int rows,
                              int mc, int cap, float step, int key_base) {
  extern __shared__ int off[];  // mc + 1 run starts of this row's cells
  const int r = blockIdx.x;
  const int lo0 = row_start[r], hi0 = row_start[r + 1];
  for (int x = threadIdx.x; x <= mc; x += blockDim.x) {
    const int target = key_base + r * mc + x;  // cell key
    int lo = lo0, hi = hi0;  // first index in [lo0, hi0) with key >= target
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys_s[mid] < target) lo = mid + 1; else hi = mid;
    }
    off[x] = lo;
  }
  __syncthreads();
  const size_t S = (size_t)rows * mc * cap;
  const float base = 1.0e5f;
  for (int t = threadIdx.x; t < mc * cap; t += blockDim.x) {
    const int x = t / cap, s = t - x * cap;
    const int len = off[x + 1] - off[x];
    const size_t dst = (size_t)r * mc * cap + t;
    if (s < len) {  // s < cap always, so this is s < min(len, cap)
      const size_t src = (size_t)off[x] + s;
#pragma unroll
      for (int c = 0; c < 6; ++c) posvel[c * S + dst] = chans[(size_t)c * M + src];
      pid_out[dst] = pid_s[src];
    } else {
      // park lattice, rounded step by step as the plain version rounds it
      posvel[dst] = __fadd_rn(base, __fmul_rn((float)t, step));
      posvel[S + dst] = __fadd_rn(base, __fmul_rn((float)r, step));
      posvel[2 * S + dst] = base;
      posvel[3 * S + dst] = 0.f;
      posvel[4 * S + dst] = 0.f;
      posvel[5 * S + dst] = 0.f;
      pid_out[dst] = -1;
    }
  }
}

}  // namespace mdnl

namespace {

int launch_expand(const void* chans, const void* pid_s, const void* keys_s,
                  const void* row_start, void* posvel, void* pid_out, int M,
                  int rows, int mc, int cap, float step, int key_base,
                  void* stream) {
  const size_t smem = (size_t)(mc + 1) * sizeof(int);
  mdnl::expand_kernel<<<rows, 256, smem, (cudaStream_t)stream>>>(
      (const float*)chans, (const int*)pid_s, (const int*)keys_s,
      (const int*)row_start, (float*)posvel, (int*)pid_out, M, rows, mc, cap,
      step, key_base);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdnl_expand(const void* chans, const void* pid_s,
                           const void* keys_s, const void* row_start,
                           void* posvel, void* pid_out, int M, int rows,
                           int mc, int cap, float step, void* stream) {
  return launch_expand(chans, pid_s, keys_s, row_start, posvel, pid_out, M,
                       rows, mc, cap, step, 0, stream);
}

// The slab form: cell keys from key_base on.
extern "C" int mdnl_expand_slab(const void* chans, const void* pid_s,
                                const void* keys_s, const void* row_start,
                                void* posvel, void* pid_out, int M, int rows,
                                int mc, int cap, float step, int key_base,
                                void* stream) {
  return launch_expand(chans, pid_s, keys_s, row_start, posvel, pid_out, M,
                       rows, mc, cap, step, key_base, stream);
}
