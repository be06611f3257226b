// K1 expand: records -> dense cap-stride slots per cell, read through the
// stable sort's permutation.
//
// Replaces md_neighbor_list_tpu/ops/dense_cells.py::_expand_kernel. The TPU
// sorts eight payloads by key because it has no gather, and its body realises
// out[c*cap + s] = rec[off_c + s] as log-step lane rolls over a DMA window.
// Here the sort carries no payload: slot s of cell c takes record
// order[off_c + s] of the unsorted stream, read by the kernel itself, so the
// rebuild makes no sorted copy of the records.
//
// One block of 128 threads per (z, y) row, so that the 1,225 rows at mc = 35
// are resident together in one wave:
//  1. Cell starts, by one coalesced pass over the row's sorted keys
//     [row_start[r], row_start[r+1]): the record at i starts every cell in
//     (key[i-1], key[i]], so each of the mc + 1 starts is written once, and
//     an empty cell takes its right-hand neighbour's start. The keys are
//     loaded four a thread before any is used; no dependent search.
//  2. The copy: a thread takes V = 4 consecutive slots of the row, loads
//     their permutation entries, then the seven words of each record, and
//     writes each channel of its four slots with one 16-byte store. A row's
//     slots start 16-byte aligned where mc*cap % 4 == 0 (mc = 35, cap = 40);
//     other caps take V = 1, scalar stores. A slot past its cell's run (or
//     past cap: runs longer than cap are truncated, and the caller's particle
//     count detects the loss) gets the park lattice, zero velocity, pid -1.
// On the H100 at mc = 35, cap = 40 the key pass took the kernel from 0.066 to
// 0.047 ms, 128 threads a block to 0.0446 (256 threads, or two blocks a row,
// within 1 % of that), the 16-byte stores to 0.0443.
//
// Cell keys start at key_base: 0 for the cube; mc*mc for a slab, whose sort
// stream also holds emigrants keyed below the owned range and foreign records
// above it (md_neighbor_list_tpu/ops/slab_kernels.py::slab_sort_expand). Row
// r's cells are keys key_base + r*mc + x; the row starts leave the records
// outside [key_base, key_base + rows*mc) out of every row, so none is read.
//
// Bound: bytes. Each record within the rows is read once (key, permutation
// entry, six channels, pid) and every slot written once (seven channels). The
// state being rebuilt was cell-sorted at the last rebuild and has moved at
// most skin/2 since, so a cell's records come mostly from consecutive slots
// of one earlier cell and the reads through the permutation nearly coalesce;
// the writes run along the row.
#include "geom.cuh"

namespace mdnl {

constexpr int kExpandThreads = 128;
constexpr int kExpandKeys = 4;  // keys a thread loads at once in pass 1

template <int V>
__device__ __forceinline__ void put(float* dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = v[j];
  }
}

template <int V>
__device__ __forceinline__ void put(int* dst, const int (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = v[j];
  }
}

// V slots a thread; mc*cap % V == 0 (the launcher picks V).
template <int V>
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const float* __restrict__ pos, const float* __restrict__ vel,
              const int* __restrict__ pid,
              const long long* __restrict__ order,
              const int* __restrict__ keys_s,
              const int* __restrict__ row_start, float* __restrict__ posvel,
              int* __restrict__ pid_out, int M, int rows, int mc, int cap,
              float step, int key_base) {
  extern __shared__ int off[];  // mc + 1 run starts of this row's cells
  const int r = blockIdx.x;
  const int lo = row_start[r], hi = row_start[r + 1];
  const int key0 = key_base + r * mc;  // the key of the row's first cell
  // 1. cell starts; i = hi stands for key mc, the end of the row. Row r holds
  // keys key0 .. key0 + mc - 1 only (row_starts): the clamps guard shared
  // memory, nothing else.
  for (int i0 = lo + threadIdx.x; i0 <= hi;
       i0 += kExpandKeys * kExpandThreads) {
    int k[kExpandKeys], prev[kExpandKeys];
#pragma unroll
    for (int u = 0; u < kExpandKeys; ++u) {
      const int i = i0 + u * kExpandThreads;
      k[u] = i < hi ? keys_s[i] - key0 : mc;
      prev[u] = i > lo && i <= hi ? keys_s[i - 1] - key0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kExpandKeys; ++u) {
      const int i = i0 + u * kExpandThreads;
      if (i > hi) break;
      const int last = min(k[u], mc);
      for (int x = max(prev[u], -1) + 1; x <= last; ++x) off[x] = i;
    }
  }
  __syncthreads();

  // 2. the copy, V consecutive slots a thread
  const int nslot = mc * cap;
  const size_t S = (size_t)rows * nslot;
  float* const out = posvel + (size_t)r * nslot;
  int* const pid_row = pid_out + (size_t)r * nslot;
  const float base = 1.0e5f;
  const float park_y = __fadd_rn(base, __fmul_rn((float)r, step));
  for (int t0 = threadIdx.x * V; t0 < nslot; t0 += kExpandThreads * V) {
    int x = t0 / cap, s = t0 - x * cap;
    int rec[V];  // the record slot t0 + j takes, or -1
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int len = off[x + 1] - off[x];
      rec[j] = s < len ? off[x] + s : -1;  // s < cap always: runs cut at cap
      if (++s == cap) { s = 0; ++x; }
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (rec[j] >= 0) rec[j] = (int)order[rec[j]];
    float v[6][V];
    int p[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (rec[j] >= 0) {
        const size_t q = (size_t)rec[j];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c][j] = pos[c * (size_t)M + q];
          v[3 + c][j] = vel[c * (size_t)M + q];
        }
        p[j] = pid[q];
      } else {
        // park lattice, rounded step by step as the plain version rounds it
        v[0][j] = __fadd_rn(base, __fmul_rn((float)(t0 + j), step));
        v[1][j] = park_y;
        v[2][j] = base;
        v[3][j] = v[4][j] = v[5][j] = 0.f;
        p[j] = -1;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) put<V>(out + c * S + t0, v[c]);
    put<V>(pid_row + t0, p);
  }
}

}  // namespace mdnl

namespace {

int launch_expand(const void* pos, const void* vel, const void* pid,
                  const void* order, const void* keys_s, const void* row_start,
                  void* posvel, void* pid_out, int M, int rows, int mc,
                  int cap, float step, int key_base, void* stream) {
  const size_t smem = (size_t)(mc + 1) * sizeof(int);
  // 16-byte aligned rows take the vector stores
  const auto kernel = (mc * cap) % 4 == 0 ? &mdnl::expand_kernel<4>
                                          : &mdnl::expand_kernel<1>;
  kernel<<<rows, mdnl::kExpandThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)vel, (const int*)pid,
      (const long long*)order, (const int*)keys_s, (const int*)row_start,
      (float*)posvel, (int*)pid_out, M, rows, mc, cap, step, key_base);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdnl_expand(const void* pos, const void* vel, const void* pid,
                           const void* order, const void* keys_s,
                           const void* row_start, void* posvel, void* pid_out,
                           int M, int rows, int mc, int cap, float step,
                           void* stream) {
  return launch_expand(pos, vel, pid, order, keys_s, row_start, posvel,
                       pid_out, M, rows, mc, cap, step, 0, stream);
}

// The slab form: cell keys from key_base on.
extern "C" int mdnl_expand_slab(const void* pos, const void* vel,
                                const void* pid, const void* order,
                                const void* keys_s, const void* row_start,
                                void* posvel, void* pid_out, int M, int rows,
                                int mc, int cap, float step, int key_base,
                                void* stream) {
  return launch_expand(pos, vel, pid, order, keys_s, row_start, posvel,
                       pid_out, M, rows, mc, cap, step, key_base, stream);
}
