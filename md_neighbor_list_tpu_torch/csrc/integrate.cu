// The NVE step's integrator: the kicks, the drift and the displacement vote
// of `models/dense_lj.py::DenseSimulator._step`, as two passes over the dense
// slot arrays (3, R, mc, cap).
//
// Replaces no Pallas kernel: the JAX step (md_neighbor_list_tpu/models/
// dense_lj.py, `step`) writes the half kick, the drift and the vote as array
// expressions, which XLA fuses. Plain PyTorch ran them as ten launches, each
// reading and writing whole slot arrays (vel.add_, pos.add_, the difference,
// square, sum, mask, where, max and compare, vel.add_ again).
//
//  kick_drift_vote: vel += (0.5 dt) force, pos += dt vel and, in the form
//    with the vote, d2 = |pos - ref_pos|^2 of each occupied slot (pid >= 0),
//    raising `*flag` where 4 d2 > skin^2: that is the plain vote's
//    `4 max(d2) > skin^2`, since times 4 is exact and some slot is over the
//    limit exactly when the largest is. `*flag` must be false before; the
//    step's closing `kick` lowers it again. The form without the vote is the
//    step of a configuration that rebuilds every step.
//  kick: vel += (0.5 dt) force after the step's force, lowering `*flag`
//    (if given) from its first thread.
//
// Bits: the plain versions (`ops/integrate.py`) are PyTorch's `add_` with an
// alpha, which the card computes as one fused multiply-add, and the vote's
// products rounded, then summed (x + y) + z as `torch.sum(dim=0)` does. Each
// is written out here (`__fmaf_rn`, `__fmul_rn`, `__fadd_rn`), so the
// compiler's contraction decides nothing, and the two give the same bits.
// One difference: a NaN displacement makes the plain maximum NaN, and so no
// vote; here it does not hide another slot's.
//
// Bound: bytes. Over every slot the vote pass reads force, vel, pos and
// ref_pos and writes vel and pos, 72 bytes, and pid, 4; the kick reads force
// and vel and writes vel, 36 bytes, and pid. About half the slots are empty
// at cap 40 (19.7-23.3 particles a cell in the benchmark's configurations),
// and an empty slot holds the park invariant (ops/dense_cells.py): zero
// velocity and exactly zero force, so the plain sequence leaves it as it is.
// Each thread therefore reads the pids of four slots first (16 bytes, as
// every load here) and skips their arrays where none holds a particle; two
// neighbouring threads, whose 16 bytes share a 32-byte sector of each plane,
// decide together, so a sector is read and written whole or not at all. What
// must move is then pid over every slot and 72 (36) bytes over the occupied
// slots' sectors. One thread a group of four slots, neighbouring threads on
// neighbouring groups; the vote is one `__syncthreads_or` a block and one
// store of the block's result. A slot count that is no multiple of four, or
// an array off 16-byte alignment, takes the same body a slot a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdnl {

constexpr int kIntegrateThreads = 256;

template <int V>
struct Lanes;

template <>
struct Lanes<4> {
  using F = float4;
  using I = int4;
  __device__ static float& at(F& v, int j) { return (&v.x)[j]; }
  __device__ static float at(const F& v, int j) { return (&v.x)[j]; }
  __device__ static int at(const I& v, int j) { return (&v.x)[j]; }
};

template <>
struct Lanes<1> {
  using F = float;
  using I = int;
  __device__ static float& at(F& v, int) { return v; }
  __device__ static float at(const F& v, int) { return v; }
  __device__ static int at(const I& v, int) { return v; }
};

// Whether the thread's group holds a particle, decided with its sector
// partner (V = 4: the neighbouring lane); false past the last group.
template <int V>
__device__ __forceinline__ bool group_held(const int* __restrict__ pid,
                                           long long g, long long groups,
                                           typename Lanes<V>::I& p) {
  using L = Lanes<V>;
  bool held = false;
  if (g < groups) {
    p = __ldg(reinterpret_cast<const typename L::I*>(pid) + g);
#pragma unroll
    for (int j = 0; j < V; ++j) held |= L::at(p, j) >= 0;
  }
  if (V > 1) held |= __shfl_xor_sync(0xffffffffu, held, 1);
  return held && g < groups;
}

template <bool VOTE, int V>
__global__ void __launch_bounds__(kIntegrateThreads)
kick_drift_vote_kernel(float* __restrict__ vel, float* __restrict__ pos,
                       const float* __restrict__ force,
                       const float* __restrict__ ref,
                       const int* __restrict__ pid, bool* __restrict__ flag,
                       long long slots, float half_dt, float dt, float thr) {
  using L = Lanes<V>;
  using F = typename L::F;
  const long long groups = slots / V;
  const long long g = (long long)blockIdx.x * kIntegrateThreads + threadIdx.x;
  typename L::I p{};
  bool over = false;
  if (group_held<V>(pid, g, groups, p)) {
    F f[3], v[3], x[3], r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long at = c * groups + g;
      f[c] = __ldg(reinterpret_cast<const F*>(force) + at);
      v[c] = reinterpret_cast<const F*>(vel)[at];
      x[c] = reinterpret_cast<const F*>(pos)[at];
      if (VOTE) r[c] = __ldg(reinterpret_cast<const F*>(ref) + at);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        L::at(v[c], j) = __fmaf_rn(half_dt, L::at(f[c], j), L::at(v[c], j));
        L::at(x[c], j) = __fmaf_rn(dt, L::at(v[c], j), L::at(x[c], j));
      }
      const long long at = c * groups + g;
      reinterpret_cast<F*>(vel)[at] = v[c];
      reinterpret_cast<F*>(pos)[at] = x[c];
    }
    if (VOTE) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float sq[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float d = __fsub_rn(L::at(x[c], j), L::at(r[c], j));
          sq[c] = __fmul_rn(d, d);
        }
        const float d2 = __fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]);
        over |= L::at(p, j) >= 0 && __fmul_rn(4.0f, d2) > thr;
      }
    }
  }
  if (VOTE && __syncthreads_or(over) && threadIdx.x == 0) *flag = true;
}

template <int V>
__global__ void __launch_bounds__(kIntegrateThreads)
kick_kernel(float* __restrict__ vel, const float* __restrict__ force,
            const int* __restrict__ pid, bool* __restrict__ flag,
            long long slots, float half_dt) {
  using L = Lanes<V>;
  using F = typename L::F;
  const long long groups = slots / V;
  const long long g = (long long)blockIdx.x * kIntegrateThreads + threadIdx.x;
  if (flag != nullptr && g == 0) *flag = false;
  typename L::I p{};
  if (!group_held<V>(pid, g, groups, p)) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const long long at = c * groups + g;
    const F f = __ldg(reinterpret_cast<const F*>(force) + at);
    F v = reinterpret_cast<const F*>(vel)[at];
#pragma unroll
    for (int j = 0; j < V; ++j)
      L::at(v, j) = __fmaf_rn(half_dt, L::at(f, j), L::at(v, j));
    reinterpret_cast<F*>(vel)[at] = v;
  }
}

// Four slots a thread where every plane of every array starts on 16 bytes.
inline bool by_four(long long slots, const void* const* ptrs, int n) {
  if (slots % 4 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return false;
  return true;
}

inline unsigned blocks_for(long long groups) {
  return (unsigned)((groups + kIntegrateThreads - 1) / kIntegrateThreads);
}

}  // namespace mdnl

// `flag` null: the form without the vote (`ref` is not read).
extern "C" int mdnl_kick_drift_vote(void* vel, void* pos, const void* force,
                                    const void* ref, const void* pid,
                                    void* flag, int slots, float half_dt,
                                    float dt, float thr, void* stream_) {
  using namespace mdnl;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (slots <= 0) return cudaSuccess;
  const void* ptrs[] = {vel, pos, force, ref, pid};
  float* v = static_cast<float*>(vel);
  float* x = static_cast<float*>(pos);
  const float* f = static_cast<const float*>(force);
  const float* r = static_cast<const float*>(ref);
  const int* p = static_cast<const int*>(pid);
  bool* b = static_cast<bool*>(flag);
  const long long n = slots;
  if (by_four(n, ptrs, 5)) {
    const unsigned grid = blocks_for(n / 4);
    if (b != nullptr)
      kick_drift_vote_kernel<true, 4><<<grid, kIntegrateThreads, 0, stream>>>(
          v, x, f, r, p, b, n, half_dt, dt, thr);
    else
      kick_drift_vote_kernel<false, 4><<<grid, kIntegrateThreads, 0, stream>>>(
          v, x, f, r, p, b, n, half_dt, dt, thr);
  } else {
    const unsigned grid = blocks_for(n);
    if (b != nullptr)
      kick_drift_vote_kernel<true, 1><<<grid, kIntegrateThreads, 0, stream>>>(
          v, x, f, r, p, b, n, half_dt, dt, thr);
    else
      kick_drift_vote_kernel<false, 1><<<grid, kIntegrateThreads, 0, stream>>>(
          v, x, f, r, p, b, n, half_dt, dt, thr);
  }
  return cudaGetLastError();
}

// `flag` null: nothing to lower.
extern "C" int mdnl_kick(void* vel, const void* force, const void* pid,
                         void* flag, int slots, float half_dt, void* stream_) {
  using namespace mdnl;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (slots <= 0) return cudaSuccess;
  const void* ptrs[] = {vel, force, pid};
  float* v = static_cast<float*>(vel);
  const float* f = static_cast<const float*>(force);
  const int* p = static_cast<const int*>(pid);
  bool* b = static_cast<bool*>(flag);
  const long long n = slots;
  if (by_four(n, ptrs, 3))
    kick_kernel<4><<<blocks_for(n / 4), kIntegrateThreads, 0, stream>>>(
        v, f, p, b, n, half_dt);
  else
    kick_kernel<1><<<blocks_for(n), kIntegrateThreads, 0, stream>>>(
        v, f, p, b, n, half_dt);
  return cudaGetLastError();
}
