// Host-side streaming decoder of the packed neighbour-list artifact
// (ops/dense_force.py::dense_lists_half): masks (5, words, R, mc, 3*cap) i32,
// one bit per unordered pair. The bit semantics are stated once, in
// ops/decode.py's module docstring; this file mirrors them and is held
// against the numpy decoder there by the tests.
//
// Decoding is an O(pairs) irregular expansion whose consumers (I/O, analysis,
// other MD tools) live on the host, so it is host C++ and not a device
// kernel: one pass over the words, a count-trailing-zeros walk over the set
// bits, no index intermediates. The port's own copy of the JAX package's
// native/decode.cpp (the mask layout is the same, so either decoder reads
// either package's artifact).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC decode.cpp
//        (done at first use by md_neighbor_list_tpu_torch/utils/native.py).
#include <cstdint>

namespace {
// HALF_OFFSETS5 (dz, dy) of ops/dense_force.py.
constexpr int DZ[5] = {0, 0, 1, 1, 1};
constexpr int DY[5] = {0, 1, -1, 0, 1};
constexpr int MASK_BITS = 32;  // bits per mask word, ops/dense_force.py

inline uint32_t word_bit_mask(int32_t cap, int32_t w) {
  // Valid bits of word w cover own slots 32w .. min(32w+31, cap-1); the
  // kernel never sets higher bits, but masking keeps the walk defensive.
  const int32_t nbits = cap - MASK_BITS * w;
  if (nbits >= MASK_BITS) return 0xffffffffu;
  if (nbits <= 0) return 0u;
  return (1u << nbits) - 1u;
}
}  // namespace

extern "C" {

// Exact decodable-pair count: popcount of every valid bit in the artifact.
// masks: C-contiguous i32 (5, words, R=mc*mc, mc, 3*cap).
int64_t mdnl_mask_pair_count(const int32_t* masks, int32_t mc, int32_t cap,
                             int32_t words) {
  const int64_t vol = (int64_t)mc * mc * mc * 3 * cap;  // per (k, w) plane
  int64_t total = 0;
  for (int k = 0; k < 5; ++k) {
    for (int32_t w = 0; w < words; ++w) {
      const uint32_t bmask = word_bit_mask(cap, w);
      const int32_t* p = masks + ((int64_t)k * words + w) * vol;
      for (int64_t e = 0; e < vol; ++e)
        total += __builtin_popcount((uint32_t)p[e] & bmask);
    }
  }
  return total;
}

// Decode every set bit to (own pid, partner pid), preserving the kernel's
// Newton-3 attribution (the OWN slot is the row the pair is charged to).
//   masks: C-contiguous i32 (5, words, R, mc, 3*cap)
//   pid:   C-contiguous i32 (R, mc, cap), -1 marks an empty slot
// Returns pairs written; -1 if any set bit points at an empty slot
// (masks and pid are from different states); -2 if out_cap is too small.
int64_t mdnl_decode_half(const int32_t* masks, const int32_t* pid,
                         int32_t mc, int32_t cap, int32_t words,
                         int32_t* out_own, int32_t* out_partner,
                         int64_t out_cap) {
  const int64_t R = (int64_t)mc * mc;
  const int64_t lanes = 3 * (int64_t)cap;
  int64_t nout = 0;
  for (int k = 0; k < 5; ++k) {
    const int32_t dz = DZ[k], dy = DY[k];
    for (int32_t w = 0; w < words; ++w) {
      const uint32_t bmask = word_bit_mask(cap, w);
      const int32_t* plane = masks + ((int64_t)k * words + w) * R * mc * lanes;
      for (int64_t r = 0; r < R; ++r) {
        const int32_t z = (int32_t)(r / mc), y = (int32_t)(r % mc);
        const int64_t prow =
            (int64_t)((z + dz) % mc) * mc + (y + dy + mc) % mc;
        for (int32_t x = 0; x < mc; ++x) {
          const int32_t* row = plane + (r * mc + x) * lanes;
          const int64_t own_base =
              (r * mc + x) * (int64_t)cap + MASK_BITS * w;
          for (int64_t lane = 0; lane < lanes; ++lane) {
            uint32_t v = (uint32_t)row[lane] & bmask;
            if (!v) continue;
            const int32_t px =
                (int32_t)((x + (int32_t)(lane / cap) - 1 + mc) % mc);
            const int32_t pj =
                pid[(prow * mc + px) * cap + (int32_t)(lane % cap)];
            while (v) {
              const int b = __builtin_ctz(v);
              v &= v - 1;
              const int32_t pi = pid[own_base + b];
              if (pi < 0 || pj < 0) return -1;
              if (nout >= out_cap) return -2;
              out_own[nout] = pi;
              out_partner[nout] = pj;
              ++nout;
            }
          }
        }
      }
    }
  }
  return nout;
}

// Decode straight into fixed-capacity padded rows in one O(pairs) pass: no
// pair buffer, no argsort (the numpy construction stable-sorts every pair);
// each decoded pair lands at its row's running cursor.
//   idx: (n, k_cap) i32, fully overwritten (pad = sentinel n)
//   cnt: (n,)      i32, fully overwritten
//   full: nonzero -> store each pair in BOTH rows (symmetric full lists)
// Returns the max row count seen — if it exceeds k_cap the overflowing
// entries were dropped (counts stay correct) and the caller must re-call
// with k_cap >= the returned value; -1 if a set bit points at an empty
// slot; -3 if a decoded pid falls outside [0, n).
int64_t mdnl_decode_half_padded(const int32_t* masks, const int32_t* pid,
                                int32_t mc, int32_t cap, int32_t words,
                                int64_t n, int64_t k_cap, int32_t full,
                                int32_t* idx, int32_t* cnt) {
  const int64_t R = (int64_t)mc * mc;
  const int64_t lanes = 3 * (int64_t)cap;
  const int32_t pad = (int32_t)n;
  for (int64_t e = 0; e < n * k_cap; ++e) idx[e] = pad;
  for (int64_t i = 0; i < n; ++i) cnt[i] = 0;
  int64_t maxc = 0;
  for (int k = 0; k < 5; ++k) {
    const int32_t dz = DZ[k], dy = DY[k];
    for (int32_t w = 0; w < words; ++w) {
      const uint32_t bmask = word_bit_mask(cap, w);
      const int32_t* plane = masks + ((int64_t)k * words + w) * R * mc * lanes;
      for (int64_t r = 0; r < R; ++r) {
        const int32_t z = (int32_t)(r / mc), y = (int32_t)(r % mc);
        const int64_t prow =
            (int64_t)((z + dz) % mc) * mc + (y + dy + mc) % mc;
        for (int32_t x = 0; x < mc; ++x) {
          const int32_t* row = plane + (r * mc + x) * lanes;
          const int64_t own_base =
              (r * mc + x) * (int64_t)cap + MASK_BITS * w;
          for (int64_t lane = 0; lane < lanes; ++lane) {
            uint32_t v = (uint32_t)row[lane] & bmask;
            if (!v) continue;
            const int32_t px =
                (int32_t)((x + (int32_t)(lane / cap) - 1 + mc) % mc);
            const int32_t pj =
                pid[(prow * mc + px) * cap + (int32_t)(lane % cap)];
            while (v) {
              const int b = __builtin_ctz(v);
              v &= v - 1;
              const int32_t pi = pid[own_base + b];
              if (pi < 0 || pj < 0) return -1;
              if (pi >= n || pj >= n) return -3;
              int32_t c = cnt[pi]++;
              if (c < k_cap) idx[(int64_t)pi * k_cap + c] = pj;
              if (c + 1 > maxc) maxc = c + 1;
              if (full) {
                c = cnt[pj]++;
                if (c < k_cap) idx[(int64_t)pj * k_cap + c] = pi;
                if (c + 1 > maxc) maxc = c + 1;
              }
            }
          }
        }
      }
    }
  }
  return maxc;
}

}  // extern "C"
