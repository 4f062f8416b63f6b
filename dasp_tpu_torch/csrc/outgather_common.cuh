// One output block of the outgather: the body shared by outgather.cu (K2,
// K4) and resident.cu (K6's phase D).
//
//     out[b, l] = sum_{k < K} y2[src[b, k], perm[k, b, l]]
//
// A group of threads per output block, each owning 16 bytes of the block's
// row (4 lanes of f32: one warp a block; 2 lanes of f64: two warps) and
// reading their perm bytes as one word.  The block's src row is read once;
// a slot that names the zero row reads no perm word (the branch is
// uniform across the group: every thread reads the same src words), and a
// block with no used slot writes its zeros at once.  For each chunk, every perm word and then
// every y2 gather is issued before the first add, so a lane has
// 4 x OG_CHUNK (f32) or 2 x OG_CHUNK (f64) gathers in flight where the
// one-slot loop had one (K6's instances of two lane columns a thread, with
// half as many threads, take chunks of 2 x OG_CHUNK slots).  The
// adds run in slot order from zero, each rounded, and a dropped slot adds
// the zero row's zero (outgather_plain adds it too), so the sums equal
// outgather_plain's.
//
// K6's last step passes its COO residue too (res_bptr non-null): the
// thread that owns lane l of block b adds the row's residue sum, rsum[i]
// for the entry i * 128 + l of the block's range, to its sum after the
// last slot, so each output word still has one writer.
//
// y2 and rsum are read with plain loads, never through the read-only path:
// K6 writes them in the same launch.  perm and out must be 4- and 16-byte aligned
// (the wrappers check perm; out is their own allocation).  Lanes per
// thread were tried at 1, 2 and 4 for both types on an NVIDIA H100 80GB
// HBM3: 16 bytes a thread was the fastest for each (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OG_LANES = 128;
constexpr int OG_CHUNK = 4;     // slots whose loads are in flight together
constexpr int OG_KMAX = 8;      // slots a block may have (K_SOURCES = 7)

// Each thread owns 16 bytes of an output block's row: 4 lanes of f32, 2 of
// f64, so a group of og_threads<T>() threads takes one output block.
template <typename T>
__host__ __device__ constexpr int og_lanes() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int og_threads() {
  return OG_LANES / og_lanes<T>();
}

template <typename T>
struct alignas(16) OgVec {
  T v[og_lanes<T>()];
};

__device__ __forceinline__ float og_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double og_add(double a, double b) {
  return __dadd_rn(a, b);
}

// the perm bytes of a thread's lanes, as one word
template <int L>
__device__ __forceinline__ uint32_t og_perm(const int8_t* row, int lane) {
  if (L == 4) return __ldg(reinterpret_cast<const uint32_t*>(row) + lane);
  return __ldg(reinterpret_cast<const unsigned short*>(row) + lane);
}

// output block b, by the og_threads<T>() threads of a group (lane = the
// thread's index in it), CHUNK slots' loads in flight.  The gathers and
// adds are unconditional, so that the compiler issues every load of a
// chunk before its first add: a zero-row slot (and a slot past K in the
// last chunk) gathers word 0 of the zero row and adds that zero, which
// changes no sum; only its perm word is not read.
template <typename T, int CHUNK = OG_CHUNK>
__device__ __forceinline__ void outgather_block(
    const int32_t* __restrict__ src, const int8_t* __restrict__ perm,
    const T* y2, T* out, int64_t b, int B, int K, int zero_row, int lane,
    const int32_t* __restrict__ res_bptr = nullptr,
    const int32_t* __restrict__ res_bent = nullptr, const T* rsum = nullptr) {
  constexpr int L = og_lanes<T>();
  int s[OG_KMAX];
  bool any = false;
#pragma unroll
  for (int k = 0; k < OG_KMAX; ++k) {
    s[k] = k < K ? __ldg(src + b * K + k) : zero_row;
    any |= s[k] != zero_row;
  }
  OgVec<T> acc;
#pragma unroll
  for (int q = 0; q < L; ++q) acc.v[q] = T(0);
  if (any) {                    // uniform in the group: one src row
#pragma unroll
    for (int k0 = 0; k0 < OG_KMAX; k0 += CHUNK) {
      if (k0 >= K) break;
      uint32_t pw[CHUNK];
      T v[CHUNK][L];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        pw[u] = s[k0 + u] != zero_row
                    ? og_perm<L>(perm + ((int64_t)(k0 + u) * B + b) *
                                            OG_LANES, lane)
                    : 0u;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
#pragma unroll
        for (int q = 0; q < L; ++q)
          v[u][q] = y2[(int64_t)s[k0 + u] * OG_LANES +
                       ((pw[u] >> (8 * q)) & 255)];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
#pragma unroll
        for (int q = 0; q < L; ++q) acc.v[q] = og_add(acc.v[q], v[u][q]);
    }
  }
  if (res_bptr) {                // the residue rows of block b
    const int r1 = __ldg(res_bptr + b + 1);
    for (int r = __ldg(res_bptr + b); r < r1; ++r) {
      const int e = __ldg(res_bent + r);
      const int q = (e & (OG_LANES - 1)) - lane * L;
#pragma unroll
      for (int u = 0; u < L; ++u)
        if (u == q) acc.v[u] = og_add(acc.v[u], rsum[e >> 7]);
    }
  }
  reinterpret_cast<OgVec<T>*>(out + b * OG_LANES)[lane] = acc;
}

}  // namespace
