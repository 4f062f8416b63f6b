// outgather (K2, and K4 as its fp64 instance): assemble y blocks from
// lane-permuted rows of the stacked partial matrix y2.
//
// Replaces dasp_tpu/ops/pallas_backend.py:_make_outgather (:437-485) and,
// as the fp64 instance, _make_outgather_dd (:378-434).
//     out[b, l] = sum_{k < K} y2[src[b, k], perm[k, b, l]]
// src (B, K) int32 names up to K source rows of y2 per 128-row output
// block (the primary SELL slice, short/medium bucket slices, long-row
// scalar rows, residue rows); an unused slot names the all-zero row
// `zero_row`.  perm (K, B, 128) int8 holds lane ids 0..127 (k-major, as
// the lowering stores it).  Instances: dasp_outgather_f32 (float y2 and
// out) and dasp_outgather_f64 (double; the reference's dd.add of hi/lo
// pairs across the K sources becomes one rounded fp64 add each).
//
// Shape on Hopper: one block of 128 x BPB threads takes BPB output blocks;
// thread l computes lane l of its block, walking the K sources in order
// (the same order as the reference and as outgather_plain, so the sums
// agree bit for bit: each add is rounded, never contracted).  Every
// thread of a block row reads the same src word, so the branch below is
// uniform across the row.
//
// Ranges: the reference launches once per og_ranges range, each at its
// own static K, because an unused slot still costs its row load there.
// Here K is a runtime loop bound, and one launch covers all of B_pad at
// k_used: a slot that names the zero row is skipped (adding the zero row
// changes nothing), which saves its y2 row read and its perm read just as
// the range split did.  So og_src/og_perm are not used on the device.
//
// Bound: bytes.  Per output word: one 4 B (8 B fp64) store plus, per used
// slot, a 1 B perm read (streamed, coalesced) and one y2 gather within one
// row (y2 of cop20k_like is ~1.4 MB f32 / 2.8 MB f64: it stays in L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int BPB = 4;          // output blocks per CUDA block

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(LANES * BPB)
outgather_kernel(const int32_t* __restrict__ src,
                 const int8_t* __restrict__ perm,
                 const T* __restrict__ y2, T* __restrict__ out,
                 int B, int K, int zero_row) {
  const int l = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * BPB + threadIdx.y;
  if (b >= B) return;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int s = src[b * K + k];
    if (s == zero_row) continue;
    const int p = (uint8_t)perm[((int64_t)k * B + b) * LANES + l];
    acc = add_rn(acc, y2[(int64_t)s * LANES + p]);
  }
  out[b * LANES + l] = acc;
}

template <typename T>
int launch(const void* src, const void* perm, const void* y2, void* out,
           int B, int K, int zero_row, void* stream) {
  if (B <= 0) return 0;
  const dim3 block(LANES, BPB);
  const dim3 grid((B + BPB - 1) / BPB);
  outgather_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int8_t*>(perm),
      static_cast<const T*>(y2), static_cast<T*>(out), B, K, zero_row);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dasp_outgather_f32(const void* src, const void* perm,
                                  const void* y2, void* out, int B, int K,
                                  int zero_row, void* stream) {
  return launch<float>(src, perm, y2, out, B, K, zero_row, stream);
}

extern "C" int dasp_outgather_f64(const void* src, const void* perm,
                                  const void* y2, void* out, int B, int K,
                                  int zero_row, void* stream) {
  return launch<double>(src, perm, y2, out, B, K, zero_row, stream);
}
