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
// Ranges: the reference launches once per og_ranges range, each at its
// own static K, because an unused slot still costs its row load there.
// Here one launch covers all of B_pad at k_used: a slot that names the
// zero row is dropped before its gathers (adding the zero row changes
// nothing), which saves its y2 and perm reads just as the range split
// did.  So og_src/og_perm are not used on the device.
//
// Batch: an SpMM pass gathers the y2 of its kv vectors through the same
// src and perm, so the launcher takes (nb, rows, 128) and runs the batch
// as the grid's second dimension over the same body: one launch a pass.
//
// Bound on this card: latency, not bytes.  Per output word the kernel
// must move one 4 B (8 B fp64) store and, per used slot, a 1 B perm read
// and one y2 gather (y2 of cop20k_like is ~1.4 MB f32: it stays in L2):
// 0.4 / 3.1 us at cop20k_like / webbase_like shapes in f32 at the copy
// rate, less than one graph-replayed launch on cop20k_like.  What is left
// is the chain src -> perm -> y2 of dependent loads.  The first design
// (one thread per lane walking the slots, which the compiler served one
// slot's loads at a time) paid that chain once per slot.  This one runs
// the body of outgather_common.cuh: a group of threads per output block,
// 16 bytes of the block's row per thread, every slot's perm word and
// gathers in flight before the first add, so a block costs three round
// trips whatever its K.  Measured with chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W, 20 launches captured in one graph, at cop20k_like /
// webbase_like: f32 2.2 / 3.9 us, f64 2.4 / 5.2, against 2.7-2.8 / 6.3-6.4
// and 2.8-2.9 / 6.6-6.7 for the first design on the same card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "outgather_common.cuh"

namespace {

constexpr int WPB = 8;          // output blocks per CUDA block

// blockIdx.y names the vector of a batch: y2 is (nb, rows, 128) and out
// (nb, B, 128), src and perm are shared by the batch (nb = 1: one SpMV).
template <typename T>
__global__ void __launch_bounds__(og_threads<T>() * WPB)
outgather_kernel(const int32_t* __restrict__ src,
                 const int8_t* __restrict__ perm,
                 const T* __restrict__ y2, T* __restrict__ out,
                 int B, int K, int zero_row, int64_t y2_words) {
  const int64_t b = (int64_t)blockIdx.x * WPB + threadIdx.y;
  if (b >= B) return;
  outgather_block<T>(src, perm, y2 + blockIdx.y * y2_words,
                     out + blockIdx.y * (int64_t)B * OG_LANES, b, B, K,
                     zero_row, threadIdx.x);
}

template <typename T>
int launch(const void* src, const void* perm, const void* y2, void* out,
           int B, int K, int zero_row, int nb, long long y2_words,
           void* stream) {
  if (B <= 0 || nb <= 0) return 0;
  if (K > OG_KMAX || nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(og_threads<T>(), WPB);
  const dim3 grid((B + WPB - 1) / WPB, nb);
  outgather_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int8_t*>(perm),
      static_cast<const T*>(y2), static_cast<T*>(out), B, K, zero_row,
      (int64_t)y2_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dasp_outgather_f32(const void* src, const void* perm,
                                  const void* y2, void* out, int B, int K,
                                  int zero_row, int nb, long long y2_words,
                                  void* stream) {
  return launch<float>(src, perm, y2, out, B, K, zero_row, nb, y2_words,
                       stream);
}

extern "C" int dasp_outgather_f64(const void* src, const void* perm,
                                  const void* y2, void* out, int B, int K,
                                  int zero_row, int nb, long long y2_words,
                                  void* stream) {
  return launch<double>(src, perm, y2, out, B, K, zero_row, nb, y2_words,
                        stream);
}
