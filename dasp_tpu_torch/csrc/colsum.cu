// colsum (K1, and K3 as its fp64 instance): per-vreg windowed-gather
// products and per-level column sums.
//
// Replaces dasp_tpu/ops/pallas_backend.py:_make_colsum (:121-160, body
// _colsum_body :63-118) and, as the fp64 instance, _make_colsum_dd
// (:277-375).  A stream is NV "vregs", each an 8x128 tile of values and
// int16 slot metadata idx = c<<10 | q<<7 | lam.  Slot (i, j) of vreg v
// multiplies vals[v,i,j] by
//     x2d[wins[v, 1 + c] + q, lam],   lam = idx[v,i,j] & 127,
// where q = (cell>>7)&7 and c = cell>>10 are read at the CELL (i, lam) of
// the same tile, not at (i, j): one cell names one x word, and every slot
// of a sublane that gathers lane lam shares it (wplan.py).  The products
// of each group of `stride` sublanes are summed, giving R = 8/stride
// output rows per vreg: out (NV*R, 128).
//
// Instances (value type / x, sum and output type):
//   dasp_colsum_f32   float          / float
//   dasp_colsum_bf16  __nv_bfloat16  / float   (value upcast, exact)
//   dasp_colsum_f64   double         / double  (K3)
// The reference runs fp64 as double-double f32 pairs because the TPU has
// no fp64 datapath; Hopper has one, so K3 is this kernel in fp64: one
// value array, one x table, one partials array, no compensated sums.
//
// Shape on Hopper: one block of 128 x VPB threads takes VPB vregs; thread
// j owns lane column j of its vreg.  The vreg's 8x128 idx tile (2 KB) is
// staged in shared memory so that thread j can read the cell (i, lam)
// another thread loaded.  Thread j walks the 8 sublanes and keeps the R
// level sums in registers (stride is a template parameter, so the level
// of sublane i is a compile-time constant), then writes R coalesced rows.
// No shuffles, no atomics, no sequential grid.
//
// Bound: bytes.  Per slot the value (4 B f32, 2 B bf16, 8 B f64) and 2 B
// of idx are streamed once and one x word is gathered; the x table (0.5 MB
// f32 / 1 MB f64 for cop20k_like) stays in the 50 MB L2, so the stream of
// vals+idx from device memory sets the time: 6, 4 and 10 B per slot.
// vals/idx loads are 128 consecutive words per sublane (coalesced); the x
// gather hits 8 distinct rows per vreg at most.
//
// Traps handled: idx is upcast to int before shifting (values are
// non-negative, c <= 31, so idx < 2^15); P is a runtime argument (the row
// stride of wins), not an unroll; the round tag is clamped to P-1, which
// is what the reference does at P=1 (it reads window 1 whatever the tag)
// and a no-op for the tags the packer emits; pad vregs (all-zero tiles)
// give zero rows; NV need not be a multiple of VPB (tail masked).  Each
// product is rounded and then added (mul_rn / add_rn below): nvcc would
// otherwise contract a*x + acc into an FMA, and the level sums would no
// longer equal colsum_plain's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"

namespace {

constexpr int VPB = 4;          // vregs per block (512 threads)

template <typename V, typename A, int STRIDE>
__global__ void __launch_bounds__(LANES * VPB)
colsum_kernel(const int32_t* __restrict__ wins, const V* __restrict__ vals,
              const int16_t* __restrict__ idx, const A* __restrict__ x2d,
              A* __restrict__ out, int nv, int P) {
  constexpr int R = SUB / STRIDE;
  __shared__ int16_t tile[VPB][SUB][LANES];
  const int j = threadIdx.x;
  const int t = threadIdx.y;
  const int64_t v = (int64_t)blockIdx.x * VPB + t;
  const bool live = v < nv;
  const int64_t base = v * SUB * LANES;
  if (live) {
#pragma unroll
    for (int i = 0; i < SUB; ++i) tile[t][i][j] = idx[base + i * LANES + j];
  }
  __syncthreads();
  if (!live) return;

  const int32_t* w = wins + v * (P + 1) + 1;
  A acc[R];
#pragma unroll
  for (int L = 0; L < R; ++L) acc[L] = A(0);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int lam = (int)tile[t][i][j] & 127;
    const A xv = x2d[x_row(tile[t][i], lam, w, P) * LANES + lam];
    acc[i / STRIDE] = add_rn(acc[i / STRIDE],
                             mul_rn(widen(vals[base + i * LANES + j]), xv));
  }
  A* o = out + v * R * LANES + j;
#pragma unroll
  for (int L = 0; L < R; ++L) o[L * LANES] = acc[L];
}

template <typename V, typename A>
int launch(const void* wins, const void* vals, const void* idx,
           const void* x2d, void* out, int nv, int P, int stride,
           void* stream) {
  if (nv <= 0) return 0;
  const dim3 block(LANES, VPB);
  const dim3 grid((nv + VPB - 1) / VPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(wins);
  auto a = static_cast<const V*>(vals);
  auto ix = static_cast<const int16_t*>(idx);
  auto x = static_cast<const A*>(x2d);
  auto o = static_cast<A*>(out);
  switch (stride) {
    case 2: colsum_kernel<V, A, 2><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P); break;
    case 4: colsum_kernel<V, A, 4><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P); break;
    case 8: colsum_kernel<V, A, 8><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dasp_colsum_f32(const void* wins, const void* vals,
                               const void* idx, const void* x2d, void* out,
                               int nv, int P, int stride, void* stream) {
  return launch<float, float>(wins, vals, idx, x2d, out, nv, P, stride,
                              stream);
}

extern "C" int dasp_colsum_bf16(const void* wins, const void* vals,
                                const void* idx, const void* x2d, void* out,
                                int nv, int P, int stride, void* stream) {
  return launch<__nv_bfloat16, float>(wins, vals, idx, x2d, out, nv, P,
                                      stride, stream);
}

extern "C" int dasp_colsum_f64(const void* wins, const void* vals,
                               const void* idx, const void* x2d, void* out,
                               int nv, int P, int stride, void* stream) {
  return launch<double, double>(wins, vals, idx, x2d, out, nv, P, stride,
                                stream);
}

extern "C" const char* dasp_cuda_error_name(int rc) {
  return cudaGetErrorName(static_cast<cudaError_t>(rc));
}
