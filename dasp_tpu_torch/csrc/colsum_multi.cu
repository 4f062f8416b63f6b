// colsum_multi (K5): the colsum of K1/K3 against kv stacked x tables, for
// SpMM (Y = A X, X with kv columns at a time).
//
// Replaces dasp_tpu/ops/pallas_backend.py:_make_colsum_multi (:174-249).
// x3d is (kv*S, 128): table j (column j of X, as an x2d table) starts at
// row j*S, and the windows in wins are row offsets WITHIN one table, so
// slot (i, lam) of vreg v gathers x3d[j*S + wins[v, 1+c] + q, lam] for
// every j (q and c read at the cell (i, lam), as in colsum.cu).  The
// output is (kv, NV*R, 128): slice j is exactly what K1 (or K3) computes
// on table j.
//
// Instances (value type / x, sum and output type), kv in {1, 2, 4, 8}:
//   dasp_colsum_multi_f32   float          / float
//   dasp_colsum_multi_bf16  __nv_bfloat16  / float
//   dasp_colsum_multi_f64   double         / double
// The reference's fp64 SpMM tier (spmm_fn_dd, :1043) runs this kernel
// twice in f32 on hi/lo cross products; Hopper has fp64, so one fp64 pass
// replaces it, without that tier's 2^-24-of-row-mass error.
//
// Shape on Hopper: K1's (one block of 128 x VPB threads, VPB vregs, thread
// j owns lane column j, the idx tile staged in shared memory for the cell
// lookup).  Each thread loads its slot's value and idx word ONCE and
// resolves the slot's x row once, then takes the kv products; the kv*R
// level sums stay in registers (kv and stride are template parameters: at
// most 8 x 4 doubles).  The products and adds run in K1's order with
// rounded mul/add, so slice j equals K1 (K3) on table j bit for bit.
//
// Bound: bytes.  The A stream (value + 2 B idx per slot) is read once per
// kv vectors instead of once per vector, so its bytes per vector fall by
// kv x; the kv x gathers per slot hit L2 (kv tables of 0.5 MB f32 / 1 MB
// f64 at cop20k_like), and the output (kv x K1's) is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"

namespace {

constexpr int VPB = 4;          // vregs per block (512 threads)

template <typename V, typename A, int STRIDE, int KV>
__global__ void __launch_bounds__(LANES * VPB)
colsum_multi_kernel(const int32_t* __restrict__ wins,
                    const V* __restrict__ vals,
                    const int16_t* __restrict__ idx,
                    const A* __restrict__ x3d, A* __restrict__ out, int nv,
                    int P, int S) {
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
  const int64_t table = (int64_t)S * LANES;      // words per x table
  A acc[KV][R];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
#pragma unroll
    for (int L = 0; L < R; ++L) acc[k][L] = A(0);
  }
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int lam = (int)tile[t][i][j] & 127;
    const A* xp = x3d + x_row(tile[t][i], lam, w, P) * LANES + lam;
    const A a = widen(vals[base + i * LANES + j]);
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      acc[k][i / STRIDE] = add_rn(acc[k][i / STRIDE],
                                  mul_rn(a, xp[k * table]));
    }
  }
  const int64_t rows = (int64_t)nv * R;          // rows per output slice
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    A* o = out + (k * rows + v * R) * LANES + j;
#pragma unroll
    for (int L = 0; L < R; ++L) o[L * LANES] = acc[k][L];
  }
}

template <typename V, typename A, int STRIDE>
void launch_kv(int kv, dim3 grid, dim3 block, cudaStream_t s,
               const int32_t* w, const V* a, const int16_t* ix, const A* x,
               A* o, int nv, int P, int S) {
  switch (kv) {
    case 1: colsum_multi_kernel<V, A, STRIDE, 1><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P, S); break;
    case 2: colsum_multi_kernel<V, A, STRIDE, 2><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P, S); break;
    case 4: colsum_multi_kernel<V, A, STRIDE, 4><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P, S); break;
    case 8: colsum_multi_kernel<V, A, STRIDE, 8><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P, S); break;
  }
}

template <typename V, typename A>
int launch(const void* wins, const void* vals, const void* idx,
           const void* x3d, void* out, int nv, int P, int stride, int S,
           int kv, void* stream) {
  if (nv <= 0) return 0;
  if (kv != 1 && kv != 2 && kv != 4 && kv != 8) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(LANES, VPB);
  const dim3 grid((nv + VPB - 1) / VPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(wins);
  auto a = static_cast<const V*>(vals);
  auto ix = static_cast<const int16_t*>(idx);
  auto x = static_cast<const A*>(x3d);
  auto o = static_cast<A*>(out);
  switch (stride) {
    case 2: launch_kv<V, A, 2>(kv, grid, block, s, w, a, ix, x, o, nv, P, S); break;
    case 4: launch_kv<V, A, 4>(kv, grid, block, s, w, a, ix, x, o, nv, P, S); break;
    case 8: launch_kv<V, A, 8>(kv, grid, block, s, w, a, ix, x, o, nv, P, S); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dasp_colsum_multi_f32(const void* wins, const void* vals,
                                     const void* idx, const void* x3d,
                                     void* out, int nv, int P, int stride,
                                     int S, int kv, void* stream) {
  return launch<float, float>(wins, vals, idx, x3d, out, nv, P, stride, S,
                              kv, stream);
}

extern "C" int dasp_colsum_multi_bf16(const void* wins, const void* vals,
                                      const void* idx, const void* x3d,
                                      void* out, int nv, int P, int stride,
                                      int S, int kv, void* stream) {
  return launch<__nv_bfloat16, float>(wins, vals, idx, x3d, out, nv, P,
                                      stride, S, kv, stream);
}

extern "C" int dasp_colsum_multi_f64(const void* wins, const void* vals,
                                     const void* idx, const void* x3d,
                                     void* out, int nv, int P, int stride,
                                     int S, int kv, void* stream) {
  return launch<double, double>(wins, vals, idx, x3d, out, nv, P, stride, S,
                                kv, stream);
}
