// resident_probe (T4): does a chained loop re-read a stream that fits the
// 50 MB L2 from L2?
//
// Replaces tools/resident_probe.py:make (:27-62), the TPU probe of VMEM
// residency.  Per vreg (an 8x128 tile of f32 values and int16 idx), slot
// (i, j) gathers x[q, lam] from a fixed 64-row x table, lam = idx & 127
// and q = (cell >> 7) & 7 read at the cell (i, lam), as K1 reads it; the
// products are summed over the 8 sublanes in order: out (nv, 128).  One
// cooperative launch runs `iters` sweeps over the whole stream, with a
// grid-wide barrier between sweeps, as K6 runs its steps: every sweep
// re-reads all of vals and idx, and only the L2 can keep them between
// sweeps.  The x table (32 KB, 4 KB of it used) stays on chip.
//
// Bound: bytes.  6 B per slot streamed (4 B value, 2 B idx) plus 0.5 B per
// slot of output; a sweep whose stream comes from device memory runs at
// most at the copy rate, one served from L2 may run faster.
// resident_probe_plain (dasp_tpu_torch/probes/resident_probe.py) sums in
// the same order; each product and sum is rounded, never contracted.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int VPB = 4;          // vregs per block (512 threads)

__global__ void __launch_bounds__(LANES * VPB)
probe_kernel(const float* __restrict__ vals, const int16_t* __restrict__ idx,
             const float* __restrict__ x, float* __restrict__ out,
             int64_t nv, int iters) {
  __shared__ int16_t tile[VPB][SUB][LANES];
  cg::grid_group grid = cg::this_grid();
  const int j = threadIdx.x;
  const int t = threadIdx.y;
  for (int it = 0; it < iters; ++it) {
    for (int64_t g = blockIdx.x; g * VPB < nv; g += gridDim.x) {
      const int64_t v = g * VPB + t;
      const bool live = v < nv;
      const int64_t base = v * SUB * LANES;
      if (live) {
#pragma unroll
        for (int i = 0; i < SUB; ++i) tile[t][i][j] = idx[base + i * LANES + j];
      }
      __syncthreads();
      if (live) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          const int lam = (int)tile[t][i][j] & 127;
          const int q = ((int)tile[t][i][lam] >> 7) & 7;
          acc = add_rn(acc, mul_rn(vals[base + i * LANES + j],
                                   x[q * LANES + lam]));
        }
        out[v * LANES + j] = acc;
      }
      __syncthreads();
    }
    if (it + 1 < iters) grid.sync();
  }
}

}  // namespace

extern "C" int dasp_resident_probe(const void* vals, const void* idx,
                                   const void* x, void* out, long long nv,
                                   int iters, void* stream) {
  if (nv <= 0 || iters < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                      LANES * VPB, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)std::max<long long>(
      1, std::min<long long>((nv + VPB - 1) / VPB, (long long)per_sm * sms));
  const float* v = static_cast<const float*>(vals);
  const int16_t* ix = static_cast<const int16_t*>(idx);
  const float* xp = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  int64_t n = nv;
  void* args[] = {&v, &ix, &xp, &o, &n, &iters};
  e = cudaLaunchCooperativeKernel((const void*)probe_kernel, dim3(grid),
                                  dim3(LANES, VPB), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
