// gather_probe (T1): what a gather costs on Hopper, against a plain stream.
//
// Replaces tools/gather_bench.py:pallas_stream_op (:46-65) with its three
// kernel bodies (:76, :81-82, :87-88).  The stream is R rows of 128 int32
// idx; the table xw is (2048, 128) f32 (1 MB); out is (R, 128) f32:
//   copy     out[r, j] = float(idx[r, j] * 2)             (reads no table)
//   lane     out[r, j] = xw[r mod 2048, idx[r, j]]        (idx in [0, 128))
//   sublane  out[r, j] = xw[idx[r, j], j]                 (idx in [0, 2048))
// On the TPU the table block index is constant (:58), so the lane gather
// of stream row r reads table row r mod 2048 of the block, not a global
// row.  The kernels do no bounds checks: idx must lie in the table.
//
// Shape on Hopper: one thread per element, a block of 128 x RPB threads
// takes RPB stream rows; idx loads and out stores are 128 consecutive
// words per row (coalesced).
//   lane:    the block stages its RPB table rows (512 B each) in shared
//            memory and gathers from there: the shared-memory gather.
//   sublane: the 1 MB table exceeds the 227 KB of shared memory a block
//            may use, so the gather reads device memory through L2 and
//            the read-only path (__ldg): the L2 gather.
// Bound: bytes.  8 B per element streamed (idx in, out back) as the tool
// counts them; the table (1 MB) stays in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int TABLE_ROWS = 2048;  // the tool's block B (:46)
constexpr int RPB = 4;            // stream rows per block (512 threads)

enum Body { COPY = 0, LANE = 1, SUBLANE = 2 };

template <int BODY>
__global__ void __launch_bounds__(LANES * RPB)
gather_kernel(const int32_t* __restrict__ idx, const float* __restrict__ xw,
              float* __restrict__ out, int rows) {
  __shared__ float row[RPB][LANES];
  const int j = threadIdx.x;
  const int t = threadIdx.y;
  const int64_t r = (int64_t)blockIdx.x * RPB + t;
  const bool live = r < rows;
  const int64_t e = r * LANES + j;
  if (BODY == LANE) {
    if (live) row[t][j] = xw[(r % TABLE_ROWS) * LANES + j];
    __syncthreads();
  }
  if (!live) return;
  const int i = idx[e];
  if (BODY == COPY) {
    out[e] = (float)(int32_t)((uint32_t)i * 2u);  // wraps as int32 does
  } else if (BODY == LANE) {
    out[e] = row[t][i];
  } else {
    out[e] = __ldg(xw + (int64_t)i * LANES + j);
  }
}

}  // namespace

extern "C" int dasp_gather_probe(const void* idx, const void* xw, void* out,
                                 int rows, int body, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(LANES, RPB);
  const dim3 grid((rows + RPB - 1) / RPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  auto x = static_cast<const float*>(xw);
  auto o = static_cast<float*>(out);
  switch (body) {
    case COPY: gather_kernel<COPY><<<grid, block, 0, s>>>(ix, x, o, rows); break;
    case LANE: gather_kernel<LANE><<<grid, block, 0, s>>>(ix, x, o, rows); break;
    case SUBLANE: gather_kernel<SUBLANE><<<grid, block, 0, s>>>(ix, x, o, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
