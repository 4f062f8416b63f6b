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
// Bound: bytes.  8 B per element streamed (idx in, out back) as the tool
// counts them; the table (1 MB) stays in the 50 MB L2.  The first design
// (one thread per element, 512-thread blocks, the sublane body one __ldg
// word a thread from the table through L2) ran the sublane body at 22.3 us
// for R = 20,480 against a bound of 6.6 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6): a warp's 32 gathers touch ~32 lines of the table, and each
// stream row waited on its idx load before its gather could start.
//
// Shape on Hopper (PERF.md §6, the T1-T3 redesign):
//   sublane: column j of the table is fixed for lane j, so a slab of SLAB
//            columns (2048 x SLAB x 4 B: 128 KB at SLAB = 16) fits in shared
//            memory though the 1 MB table does not.  A persistent block
//            owns one slab (blockIdx mod GROUPS) and a contiguous range of
//            CHUNK-row chunks of the stream (blockIdx / GROUPS of `splits`
//            even shares; the last chunk may be short).  It copies its slab
//            in once with cp.async, then walks its chunks: the idx of a
//            chunk (SLAB contiguous words a row, whole sectors) arrive by
//            cp.async STAGES - 1 chunks ahead, each thread gathers from the
//            slab and writes out[r, c0:c0+SLAB].  Device memory sees idx in
//            and out back; L2 serves each block's slab once.  The grid is
//            GROUPS x splits, splits = the co-resident blocks / GROUPS (at
//            most the chunks): 8 x 16 on 132 SMs at SLAB = 16.  A warp's
//            gathers are 2 rows x 16 columns: bank = column + 16 x (idx & 1),
//            at most 2 ways.
//   copy and lane: streams, 16-byte loads and stores, a grid-stride loop
//            over a persistent grid (the co-resident blocks, a multiple of
//            the SM count).  copy keeps UNROLL loads of a thread in flight;
//            lane takes RPB = 8 stream rows a block step, loads their table
//            rows (r mod 2048) with the idx as part of the stream, and
//            gathers from those rows in shared memory.
// Measured (PERF.md §6, PR 11's table: chip_smoke.py's [probe] sweep, one
// launch a graph replay; NVIDIA H100 80GB HBM3, 700 W): sublane at
// R = 20,480 in under half the time of torch.gather and past half its
// bound.  A slab of 8 columns (64 KB, two blocks a SM, 32-byte idx rows)
// ran slower at both sizes of the tool (PERF.md §6 gives the readings and
// the commit whose probes/probe_levers.py took them), so 16 columns ship.

#include <algorithm>

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int LANES = 128;
constexpr int TABLE_ROWS = 2048;  // the tool's block B (:46)
constexpr int MAX_DEV = 16;       // devices whose grid size is cached

// sublane
constexpr int SLAB = 16;                     // table columns a block holds
constexpr int GROUPS = LANES / SLAB;         // slabs of the table
constexpr int CHUNK = 256;                   // stream rows a stage holds
constexpr int STAGES = 4;                    // idx chunks in the ring
constexpr int SUB_THREADS = 512;
constexpr int SLAB_BYTES = TABLE_ROWS * SLAB * 4;
constexpr int SUB_SMEM = SLAB_BYTES + STAGES * CHUNK * SLAB * 4;
static_assert(LANES % SLAB == 0 && SLAB % 4 == 0, "slab of whole vectors");
static_assert(CHUNK * SLAB / 4 % SUB_THREADS == 0 &&
              TABLE_ROWS * SLAB / 4 % SUB_THREADS == 0,
              "slab and chunk copies in whole passes");

// copy and lane
constexpr int STREAM_THREADS = 256;
constexpr int UNROLL = 4;                    // copy: vectors in flight
constexpr int RPB = STREAM_THREADS * 4 / LANES;  // lane: rows a step (8)

enum Body { COPY = 0, LANE = 1, SUBLANE = 2 };

__global__ void __launch_bounds__(STREAM_THREADS)
copy_kernel(const int4* __restrict__ idx, float4* __restrict__ out,
            int64_t n4) {
  const int64_t step = (int64_t)gridDim.x * STREAM_THREADS * UNROLL;
  for (int64_t b = (int64_t)blockIdx.x * STREAM_THREADS * UNROLL +
                   threadIdx.x;
       b < n4; b += step) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = b + u * STREAM_THREADS;
      if (e < n4) v[u] = idx[e];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = b + u * STREAM_THREADS;
      // wraps as int32 does
      if (e < n4)
        out[e] = make_float4((float)(int32_t)((uint32_t)v[u].x * 2u),
                             (float)(int32_t)((uint32_t)v[u].y * 2u),
                             (float)(int32_t)((uint32_t)v[u].z * 2u),
                             (float)(int32_t)((uint32_t)v[u].w * 2u));
    }
  }
}

__global__ void __launch_bounds__(STREAM_THREADS)
lane_kernel(const int4* __restrict__ idx, const float4* __restrict__ xw,
            float4* __restrict__ out, int rows) {
  __shared__ float4 row4[RPB][LANES / 4];
  const int t = threadIdx.x / (LANES / 4);   // the block's row of a step
  const int k = threadIdx.x % (LANES / 4);   // the thread's 4 lanes
  const float* row = reinterpret_cast<const float*>(row4[t]);
  const int steps = (rows + RPB - 1) / RPB;
  for (int s = blockIdx.x; s < steps; s += gridDim.x) {
    const int64_t r = (int64_t)s * RPB + t;
    const bool live = r < rows;
    int4 i;
    float4 tv;
    if (live) {
      i = idx[r * (LANES / 4) + k];
      tv = xw[(r % TABLE_ROWS) * (LANES / 4) + k];
    }
    __syncthreads();                  // the last step's gathers are done
    if (live) row4[t][k] = tv;
    __syncthreads();
    if (live)
      out[r * (LANES / 4) + k] = make_float4(row[i.x], row[i.y], row[i.z],
                                             row[i.w]);
  }
}

__global__ void __launch_bounds__(SUB_THREADS, 1)
sublane_kernel(const int32_t* __restrict__ idx, const float* __restrict__ xw,
               float* __restrict__ out, int rows, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* slab = reinterpret_cast<float*>(smem);            // [2048][SLAB]
  int32_t* ring = reinterpret_cast<int32_t*>(smem + SLAB_BYTES);
  constexpr int Q = SLAB / 4;                 // 16-byte pieces a row
  const int t = threadIdx.x;
  const int c0 = (blockIdx.x % GROUPS) * SLAB;
  const int s = blockIdx.x / GROUPS;
  const int nch = (rows + CHUNK - 1) / CHUNK;
  const int k0 = (int)((int64_t)s * nch / splits);
  const int k1 = (int)((int64_t)(s + 1) * nch / splits);
  // the slab; its copies join the first chunk's group
#pragma unroll
  for (int m = 0; m < TABLE_ROWS * Q / SUB_THREADS; ++m) {
    const int e = t + m * SUB_THREADS;
    cp_async16(slab + 4 * e, xw + (int64_t)(e / Q) * LANES + c0 + 4 * (e % Q));
  }
  // every thread commits one group a chunk, a chunk past the range too, so
  // that the pending counts stay in step
  auto stage = [&](int k) {
    if (k < k1) {
      int32_t* st = ring + (k % STAGES) * CHUNK * SLAB;
#pragma unroll
      for (int m = 0; m < CHUNK * Q / SUB_THREADS; ++m) {
        const int e = t + m * SUB_THREADS;
        const int64_t r = (int64_t)k * CHUNK + e / Q;
        if (r < rows) cp_async16(st + 4 * e, idx + r * LANES + c0 + 4 * (e % Q));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) stage(k0 + i);
  for (int k = k0; k < k1; ++k) {
    cp_async_wait<STAGES - 2>();      // chunk k (and the slab) arrived
    __syncthreads();                  // and chunk k - 1 is consumed
    stage(k + STAGES - 1);
    const int32_t* st = ring + (k % STAGES) * CHUNK * SLAB;
    const int64_t r0 = (int64_t)k * CHUNK;
#pragma unroll
    for (int m = 0; m < CHUNK * SLAB / SUB_THREADS; ++m) {
      const int e = t + m * SUB_THREADS;
      const int64_t r = r0 + e / SLAB;
      if (r < rows) out[r * LANES + c0 + e % SLAB] = slab[st[e] * SLAB + e % SLAB];
    }
  }
}

const void* kernel_of(int body) {
  switch (body) {
    case COPY: return (const void*)copy_kernel;
    case LANE: return (const void*)lane_kernel;
    case SUBLANE: return (const void*)sublane_kernel;
  }
  return nullptr;
}

int threads_of(int body) {
  return body == SUBLANE ? SUB_THREADS : STREAM_THREADS;
}

int smem_of(int body) { return body == SUBLANE ? SUB_SMEM : 0; }

// co-resident blocks a SM of `body`'s kernel (raising the sublane kernel's
// dynamic shared-memory limit first), and the SMs, once per device
int occupancy(int body, int* per_sm, int* sms) {
  static int cache[MAX_DEV][3][2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  int* c = cache[dev][body];
  if (c[0] == 0) {
    const void* f = kernel_of(body);
    if (body == SUBLANE)
      e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SUB_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c[0], f, threads_of(body), smem_of(body));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&c[1], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      c[0] = 0;
      return (int)e;
    }
    if (c[0] < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  *per_sm = c[0];
  *sms = c[1];
  return 0;
}

}  // namespace

extern "C" int dasp_gather_probe(const void* idx, const void* xw, void* out,
                                 int rows, int body, void* stream) {
  if (rows <= 0 || !kernel_of(body)) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  int rc = occupancy(body, &per_sm, &sms);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int32_t*>(idx);
  auto x = static_cast<const float*>(xw);
  auto o = static_cast<float*>(out);
  const int blocks = per_sm * sms;
  if (body == COPY) {
    const int64_t n4 = (int64_t)rows * LANES / 4;
    const int64_t need = (n4 + STREAM_THREADS * UNROLL - 1) /
                         (STREAM_THREADS * UNROLL);
    const int grid = (int)std::min<int64_t>(need, blocks);
    copy_kernel<<<grid, STREAM_THREADS, 0, s>>>(
        reinterpret_cast<const int4*>(ix), reinterpret_cast<float4*>(o), n4);
  } else if (body == LANE) {
    const int grid = std::min((rows + RPB - 1) / RPB, blocks);
    lane_kernel<<<grid, STREAM_THREADS, 0, s>>>(
        reinterpret_cast<const int4*>(ix), reinterpret_cast<const float4*>(x),
        reinterpret_cast<float4*>(o), rows);
  } else {
    const int nch = (rows + CHUNK - 1) / CHUNK;
    int splits = blocks / GROUPS;
    if (splits > nch) splits = nch;
    if (splits < 1) splits = 1;
    sublane_kernel<<<GROUPS * splits, SUB_THREADS, SUB_SMEM, s>>>(
        ix, x, o, rows, splits);
  }
  return (int)cudaGetLastError();
}

// registers a thread, local (stack and spill) bytes a thread, shared bytes
// a block (static and dynamic), co-resident blocks a SM of `body`'s kernel,
// and the table columns a sublane block holds (0 for copy and lane)
extern "C" int dasp_gather_probe_info(int body, int* out) {
  const void* f = kernel_of(body);
  if (!f) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  int rc = occupancy(body, &per_sm, &sms);
  if (rc) return rc;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes + smem_of(body);
  out[3] = per_sm;
  out[4] = body == SUBLANE ? SLAB : 0;
  return 0;
}
