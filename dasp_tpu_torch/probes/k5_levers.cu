// K5 (csrc/colsum_multi.cu) with its design decisions as compile-time
// switches, for probes/k5_levers.py, which builds one library per variant
// and times them beside each other on one card.  It is on no path of the
// package.  With every switch at its default this is the design that
// csrc/colsum_multi.cu ships; each switch turns one decision the other way:
//   K5_STACKED=0     x interleaved by vector, (S, 128, kv), one vector load
//                    a slot, in place of kv stacked (S, 128) tables
//   K5_STAGED=0      no persistent grid and no cp.async: a block takes its
//                    vregs, copies their idx tiles to shared memory, exits
//   K5_STAGE_VALS=1  the values staged through shared memory too
//   K5_VPB=n         n vregs (n * 128 threads) a block; K5_MINB blocks a SM
//                    is what the compiler must allow (64 registers a thread
//                    at n * K5_MINB = 8)
//   K5_CONTIG=1      a block walks a contiguous share of the vregs, not
//                    every gridDim.x-th
//   K5_FLIGHT=w      words of x gathers a thread issues before its products
//   K5_XLOAD=1/2     the x gathers as ld.global.nc / ld.global.cg (past L1)
//   K5_VLOAD=1/2     the values as ld.global.cs (streaming) / ld.global.cg
// The arithmetic and its order are K5's in every variant.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"
#include "cp_async.cuh"

namespace {

#ifndef K5_VPB
#define K5_VPB 1
#endif
#ifndef K5_MINB
#define K5_MINB 8
#endif
#ifndef K5_FLIGHT
#define K5_FLIGHT 32
#endif
#ifndef K5_STACKED
#define K5_STACKED 1
#endif
#ifndef K5_STAGED
#define K5_STAGED 1
#endif
#ifndef K5_CONTIG
#define K5_CONTIG 0
#endif
#ifndef K5_STAGE_VALS
#define K5_STAGE_VALS 0
#endif
#ifndef K5_XLOAD
#define K5_XLOAD 0
#endif
#ifndef K5_VLOAD
#define K5_VLOAD 0
#endif
constexpr int VPB = K5_VPB;     // vregs per group (128 threads each)
constexpr int MAX_P = 32;       // windows of a vreg (the packer's cap)
constexpr int MIN_BLOCKS = K5_MINB;  // blocks a SM the compiler must allow
constexpr int FLIGHT = K5_FLIGHT;    // words of x gathers in flight a thread
constexpr int MAX_DEV = 16;     // devices whose launch shape is cached

// the kv words of one slot: one load of up to 16 bytes, or two or four
template <typename A, int KV>
struct alignas(sizeof(A) * KV < 16 ? sizeof(A) * KV : 16) XVec {
  A v[KV];
};

#if K5_XLOAD == 1
#define XLD(p) __ldg(p)
#elif K5_XLOAD == 2
#define XLD(p) __ldcg(p)
#else
#define XLD(p) (*(p))
#endif
template <typename A, int KV>
__device__ __forceinline__ XVec<A, KV> load_x(const XVec<A, KV>* p) {
  XVec<A, KV> r;
  constexpr int B = (int)sizeof(XVec<A, KV>);
  if constexpr (B >= 16) {
#pragma unroll
    for (int c = 0; c < B / 16; ++c)
      reinterpret_cast<int4*>(&r)[c] = XLD(reinterpret_cast<const int4*>(p) + c);
  } else if constexpr (B == 8) {
    *reinterpret_cast<int2*>(&r) = XLD(reinterpret_cast<const int2*>(p));
  } else {
    *reinterpret_cast<int*>(&r) = XLD(reinterpret_cast<const int*>(p));
  }
  return r;
}
#if K5_VLOAD == 1
#define VLD(p) __ldcs(p)
#elif K5_VLOAD == 2
#define VLD(p) __ldcg(p)
#else
#define VLD(p) (*(p))
#endif
__device__ __forceinline__ float load_v(const float* p) { return VLD(p); }
__device__ __forceinline__ double load_v(const double* p) { return VLD(p); }
__device__ __forceinline__ float load_v(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      VLD(reinterpret_cast<const unsigned short*>(p))));
}

// The operands of one group of VPB vregs, staged into shared memory by
// cp.async while the block computes the group before it.
template <typename V>
struct alignas(16) Stage {
  int16_t tile[VPB][SUB][LANES];
#if K5_STAGE_VALS
  V vals[VPB][SUB][LANES];
#endif
  int32_t wins[VPB][MAX_P + 1];
};

// Start the copies of group g into `st`; every thread commits one group of
// copies, so that the pending counts of all threads stay in step.
template <typename V>
__device__ __forceinline__ void stage_group(Stage<V>& st,
                                            const int32_t* __restrict__ wins,
                                            const V* __restrict__ vals,
                                            const int16_t* __restrict__ idx,
                                            int64_t g, int nv, int P, int t,
                                            int j) {
  const int64_t v = g * VPB + t;
  if (v < nv) {
    cp_async16(&st.tile[t][0][0] + 8 * j, idx + v * SUB * LANES + 8 * j);
#if K5_STAGE_VALS
    constexpr int CHUNKS = SUB * LANES * (int)sizeof(V) / 16;
    const char* gv = reinterpret_cast<const char*>(vals + v * SUB * LANES);
    char* sv = reinterpret_cast<char*>(&st.vals[t][0][0]);
#pragma unroll
    for (int c = j; c < CHUNKS; c += LANES) cp_async16(sv + 16 * c, gv + 16 * c);
#endif
    if (j <= P) cp_async4(&st.wins[t][j], wins + v * (P + 1) + j);
  }
  cp_async_commit();
}

// One vreg from its staged operands: lane column j of every level of every
// slice.  `out` points at (row v*R, lane j) of slice 0; `slice` is the
// words of one slice.
template <typename V, typename A, int STRIDE, int KV>
__device__ __forceinline__ void colsum_multi_vreg(
    const int16_t (*tile)[LANES], const V (*vals)[LANES], const int32_t* w,
    int P, const XVec<A, KV>* __restrict__ x, A* __restrict__ out,
    int64_t slice, int j, int64_t table) {
  constexpr int XW = KV * (int)sizeof(A) / 4;        // words a gather
  constexpr int G = FLIGHT / XW < SUB ? FLIGHT / XW : SUB;
  A acc[KV];
#pragma unroll
  for (int i0 = 0; i0 < SUB; i0 += G) {
    XVec<A, KV> xv[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int lam = (int)tile[i0 + u][j] & 127;
#if K5_STACKED
      const A* xp = reinterpret_cast<const A*>(x) +
                    x_row(tile[i0 + u], lam, w, P) * LANES + lam;
#pragma unroll
      for (int k = 0; k < KV; ++k) xv[u].v[k] = XLD(xp + k * table);
#else
      xv[u] = load_x<A, KV>(x + x_row(tile[i0 + u], lam, w, P) * LANES + lam);
#endif
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int i = i0 + u;
      const A a = load_v(&vals[i][j]);
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const A p = mul_rn(a, xv[u].v[k]);
        acc[k] = add_rn(i % STRIDE == 0 ? A(0) : acc[k], p);
      }
      if (i % STRIDE == STRIDE - 1) {
#pragma unroll
        for (int k = 0; k < KV; ++k)
          out[k * slice + (i / STRIDE) * LANES] = acc[k];
      }
    }
  }
}

template <typename V, typename A, int STRIDE, int KV>
__global__ void __launch_bounds__(LANES * VPB, MIN_BLOCKS)
colsum_multi_kernel(const int32_t* __restrict__ wins,
                    const V* __restrict__ vals,
                    const int16_t* __restrict__ idx,
                    const XVec<A, KV>* __restrict__ x, A* __restrict__ out,
                    int nv, int P, int64_t table) {
  constexpr int R = SUB / STRIDE;
  const int j = threadIdx.x;
  const int t = threadIdx.y;
  const int64_t groups = ((int64_t)nv + VPB - 1) / VPB;
  const int64_t slice = (int64_t)nv * R * LANES;
#if K5_STAGED
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<V>* const stage = reinterpret_cast<Stage<V>*>(smem);   // two
  int buf = 0;
#if K5_CONTIG
  const int64_t per = (groups + gridDim.x - 1) / gridDim.x;
  const int64_t g0 = blockIdx.x * per;
  const int64_t g1 = g0 + per < groups ? g0 + per : groups;
  const int64_t step = 1;
#else
  const int64_t g0 = blockIdx.x, g1 = groups, step = gridDim.x;
#endif
  if (g0 < g1) stage_group(stage[buf], wins, vals, idx, g0, nv, P, t, j);
  for (int64_t g = g0; g < g1; g += step) {
    if (g + step < g1) {
      stage_group(stage[buf ^ 1], wins, vals, idx, g + step, nv, P, t, j);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<V>& st = stage[buf];
    const int64_t v = g * VPB + t;
    if (v < nv)
      colsum_multi_vreg<V, A, STRIDE, KV>(
          st.tile[t],
#if K5_STAGE_VALS
          st.vals[t],
#else
          reinterpret_cast<const V(*)[LANES]>(vals + v * SUB * LANES),
#endif
          &st.wins[t][1], P, x, out + v * R * LANES + j, slice, j, table);
    __syncthreads();
    buf ^= 1;
  }
#else
  __shared__ int16_t tile[VPB][SUB][LANES];
  const int64_t v = (int64_t)blockIdx.x * VPB + t;
  const bool live = v < nv;
  const int64_t base = v * SUB * LANES;
  if (live) {
#pragma unroll
    for (int i = 0; i < SUB; ++i) tile[t][i][j] = idx[base + i * LANES + j];
  }
  __syncthreads();
  if (!live) return;
  colsum_multi_vreg<V, A, STRIDE, KV>(
      tile[t], reinterpret_cast<const V(*)[LANES]>(vals + base),
      wins + v * (P + 1) + 1, P, x, out + v * R * LANES + j, slice, j, table);
#endif
}

template <typename V, typename A, int STRIDE>
const void* kernel_kv(int kv) {
  switch (kv) {
    case 1: return (const void*)colsum_multi_kernel<V, A, STRIDE, 1>;
    case 2: return (const void*)colsum_multi_kernel<V, A, STRIDE, 2>;
    case 4: return (const void*)colsum_multi_kernel<V, A, STRIDE, 4>;
    case 8: return (const void*)colsum_multi_kernel<V, A, STRIDE, 8>;
  }
  return nullptr;
}

template <typename V, typename A>
const void* kernel_of(int stride, int kv) {
  switch (stride) {
    case 2: return kernel_kv<V, A, 2>(kv);
    case 4: return kernel_kv<V, A, 4>(kv);
    case 8: return kernel_kv<V, A, 8>(kv);
  }
  return nullptr;
}

// Allow the instance its two stages of dynamic shared memory and ask how
// many of its blocks are co-resident on a SM.
template <typename V>
cudaError_t prepare(const void* f, int* per_sm) {
  const int dyn = K5_STAGED ? 2 * (int)sizeof(Stage<V>) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, f, LANES * VPB,
                                                      dyn);
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorLaunchOutOfResources;
  return e;
}

template <typename V, typename A>
int launch(const void* wins, const void* vals, const void* idx,
           const void* x, void* out, int nv, int P, int stride, int kv,
           void* stream, long long table_ll) {
  int64_t table = table_ll;
  if (nv <= 0) return 0;
  const void* f = kernel_of<V, A>(stride, kv);
  if (!f || P < 1 || P > MAX_P) return (int)cudaErrorInvalidValue;
  // the co-resident blocks of each instance, asked once per device
  static int resident[MAX_DEV][4][4];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  int& cap = resident[dev][stride / 4 + (stride == 8)][kv / 2 - (kv == 8)];
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    e = prepare<V>(f, &per_sm);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    cap = per_sm * sms;
  }
  const int64_t groups = ((int64_t)nv + VPB - 1) / VPB;
  const int grid = K5_STAGED ? (int)(groups < cap ? groups : cap) : (int)groups;
  void* args[] = {&wins, &vals, &idx, &x, &out, &nv, &P, &table};
  e = cudaLaunchKernel(f, dim3(grid), dim3(LANES, VPB), args,
                       K5_STAGED ? 2 * sizeof(Stage<V>) : 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// registers a thread, local (stack and spill) bytes a thread, shared bytes
// a block and co-resident blocks a SM of one instance
template <typename V, typename A>
int info(int stride, int kv, int* out) {
  const void* f = kernel_of<V, A>(stride, kv);
  if (!f) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaFuncAttributes a;
  cudaError_t e = prepare<V>(f, &per_sm);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes + (K5_STAGED ? 2 * (int)sizeof(Stage<V>) : 0);
  out[3] = per_sm;
  return 0;
}

}  // namespace

extern "C" int dasp_colsum_multi_info(int dtype, int stride, int kv,
                                      int* out) {
  switch (dtype) {
    case 0: return info<float, float>(stride, kv, out);
    case 1: return info<__nv_bfloat16, float>(stride, kv, out);
    case 2: return info<double, double>(stride, kv, out);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int dasp_colsum_multi_f32(const void* wins, const void* vals,
    const void* idx, const void* x, void* out, int nv, int P, int stride,
    int kv, void* stream, long long table) {
  return launch<float, float>(wins, vals, idx, x, out, nv, P, stride, kv, stream, table);
}

extern "C" int dasp_colsum_multi_bf16(const void* wins, const void* vals,
    const void* idx, const void* x, void* out, int nv, int P, int stride,
    int kv, void* stream, long long table) {
  return launch<__nv_bfloat16, float>(wins, vals, idx, x, out, nv, P, stride, kv, stream, table);
}

extern "C" int dasp_colsum_multi_f64(const void* wins, const void* vals,
    const void* idx, const void* x, void* out, int nv, int P, int stride,
    int kv, void* stream, long long table) {
  return launch<double, double>(wins, vals, idx, x, out, nv, P, stride, kv, stream, table);
}
