// colsum_multi (K5): the windowed-gather colsum against kv stacked x
// tables, for SpMM (Y = A X, kv columns of X per pass); its kv = 1
// instance is K1 (and, in fp64, K3), the single-vector colsum.
//
// Replaces dasp_tpu/ops/pallas_backend.py:_make_colsum_multi (:174-249)
// and, at kv = 1, _make_colsum (:121-160, body _colsum_body :63-118) and
// _make_colsum_dd (:277-375).  A stream is NV "vregs", each an 8x128 tile
// of values and int16 slot metadata idx = c<<10 | q<<7 | lam.  x3d is
// (kv*S, 128): table k (column k of X, as an x2d table) starts at row k*S,
// and the windows in wins are row offsets WITHIN one table, so slot (i, j)
// of vreg v multiplies vals[v,i,j] by
//     x3d[k*S + wins[v, 1 + c] + q, lam],   lam = idx[v,i,j] & 127,
// for every k, where q = (cell>>7)&7 and c = cell>>10 are read at the CELL
// (i, lam) of the same tile, not at (i, j): one cell names one x word, and
// every slot of a sublane that gathers lane lam shares it (wplan.py).  The
// products of each group of `stride` sublanes are summed, giving R =
// 8/stride output rows per vreg.  Each A tile is read once for the kv
// vectors, and the output is (kv, NV*R, 128).
//
// Instances (value type / x, sum and output type), kv in {1, 2, 4, 8}:
//   dasp_colsum_multi_f32   float          / float
//   dasp_colsum_multi_bf16  __nv_bfloat16  / float   (value upcast, exact)
//   dasp_colsum_multi_f64   double         / double  (K3 at kv = 1)
// The reference runs fp64 as double-double f32 pairs because the TPU has
// no fp64 datapath (K3, and its SpMM tier spmm_fn_dd, :1043, runs its
// kernel twice in f32 on hi/lo cross products); Hopper has one, so one
// fp64 pass replaces them, without that tier's 2^-24-of-row-mass error.
//
// What bounds it on this card.  In bytes, the A stream (value + 2 B of idx
// a slot) read once per kv vectors and the kv output slices (0.8 / 2.5 us
// a vector at the copy rate on cop20k_like / webbase_like in f32).  The
// first design (a block of 4 vregs that stages the idx tile, syncs and
// exits, kv * R sums in registers) ran at 0.45-0.52 of that bound on
// cop20k_like; K1's kernel of that shape at 0.49-0.62, lowest in bf16,
// whose 4 B a slot leave the least time to hide a latency chain that does
// not shrink with the value type.
// chip_smoke.py's split of it (K5 at kv = 1, 2, 4, 8, as it is and with
// every gather sent to one fixed row of its table, K1 beside them) showed
// that each further vector cost 3.3-4.2 us in f32 wherever its gathers
// landed, and probes/k5_levers.py that with the x gathers sent past the L1
// (ld.global.cg) a pass is 1.3-2.7x slower: the gathers are served by the
// L1, and the kernel is bound by what the SM's load path (L1 and shared
// memory share it) can serve, and by the dependent loads in front of each
// gather.  What this design does about it (each figure from
// probes/k5_levers.py on an NVIDIA H100 80GB HBM3, 700 W, a pass over the
// streams of cop20k_like and webbase_like at kv = 4 and 8):
//   - small blocks and little shared memory: one vreg per block (128
//     threads, 8-12 blocks a SM), 4 KB of shared memory a block, so the L1
//     keeps the x windows (blocks of 4 vregs: up to 16 % slower, of 8: up
//     to 33 %); the values are loaded straight from device memory (staged
//     through shared memory too: 4-14 % slower at kv = 4, up to 27 % at
//     kv = 8);
//   - a persistent grid: as many blocks as are co-resident, each walking
//     every gridDim.x-th vreg, with the NEXT vreg's idx tile and wins row
//     on their way into shared memory (cp.async) while the block computes
//     the current one, so the cell lookup and the window offset, the two
//     loads in front of every gather, come from shared memory (without it:
//     3-13 % slower in f32 and bf16 at kv = 4, within 2 % in fp64 and at
//     kv = 8);
//   - the gathers of up to 8 sublanes (32 words a thread) are issued
//     before the first product (16 words: within 3 %); at kv = 1 that is
//     every sublane of the vreg (8 words, 16 in fp64);
//   - a level's kv sums live in kv registers and are stored when the level
//     ends (128 consecutive words: coalesced, each word written once), so
//     the kernel holds kv sums, not kv * R.
// At kv = 1 (K1, K3) the same holds (probes/k5_levers.py 1, the same
// card): with the x gathers sent past the L1 a pass is 1.1-4.9x slower,
// unstaged 14-22 % slower in f32 and bf16 (1-3 % in fp64), in blocks of 4
// vregs up to 14 % slower.  So K1/K3 are this instance: it runs them at
// 0.58-0.83 of their bound on cop20k_like and 0.68-0.82 on rmat_like,
// whose streams exceed the L2, where a kernel of K1's first shape ran at
// 0.49-0.62 (chip_smoke.py, PERF.md section 6).
// Tried and left out: x interleaved by vector as (S, 128, kv) with one
// vector load a slot (within 4 % at kv = 4; at kv = 8 9-20 % slower on
// cop20k_like and 0-5 % faster on webbase_like); a contiguous share of the
// vregs per block (0-19 % slower); streaming loads (ld.global.cs) of the
// values (at kv = 4 up to 11 % faster on cop20k_like, up to 10 % slower on
// webbase_like; at kv = 1 33-40 % slower in f32 and bf16, 5-10 % faster
// in fp64, on an instance that no path with a K6 schedule runs).
// The products and adds run in the reference's order with rounded mul/add
// (each level starts from zero and adds its sublanes in order; nvcc would
// otherwise contract a*x + acc into an FMA), so slice k equals the kv = 1
// instance (K1, K3) on table k bit for bit, and both equal
// ops/colsum.py:colsum_plain.
//
// Traps handled: idx is upcast to int before shifting (values are
// non-negative, c <= 31, so idx < 2^15); P is a runtime argument (the row
// stride of wins), at most MAX_P (the packer's cap); the round tag is
// clamped to P-1, which is what the reference does at P=1 (it reads window
// 1 whatever the tag) and a no-op for the tags the packer emits; pad vregs
// (all-zero tiles) give zero rows; NV need not be a multiple of anything;
// an unsupported kv, stride or P is refused with cudaErrorInvalidValue.
// idx must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"
#include "cp_async.cuh"

namespace {

constexpr int MAX_P = 32;       // windows of a vreg (the packer's cap)
constexpr int MIN_BLOCKS = 8;   // blocks a SM the compiler must allow (at
                                // most 64 registers a thread)
constexpr int FLIGHT = 32;      // words of x gathers in flight a thread
constexpr int MAX_DEV = 16;     // devices whose grid size is cached

// The idx tile and wins row of one vreg, staged into shared memory by
// cp.async while the block computes the vreg before it.
struct alignas(16) Stage {
  int16_t tile[SUB][LANES];
  int32_t wins[MAX_P + 1];
};

// Start the copies of vreg v into `st`; every thread commits one group of
// copies, so that the pending counts of all threads stay in step.
__device__ __forceinline__ void stage_vreg(Stage& st,
                                           const int32_t* __restrict__ wins,
                                           const int16_t* __restrict__ idx,
                                           int64_t v, int P, int j) {
  cp_async16(&st.tile[0][0] + 8 * j, idx + v * SUB * LANES + 8 * j);
  if (j <= P) cp_async4(&st.wins[j], wins + v * (P + 1) + j);
  cp_async_commit();
}

// One vreg: lane column j of every level of every slice.  `vals` points at
// the vreg's values, `out` at (row v*R, lane j) of slice 0; `table` and
// `slice` are the words of one x table and of one output slice.
template <typename V, typename A, int STRIDE, int KV>
__device__ __forceinline__ void colsum_multi_vreg(
    const int16_t (*tile)[LANES], const int32_t* w, int P,
    const V* __restrict__ vals, const A* __restrict__ x3d, int64_t table,
    A* __restrict__ out, int64_t slice, int j) {
  constexpr int XW = KV * (int)sizeof(A) / 4;        // words a slot gathers
  constexpr int G = FLIGHT / XW < SUB ? FLIGHT / XW : SUB;
  A acc[KV];
#pragma unroll
  for (int i0 = 0; i0 < SUB; i0 += G) {
    A xv[G][KV];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int lam = (int)tile[i0 + u][j] & 127;
      const A* xp = x3d + x_row(tile[i0 + u], lam, w, P) * LANES + lam;
#pragma unroll
      for (int k = 0; k < KV; ++k) xv[u][k] = xp[k * table];
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int i = i0 + u;
      const A a = widen(vals[i * LANES + j]);
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const A p = mul_rn(a, xv[u][k]);
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
__global__ void __launch_bounds__(LANES, MIN_BLOCKS)
colsum_multi_kernel(const int32_t* __restrict__ wins,
                    const V* __restrict__ vals,
                    const int16_t* __restrict__ idx,
                    const A* __restrict__ x3d, A* __restrict__ out, int nv,
                    int P, int64_t table) {
  constexpr int R = SUB / STRIDE;
  __shared__ Stage stage[2];
  const int j = threadIdx.x;
  const int64_t slice = (int64_t)nv * R * LANES;
  int buf = 0;
  // two vregs in flight: vreg v is computed from its staged tile and wins
  // row while those of v + gridDim.x are copied in (the grid is at most nv)
  stage_vreg(stage[buf], wins, idx, blockIdx.x, P, j);
  for (int64_t v = blockIdx.x; v < nv; v += gridDim.x) {
    if (v + gridDim.x < nv) {
      stage_vreg(stage[buf ^ 1], wins, idx, v + gridDim.x, P, j);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    colsum_multi_vreg<V, A, STRIDE, KV>(
        stage[buf].tile, &stage[buf].wins[1], P, vals + v * SUB * LANES, x3d,
        table, out + v * R * LANES + j, slice, j);
    __syncthreads();              // stage[buf] is refilled two vregs on
    buf ^= 1;
  }
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

template <typename V, typename A>
int launch(const void* wins, const void* vals, const void* idx,
           const void* x3d, void* out, int nv, int P, int stride, int S,
           int kv, void* stream) {
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, LANES, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    cap = per_sm * sms;
  }
  int64_t table = (int64_t)S * LANES;            // words per x table
  void* args[] = {&wins, &vals, &idx, &x3d, &out, &nv, &P, &table};
  e = cudaLaunchKernel(f, dim3(nv < cap ? nv : cap), dim3(LANES), args, 0,
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
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, LANES, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
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

// the name of a CUDA error code, for the wrappers' messages
// (ops/_build.py:check)
extern "C" const char* dasp_cuda_error_name(int rc) {
  return cudaGetErrorName(static_cast<cudaError_t>(rc));
}
