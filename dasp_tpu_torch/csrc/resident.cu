// resident (K6): `iters` chained SpMVs in ONE persistent cooperative launch.
//
// Replaces dasp_tpu/ops/resident.py:make_resident_loop (:452; kernel
// kernel_factory :508-1036, pallas_call :1137).  Each step t computes a
// whole y from the kernel's own copy of x and feeds it back:
//   (A) colsum of every stream, K1's math, over one concatenated vreg
//       index, into a partials buffer with one range per stream;
//   (B) the sell folds into the sell rows of y2 (one y2 word per thread),
//       and the per-vreg totals of the streams that long rows read (one
//       warp per vreg);
//   (C) each long scalar p = sum of multiplicity x total over its list,
//       into y2 row Z - n_long_rows + p / 127, lane p % 127 (lane 127 and
//       the tail of the last long row are written as zero);
//   (D) the outgather, K2's math, into out, and the tap
//       x_scr[r, l] += y2[0, l] * tap on every row r.
// Phases are separated by cg::this_grid().sync(); at t = 0 the kernel
// copies x into x_scr and zeroes the zero row Z of y2.  Every output word
// is written by one thread and there are no atomics, so the result is
// deterministic.  Instances (value / sum type): dasp_resident_f32
// (float / float), dasp_resident_bf16 (__nv_bfloat16 / float),
// dasp_resident_f64 (double / double: native fp64, where the reference
// carries double-double pairs and an f32 incidence matmul).
//
// Order of arithmetic (ops/resident.py's docstring; resident_loop_plain
// follows it, and every add and product is rounded, never contracted):
// colsum as K1 (sublanes in order within a level); a sell fold adds its
// w8 x F partial rows in (w, f) row-major order from the (0, 0) row; a
// vreg total adds the R partial rows per lane in order, then a lane tree
// c[l] += c[l + s], s = 64, 32, 16, 8, 4, 2, 1; a long scalar adds
// m * total over its list in order from the first product; the outgather
// adds the k_used slots in order, skipping zero-row slots.
//
// Shape on Hopper: blocks of 128 x VPB threads, as many as are co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, fewer if the work
// needs fewer), launched by cudaLaunchCooperativeKernel; each phase walks
// its items in a grid-stride loop.  In (A) thread j of a thread row owns
// lane column j of one vreg, with the vreg's idx tile in shared memory for
// the cell lookup, as in K1; a stream's stride selects a templated body.
// Partials, totals, y2 and x_scr live in device memory (L2 for all but the
// largest plans): the wrapper allocates them, the kernel allocates nothing.
//
// Bound: bytes.  Per step the kernel streams every stream's wins, vals and
// idx (6 B per slot f32, 4 B bf16, 10 B f64), the outgather's src and perm
// (1 B per output word per used slot), writes and reads back y2 and the
// partials, and writes out.  Those bytes over the copy rate bound one
// step: at cop20k_like shapes a step streams 28.7 MB in f32, 19.8 MB in
// bf16 and 48.0 MB in f64, at webbase_like shapes 46.2, 35.7 and 78.7 MB,
// which an NVIDIA H100 80GB HBM3 (700 W, ~3.0 TB/s copy rate) needs
// 6.6-26.3 us to move (chip_smoke.py's `resident* alone` lines).  A chain
// whose tables fit the 50 MB L2 might re-read them from L2; the probe of
// csrc/resident_probe.cu found no such gain.  What the
// design does about the bound: the glue between K1 and K2 on the streamed
// path (fold reductions, cat, gathers, a dozen launches per step) becomes
// two passes over partials and y2 inside the one launch, with no host
// issue per step; the stream is read once per step, coalesced.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int VPB = 4;                     // thread rows per block
constexpr int WARPS = VPB * LANES / 32;    // warps per block
constexpr int LONG_PACK = 127;             // long scalars per y2 row

// int64 fields of one stream's row of the descriptor table, in the order
// of ops/resident.py:DESC_FIELDS
enum { D_WINS, D_VALS, D_IDX, D_P, D_STRIDE, D_NV, D_VOFF, D_POFF, D_TOFF,
       NDESC };

template <typename A>
struct Params {
  const int64_t* desc;      // (n_streams, NDESC)
  int n_streams;
  int64_t nv_total;         // vregs over all streams
  int64_t n_tot;            // vreg totals (vregs of the long streams)
  const int64_t* fold;      // (n_fold, 4): first partial row, w8, F, R_st
  int64_t n_fold;           // sell rows of y2
  const int64_t* inc_ptr;   // (n_long + 1,) CSR pointers of the lists
  const int64_t* inc_tot;   // total index of each list entry
  const int32_t* inc_mult;  // multiplicity of each list entry
  int n_long, n_long_rows;
  const int32_t* src;       // (B, K) stripped to <= Z
  const int8_t* perm;       // (K, B, 128) lane ids
  int B, K, Z;
  const A* x;               // caller's x table, never written
  A* x_scr;                 // the kernel's x table
  int64_t x_words;
  A* part;                  // concatenated partials
  A* y2;                    // (Z + 1, 128)
  A* tot;                   // (n_tot,)
  A* out;                   // (B, 128)
  int iters;
  A tap;
};

// one vreg's colsum (K1's body): R = 8/STRIDE level sums of lane j
template <typename V, typename A, int STRIDE>
__device__ __forceinline__ void colsum_vreg(int16_t (*tile)[LANES],
                                            const int32_t* w, int P,
                                            const V* vals, const A* x,
                                            A* part, int j) {
  constexpr int R = SUB / STRIDE;
  A acc[R];
#pragma unroll
  for (int L = 0; L < R; ++L) acc[L] = A(0);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int lam = (int)tile[i][j] & 127;
    const A xv = x[x_row(tile[i], lam, w, P) * LANES + lam];
    acc[i / STRIDE] = add_rn(acc[i / STRIDE],
                             mul_rn(widen(vals[i * LANES + j]), xv));
  }
#pragma unroll
  for (int L = 0; L < R; ++L) part[L * LANES] = acc[L];
}

template <typename V, typename A>
__global__ void __launch_bounds__(LANES * VPB)
resident_kernel(Params<A> p) {
  __shared__ int16_t tile[VPB][SUB][LANES];
  cg::grid_group grid = cg::this_grid();
  const int j = threadIdx.x;
  const int t = threadIdx.y;
  const int64_t row = (int64_t)blockIdx.x * VPB + t;   // this thread row
  const int64_t rows = (int64_t)gridDim.x * VPB;       // thread rows
  const int64_t tid = row * LANES + j;
  const int64_t nthreads = rows * LANES;
  const int lane = j & 31;
  const int64_t warp = tid >> 5;
  const int64_t nwarps = nthreads >> 5;
  const int64_t long_base = (int64_t)(p.Z - p.n_long_rows) * LANES;

  for (int64_t i = tid; i < p.x_words; i += nthreads) p.x_scr[i] = p.x[i];
  if (row == 0) p.y2[(int64_t)p.Z * LANES + j] = A(0);
  grid.sync();

  for (int it = 0; it < p.iters; ++it) {
    // (A) colsum; the trip count is uniform in a block (__syncthreads)
    for (int64_t g = blockIdx.x; g * VPB < p.nv_total; g += gridDim.x) {
      const int64_t gv = g * VPB + t;
      const bool live = gv < p.nv_total;
      const int64_t* d = p.desc;
      int64_t v = 0;
      if (live) {
        for (int s = 1; s < p.n_streams; ++s)
          if (p.desc[s * NDESC + D_VOFF] <= gv) d = p.desc + s * NDESC;
        v = gv - d[D_VOFF];
        const int16_t* ix =
            reinterpret_cast<const int16_t*>(d[D_IDX]) + v * SUB * LANES;
#pragma unroll
        for (int i = 0; i < SUB; ++i) tile[t][i][j] = ix[i * LANES + j];
      }
      __syncthreads();
      if (live) {
        const int P = (int)d[D_P];
        const int stride = (int)d[D_STRIDE];
        const int32_t* w =
            reinterpret_cast<const int32_t*>(d[D_WINS]) + v * (P + 1) + 1;
        const V* vals =
            reinterpret_cast<const V*>(d[D_VALS]) + v * SUB * LANES;
        A* out = p.part + (d[D_POFF] + v * (SUB / stride)) * LANES + j;
        if (stride == 2)
          colsum_vreg<V, A, 2>(tile[t], w, P, vals, p.x_scr, out, j);
        else if (stride == 4)
          colsum_vreg<V, A, 4>(tile[t], w, P, vals, p.x_scr, out, j);
        else
          colsum_vreg<V, A, 8>(tile[t], w, P, vals, p.x_scr, out, j);
      }
      __syncthreads();
    }
    grid.sync();

    // (B) sell folds, then vreg totals (one warp per vreg)
    for (int64_t r = row; r < p.n_fold; r += rows) {
      const int64_t* f = p.fold + r * 4;
      const int w8 = (int)f[1];
      const int F = (int)f[2];
      const int64_t r_st = f[3];
      const A* src = p.part + f[0] * LANES + j;
      A acc = src[0];
      for (int w = 0; w < w8; ++w)
        for (int ff = 0; ff < F; ++ff)
          if (w | ff) acc = add_rn(acc, src[(w * r_st + ff) * LANES]);
      p.y2[r * LANES + j] = acc;
    }
    for (int64_t ti = warp; ti < p.n_tot; ti += nwarps) {
      const int64_t* d = p.desc;
      for (int s = 0; s < p.n_streams; ++s) {
        const int64_t o = p.desc[s * NDESC + D_TOFF];
        if (o >= 0 && o <= ti && ti < o + p.desc[s * NDESC + D_NV])
          d = p.desc + s * NDESC;
      }
      const int R = SUB / (int)d[D_STRIDE];
      const A* src = p.part + (d[D_POFF] + (ti - d[D_TOFF]) * R) * LANES;
      A c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = src[lane + 32 * q];
        for (int r = 1; r < R; ++r)
          c[q] = add_rn(c[q], src[r * LANES + lane + 32 * q]);
      }
      c[0] = add_rn(c[0], c[2]);      // s = 64
      c[1] = add_rn(c[1], c[3]);
      c[0] = add_rn(c[0], c[1]);      // s = 32
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        c[0] = add_rn(c[0], __shfl_down_sync(0xffffffffu, c[0], s));
      if (lane == 0) p.tot[ti] = c[0];
    }
    grid.sync();

    // (C) long scalars into the long rows of y2
    if (p.n_long_rows) {
      for (int64_t i = tid; i < (int64_t)p.n_long_rows * LANES;
           i += nthreads) {
        const int l = (int)(i % LANES);
        const int64_t sp = (i / LANES) * LONG_PACK + l;
        A acc = A(0);
        if (l < LONG_PACK && sp < p.n_long) {
          const int64_t k0 = p.inc_ptr[sp];
          const int64_t k1 = p.inc_ptr[sp + 1];
          if (k0 < k1) acc = mul_rn((A)p.inc_mult[k0], p.tot[p.inc_tot[k0]]);
          for (int64_t k = k0 + 1; k < k1; ++k)
            acc = add_rn(acc, mul_rn((A)p.inc_mult[k], p.tot[p.inc_tot[k]]));
        }
        p.y2[long_base + i] = acc;
      }
      grid.sync();
    }

    // (D) outgather, then the tap (y2 row 0 is final; (A) read x_scr
    // before the syncs above)
    for (int64_t b = row; b < p.B; b += rows) {
      A acc = A(0);
      for (int k = 0; k < p.K; ++k) {
        const int s = p.src[b * p.K + k];
        if (s == p.Z) continue;
        const int l = (uint8_t)p.perm[((int64_t)k * p.B + b) * LANES + j];
        acc = add_rn(acc, p.y2[(int64_t)s * LANES + l]);
      }
      p.out[b * LANES + j] = acc;
    }
    for (int64_t i = tid; i < p.x_words; i += nthreads)
      p.x_scr[i] = add_rn(p.x_scr[i], mul_rn(p.y2[i % LANES], p.tap));
    if (it + 1 < p.iters) grid.sync();
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename V, typename A>
int launch(const void* desc, int n_streams, long long nv_total,
           long long n_tot, const void* fold, long long n_fold,
           const void* inc_ptr, const void* inc_tot, const void* inc_mult,
           int n_long, int n_long_rows, const void* src, const void* perm,
           int B, int K, int Z, const void* x, void* x_scr,
           long long x_words, void* part, void* y2, void* tot, void* out,
           int iters, double tap, void* stream) {
  if (iters < 1 || n_streams < 1 || Z < n_long_rows)
    return (int)cudaErrorInvalidValue;
  Params<A> p;
  p.desc = static_cast<const int64_t*>(desc);
  p.n_streams = n_streams;
  p.nv_total = nv_total;
  p.n_tot = n_tot;
  p.fold = static_cast<const int64_t*>(fold);
  p.n_fold = n_fold;
  p.inc_ptr = static_cast<const int64_t*>(inc_ptr);
  p.inc_tot = static_cast<const int64_t*>(inc_tot);
  p.inc_mult = static_cast<const int32_t*>(inc_mult);
  p.n_long = n_long;
  p.n_long_rows = n_long_rows;
  p.src = static_cast<const int32_t*>(src);
  p.perm = static_cast<const int8_t*>(perm);
  p.B = B;
  p.K = K;
  p.Z = Z;
  p.x = static_cast<const A*>(x);
  p.x_scr = static_cast<A*>(x_scr);
  p.x_words = x_words;
  p.part = static_cast<A*>(part);
  p.y2 = static_cast<A*>(y2);
  p.tot = static_cast<A*>(tot);
  p.out = static_cast<A*>(out);
  p.iters = iters;
  p.tap = (A)tap;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resident_kernel<V, A>, LANES * VPB, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as many blocks as are co-resident, or as the largest phase has rows
  int64_t need = cdiv(nv_total, VPB);
  need = std::max(need, cdiv(n_fold, VPB));
  need = std::max(need, cdiv(B, VPB));
  need = std::max(need, cdiv(n_tot, WARPS));
  need = std::max(need, cdiv(x_words, (int64_t)VPB * LANES));
  need = std::max(need, cdiv(n_long_rows, VPB));
  const int grid = (int)std::max<int64_t>(
      1, std::min<int64_t>(need, (int64_t)per_sm * sms));
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)resident_kernel<V, A>,
                                  dim3(grid), dim3(LANES, VPB), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#define DASP_RESIDENT(NAME, V, A)                                            \
  extern "C" int NAME(                                                       \
      const void* desc, int n_streams, long long nv_total, long long n_tot,  \
      const void* fold, long long n_fold, const void* inc_ptr,               \
      const void* inc_tot, const void* inc_mult, int n_long,                 \
      int n_long_rows, const void* src, const void* perm, int B, int K,      \
      int Z, const void* x, void* x_scr, long long x_words, void* part,      \
      void* y2, void* tot, void* out, int iters, double tap, void* stream) { \
    return launch<V, A>(desc, n_streams, nv_total, n_tot, fold, n_fold,      \
                        inc_ptr, inc_tot, inc_mult, n_long, n_long_rows,     \
                        src, perm, B, K, Z, x, x_scr, x_words, part, y2,     \
                        tot, out, iters, tap, stream);                       \
  }

DASP_RESIDENT(dasp_resident_f32, float, float)
DASP_RESIDENT(dasp_resident_bf16, __nv_bfloat16, float)
DASP_RESIDENT(dasp_resident_f64, double, double)
