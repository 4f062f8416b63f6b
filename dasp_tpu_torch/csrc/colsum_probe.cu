// colsum_probe (T2 and T3): the colsum body with one feature changed at a
// time, to time what each feature of K1 costs on Hopper.
//
// Replaces tools/roundcost_ab.py:make_colsum (:40-122, T2: what a window
// round costs, by where the round tag is read) and
// tools/stream_bench2.py:make (:39-101, T3: a ladder from a static
// window to P rounds).  A stream is NV vregs, each an 8x128 tile of f32
// values and int16 idx; with lam = idx & 127, cell = the idx word at
// (i, lam) of the same tile, q = (cell >> 7) & 7 and w_p = wins[v, 1+p],
// slot (i, j) of vreg v gathers
//   STATIC  x[q, lam]                                (T3 A: no wins read)
//   ONE     x[w_0 + q, lam]                          (P = 1; T3 B, C)
//   CUR     x[w_c + q, lam], c = idx[i,j] >> 10      (tag at the slot;
//                                                     T2 cur, T3 D-F)
//   FLANE   x[w_c + q, lam], c = cell >> 10          (tag at the cell: K1)
//   FBOTH   x[w_c + q, lam], c = idx[q, lam] >> 10   (tag at row q of the
//                                                     raw tile, lane lam)
// and a tag outside [0, P) gathers 0, as the tools' masked-select trees
// do.  The
// trees pick exactly one round per slot, so this reads the tag and does
// ONE gather per slot, not P masked ones: what the probes measure here is
// how the time varies with P (a wins row is P+1 words) and with where the
// tag is read.  The products of each group of `stride` sublanes are
// summed in sublane order: out (NV*8/stride, 128).
//
// Bound: bytes.  6 B per slot streamed (4 B value, 2 B idx) plus the
// output; the x table (0.75 MB for T3, 2 MB for T2) stays in the 50 MB
// L2.  Each product is rounded and then added (mul_rn / add_rn), as in
// K1: T2 FLANE at any P, T2 at P = 1 and T3 B equal K1 at stride 8, and
// T3 C equals K1 at stride 2, bit for bit.
//
// The first design (K1's shape: blocks of 4 vregs that exit, the idx tile
// copied in synchronously, each window word w[c] read from device memory,
// nothing staged for the next vreg) ran T3 D (P = 4) at 23.0 us and T2 cur
// at P = 32 at 35.5 against bounds of 8.4 and 8.9 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md §6): each vreg's chain of dependent loads (idx, cell,
// wins, x) ran with nothing overlapping it.
//
// Shape on Hopper: K6's phase A (csrc/resident.cu), the colsum users run.
// A block of 128 threads (thread j owns lane column j) walks every
// gridDim.x-th vreg of a persistent grid (the co-resident blocks of the
// instance, at most NV).  While it computes vreg v, the operands of
// v + gridDim.x are on their way into the other of two shared-memory
// stages by cp.async: its idx tile, its values and its wins row, so the
// cell lookup, the tag and the window word come from shared memory; a
// thread's 8 gathers are issued before its first product.  A stage is
// 6,288 B, two are 12.6 KB of static shared memory a block.  The form and
// the stride are template parameters, P a runtime argument.  Every window
// a vreg names must lie whole in x.
//
// What holds it back (PERF.md §6, PR 11's table: chip_smoke.py's [probe]
// sweeps, one launch a graph replay; NVIDIA H100 80GB HBM3, 700 W): the x
// gathers' L2 sectors.  A warp's 32 gathers touch ~20-32 sectors, and a
// vreg's 1,024 touch an estimated ~128 (P = 1) to ~900 (P = 32) distinct
// ones, all served by L2.  In the T3 ladder, D (4 random windows) and E
// (the same 4 tags, every window 0, which stays in L1) differ in nothing
// else, and E runs in about 0.6 of D's time; T2 cur's time grows with P
// as those distinct sectors do, about threefold from P = 1 to P = 32.
// Staging the vreg's windows in shared memory too (8 rows x 512 B, 4 KB
// each, fetched whole) was slower at every P it was tried (P <= 2 and
// P <= 4), and loading the values with ld.global.cs rather than staging
// them was within a few per cent at the tools' sizes: PERF.md §6 gives
// the readings and the commit whose probes/probe_levers.py took them.
//
// NV need not be a multiple of the grid (each block takes what is left).

#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"
#include "cp_async.cuh"

namespace {

constexpr int MAX_P = 32;       // tags an int16 idx can carry (0..31): the
                                // words of a wins row that are read
constexpr int MIN_BLOCKS = 8;   // blocks a SM the compiler must allow (at
                                // most 64 registers a thread)
constexpr int MAX_DEV = 16;     // devices whose occupancies are cached

// one stage: idx tile, values, wins row (MAX_P + 1 words, padded to 16 B)
struct __align__(16) Stage {
  int16_t tile[SUB][LANES];
  float vals[SUB][LANES];
  int32_t wins[(MAX_P + 1 + 3) / 4 * 4];
};

enum Form { STATIC = 0, ONE = 1, CUR = 2, FLANE = 3, FBOTH = 4 };

template <int FORM, int STRIDE>
__global__ void __launch_bounds__(LANES, MIN_BLOCKS)
probe_kernel(const int32_t* __restrict__ wins, const float* __restrict__ vals,
             const int16_t* __restrict__ idx, const float* __restrict__ x2d,
             float* __restrict__ out, int nv, int P) {
  constexpr int R = SUB / STRIDE;
  __shared__ Stage stages[2];
  const int j = threadIdx.x;
  const int64_t G = gridDim.x;
  // start the copies of vreg v into stage s; every thread commits one
  // group, so that the pending counts of all threads stay in step
  auto stage = [&](Stage& s, int64_t v) {
    cp_async16(&s.tile[0][0] + 8 * j, idx + v * SUB * LANES + 8 * j);
#pragma unroll
    for (int k = 0; k < SUB * LANES / 4 / LANES; ++k)
      cp_async16(&s.vals[0][0] + 4 * (j + LANES * k),
                 vals + v * SUB * LANES + 4 * (j + LANES * k));
    if (FORM != STATIC && j <= min(P, MAX_P))
      cp_async4(s.wins + j, wins + v * (P + 1) + j);
    cp_async_commit();
  };

  int64_t v = blockIdx.x;
  stage(stages[0], v);
  for (int b = 0; v < nv; v += G, b ^= 1) {
    if (v + G < nv) {
      stage(stages[b ^ 1], v + G);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage& st = stages[b];
    const int32_t* w = st.wins + 1;
    float g[SUB], a[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      a[i] = st.vals[i][j];
      const int slot = (int)st.tile[i][j];      // upcast before shifting
      const int lam = slot & 127;
      const int cell = (int)st.tile[i][lam];
      const int q = (cell >> 7) & 7;
      if (FORM == STATIC || FORM == ONE) {
        g[i] = x2d[(int64_t)((FORM == ONE ? w[0] : 0) + q) * LANES + lam];
      } else {
        const int c = FORM == CUR ? slot >> 10
                    : FORM == FLANE ? cell >> 10
                    : (int)st.tile[q][lam] >> 10;
        g[i] = (unsigned)c >= (unsigned)P
                   ? 0.0f : x2d[(int64_t)(w[c] + q) * LANES + lam];
      }
    }
    float acc[R];
#pragma unroll
    for (int L = 0; L < R; ++L) acc[L] = 0.0f;
#pragma unroll
    for (int i = 0; i < SUB; ++i)
      acc[i / STRIDE] = add_rn(acc[i / STRIDE], mul_rn(a[i], g[i]));
    float* o = out + v * R * LANES + j;
#pragma unroll
    for (int L = 0; L < R; ++L) o[L * LANES] = acc[L];
    __syncthreads();              // stage b is refilled two vregs on
  }
}

constexpr int stride_index(int stride) {
  return stride == 2 ? 0 : stride == 4 ? 1 : 2;
}

template <int FORM>
const void* kernel_stride(int stride) {
  switch (stride) {
    case 2: return (const void*)probe_kernel<FORM, 2>;
    case 4: return (const void*)probe_kernel<FORM, 4>;
    case 8: return (const void*)probe_kernel<FORM, 8>;
  }
  return nullptr;
}

const void* kernel_form(int form, int stride) {
  switch (form) {
    case STATIC: return kernel_stride<STATIC>(stride);
    case ONE: return kernel_stride<ONE>(stride);
    case CUR: return kernel_stride<CUR>(stride);
    case FLANE: return kernel_stride<FLANE>(stride);
    case FBOTH: return kernel_stride<FBOTH>(stride);
  }
  return nullptr;
}

// The instance of (form, stride), its co-resident blocks a SM (found once
// per device and instance) and the SMs.
int plan(int form, int stride, const void** f, int* per_sm, int* sms) {
  *f = kernel_form(form, stride);
  if (!*f) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  static int cache[MAX_DEV][5][3];
  int& c = cache[dev][form][stride_index(stride)];
  if (c == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c, *f, LANES, 0);
    if (e != cudaSuccess) {
      c = 0;
      return (int)e;
    }
    if (c < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  *per_sm = c;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

int launch_form(int form, const void* wins, const void* vals, const void* idx,
                const void* x2d, void* out, int nv, int P, int stride,
                void* stream) {
  if (nv <= 0 || P < 1) return (int)cudaErrorInvalidValue;
  const void* f = nullptr;
  int per_sm = 0, sms = 0;
  int rc = plan(form, stride, &f, &per_sm, &sms);
  if (rc) return rc;
  const int cap = per_sm * sms;
  void* args[] = {&wins, &vals, &idx, &x2d, &out, &nv, &P};
  cudaError_t e = cudaLaunchKernel(f, dim3(nv < cap ? nv : cap), dim3(LANES),
                                   args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int roundcost_form(int P, int variant) { return P == 1 ? ONE : CUR + variant; }

int stream_form(int P, int variant) {
  return P > 1 ? CUR : variant == 0 ? STATIC : ONE;
}

// registers a thread, local (stack and spill) bytes a thread, shared bytes
// a block and co-resident blocks a SM of the instance of (form, stride)
int info(int form, int stride, int* out) {
  const void* f = nullptr;
  int per_sm = 0, sms = 0;
  int rc = plan(form, stride, &f, &per_sm, &sms);
  if (rc) return rc;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = per_sm;
  return 0;
}

}  // namespace

// T2: variant 0 cur, 1 flane, 2 fboth; at P = 1 every variant is the ONE
// form (roundcost_ab.py:51-55).  Output (nv, 128).
extern "C" int dasp_roundcost_probe(const void* wins, const void* vals,
                                    const void* idx, const void* x2d,
                                    void* out, int nv, int P, int variant,
                                    void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  return launch_form(roundcost_form(P, variant), wins, vals, idx, x2d, out,
                     nv, P, SUB, stream);
}

// T3: variant 0 "A" (the static window), 1 "B"; at P > 1 either is the CUR
// form (stream_bench2.py:52-73).  Output (nv * 8 / stride, 128).
extern "C" int dasp_stream_probe(const void* wins, const void* vals,
                                 const void* idx, const void* x2d, void* out,
                                 int nv, int P, int variant, int stride,
                                 void* stream) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  return launch_form(stream_form(P, variant), wins, vals, idx, x2d, out, nv,
                     P, stride, stream);
}

// The [build] figures (info above) of T2's (P, variant) and of T3's
// (P, variant, stride), as the two entry points above would launch them.
extern "C" int dasp_roundcost_probe_info(int P, int variant, int* out) {
  if (variant < 0 || variant > 2 || P < 1) return (int)cudaErrorInvalidValue;
  return info(roundcost_form(P, variant), SUB, out);
}

extern "C" int dasp_stream_probe_info(int P, int variant, int stride,
                                      int* out) {
  if (variant < 0 || variant > 1 || P < 1) return (int)cudaErrorInvalidValue;
  return info(stream_form(P, variant), stride, out);
}
