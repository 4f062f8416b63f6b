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
// Shape on Hopper: K1's (csrc/colsum.cu).  A block of 128 x VPB threads
// takes VPB vregs, thread j owns lane column j, the vreg's idx tile is
// staged in shared memory for the cell lookups, the form and the stride
// are template parameters and P a runtime argument.  NV need not be a
// multiple of VPB (tail masked).
//
// Bound: bytes.  6 B per slot streamed (4 B value, 2 B idx) plus the
// output; the x table (0.75 MB for T3, 2 MB for T2) stays in the 50 MB
// L2.  Each product is rounded and then added (mul_rn / add_rn), as in
// K1: T2 FLANE at any P, T2 at P = 1 and T3 B equal K1 at stride 8, and
// T3 C equals K1 at stride 2, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"

namespace {

constexpr int VPB = 4;          // vregs per block (512 threads)

enum Form { STATIC = 0, ONE = 1, CUR = 2, FLANE = 3, FBOTH = 4 };

template <int FORM, int STRIDE>
__global__ void __launch_bounds__(LANES * VPB)
probe_kernel(const int32_t* __restrict__ wins, const float* __restrict__ vals,
             const int16_t* __restrict__ idx, const float* __restrict__ x2d,
             float* __restrict__ out, int nv, int P) {
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
  float acc[R];
#pragma unroll
  for (int L = 0; L < R; ++L) acc[L] = 0.0f;
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    const int slot = (int)tile[t][i][j];        // upcast before shifting
    const int lam = slot & 127;
    const int cell = (int)tile[t][i][lam];
    const int q = (cell >> 7) & 7;
    float g;
    if (FORM == STATIC) {
      g = x2d[q * LANES + lam];
    } else if (FORM == ONE) {
      g = x2d[(int64_t)(w[0] + q) * LANES + lam];
    } else {
      const int c = FORM == CUR ? slot >> 10
                  : FORM == FLANE ? cell >> 10
                  : (int)tile[t][q][lam] >> 10;
      g = (unsigned)c < (unsigned)P ? x2d[(int64_t)(w[c] + q) * LANES + lam]
                                    : 0.0f;
    }
    acc[i / STRIDE] = add_rn(acc[i / STRIDE],
                             mul_rn(vals[base + i * LANES + j], g));
  }
  float* o = out + v * R * LANES + j;
#pragma unroll
  for (int L = 0; L < R; ++L) o[L * LANES] = acc[L];
}

template <int FORM>
int launch(const void* wins, const void* vals, const void* idx,
           const void* x2d, void* out, int nv, int P, int stride,
           void* stream) {
  if (nv <= 0 || P < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(LANES, VPB);
  const dim3 grid((nv + VPB - 1) / VPB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(wins);
  auto a = static_cast<const float*>(vals);
  auto ix = static_cast<const int16_t*>(idx);
  auto x = static_cast<const float*>(x2d);
  auto o = static_cast<float*>(out);
  switch (stride) {
    case 2: probe_kernel<FORM, 2><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P); break;
    case 4: probe_kernel<FORM, 4><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P); break;
    case 8: probe_kernel<FORM, 8><<<grid, block, 0, s>>>(w, a, ix, x, o, nv, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch_form(int form, const void* wins, const void* vals, const void* idx,
                const void* x2d, void* out, int nv, int P, int stride,
                void* stream) {
  switch (form) {
    case STATIC: return launch<STATIC>(wins, vals, idx, x2d, out, nv, P, stride, stream);
    case ONE: return launch<ONE>(wins, vals, idx, x2d, out, nv, P, stride, stream);
    case CUR: return launch<CUR>(wins, vals, idx, x2d, out, nv, P, stride, stream);
    case FLANE: return launch<FLANE>(wins, vals, idx, x2d, out, nv, P, stride, stream);
    case FBOTH: return launch<FBOTH>(wins, vals, idx, x2d, out, nv, P, stride, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// T2: variant 0 cur, 1 flane, 2 fboth; at P = 1 every variant is the ONE
// form (roundcost_ab.py:51-55).  Output (nv, 128).
extern "C" int dasp_roundcost_probe(const void* wins, const void* vals,
                                    const void* idx, const void* x2d,
                                    void* out, int nv, int P, int variant,
                                    void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  return launch_form(P == 1 ? ONE : CUR + variant, wins, vals, idx, x2d, out,
                     nv, P, SUB, stream);
}

// T3: variant 0 "A" (the static window), 1 "B"; at P > 1 either is the CUR
// form (stream_bench2.py:52-73).  Output (nv * 8 / stride, 128).
extern "C" int dasp_stream_probe(const void* wins, const void* vals,
                                 const void* idx, const void* x2d, void* out,
                                 int nv, int P, int variant, int stride,
                                 void* stream) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  const int form = P > 1 ? CUR : variant == 0 ? STATIC : ONE;
  return launch_form(form, wins, vals, idx, x2d, out, nv, P, stride, stream);
}
