// K6 (csrc/resident.cu, included whole) at the launch shape its -D flags
// name, for probes/k6_levers.py, which builds one library per shape and
// times them beside each other on one card.  It is on no path of the
// package.  The kernel and its order of arithmetic are resident.cu's own;
// only the Shape of the extra entry points dasp_k6_lever_{f32,bf16,f64}
// differs:
//   K6_COLS=c    lane columns a thread (thread rows of 128 / c threads)
//   K6_MINB=m    blocks a SM the compiler must leave registers for
//   K6_STAGES=s  item stages in shared memory
//   K6_EF=1      the values copied with an L2 evict-first policy
// The defaults are shape (0) of k6_levers.py: one column a thread (512
// threads), 2 blocks a SM, 2 stages, the default cache policy.  With
//   K6_XI=x      x tables gathered together in phase A of an SpMM pass
// it also defines dasp_k6_lever_{f32,bf16,f64}_kv8: a pass of 8 tables at
// the shipped Shape of each value type, for k6_levers.py's kv arm; with
//   K6_XI64=y    y tables together in the f64 pass (x in f32 and bf16)
//   K6_XIL=0     the pass's x tables stacked, as the TPU keeps them (1,
//                the library's PASS_X_INTERLEAVED, by default: interleaved
//                by column)

#define DASP_RESIDENT_KV1_ONLY
#include "resident.cu"

#ifndef K6_COLS
#define K6_COLS 1
#endif
#ifndef K6_MINB
#define K6_MINB 2
#endif
#ifndef K6_STAGES
#define K6_STAGES 2
#endif
#ifndef K6_EF
#define K6_EF 0
#endif

namespace {
using LeverShape = Shape<K6_COLS, K6_MINB, K6_STAGES, K6_EF != 0>;
}  // namespace

DASP_RESIDENT(dasp_k6_lever_f32, float, float, LeverShape, 1, 1, 0)
DASP_RESIDENT(dasp_k6_lever_bf16, __nv_bfloat16, float, LeverShape, 1, 1, 0)
DASP_RESIDENT(dasp_k6_lever_f64, double, double, LeverShape, 1, 1, 0)

// the build figures of the shape's instance for value type dtype (0 f32,
// 1 bf16, 2 f64), as dasp_resident_info gives them
extern "C" int dasp_k6_lever_info(int dtype, int* out) {
  switch (dtype) {
    case 0: return info<float, float, LeverShape>(out);
    case 1: return info<__nv_bfloat16, float, LeverShape>(out);
    case 2: return info<double, double, LeverShape>(out);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef K6_XI
#ifndef K6_XI64
#define K6_XI64 K6_XI
#endif
#ifndef K6_XIL
#define K6_XIL PASS_X_INTERLEAVED
#endif
namespace {
constexpr bool LEVER_XIL = K6_XIL != 0;
}  // namespace
DASP_RESIDENT(dasp_k6_lever_f32_kv8, float, float, ShapeF32, 8, K6_XI,
              LEVER_XIL)
DASP_RESIDENT(dasp_k6_lever_bf16_kv8, __nv_bfloat16, float, ShapeF32, 8,
              K6_XI, LEVER_XIL)
DASP_RESIDENT(dasp_k6_lever_f64_kv8, double, double, ShapeF64, 8, K6_XI64,
              LEVER_XIL)

// the build figures of the kv = 8 instance of value type dtype
extern "C" int dasp_k6_lever_kv_info(int dtype, int* out) {
  switch (dtype) {
    case 0: return info<float, float, ShapeF32, 8, K6_XI, LEVER_XIL>(out);
    case 1:
      return info<__nv_bfloat16, float, ShapeF32, 8, K6_XI, LEVER_XIL>(out);
    case 2: return info<double, double, ShapeF64, 8, K6_XI64, LEVER_XIL>(out);
  }
  return (int)cudaErrorInvalidValue;
}
#endif
