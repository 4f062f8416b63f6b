// Shared by colsum_multi.cu (K1/K3 at kv = 1, K5), resident.cu (K6) and the
// probes: the tile shape, the cell lookup of a slot's x row, and rounded
// arithmetic per sum type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 8;
constexpr int LANES = 128;

// Row of the x table that slot (i, j) gathers: its window's offset plus q,
// with q and the round tag c read at the cell (i, lam) of the idx tile
// (`tile_row` is sublane i of the tile in shared memory; w points at the
// vreg's window offsets, wins[v, 1:]).  idx is upcast before shifting.
__device__ __forceinline__ int64_t x_row(const int16_t* tile_row, int lam,
                                         const int32_t* w, int P) {
  const int cell = (int)tile_row[lam];
  const int q = (cell >> 7) & 7;
  const int c = min(cell >> 10, P - 1);
  return (int64_t)(w[c] + q);
}

// value type -> sum type (bf16 -> f32 is exact)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }

// rounded product and sum, never contracted into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

}  // namespace
