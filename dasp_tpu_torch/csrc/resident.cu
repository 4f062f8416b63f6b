// resident (K6): `iters` chained SpMVs in ONE persistent cooperative launch.
//
// Replaces dasp_tpu/ops/resident.py:make_resident_loop (:452; kernel
// kernel_factory :508-1036, pallas_call :1137).  Each step t computes a
// whole y from x_t (the caller's x at t = 0, the kernel's own copy x_scr
// after) and feeds it back:
//   (A) per work item of the schedule (ops/resident.py:prepare): up to
//       VPB vregs of one stream, one per thread row.  Each thread row
//       computes its vreg's colsum (K1's math) in registers, folds its F
//       consecutive levels into the R levels of the y2 rows it feeds, and,
//       when a long scalar reads the vreg, its total.  The item then sums
//       its vregs' folded levels per slice in shared memory and writes
//       them: as y2 rows when the item holds whole slices (w8 <= VPB), or
//       as the rows of one chunk in `cbuf` when it holds a chunk of a wide
//       slice (w8 > VPB);
//   (C) only when the plan has wide slices or long rows: each wide y2 row
//       is the sum of its slice's chunk rows; each long scalar
//       p = sum of multiplicity x total over its list, into y2 row
//       Z - n_long_rows + p / 127, lane p % 127 (lane 127 and the tail of
//       the last long row are written as zero);
//   (D) the outgather (outgather_common.cuh, K2's body) into out, and,
//       at every step but the last, the tap
//       x_scr[r, l] = x_t[r, l] + y2[0, l] * tap on every row r (nothing
//       reads a tap after the last step: at iters = 1 there is none, and
//       no x_scr).
// The COO residue (the rows the packer left out of the streams) is summed
// from the caller's x once per call, in phase A of step 0 after the
// block's items: a warp takes a task of the residue schedule
// (ops/resident.py:prepare), either up to 32 rows, one a lane, each
// summed over its octave tree's slots in order, or one row of a tree at
// least RES_WARP_MIN slots wide, its slots dealt to the lanes (lane i
// sums slots i, i + 32, ...) and the lanes added by a shuffle tree.  The
// sums wait in rsum, and in phase D of the last step the thread that
// outgathers a row's lane adds its sum to it, so a single-vector SpMV is
// one launch at iters = 1.
// Phases are separated by cg::this_grid().sync(): two per step (after A,
// after D) when the plan has no wide slice and no long row, three with
// them, and none after the last step's D unless the clock runs; there is
// no phase B.  Every output word is written by one thread and there are no
// atomics, so the result is deterministic.  Instances
// (value / sum type): dasp_resident_f32 (float / float),
// dasp_resident_bf16 (__nv_bfloat16 / float), dasp_resident_f64 (double /
// double: native fp64, where the reference carries double-double pairs
// and an f32 incidence matmul).
//
// An SpMM pass (dasp_resident_{f32,bf16,f64}_kv{2,4,8}, spmm_kernel) runs
// one step for KV x tables in one launch, the phases of resident_kernel
// without the chain and its tap.  Its layouts are the card's, not the
// TPU's (PASS_X_INTERLEAVED): x is one (S * 128, KV) array, the tables
// interleaved by column (word at * KV + v is table v's word at; at KV = 1
// the one-table layout), so that one 16-byte load (8-byte for two f32
// tables) gathers a slot's words of a group of tables, a span of KV words
// where the TPU's stacked (KV * S, 128) tables cost one 32-byte sector a
// table; out is (B * 128, KV) in the value type, the caller's Y: phase D
// gives a thread an output block's lane and all KV tables, and writes its
// KV sums together, bf16 rounded once from the f32 sum (no kernel after
// the pass).  Phase A stages an item's operands once and folds the tables
// from the same shared tile, XI of them gathered together, each through
// red and lsum
// into its own y2, chunk rows and totals; the residue's (task, table)
// pairs, (C)'s wide rows and long lanes are dealt over the grid per
// table.  y2 stays one buffer a table: interleaved, phase A's writes
// scatter a word a sector and the pass ran slower (PERF.md §6).
// So A is read from device memory once a pass, as K5 reads it, and a
// thread holds XI tables' sums at a time, not KV as K5 does: the f64
// instances stay without local memory.  Table v's y2 and Y column are
// word for word those of a one-table step on table v.  The pass has a
// kernel of its own so that resident_kernel's code stays as it was: one
// kernel templated on KV moved the one-table build's register allocation
// (8 -> 0 local bytes) and made its f32 and bf16 steps 1-3 % slower
// (PERF.md §6).  The two kernels share phase A's colsum (colsum_fold, XI
// = 1 and the stacked form in a step) and the residue's sums
// (residue_sums, KV = 1 in a step); so shared, resident_kernel's SASS is
// the same as with copies of its own.  The phase clock is compiled only
// at KV = 1 and at KV_CLOCK.  What bounds a pass is phase A's chain of
// dependent loads, as for a step, and past the L2 the sectors its
// gathers pull.  A pass of 8 on an NVIDIA H100 80GB HBM3 at 700 W
// (probes/k6_levers.py's kv arm, PERF.md §6) at cop20k_like /
// webbase_like / rmat_like / uniform_medium: f32 58.4 / 83.6 / 555.9 /
// 157.1 us, f64 111.0 / 146.5 / 911.6 / 287.4, against 167.1 / 276.0 /
// 863.1 / 359.1 and 171.1 / 286.6 / 935.3 / 390.7 for cuSPARSE A @ X,
// and f32 62.1 / 86.6 / 644.6 / 196.7, f64 108.3 / 150.1 / 1219.2 /
// 466.1 with the x tables stacked.
//
// Order of arithmetic (ops/resident.py's docstring; resident_loop_plain
// follows it, and every add and product is rounded, never contracted):
// colsum as K1 (sublanes in order within a level); a vreg's folded level r
// adds its levels rF .. rF+F-1 in order; a chunk adds the folded levels of
// its (at most VPB) vregs in order; a slice's y2 row is its one chunk, or,
// for a wide slice, its chunks added in order from the first; a vreg total
// adds the vreg's levels per lane in order, then a lane tree
// c[l] += c[l + s], s = 64, 32, 16, 8, 4, 2, 1; a long scalar adds
// m * total over its list in order from the first product; the outgather
// adds the k_used slots in order from zero; a residue row's sum starts at
// the product of its tree's slot 0 and adds the slots 1 .. w - 1 in order
// (a padding slot adds a zero), or, for a tree of w >= RES_WARP_MIN slots,
// lane i adds the slots i, i + 32, ... in order and the lanes are added by
// c[l] += c[l + s], s = 16, 8, 4, 2, 1; the residue sum is added to the
// outgather's sum last.
//
// What bounds it on this card.  Latency, not bytes: the bytes a step
// moves (each scheduled vreg's wins, vals and idx, the x table, y2 and the
// chunk rows written and read once, src and the used slots' perm, out,
// the tap's read and write of x_scr; chip_smoke.py:resident_bytes) take
// 7-34 us at the copy rate over the two suite arms and three dtypes, and
// phase A is a chain of dependent loads (idx and wins, then the x
// gathers) per item at 2 blocks of 512 threads a SM.  The first design
// spent 27-51 % of its step outside the colsum: one thread row per y2
// row added up to w8 x F = 128 partial rows one L2 round trip after
// another while every other block waited at the barrier, every partial
// row went to device memory and back, each step had three or four grid
// barriers, the outgather had one slot's loads in flight, and each vreg
// scanned the stream descriptors.  This design folds in registers and
// shared memory inside phase A (no partials buffer, no phase B); cuts a
// wide slice into chunks of VPB vregs whose rows phase C combines with
// eight loads in flight; stages each item's idx tile, values and wins row
// into shared memory with cp.async while the block computes the item
// before it (and the first item of the next step before the step's
// barriers), so that an item waits only on its x gathers; sorts the
// schedule by cost so that the dearest items (P = 32 vregs) start first;
// names each item's stream directly; and issues phase D's gathers of a
// block together.  Measured with chip_smoke.py on an NVIDIA H100 80GB
// HBM3 at 700 W, graph replay of a chain of 100, per step at
// cop20k_like / webbase_like: f32 21.7 / 32.6 us, bf16 21.0 / 28.6, f64
// 35.2 / 49.2, against 29.9 / 75.6, 27.8 / 71.5 and 52.8 / 88.4 for the
// first design on the same card and 23.5 / 29.4 (f32) and 26.8 / 39.3
// (f64) for cuSPARSE.  The phase clock (`stamps`) times the phases; with
// it on, a barrier of its own ends the items of step 0 so that the
// residue's sums have a word of their own (R; its adds count in D), and D
// has no tap at the last step.  PERF.md has the split before and
// after.
//
// Shape on Hopper (`Shape`): blocks of VPB thread rows, as many as are
// co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, fewer
// if the work needs fewer), launched by cudaLaunchCooperativeKernel with
// two item stages in dynamic shared memory; each phase walks its work in a
// grid-stride loop.  In (A) thread j of a thread row owns the lane
// columns j, j + 128 / COLS, ... of its vreg, and reads the cell of each
// slot from the staged idx tile, as in K1; a stream's stride and the
// item's F select a templated body.  Each value type runs the shape that
// probes/k6_levers.py measured fastest on cop20k_like, webbase_like and
// rmat_like (PERF.md §6).  fp64 threads own two lane columns: thread
// rows of 64, 256 threads a block, two blocks a SM at 128 registers with
// no local memory, 16 gathers a thread and as many in flight a SM as at
// one column (8,192); phase D and the tap keep twice the loads in flight
// a thread, so a SM keeps as many as at one column.  At one column and
// 64 registers the fp64 body spilled (168 B of local memory a thread,
// 176 B of spill stores; the f64 step ran 5-11 % slower once the
// residue's code added to them), and one block of 512 threads a SM at
// 128 registers halved the x gathers in flight.  f32 and bf16 keep one
// column a thread (512 threads, two blocks a SM, 64 registers): two
// columns were slower at rmat_like (f32) and webbase_like (bf16).  Every
// instance copies its values with an L2 evict-first policy, so that x
// and the idx tiles stay in the L2 for the gathers (fp64 values are 8 of
// a slot's 10 bytes).  Per f64 step of a chain of 100 at cop20k_like /
// webbase_like / rmat_like on an NVIDIA H100 80GB HBM3 at 700 W: 26.08 /
// 41.24 / 266.17 us against 33.53 / 48.20 / 272.20 us at one column a
// thread and 64 registers.
// y2, the chunk rows, the totals and x_scr live in device memory (L2 for
// all but the largest plans): the wrapper allocates them, the kernel
// allocates nothing.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "colsum_common.cuh"
#include "cp_async.cuh"
#include "outgather_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int VPB = 4;                     // thread rows (vregs) per block
constexpr int MAX_R = 4;                   // y2 levels per slice (stride 2)
constexpr int LONG_PACK = 127;             // long scalars per y2 row
constexpr int COMBINE = 8;                 // chunk rows in flight in (C)
constexpr int TAP_U = 2;                   // x vectors in flight a lane
                                           // column in the tap
constexpr int MAX_P = 32;                  // windows of a vreg (the packer's
                                           // P_CLASSES[-1])
constexpr int WARP = 32;
constexpr int RES_WARP_MIN = 64;           // tree slots from which a residue
                                           // row takes a whole warp

// The launch shape of an instance: COLS lane columns a thread (a thread
// row is TW = 128 / COLS threads, lanes j, j + TW, ...; a block VPB thread
// rows), MINB blocks a SM that the compiler must leave registers for
// (65,536 / (threads x MINB) a thread), STAGES item stages in shared
// memory (STAGES - 1 items' operands in flight while one computes), and
// whether the values are copied with an L2 evict-first policy.
template <int COLS_, int MINB_, int STAGES_, bool EVICT_FIRST_>
struct Shape {
  static_assert(LANES % COLS_ == 0 && LANES / COLS_ > MAX_P,
                "a thread row copies a vreg's wins row, a word a thread");
  static constexpr int COLS = COLS_;
  static constexpr int TW = LANES / COLS_;
  static constexpr int THREADS = TW * VPB;
  static constexpr int MINB = MINB_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool EVICT_FIRST = EVICT_FIRST_;
};

// int64 fields of one stream's row of the descriptor table, in the order
// of ops/resident.py:DESC_FIELDS
enum { D_WINS, D_VALS, D_IDX, D_P, D_STRIDE, NDESC };
// int32 fields of a work item (ops/resident.py:ITEM_FIELDS)
enum { I_STREAM, I_V0, I_NV, I_W, I_F, I_R, I_DST, I_OUT, I_TOT, I_MASK,
       NITEM };
enum { DST_Y2, DST_CHUNK, DST_NONE };      // where an item's rows go
// int32 fields of a wide y2 row (ops/resident.py:WIDE_FIELDS)
enum { W_Y2, W_FIRST, W_N, W_STEP, NWIDE };
// int32 fields of a residue row (ops/resident.py:RES_FIELDS): its first
// slot, its slots, its tree's width; of a residue task (RES_TASK_FIELDS):
// its first row, its rows
enum { R_SLOT, R_LEN, R_W, NRES };
enum { T_FIRST, T_N, NTASK };
// words of the phase clock (ops/resident.py:STAMPS)
enum { S_A, S_R, S_C, S_D, S_GRID, S_PER_SM, STAMP_WORDS };

template <typename A>
struct Params {
  const int64_t* desc;      // (n_streams, NDESC)
  const int32_t* items;     // (n_items, NITEM), in schedule order
  int n_items;
  const int32_t* wide;      // (n_wide, NWIDE)
  int n_wide;
  A* cbuf;                  // chunk rows of the wide slices
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
  A* y2;                    // (Z + 1, 128): row Z is zeroed at the start
  A* tot;                   // vreg totals
  A* out;                   // (B, 128)
  const int32_t* res_ent;   // (n_res, NRES) residue rows, in task order
  const int32_t* res_task;  // (n_res_tasks, NTASK)
  int n_res_tasks;
  const int32_t* res_cols;  // residue slots: x word, value
  const A* res_vals;
  A* rsum;                  // (n_res,) the residue rows' sums
  const int32_t* res_bptr;  // (B + 1,) residue entries of each out block
  const int32_t* res_bent;  // row index * 128 + lane, by block
  int iters;
  A tap;
  long long* stamps;        // the phase clock (STAMP_WORDS), or null
  int per_sm;               // co-resident blocks per SM (for the clock)
};

// spmm_kernel's: K6's and the words from one x table's buffer to the next's
// (x's is x_words, y2's (Z + 1) x 128, out's B x 128)
template <typename A>
struct PassParams : Params<A> {
  int64_t cbuf_vs, tot_vs, rsum_vs;
};

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// The phase clock: thread 0 of block 0 reads %globaltimer at the start,
// right after every grid.sync() and at the end, and adds each interval to
// its phase's word of `stamps` in device memory (so that no array of the
// clock sits in a thread's local memory); the times thus include the
// wait for the slowest block.  It is compiled only into the kernel that a
// call with `stamps` launches (ON): every other call's kernel holds no
// register for it.
template <bool ON>
struct Clock {
  long long* out;
  long long last;
  __device__ explicit Clock(long long* stamps)
      : out(ON && blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0
                ? stamps : nullptr), last(0) {
    if (!out) return;
    for (int k = 0; k < STAMP_WORDS; ++k) out[k] = 0;
    last = global_ns();
  }
  __device__ void lap(int phase) {
    if (!out) return;
    const long long now = global_ns();
    out[phase] += now - last;
    last = now;
  }
  __device__ void write(int per_sm) {
    if (!out) return;
    out[S_GRID] = gridDim.x;
    out[S_PER_SM] = per_sm;
  }
};

// The operands of one work item, staged into shared memory by cp.async
// while the block computes the item before it: the item's row of the
// schedule, and per thread row its vreg's idx tile, values and wins row.
template <typename V>
struct alignas(16) Stage {
  int16_t tile[VPB][SUB][LANES];
  V vals[VPB][SUB][LANES];
  int32_t wins[VPB][MAX_P + 1];
  int32_t item[NITEM];
};

// Start the copies of item g into `st`; every thread commits one group, so
// that the groups of all threads stay in step.  Thread j of a thread row
// copies the 16-byte pieces j, j + TW, ... of its vreg's idx tile and
// values.
template <typename V, class S>
__device__ __forceinline__ void stage_item(Stage<V>& st, const int32_t* items,
                                           const int64_t* desc, int64_t g,
                                           int t, int j, uint64_t policy) {
  const int32_t* item = items + g * NITEM;
  if (t == 0 && j < NITEM) cp_async4(&st.item[j], item + j);
  if (t < item[I_NV]) {
    const int64_t* d = desc + (int64_t)item[I_STREAM] * NDESC;
    const int64_t v = (int64_t)item[I_V0] + t;
    const int P = (int)d[D_P];
    constexpr int TILE = SUB * LANES * (int)sizeof(int16_t) / 16;
    constexpr int CHUNKS = SUB * LANES * (int)sizeof(V) / 16;
    static_assert(TILE % S::TW == 0 && CHUNKS % S::TW == 0,
                  "a thread row copies whole 16-byte pieces");
    const int16_t* gt =
        reinterpret_cast<const int16_t*>(d[D_IDX]) + v * SUB * LANES;
#pragma unroll
    for (int k = 0; k < TILE / S::TW; ++k)
      cp_async16(&st.tile[t][0][0] + 8 * (j + k * S::TW),
                 gt + 8 * (j + k * S::TW));
    const char* gv = reinterpret_cast<const char*>(
        reinterpret_cast<const V*>(d[D_VALS]) + v * SUB * LANES);
    char* sv = reinterpret_cast<char*>(&st.vals[t][0][0]);
#pragma unroll
    for (int k = 0; k < CHUNKS / S::TW; ++k) {
      const int c = j + k * S::TW;
      if constexpr (S::EVICT_FIRST)
        cp_async16_hint(sv + 16 * c, gv + 16 * c, policy);
      else
        cp_async16(sv + 16 * c, gv + 16 * c);
    }
    if (j <= P)   // TW >= MAX_P + 1
      cp_async4(&st.wins[t][j],
                reinterpret_cast<const int32_t*>(d[D_WINS]) + v * (P + 1) + j);
  }
  cp_async_commit();
}

// XN consecutive words of p into v, as 16-byte loads (8-byte for two f32
// words); p is aligned to XN words (to 16 bytes at most).  Plain loads,
// as the stacked tables' gathers are: they serve an SpMM pass's x tables.
template <int XN>
__device__ __forceinline__ void load_words(const float* p, float (&v)[XN]) {
  static_assert(XN % 4 == 0 || XN == 2, "2, 4 or 8 words");
  if constexpr (XN % 4 == 0) {
#pragma unroll
    for (int k = 0; k < XN / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
}
template <int XN>
__device__ __forceinline__ void load_words(const double* p,
                                           double (&v)[XN]) {
  static_assert(XN % 2 == 0, "2, 4 or 8 words");
#pragma unroll
  for (int k = 0; k < XN / 2; ++k) {
    const double2 q = reinterpret_cast<const double2*>(p)[k];
    v[2 * k] = q.x;
    v[2 * k + 1] = q.y;
  }
}

// N consecutive output words v into p, as 16-byte stores (8-byte for two
// f32 words); p is aligned to N words (to 16 bytes at most)
template <int N>
__device__ __forceinline__ void store_words(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
    static_assert(N == 2, "2, 4 or 8 words");
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}
template <int N>
__device__ __forceinline__ void store_words(double* p,
                                            const double (&v)[N]) {
  static_assert(N % 2 == 0, "2, 4 or 8 words");
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    reinterpret_cast<double2*>(p)[k] = make_double2(v[2 * k], v[2 * k + 1]);
}
// bf16 words, packed two to a 32-bit word: 4, 8 or 16 bytes
template <int N>
__device__ __forceinline__ void store_words(__nv_bfloat16* p,
                                            const __nv_bfloat16 (&v)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 words");
  uint32_t w[N / 2];
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    w[k] = (uint32_t)__bfloat16_as_ushort(v[2 * k])
           | ((uint32_t)__bfloat16_as_ushort(v[2 * k + 1]) << 16);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (N == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// the sum type's word -> the output type's (bf16 rounds once, to nearest
// even, as the plain version's .to(torch.bfloat16))
__device__ __forceinline__ float narrow_to(float a, float) { return a; }
__device__ __forceinline__ double narrow_to(double a, double) { return a; }
__device__ __forceinline__ __nv_bfloat16 narrow_to(float a, __nv_bfloat16) {
  return __float2bfloat16_rn(a);
}

// one vreg's colsum (K1's body) from its staged operands, for the COLS
// lane columns j + c * TW of the thread and XI x tables, their gathers in
// flight together: tables x, x + xs, ... (XK = 0: one table in a step, or
// an SpMM pass's tables stacked), or the words x[at * XK + u] (an SpMM
// pass's tables interleaved, XK = KV; one load of XI words a slot).
// R = 8/STRIDE level sums a column and table in registers; then table u's
// R/F folded levels lv[u][c] and its lane sum ls[u][c]
template <typename V, typename A, int COLS, int STRIDE, int F, int XI,
          int XK>
__device__ __forceinline__ void colsum_fold(const int16_t (*tile)[LANES],
                                            const int32_t* w, int P,
                                            const V (*vals)[LANES],
                                            const A* x, int64_t xs, int j,
                                            A (&lv)[XI][COLS][MAX_R],
                                            A (&ls)[XI][COLS]) {
  constexpr int R = SUB / STRIDE;
  constexpr int TW = LANES / COLS;
  A acc[XI][COLS][R];
#pragma unroll
  for (int u = 0; u < XI; ++u)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int L = 0; L < R; ++L) acc[u][c][L] = A(0);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int jc = j + c * TW;
      const int lam = (int)tile[i][jc] & 127;
      const int64_t at = x_row(tile[i], lam, w, P) * LANES + lam;
      if constexpr (XK == 0) {
#pragma unroll
        for (int u = 0; u < XI; ++u) {
          const A xv = x[u * xs + at];
          acc[u][c][i / STRIDE] =
              add_rn(acc[u][c][i / STRIDE], mul_rn(widen(vals[i][jc]), xv));
        }
      } else {
        A xv[XI];
        load_words<XI>(x + at * XK, xv);
#pragma unroll
        for (int u = 0; u < XI; ++u)
          acc[u][c][i / STRIDE] = add_rn(acc[u][c][i / STRIDE],
                                         mul_rn(widen(vals[i][jc]), xv[u]));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < XI; ++u)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      ls[u][c] = acc[u][c][0];
#pragma unroll
      for (int L = 1; L < R; ++L) ls[u][c] = add_rn(ls[u][c], acc[u][c][L]);
#pragma unroll
      for (int r = 0; r < R / F; ++r) {
        lv[u][c][r] = acc[u][c][r * F];
#pragma unroll
        for (int f = 1; f < F; ++f)
          lv[u][c][r] = add_rn(lv[u][c][r], acc[u][c][r * F + f]);
      }
    }
}

template <typename V, typename A, int COLS, int XI, int XK = 0>
__device__ __forceinline__ void colsum_item(
    int stride, int F, const int16_t (*tile)[LANES], const int32_t* w, int P,
    const V (*vals)[LANES], const A* x, int64_t xs, int j,
    A (&lv)[XI][COLS][MAX_R], A (&ls)[XI][COLS]) {
  if (stride == 8) {
    colsum_fold<V, A, COLS, 8, 1, XI, XK>(tile, w, P, vals, x, xs, j, lv,
                                          ls);
  } else if (stride == 4) {
    if (F == 2)
      colsum_fold<V, A, COLS, 4, 2, XI, XK>(tile, w, P, vals, x, xs, j, lv,
                                            ls);
    else
      colsum_fold<V, A, COLS, 4, 1, XI, XK>(tile, w, P, vals, x, xs, j, lv,
                                            ls);
  } else {
    if (F == 4)
      colsum_fold<V, A, COLS, 2, 4, XI, XK>(tile, w, P, vals, x, xs, j, lv,
                                            ls);
    else if (F == 2)
      colsum_fold<V, A, COLS, 2, 2, XI, XK>(tile, w, P, vals, x, xs, j, lv,
                                            ls);
    else
      colsum_fold<V, A, COLS, 2, 1, XI, XK>(tile, w, P, vals, x, xs, j, lv,
                                            ls);
  }
}

// word c of an x table whose words lie XS apart
template <int XS, typename A>
__device__ __forceinline__ A x_word(const A* x, int32_t c) {
  if constexpr (XS == 1)
    return x[c];
  else
    return x[(int64_t)c * XS];
}

// The COO residue's row sums from the KV x tables (an SpMM pass's; KV = 1
// for a step) into rsum, rsum + rsum_vs, ...: a warp per task and table
// (warp `warp` of `warps`, counted from the grid's last warp, whose blocks
// hold the cheapest items), the KV tables of a task on neighbouring warps.
// Table v's word c is x[c * KV + v] with the tables interleaved (XIL),
// x[v * x_words + c] with them stacked.
template <typename A, int KV, bool XIL = false>
__device__ __forceinline__ void residue_sums(const Params<A>& p,
                                             int64_t rsum_vs, int64_t warp,
                                             int64_t warps, int lane) {
  for (int64_t k = warps - 1 - warp; k < (int64_t)p.n_res_tasks * KV;
       k += warps) {
    const int32_t* task = p.res_task + (k / KV) * NTASK;
    const int64_t tab = k % KV;            // the x table
    const A* x = XIL ? p.x + tab : p.x + tab * p.x_words;
    constexpr int XS = XIL ? KV : 1;       // words from one x word to the next
    A* rsum = p.rsum + tab * rsum_vs;
    const int64_t e0 = task[T_FIRST];
    const int32_t* e = p.res_ent + e0 * NRES;
    if (e[R_W] >= RES_WARP_MIN) {          // one wide row for the warp
      const int64_t s0 = e[R_SLOT];
      const int L = e[R_LEN], w = e[R_W];
      A acc = A(0);
      for (int k2 = lane; k2 < w; k2 += WARP) {
        const A v = k2 < L ? mul_rn(p.res_vals[s0 + k2],
                                    x_word<XS>(x, p.res_cols[s0 + k2]))
                           : A(0);
        acc = k2 == lane ? v : add_rn(acc, v);
      }
#pragma unroll
      for (int s = WARP / 2; s > 0; s >>= 1)
        acc = add_rn(acc, __shfl_down_sync(0xffffffffu, acc, s));
      if (lane == 0) rsum[e0] = acc;
    } else if (lane < task[T_N]) {          // a row a lane
      const int32_t* el = e + (int64_t)lane * NRES;
      const int64_t s0 = el[R_SLOT];
      const int L = el[R_LEN], w = el[R_W];
      A acc = mul_rn(p.res_vals[s0], x_word<XS>(x, p.res_cols[s0]));
      for (int k2 = 1; k2 < L; ++k2)
        acc = add_rn(acc, mul_rn(p.res_vals[s0 + k2],
                                 x_word<XS>(x, p.res_cols[s0 + k2])));
      if (w > L) acc = add_rn(acc, A(0));  // the padding slots' zeros
      rsum[e0 + lane] = acc;
    }
  }
}

template <typename V, typename A, class S, bool CLOCK>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
resident_kernel(Params<A> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<V>* const stage = reinterpret_cast<Stage<V>*>(smem);   // S::STAGES
  __shared__ A red[VPB][MAX_R][LANES];     // folded levels of the item
  __shared__ A lsum[VPB][LANES];           // lane sums of the totals
  cg::grid_group grid = cg::this_grid();
  constexpr int TW = S::TW;
  constexpr int NS = S::STAGES;
  const int j = threadIdx.x;               // lane columns j, j + TW, ...
  const int t = threadIdx.y;
  const int64_t row = (int64_t)blockIdx.x * VPB + t;   // this thread row
  const int64_t rows = (int64_t)gridDim.x * VPB;       // thread rows
  const int64_t tid = row * TW + j;
  const int64_t nthreads = rows * TW;
  const int64_t long_base = (int64_t)(p.Z - p.n_long_rows) * LANES;
  const bool mid = p.n_wide > 0 || p.n_long_rows > 0;
  uint64_t policy = 0;
  if constexpr (S::EVICT_FIRST) policy = l2_evict_first();
  Clock<CLOCK> clock(p.stamps);
  if (row == 0) {                           // read from (D) on
#pragma unroll
    for (int c = 0; c < S::COLS; ++c)
      p.y2[(int64_t)p.Z * LANES + j + c * TW] = A(0);
  }
  // the block's first NS - 1 items: their operands do not change from
  // step to step, so each step stages the next step's before its barriers
  int buf = 0;
#pragma unroll
  for (int k = 0; k < NS - 1; ++k)
    if (blockIdx.x + (int64_t)k * gridDim.x < p.n_items)
      stage_item<V, S>(stage[k], p.items, p.desc,
                       blockIdx.x + (int64_t)k * gridDim.x, t, j, policy);

  for (int it = 0; it < p.iters; ++it) {
    const A* x = it == 0 ? p.x : p.x_scr;
    // (A) the schedule, NS items in flight: item g is computed from its
    // staged operands while those of the next NS - 1 are copied in
    for (int64_t g = blockIdx.x; g < p.n_items; g += gridDim.x) {
      const int64_t next = g + (int64_t)(NS - 1) * gridDim.x;
      if (next < p.n_items) {
        stage_item<V, S>(stage[(buf + NS - 1) % NS], p.items, p.desc, next,
                         t, j, policy);
        cp_async_wait<NS - 1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const Stage<V>& st = stage[buf];
      const int32_t* item = st.item;
      const int64_t* d = p.desc + (int64_t)item[I_STREAM] * NDESC;
      const bool live = t < item[I_NV];
      const int w8 = item[I_W];
      const int R = item[I_R];
      const bool total = (item[I_MASK] >> t) & 1;
      A* const o = item[I_DST] == DST_Y2 ? p.y2 : p.cbuf;
      const int64_t out0 = item[I_OUT];
      A lv[1][S::COLS][MAX_R], ls[1][S::COLS];
#pragma unroll
      for (int c = 0; c < S::COLS; ++c) {
        ls[0][c] = A(0);
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) lv[0][c][r] = A(0);
      }
      if (live) {
        colsum_item<V, A, S::COLS, 1>((int)d[D_STRIDE], item[I_F],
                                      st.tile[t], &st.wins[t][1], (int)d[D_P],
                                      st.vals[t], x, 0, j, lv, ls);
#pragma unroll
        for (int c = 0; c < S::COLS; ++c) {
          const int jc = j + c * TW;
          if (w8 == 1 && item[I_DST] != DST_NONE) {
#pragma unroll
            for (int r = 0; r < MAX_R; ++r)
              if (r < R)
                o[(out0 + (int64_t)t * R + r) * LANES + jc] = lv[0][c][r];
          } else if (w8 > 1) {
#pragma unroll
            for (int r = 0; r < MAX_R; ++r)
              if (r < R) red[t][r][jc] = lv[0][c][r];
          }
          if (total) lsum[t][jc] = ls[0][c];
        }
      }
      __syncthreads();
      if (live && w8 > 1 && t % w8 == 0) {   // the first vreg of a slice
#pragma unroll
        for (int c = 0; c < S::COLS; ++c) {
          const int jc = j + c * TW;
#pragma unroll
          for (int r = 0; r < MAX_R; ++r) {
            if (r < R) {
              A acc = red[t][r][jc];
              for (int u = 1; u < w8; ++u) acc = add_rn(acc, red[t + u][r][jc]);
              o[(out0 + (int64_t)(t / w8) * R + r) * LANES + jc] = acc;
            }
          }
        }
      }
      if (live && total && j < 32) {         // warp 0 of the thread row
        A c0 = lsum[t][j], c1 = lsum[t][j + 32];
        const A c2 = lsum[t][j + 64], c3 = lsum[t][j + 96];
        c0 = add_rn(c0, c2);      // s = 64
        c1 = add_rn(c1, c3);
        c0 = add_rn(c0, c1);      // s = 32
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          c0 = add_rn(c0, __shfl_down_sync(0xffffffffu, c0, s));
        if (j == 0) p.tot[(int64_t)item[I_TOT] + t] = c0;
      }
      __syncthreads();
      buf = (buf + 1) % NS;
    }
    if (it + 1 < p.iters) {
#pragma unroll
      for (int k = 0; k < NS - 1; ++k)
        if (blockIdx.x + (int64_t)k * gridDim.x < p.n_items)
          stage_item<V, S>(stage[(buf + k) % NS], p.items, p.desc,
                           blockIdx.x + (int64_t)k * gridDim.x, t, j, policy);
    }
    const bool res_lap = CLOCK && it == 0 && p.n_res_tasks > 0;
    if (res_lap) {              // the clock times the residue on its own
      grid.sync();
      clock.lap(S_A);
    }
    if (it == 0)
      residue_sums<A, 1>(p, 0, row * (TW / WARP) + j / WARP,
                         rows * (TW / WARP), j % WARP);
    grid.sync();
    clock.lap(res_lap ? S_R : S_A);

    // (C) wide rows (one thread row each), long scalars (one thread per
    // lane of a long row, counted from the thread after the wide rows')
    if (mid) {
      for (int64_t r = row; r < p.n_wide; r += rows) {
        const int32_t* wr = p.wide + r * NWIDE;
        const int n = wr[W_N];
        const int64_t step = (int64_t)wr[W_STEP] * LANES;
#pragma unroll
        for (int cc = 0; cc < S::COLS; ++cc) {
          const A* c = p.cbuf + (int64_t)wr[W_FIRST] * LANES + j + cc * TW;
          A acc = c[0];
          for (int c0 = 1; c0 < n; c0 += COMBINE) {
            // unconditional loads (clamped to the last chunk), so that all
            // COMBINE are in flight before the first add
            A v[COMBINE];
#pragma unroll
            for (int u = 0; u < COMBINE; ++u)
              v[u] = c[min(c0 + u, n - 1) * step];
#pragma unroll
            for (int u = 0; u < COMBINE; ++u) {
              const A sum = add_rn(acc, v[u]);
              acc = c0 + u < n ? sum : acc;
            }
          }
          p.y2[(int64_t)wr[W_Y2] * LANES + j + cc * TW] = acc;
        }
      }
      const int64_t first = (tid + (int64_t)p.n_wide * TW) % nthreads;
      for (int64_t i = first; i < (int64_t)p.n_long_rows * LANES;
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
      clock.lap(S_C);
    }

    // (D) outgather (adding the residue at the last step), then, but for
    // the last step, the tap in 16-byte vectors; a thread of COLS lane
    // columns keeps COLS times the slots and the tap's vectors in flight,
    // so that a SM has as many loads in flight as at one column a thread
    // (y2 row 0 is final; (A) has read x)
    const bool last = it + 1 == p.iters;
    constexpr int OG_K = OG_CHUNK * S::COLS < OG_KMAX ? OG_CHUNK * S::COLS
                                                      : OG_KMAX;
    for (int64_t b = tid / og_threads<A>(); b < p.B;
         b += nthreads / og_threads<A>())
      outgather_block<A, OG_K>(p.src, p.perm, p.y2, p.out, b, p.B, p.K, p.Z,
                               (int)(tid % og_threads<A>()),
                               last && p.n_res_tasks ? p.res_bptr : nullptr,
                               p.res_bent, p.rsum);

    if (!last) {
      constexpr int TU = TAP_U * S::COLS;
      constexpr int VW = og_lanes<A>();
      const OgVec<A>* xv = reinterpret_cast<const OgVec<A>*>(x);
      const OgVec<A>* y0 = reinterpret_cast<const OgVec<A>*>(p.y2);
      OgVec<A>* xs = reinterpret_cast<OgVec<A>*>(p.x_scr);
      const int64_t n = p.x_words / VW;
      for (int64_t i0 = tid; i0 < n; i0 += nthreads * TU) {
        OgVec<A> a[TU], y[TU];
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          const int64_t i = i0 + u * nthreads;
          if (i < n) {
            a[u] = xv[i];
            y[u] = y0[i % (LANES / VW)];
          }
        }
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          const int64_t i = i0 + u * nthreads;
          if (i < n) {
#pragma unroll
            for (int e = 0; e < VW; ++e)
              a[u].v[e] = add_rn(a[u].v[e], mul_rn(y[u].v[e], p.tap));
            xs[i] = a[u];
          }
        }
      }
    }
    // the clock's last lap waits for every block
    if (!last || CLOCK) grid.sync();
    clock.lap(S_D);
  }
  clock.write(p.per_sm);
}

// An SpMM pass's x layout, spmm_kernel's XIL.  true: the KV x tables are
// one (S * 128, KV) array, table v's word `at` at at * KV + v, so that one
// load of a group of tables serves a slot; false: stacked, (KV * S, 128),
// table v's word at at v * S * 128 + at (the TPU's layout, which only
// probes/k6_levers.py's layout lever builds).  y2 (KV, Z + 1, 128), the
// chunk rows, the totals and the residue's sums are one buffer a table,
// and out is (B * 128, KV) in the value type, whatever the layout.

// Phase D of an SpMM pass for output block b, lane l: the outgather's sums
// of the KV tables (K2's order: the k_used slots from zero, a zero-row slot
// and a slot past K in the last chunk adding the zero row's word 0; the
// residue's sum last), DC slots' gathers in flight, rounded once to the
// value type V and written together, out[(b * 128 + l) * KV + v]
template <typename V, typename A, int KV, int DC>
__device__ __forceinline__ void pass_outgather(const PassParams<A>& p,
                                               V* out, int64_t b, int l,
                                               int64_t y2_vs) {
  static_assert(OG_KMAX % DC == 0, "whole chunks of slots");
  int s[OG_KMAX];
  bool any = false;
#pragma unroll
  for (int k = 0; k < OG_KMAX; ++k) {
    s[k] = k < p.K ? __ldg(p.src + b * p.K + k) : p.Z;
    any |= s[k] != p.Z;
  }
  A acc[KV];
#pragma unroll
  for (int v = 0; v < KV; ++v) acc[v] = A(0);
  if (any) {                    // uniform in the block: one src row
#pragma unroll
    for (int k0 = 0; k0 < OG_KMAX; k0 += DC) {
      if (k0 >= p.K) break;
      int pl[DC];
#pragma unroll
      for (int u = 0; u < DC; ++u)
        pl[u] = s[k0 + u] != p.Z
                    ? (int)__ldg(p.perm + ((int64_t)(k0 + u) * p.B + b) *
                                              LANES + l) & (LANES - 1)
                    : 0;
      A w[DC][KV];
#pragma unroll
      for (int u = 0; u < DC; ++u) {
        const int64_t at = (int64_t)s[k0 + u] * LANES + pl[u];
#pragma unroll
        for (int v = 0; v < KV; ++v) w[u][v] = p.y2[v * y2_vs + at];
      }
#pragma unroll
      for (int u = 0; u < DC; ++u)
#pragma unroll
        for (int v = 0; v < KV; ++v) acc[v] = add_rn(acc[v], w[u][v]);
    }
  }
  if (p.n_res_tasks) {          // the residue rows of block b
    const int r1 = __ldg(p.res_bptr + b + 1);
    for (int r = __ldg(p.res_bptr + b); r < r1; ++r) {
      const int e = __ldg(p.res_bent + r);
      if ((e & (LANES - 1)) == l) {
#pragma unroll
        for (int v = 0; v < KV; ++v)
          acc[v] = add_rn(acc[v], p.rsum[v * p.rsum_vs + (e >> 7)]);
      }
    }
  }
  V o[KV];
#pragma unroll
  for (int v = 0; v < KV; ++v) o[v] = narrow_to(acc[v], V());
  store_words<KV>(out + (b * LANES + l) * KV, o);
}

// An SpMM pass: one step of resident_kernel for KV > 1 x tables, XI of
// them (at most KV) gathered together in phase A, on x in the layout XIL;
// no chain, no tap
template <typename V, typename A, class S, bool CLOCK, int KV, int XI,
          bool XIL>
__global__ void __launch_bounds__(S::THREADS, S::MINB)
spmm_kernel(PassParams<A> p) {
  constexpr int XN = XI < KV ? XI : KV;
  static_assert(KV > 1 && KV % XN == 0, "KV > 1 tables, XN at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<V>* const stage = reinterpret_cast<Stage<V>*>(smem);   // S::STAGES
  __shared__ A red[VPB][MAX_R][LANES];     // folded levels of the item
  __shared__ A lsum[VPB][LANES];           // lane sums of the totals
  cg::grid_group grid = cg::this_grid();
  constexpr int TW = S::TW;
  constexpr int NS = S::STAGES;
  const int j = threadIdx.x;               // lane columns j, j + TW, ...
  const int t = threadIdx.y;
  const int64_t row = (int64_t)blockIdx.x * VPB + t;   // this thread row
  const int64_t rows = (int64_t)gridDim.x * VPB;       // thread rows
  const int64_t tid = row * TW + j;
  const int64_t nthreads = rows * TW;
  const int64_t long_base = (int64_t)(p.Z - p.n_long_rows) * LANES;
  const int64_t y2_vs = (int64_t)(p.Z + 1) * LANES;     // words a table
  uint64_t policy = 0;
  if constexpr (S::EVICT_FIRST) policy = l2_evict_first();
  Clock<CLOCK> clock(p.stamps);
  for (int64_t v = row; v < KV; v += rows)   // row Z of each y2, read in (D)
#pragma unroll
    for (int c = 0; c < S::COLS; ++c)
      p.y2[v * y2_vs + (int64_t)p.Z * LANES + j + c * TW] = A(0);
  int buf = 0;
#pragma unroll
  for (int k = 0; k < NS - 1; ++k)
    if (blockIdx.x + (int64_t)k * gridDim.x < p.n_items)
      stage_item<V, S>(stage[k], p.items, p.desc,
                       blockIdx.x + (int64_t)k * gridDim.x, t, j, policy);

  // (A) the schedule as in resident_kernel; each item's staged operands
  // serve the KV tables, XN at a time (with the tables interleaved, one
  // load of XN words a slot), each table's folded levels going through red
  // and lsum in turn
  for (int64_t g = blockIdx.x; g < p.n_items; g += gridDim.x) {
    const int64_t next = g + (int64_t)(NS - 1) * gridDim.x;
    if (next < p.n_items) {
      stage_item<V, S>(stage[(buf + NS - 1) % NS], p.items, p.desc, next, t,
                       j, policy);
      cp_async_wait<NS - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<V>& st = stage[buf];
    const int32_t* item = st.item;
    const int64_t* d = p.desc + (int64_t)item[I_STREAM] * NDESC;
    const bool live = t < item[I_NV];
    const int w8 = item[I_W];
    const int R = item[I_R];
    const bool total = (item[I_MASK] >> t) & 1;
    const bool to_y2 = item[I_DST] == DST_Y2;
    const int64_t out0 = item[I_OUT];
#pragma unroll 1
    for (int v0 = 0; v0 < KV; v0 += XN) {
      A lv[XN][S::COLS][MAX_R], ls[XN][S::COLS];
#pragma unroll
      for (int u = 0; u < XN; ++u)
#pragma unroll
        for (int c = 0; c < S::COLS; ++c) {
          ls[u][c] = A(0);
#pragma unroll
          for (int r = 0; r < MAX_R; ++r) lv[u][c][r] = A(0);
        }
      if (live)
        colsum_item<V, A, S::COLS, XN, XIL ? KV : 0>(
            (int)d[D_STRIDE], item[I_F], st.tile[t], &st.wins[t][1],
            (int)d[D_P], st.vals[t],
            XIL ? p.x + v0 : p.x + v0 * p.x_words, p.x_words, j, lv, ls);
#pragma unroll
      for (int u = 0; u < XN; ++u) {
        const int64_t v = v0 + u;
        A* const o = to_y2 ? p.y2 + v * y2_vs : p.cbuf + v * p.cbuf_vs;
        if (u > 0) __syncthreads();          // table v - 1 has read red
        if (live) {
#pragma unroll
          for (int c = 0; c < S::COLS; ++c) {
            const int jc = j + c * TW;
            if (w8 == 1 && item[I_DST] != DST_NONE) {
#pragma unroll
              for (int r = 0; r < MAX_R; ++r)
                if (r < R)
                  o[(out0 + (int64_t)t * R + r) * LANES + jc] = lv[u][c][r];
            } else if (w8 > 1) {
#pragma unroll
              for (int r = 0; r < MAX_R; ++r)
                if (r < R) red[t][r][jc] = lv[u][c][r];
            }
            if (total) lsum[t][jc] = ls[u][c];
          }
        }
        __syncthreads();
        if (live && w8 > 1 && t % w8 == 0) {   // the first vreg of a slice
#pragma unroll
          for (int c = 0; c < S::COLS; ++c) {
            const int jc = j + c * TW;
#pragma unroll
            for (int r = 0; r < MAX_R; ++r) {
              if (r < R) {
                A acc = red[t][r][jc];
                for (int w = 1; w < w8; ++w)
                  acc = add_rn(acc, red[t + w][r][jc]);
                o[(out0 + (int64_t)(t / w8) * R + r) * LANES + jc] = acc;
              }
            }
          }
        }
        if (live && total && j < 32) {         // warp 0 of the thread row
          A c0 = lsum[t][j], c1 = lsum[t][j + 32];
          const A c2 = lsum[t][j + 64], c3 = lsum[t][j + 96];
          c0 = add_rn(c0, c2);      // s = 64
          c1 = add_rn(c1, c3);
          c0 = add_rn(c0, c1);      // s = 32
#pragma unroll
          for (int s = 16; s > 0; s >>= 1)
            c0 = add_rn(c0, __shfl_down_sync(0xffffffffu, c0, s));
          if (j == 0) p.tot[v * p.tot_vs + (int64_t)item[I_TOT] + t] = c0;
        }
      }
      __syncthreads();
    }
    buf = (buf + 1) % NS;
  }
  const bool res_lap = CLOCK && p.n_res_tasks > 0;
  if (res_lap) {                // the clock times the residue on its own
    grid.sync();
    clock.lap(S_A);
  }
  residue_sums<A, KV, XIL>(p, p.rsum_vs, row * (TW / WARP) + j / WARP,
                           rows * (TW / WARP), j % WARP);
  grid.sync();
  clock.lap(res_lap ? S_R : S_A);

  // (C) wide rows and long scalars as in resident_kernel, for each table
  if (p.n_wide > 0 || p.n_long_rows > 0) {
    for (int64_t q = row; q < (int64_t)p.n_wide * KV; q += rows) {
      const int64_t tab = q % KV;
      const int32_t* wr = p.wide + (q / KV) * NWIDE;
      const int n = wr[W_N];
      const int64_t step = (int64_t)wr[W_STEP] * LANES;
#pragma unroll
      for (int cc = 0; cc < S::COLS; ++cc) {
        const A* c = p.cbuf + tab * p.cbuf_vs + (int64_t)wr[W_FIRST] * LANES +
                     j + cc * TW;
        A acc = c[0];
        for (int c0 = 1; c0 < n; c0 += COMBINE) {
          A v[COMBINE];
#pragma unroll
          for (int u = 0; u < COMBINE; ++u)
            v[u] = c[min(c0 + u, n - 1) * step];
#pragma unroll
          for (int u = 0; u < COMBINE; ++u) {
            const A sum = add_rn(acc, v[u]);
            acc = c0 + u < n ? sum : acc;
          }
        }
        p.y2[tab * y2_vs + (int64_t)wr[W_Y2] * LANES + j + cc * TW] = acc;
      }
    }
    const int64_t n_lanes = (int64_t)p.n_long_rows * LANES;
    const int64_t first = (tid + (int64_t)p.n_wide * KV * TW) % nthreads;
    for (int64_t i = first; i < n_lanes * KV; i += nthreads) {
      const int64_t v = i / n_lanes, il = i - v * n_lanes;
      const A* tot = p.tot + v * p.tot_vs;
      const int l = (int)(il % LANES);
      const int64_t sp = (il / LANES) * LONG_PACK + l;
      A acc = A(0);
      if (l < LONG_PACK && sp < p.n_long) {
        const int64_t k0 = p.inc_ptr[sp];
        const int64_t k1 = p.inc_ptr[sp + 1];
        if (k0 < k1) acc = mul_rn((A)p.inc_mult[k0], tot[p.inc_tot[k0]]);
        for (int64_t k = k0 + 1; k < k1; ++k)
          acc = add_rn(acc, mul_rn((A)p.inc_mult[k], tot[p.inc_tot[k]]));
      }
      p.y2[v * y2_vs + long_base + il] = acc;
    }
    grid.sync();
    clock.lap(S_C);
  }

  // (D) a thread per (output block, lane), its KV tables together, about
  // 64 bytes of gathers a lane column in flight (the one-table
  // outgather's 16 bytes x OG_CHUNK slots); out is (B * 128, KV) of the
  // value type (the launcher's `out`)
  constexpr int DB = 64 * S::COLS / (KV * (int)sizeof(A));
  constexpr int DC = DB < 1 ? 1 : DB > OG_KMAX ? OG_KMAX : DB;
  V* const out = reinterpret_cast<V*>(p.out);
  for (int64_t i = tid; i < (int64_t)p.B * LANES; i += nthreads)
    pass_outgather<V, A, KV, DC>(p, out, i / LANES, (int)(i % LANES),
                                 y2_vs);
  // the clock's last lap waits for every block
  if (CLOCK) grid.sync();
  clock.lap(S_D);
  clock.write(p.per_sm);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the dynamic shared memory of a block: its S::STAGES item stages
template <typename V, class S>
constexpr size_t stage_bytes() { return S::STAGES * sizeof(Stage<V>); }

constexpr int KV_CLOCK = 8;                // the SpMM pass the clock times

// the kernel of an instance at KV x tables (1: resident_kernel, a chain),
// with the phase clock or without it; the clock is built at one table and
// at KV_CLOCK tables only (null elsewhere)
template <typename V, typename A, class S, int KV = 1, int XI = 1,
          bool XIL = false>
const void* kernel_of(bool clock) {
  if constexpr (KV == 1)
    return clock ? (const void*)resident_kernel<V, A, S, true>
                 : (const void*)resident_kernel<V, A, S, false>;
  else if constexpr (KV == KV_CLOCK)
    return clock ? (const void*)spmm_kernel<V, A, S, true, KV, XI, XIL>
                 : (const void*)spmm_kernel<V, A, S, false, KV, XI, XIL>;
  else
    return clock ? nullptr
                 : (const void*)spmm_kernel<V, A, S, false, KV, XI, XIL>;
}

// co-resident blocks a SM of kernel f at its launch shape, after allowing
// it the dynamic shared memory it asks for
template <typename V, class S>
cudaError_t occupancy(const void* f, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stage_bytes<V, S>());
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, f, S::THREADS, stage_bytes<V, S>());
}

// what the build gave an instance's kernel without the clock (the one
// every call without `stamps` launches): registers a thread, local (stack
// and spill) bytes a thread, static shared bytes a block, the dynamic
// shared bytes its launch asks for, co-resident blocks a SM at that size,
// and threads a block
template <typename V, typename A, class S, int KV = 1, int XI = 1,
          bool XIL = false>
int info(int* out) {
  const void* f = kernel_of<V, A, S, KV, XI, XIL>(false);
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e == cudaSuccess) e = occupancy<V, S>(f, &per_sm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)stage_bytes<V, S>();
  out[4] = per_sm;
  out[5] = S::THREADS;
  return 0;
}

// kv = KV x tables: 1 launches resident_kernel (`iters` steps), more
// spmm_kernel, which needs iters = 1 and no x_scr; the clock runs at
// kv = 1 and KV_CLOCK only
template <typename V, typename A, class S, int KV, int XI, bool XIL>
int launch(const void* desc, const void* items, int n_items,
           const void* wide, int n_wide, void* cbuf, const void* inc_ptr,
           const void* inc_tot, const void* inc_mult, int n_long,
           int n_long_rows, const void* src, const void* perm, int B, int K,
           int Z, const void* x, void* x_scr, long long x_words, void* y2,
           void* tot, void* out, const void* res_ent, const void* res_task,
           int n_res_tasks, const void* res_cols, const void* res_vals,
           void* rsum, const void* res_bptr, const void* res_bent,
           int iters, double tap, void* stamps, int kv, long long cbuf_words,
           long long tot_words, long long rsum_words, void* stream) {
  const void* f = kernel_of<V, A, S, KV, XI, XIL>(stamps != nullptr);
  if (iters < 1 || n_items < 0 || Z < n_long_rows || K > OG_KMAX ||
      n_res_tasks < 0 || (iters > 1 && !x_scr) || kv != KV ||
      (KV > 1 && (iters != 1 || x_scr)) || !f)
    return (int)cudaErrorInvalidValue;
  PassParams<A> pp;
  Params<A>& p = pp;
  p.desc = static_cast<const int64_t*>(desc);
  p.items = static_cast<const int32_t*>(items);
  p.n_items = n_items;
  p.wide = static_cast<const int32_t*>(wide);
  p.n_wide = n_wide;
  p.cbuf = static_cast<A*>(cbuf);
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
  p.y2 = static_cast<A*>(y2);
  p.tot = static_cast<A*>(tot);
  p.out = static_cast<A*>(out);
  p.res_ent = static_cast<const int32_t*>(res_ent);
  p.res_task = static_cast<const int32_t*>(res_task);
  p.n_res_tasks = n_res_tasks;
  p.res_cols = static_cast<const int32_t*>(res_cols);
  p.res_vals = static_cast<const A*>(res_vals);
  p.rsum = static_cast<A*>(rsum);
  p.res_bptr = static_cast<const int32_t*>(res_bptr);
  p.res_bent = static_cast<const int32_t*>(res_bent);
  p.iters = iters;
  p.tap = (A)tap;
  p.stamps = static_cast<long long*>(stamps);
  pp.cbuf_vs = cbuf_words;
  pp.tot_vs = tot_words;
  pp.rsum_vs = rsum_words;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t dyn = stage_bytes<V, S>();
  if (e == cudaSuccess) e = occupancy<V, S>(f, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.per_sm = per_sm;
  // as many blocks as are co-resident, or as the largest phase has work
  int64_t need = n_items;
  need = std::max(need, cdiv((int64_t)n_wide * KV, VPB));
  need = std::max(need, cdiv((int64_t)B * (KV == 1 ? og_threads<A>() : LANES),
                              S::THREADS));
  if (iters > 1) need = std::max(need, cdiv(x_words, S::THREADS));
  need = std::max(need,
                  cdiv((int64_t)n_long_rows * LANES * KV, S::THREADS));
  need = std::max(need, cdiv((int64_t)n_res_tasks * KV, S::THREADS / WARP));
  const int grid = (int)std::max<int64_t>(
      1, std::min<int64_t>(need, (int64_t)per_sm * sms));
  void* args[] = {KV == 1 ? (void*)&p : (void*)&pp};
  e = cudaLaunchCooperativeKernel(f, dim3(grid), dim3(S::TW, VPB), args, dyn,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the shapes the library's instances launch at, each the fastest that
// probes/k6_levers.py measured for its value type (the header note)
using ShapeF32 = Shape<1, 2, 2, true>;     // f32 and bf16 values
using ShapeF64 = Shape<2, 2, 2, true>;
// x tables an SpMM pass gathers together in phase A, by value type, one
// 16-byte load a group (two in f64) (probes/k6_levers.py's kv arm,
// PERF.md §6).  Against two, four cut a pass of 8 by 13-27 % in
// f32 on cop20k_like, webbase_like, rmat_like and uniform_medium, and in
// f64 by 3-12 % on the last three for 4 % more on cop20k_like; eight
// spill (56 bytes a thread in f32, 3 KB in f64) and change an f32 pass by
// -6 to +0.5 %, a bf16 one by -5 to +2 %.  The f64 choice is not keyed on
// whether the KV tables fit the L2: cop20k_like and uniform_medium both
// hold 8 MB of them, and two tables win on the first, four by 12 % on the
// second
constexpr int XI_F32 = 4;                  // f32 and bf16 values
constexpr int XI_F64 = 4;
// the library's SpMM pass layout: x interleaved by column
constexpr bool PASS_X_INTERLEAVED = true;

}  // namespace

#define DASP_RESIDENT(NAME, V, A, S, KV, XI, XIL)                            \
  extern "C" int NAME(                                                       \
      const void* desc, const void* items, int n_items, const void* wide,    \
      int n_wide, void* cbuf, const void* inc_ptr, const void* inc_tot,      \
      const void* inc_mult, int n_long, int n_long_rows, const void* src,    \
      const void* perm, int B, int K, int Z, const void* x, void* x_scr,     \
      long long x_words, void* y2, void* tot, void* out,                     \
      const void* res_ent, const void* res_task, int n_res_tasks,            \
      const void* res_cols, const void* res_vals, void* rsum,                \
      const void* res_bptr, const void* res_bent, int iters, double tap,     \
      void* stamps, int kv, long long cbuf_words, long long tot_words,       \
      long long rsum_words, void* stream) {                                  \
    return launch<V, A, S, KV, XI, XIL>(                                     \
        desc, items, n_items, wide, n_wide, cbuf, inc_ptr, inc_tot,          \
        inc_mult, n_long, n_long_rows, src, perm, B, K, Z, x, x_scr,         \
        x_words, y2, tot, out, res_ent, res_task, n_res_tasks, res_cols,     \
        res_vals, rsum, res_bptr, res_bent, iters, tap, stamps, kv,          \
        cbuf_words, tot_words, rsum_words, stream);                          \
  }

DASP_RESIDENT(dasp_resident_f32, float, float, ShapeF32, 1, 1, false)
DASP_RESIDENT(dasp_resident_bf16, __nv_bfloat16, float, ShapeF32, 1, 1, false)
DASP_RESIDENT(dasp_resident_f64, double, double, ShapeF64, 1, 1, false)

// the SpMM pass: kv tables at one step (probes/k6_levers.cu, which includes
// this file, builds kv = 1 alone)
#ifndef DASP_RESIDENT_KV1_ONLY
DASP_RESIDENT(dasp_resident_f32_kv2, float, float, ShapeF32, 2, XI_F32,
              PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_f32_kv4, float, float, ShapeF32, 4, XI_F32,
              PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_f32_kv8, float, float, ShapeF32, 8, XI_F32,
              PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_bf16_kv2, __nv_bfloat16, float, ShapeF32, 2,
              XI_F32, PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_bf16_kv4, __nv_bfloat16, float, ShapeF32, 4,
              XI_F32, PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_bf16_kv8, __nv_bfloat16, float, ShapeF32, 8,
              XI_F32, PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_f64_kv2, double, double, ShapeF64, 2, XI_F64,
              PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_f64_kv4, double, double, ShapeF64, 4, XI_F64,
              PASS_X_INTERLEAVED)
DASP_RESIDENT(dasp_resident_f64_kv8, double, double, ShapeF64, 8, XI_F64,
              PASS_X_INTERLEAVED)
#endif

// K6's build figures (info above) for value type dtype (0 f32, 1 bf16,
// 2 f64) at kv tables (1, 2, 4, 8); int[6] out
extern "C" int dasp_resident_info(int dtype, int kv, int* out) {
  switch (dtype * 16 + kv) {
    case 1: return info<float, float, ShapeF32>(out);
    case 17: return info<__nv_bfloat16, float, ShapeF32>(out);
    case 33: return info<double, double, ShapeF64>(out);
#ifndef DASP_RESIDENT_KV1_ONLY
    case 2:
      return info<float, float, ShapeF32, 2, XI_F32, PASS_X_INTERLEAVED>(out);
    case 4:
      return info<float, float, ShapeF32, 4, XI_F32, PASS_X_INTERLEAVED>(out);
    case 8:
      return info<float, float, ShapeF32, 8, XI_F32, PASS_X_INTERLEAVED>(out);
    case 18:
      return info<__nv_bfloat16, float, ShapeF32, 2, XI_F32,
                  PASS_X_INTERLEAVED>(out);
    case 20:
      return info<__nv_bfloat16, float, ShapeF32, 4, XI_F32,
                  PASS_X_INTERLEAVED>(out);
    case 24:
      return info<__nv_bfloat16, float, ShapeF32, 8, XI_F32,
                  PASS_X_INTERLEAVED>(out);
    case 34:
      return info<double, double, ShapeF64, 2, XI_F64, PASS_X_INTERLEAVED>(out);
    case 36:
      return info<double, double, ShapeF64, 4, XI_F64, PASS_X_INTERLEAVED>(out);
    case 40:
      return info<double, double, ShapeF64, 8, XI_F64, PASS_X_INTERLEAVED>(out);
#endif
  }
  return (int)cudaErrorInvalidValue;
}
