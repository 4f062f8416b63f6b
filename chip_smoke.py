"""Smoke run of the PyTorch port (dasp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more printed lines each, every one raising on failure:
  1. device: needs torch.cuda; prints the card's name and power limit,
     and the device-memory copy rate (the roofline for the kernels);
  2. build: compiles the CUDA kernels (the colsum of colsum_multi.cu: K5,
     and at kv = 1 K1 and its fp64 instance K3; outgather K2 and its fp64
     instance K4, the resident executor K6 and its SpMM pass over kv = 2,
     4, 8 x tables, the L2 probe T4, and the
     probes T1 (gather_probe.cu), T2 and T3 (colsum_probe.cu)) from
     dasp_tpu_torch/csrc with nvcc into one library in
     dasp_tpu_torch/_build, and the packer's native host library
     (native/, make);
  3. kernels vs plain on the card, on the fixture every row family passes
     through (mixed_categories(2048), as __graft_entry__.entry() packs it):
     every kernel instance (K1 f32 and bf16, K3, K2, K4, K5 at kv = 1, 2,
     4 and 8 with f32, bf16 and f64 values) against its plain version on
     the same tensors (K1/K3 bit for bit), each K5 slice against K1 / K3
     on its own x, each vector of the batched outgather against
     outgather_plain on its y2, and K6 in f32, bf16 and f64 at 1 and 3
     steps, and K6's SpMM pass at kv = 2, 4, 8 on its x tables
     interleaved by column (Y (n_rows, kv) and y2 against its plain
     version, each column against one K6 step on its table), all bit for
     bit; the registers, local bytes, shared bytes and
     blocks a SM of every K5 instance (the kv = 1 ones again on a [build]
     K1 line: they are K1/K3), of the T1 bodies and of the T2/T3
     instances phase 6 launches are printed after the build, and K6's
     instances on a [build] K6 line (registers, local bytes, static
     and dynamic shared bytes, blocks a SM, threads a block; at one x
     table and at kv = 2, 4, 8; the fp64 one-table instance must use no
     local memory);
  4. the SpMV end to end at published SuiteSparse sizes (cop20k_like,
     webbase_like from bench/suite.py), one pack per matrix serving all
     dtypes: SpMVOperator on the card in f32, f64 and bf16 (each call
     exactly one K6 launch at one step, the residue inside it, and
     nothing else of the port's kernels; its y and y2 equal bit for bit to
     their plain versions), and matmat with 8, 4 and 2 columns in f32,
     bf16 and f64, on operators built with force_streamed=True (the
     streamed path), and the resident timing loop (K6, a chain of 10) of
     a default operator, each against the f64 CSR golden (for bf16 that
     of the bf16-rounded A and x), scaled by the backward-error mass
     max(|A||x|, 1), and the resident y against the streamed y; every
     kernel instance of the path (K6 at one table and at kv = 2, 4, 8)
     must launch in this phase and K1/K3, K5 and K2/K4 not at all, and
     one matmat call must launch exactly one K6 SpMM pass a pass and
     nothing else (checked also on a fixture whose residue is repacked as
     a sub-plan, which the pass sums by its trees); then every instance
     against its plain version at these shapes (K5 at kv = 4 and 8, the
     SpMM pass at kv = 2, 4 and 8); then, on counts of their own, K1/K3, K5 and
     K2/K4 on the glue path (the same tables without the K6 schedule,
     where they still run): the reference-order single-vector SpMV,
     exactly one K1/K3 a stream and one K2/K4 a plan a call, and an SpMM
     pass of 8, exactly one K5 a stream and one K2/K4 a plan, the residue
     sub-plan's included;
  5. timing with CUDA events (median of trials), each step issued eagerly
     and as a CUDA-graph replay: chained SpMV loops (TorchSpMV.timing_loop
     on the streamed operators: every step adds y[0]*1e-36 into x) in f32,
     f64 and bf16 on the kernel path, the same path with the plain
     versions, and cuSPARSE (torch.sparse_csr_tensor @ x, first held to
     the golden; f32 and f64); K6 at chains of 10 and 100 beside them,
     and alone with the bytes a step moves; K6's phase clock over one
     chain of 100 (a [phase] line per arm and dtype: phases A, C and
     D+tap per step, their sum against the graphed step, the grid
     barriers a step, the grid and blocks per SM); matmat at 8 columns
     (one K6 SpMM pass of 8; on the glue path two K5 passes of 4 and one
     pass of 8) against 8 single SpMVs and cuSPARSE A @ X, per call and
     per column, in f32, f64 and bf16, with the device kernels of one
     pass (K6's, which must be K6 alone in every dtype: bf16's Y is
     rounded inside it; and the glue's) and of one SpMV (the port's and the
     others, from the profiler), the K6 pass's phase clock at kv = 8 (a
     [phase] line), and the device kernels of a streamed SpMV
     (one K6 step, the chain's tap ops, bf16's rounding); the one-step
     K6's phase clock (A, the residue's sums R, C, D) and the single-
     vector SpMV eager and graphed beside the resident step and cuSPARSE;
     every kernel instance alone (ALONE_REPS launches
     captured in one graph, so that the host's replay cost does not
     show) beside its plain version, with the bytes it must move, its
     bound, its share of the bound and whether its tables fit in the 50
     MB L2 (where they do, the 20 launches can find them there, and a
     share above 1 is L2 residence, not a fault); the outgather of one
     pass as one launch and as one launch a vector; the K5 split (K5
     alone at kv = 1, 2, 4, 8 as it is and with every gather sent to one
     fixed row of its table, K1/K3, its kv = 1 instance, beside them);
     a torch.profiler breakdown of the f32 and f64 streamed kernel
     paths; and the T4 sweep (the rate of a chained re-read of a 6-192 MB
     stream against the copy rate);
  6. the probes T1 (gather_bench: copy, lane and sublane gathers from
     shared memory), T2 (roundcost_ab: cur/flane/fboth at P = 1..32) and
     T3 (stream_bench2: ladder A-F), at the tools' sizes, at 8x and at the
     sizes the kernels treat specially (probe_edges): every variant
     against its plain version bit for bit, and the variants that compute
     K1's function against K1 on the card bit for bit; then each sweep,
     graph replays of the kernel alone and of the tools' chained step, at
     the tools' sizes and at 8x, with the bytes, the share of the copy
     rate and the bound, on the probes' own launch counts.
  7. the bench (python -m dasp_tpu_torch.bench) through its own per-arm
     runner, run_arm, into a temporary directory: the two plans of phase
     4, scircuit_like, rmat_like (5,021,410 nnz, whose residue is
     repacked as a sub-plan at size) in f32, f64 and bf16, and a 262,144 x
     8,388,608 matrix of ~2.1M nnz whose columns span the whole range
     (more columns than the reference puts in one plan) in f32 and f64.
     rmat_like's one-step K6 (137,147 residue rows by trees) is held to
     its plain version bit for bit, y and y2, and to the golden, with its
     phase clock, in f32, bf16 and f64, and timed graphed beside a K6
     chain's step ([time] rmat_like ... one device_call); K1/K3 on its
     streams, which exceed the L2 in every dtype, are held to
     colsum_plain bit for bit and timed alone, with their share of the
     bound; K6's SpMM pass of 8 on scircuit_like, rmat_like, the wide
     matrix and uniform_medium (generated for this line alone) gets its
     phase clock, its time beside cuSPARSE A @ X and its bound (a [phase]
     line each).
     Every arm passes the bench's checks (streamed y, resident loop y,
     each matmat column and cuSPARSE against the f64 CSR golden), writes
     its resident, streamed and SpMM rows under the reference's header,
     and the summary line parses; the harness's clock and the smoke's
     must agree within 10 % on one capture of each loop of phase 5, the
     harness's time per SpMV must lie within 10 % of the smoke's for a
     resident loop and within 25 % for a streamed one (whose time depends
     on the capture by 10-16 %); every kernel instance of the path must
     launch, and K1/K3 not at all;
  8. the examples: cg_solve in f32 and fp64 at n = 65,536 and pagerank at
     n = 100,000 to the originals' thresholds (solution error < 1e-3 f32,
     < 1e-6 fp64; ranks within 1e-3 of the host power iteration), with the
     iterations, the ms per iteration with and without the read-back, and
     the SpMV's share; each SpMV is exactly one K6 launch, and K1/K3 and
     K2/K4 never run; the SpMV of CG's small plan as one K6 step against
     the reference-order glue it replaces.
  9. multi-chip: MultiChipSpMV (dasp_tpu_torch/parallel.py) with 4 chips
     on the one card, on the reference dry run's input
     (powerlaw_like(100,000, 1.8, 500,000, col_alpha=1.6), seed 11) in
     f32 and f64: y against the golden scaled by the mass, balance <=
     1.5, every chip resident, one call launching exactly one K6 (one
     step) per chip and one timing loop one K6 per chip, the loop's y
     against the golden and the streamed y; then
     the bench's --multichip arm runner (run_multichip_arm) on
     cop20k_like and wikitalk_like in f32 and f64, each arm checked;
     every kernel instance of the path must launch; after the counts are
     read, every chip's K1/K3, K2/K4 and K6 against their plain versions
     on its own gathered x table, bit for bit; then, in f32 and f64, the
     4-chip operator's time per SpMV (resident and streamed) beside one
     operator's on the same matrix, and the all-gather alone.  Four chips
     on one card show the cost of partitioning, not scaling.
 10. the tile plan (build_plan) and its executor, PyTorch ops with no
     kernel of their own (SpMVOperator(backend="xla")), on the four
     matrices of phases 4 and 7 (cop20k_like, webbase_like, scircuit_like,
     rmat_like; uncut) in f32, bf16 and f64: its tensors on the card, y
     against the mass-scaled golden (for bf16 that of the bf16-rounded A
     and x) within bench/check.py:E2E_TOL, no K1-K6 launch; a [tile] line
     each with build_plan's seconds, value slots per nnz, us per SpMV of
     a chain of 10 eager and graphed, and beside them, in the same run,
     the resident K6 step, the streamed SpMV (one K6 step each) and
     graphed cuSPARSE, and the device kernels of one tile SpMV (profiler;
     in f32 their device time by kernel, a [profile] line); then
     MultiChipSpMV(backend="xla") with 4 chips on the card, on the
     dry run's second input (mixed_categories(160 * 4) from its generator,
     seed 11) and phase 9's power-law input, in f32 and f64, against the
     golden, no K1-K6 launch, its time per SpMV beside the windowed 4-chip
     operator's.
Phases 4, 7, 8, 9 and 10 each set the kernels' launch counts to 0 before
they run and read them after; the kernels line carries phase 4's, but for
K1/K3, which no user path with a stream runs any more: theirs are counted
over the reference-order run at the end of phase 4, as T1-T4's are over
their sweeps.  It then
prints the kernels' JSON line and, last, the device JSON line.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import sys
import tempfile
import time

# kernel vs plain version, on the error scaled by max(|plain|, 1): both
# multiply the same words and sum in the same order, so they should agree
# exactly; the limits allow for reordering by the compiler
KERNEL_TOL = {"f32": 1e-6, "bf16": 1e-6, "f64": 1e-12}
# (the end-to-end limits, on the error scaled by max(|A||x|, 1), are the
# bench's: dasp_tpu_torch/bench/check.py:E2E_TOL)
DTYPES = ("f32", "f64", "bf16")
TRIALS = 5
CHAIN = 10              # SpMVs per timed step (streamed: timing_loop(CHAIN
                        # - 1); resident: timing_loop(CHAIN))
LONG_CHAIN = 100        # the longer resident chain
ALONE_REPS = 20         # launches per graph when a kernel is timed alone
K_COLS = 8              # matmat columns
# the least time the card could take (the bound_ms of the kernels line):
# NVIDIA's H100 SXM data sheet, device memory 3.35 TB/s; float32 outside
# the tensor cores 67 TFLOP/s (bf16 values are multiplied in f32), fp64
# 34 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 67e12, "f64": 34e12}

def inst(base, dtype):
    """Name of a kernel instance: the f32 one bears the bare name."""
    return base if dtype == "f32" else f"{base}_{dtype}"


# kernel instance -> (source, the TPU kernel it replaces); the K6
# instances run as TorchSpMV.timing_loop of a resident operator
OPS = "dasp_tpu/ops"
INSTANCES = {
    "colsum": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:121"),
    "colsum_bf16": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:121"),
    "colsum_f64": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:277"),
    "outgather": ("outgather.cu", f"{OPS}/pallas_backend.py:437"),
    "outgather_f64": ("outgather.cu", f"{OPS}/pallas_backend.py:378"),
    "colsum_multi": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:174"),
    "colsum_multi_bf16": ("colsum_multi.cu",
                          f"{OPS}/pallas_backend.py:174"),
    "colsum_multi_f64": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:174"),
    "resident": ("resident.cu", f"{OPS}/resident.py:452"),
    "resident_bf16": ("resident.cu", f"{OPS}/resident.py:452"),
    "resident_f64": ("resident.cu", f"{OPS}/resident.py:452"),
    # K6's SpMM pass over kv x tables: the reference's SpMM runs K5 (:174)
    # and K2/K4 for it, K6 (resident.py:452) is the kernel it extends
    **{inst("resident", d) + f"_kv{kv}": ("resident.cu",
                                          f"{OPS}/resident.py:452")
       for d in ("f32", "bf16", "f64") for kv in (2, 4, 8)},
    "resident_probe": ("resident_probe.cu", "tools/resident_probe.py:27"),
    "gather_bench": ("gather_probe.cu", "tools/gather_bench.py:46"),
    "roundcost_ab": ("colsum_probe.cu", "tools/roundcost_ab.py:40"),
    "stream_bench2": ("colsum_probe.cu", "tools/stream_bench2.py:39"),
}
# T1-T4 are probes, not on the SpMV path: their launches are counted over
# their own sweeps (phase 6), every other instance's over phase 4
PROBES = ("resident_probe", "gather_bench", "roundcost_ab", "stream_bench2")
# K1/K3, K5 and K2/K4 run only on the glue path (tables without a K6
# schedule: the reference-order single-vector SpMV and the glue's SpMM
# pass): on no user path of a plan with a stream
GLUE_PATH = ("colsum", "colsum_bf16", "colsum_f64", "colsum_multi",
             "colsum_multi_bf16", "colsum_multi_f64", "outgather",
             "outgather_f64")
MAIN_PATH = tuple(k for k in INSTANCES if k not in PROBES + GLUE_PATH)
SPMM_KV = (2, 4, 8)     # x tables of K6's SpMM pass instances
PROBE_MB = 24           # T4's row in the kernels line: a stream that fits L2
MC_CHIPS = 4            # chips of the multi-chip phase, all on the one card
PROBE_SCALES = (1, 8)   # T1-T3 at the tools' sizes and 8x (past the L2)
L2_BYTES = 50e6         # the H100's L2 (NVIDIA's data sheet)


def log(msg):
    print(msg, flush=True)


def scaled_err(a, b):
    """max |a-b| / max(|b|, 1) and max |a-b|, on the host in f64."""
    a = a.double().cpu()
    b = b.double().cpu()
    d = (a - b).abs()
    return (float((d / b.abs().clamp(min=1.0)).max()) if d.numel() else 0.0,
            float(d.max()) if d.numel() else 0.0)


def time_ms(step, iters):
    """Median over TRIALS of the device time of one call of ``step``
    (``iters`` calls between two CUDA events, after one warm-up call)."""
    import torch
    step()
    torch.cuda.synchronize()
    out = []
    for _ in range(TRIALS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            step()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def graphed(step, reps=1):
    """``reps`` calls of ``step`` captured in one CUDA graph: its replay
    (the package's own recipe, which the bench and the examples use)."""
    from dasp_tpu_torch.utils import graphed as capture
    return capture(step, reps)


def eager_and_graph(step, iters):
    """(eager ms, graph-replay ms) per call of ``step``."""
    return time_ms(step, iters), time_ms(graphed(step), iters)


def profile_line(step, iters):
    """Device time per call by kernel (torch.profiler) and the device's
    busy share of the wall time of ``iters`` eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_us = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and not e.key.startswith("aten::"):
            dev_us[e.key] = us / iters
    busy = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    return (f"device {busy:.1f} us of {wall / iters * 1e6:.1f} us wall per "
            f"call (busy {busy / (wall / iters * 1e6):.1%}, under the "
            f"profiler); top: " + "; ".join(
                f"{k[:60]} {v:.1f} us" for k, v in top))


def kernel_args(op, xs):
    """The tensors each kernel instance of ``op``'s dtype takes for one
    SpMV of xs[0] (K1/K3 per stream, K2/K4 on the resulting y2) and one
    SpMM pass of the stacked xs (K5 per stream, kv = len(xs))."""
    from dasp_tpu_torch.ops import cuda_backend as cb
    from dasp_tpu_torch.ops.colsum import colsum
    meta, arrays = op._meta, op._arrays
    cs = [(st["wins"], st["vals"], st["idx"], xs[0], s)
          for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    y2, _ = cb.stack_y2(meta, arrays, [colsum(*a) for a in cs], xs[0])
    x3d = stacked_x(xs)
    cm = [(st["wins"], st["vals"], st["idx"], x3d, s, len(xs))
          for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    return cs, (arrays["out_src"], arrays["out_perm"], y2), cm


def pass_y2(op, cm):
    """The (kv, rows, 128) y2 of one SpMM pass, from K5's arguments."""
    from dasp_tpu_torch.ops import cuda_backend as cb
    from dasp_tpu_torch.ops.colsum_multi import colsum_multi
    kv = cm[0][5]
    y2, _ = cb.stack_y2(op._meta, op._arrays, [colsum_multi(*a) for a in cm],
                        cm[0][3].view(kv, -1, 128))
    return y2


def compare_kernels(op, xs):
    """Every kernel instance of ``op``'s dtype against its plain version
    on the same card tensors (K1/K3 bit for bit), and each K5 slice
    against K1/K3 on its own table (bit for bit).  Returns {instance:
    (scaled, abs) worst error}."""
    import torch
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.colsum_multi import colsum_multi, \
        colsum_multi_plain
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    d = op.dtype
    cs, og, cm = kernel_args(op, xs)
    err = {inst("colsum", d): [0.0, 0.0], inst("colsum_multi", d): [0.0, 0.0]}
    for a in cs:
        got, want = colsum(*a), colsum_plain(*a)
        e = scaled_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"K1/K3 != colsum_plain ({d}, stride "
                                 f"{a[4]}): {e} (scaled, abs)")
        err[inst("colsum", d)] = [max(u, v) for u, v in
                                  zip(err[inst("colsum", d)], e)]
    for a in cm:
        got = colsum_multi(*a)
        e = scaled_err(got, colsum_multi_plain(*a))
        err[inst("colsum_multi", d)] = [max(u, v) for u, v in
                                        zip(err[inst("colsum_multi", d)], e)]
        for j, x in enumerate(xs):
            if not torch.equal(got[j], colsum(a[0], a[1], a[2], x, a[4])):
                raise AssertionError(f"K5 slice {j} != K1/K3 on its table "
                                     f"({d}, stride {a[4]})")
    ogd = "f64" if d == "f64" else "f32"
    err[inst("outgather", ogd)] = list(scaled_err(
        outgather(*og, op._meta.n_y2_rows), outgather_plain(*og)))
    # the pass's one outgather launch: vector j as outgather_plain on its
    # y2
    y2 = pass_y2(op, cm)
    batch = outgather(og[0], og[1], y2, op._meta.n_y2_rows)
    for j in range(len(xs)):
        if not torch.equal(batch[j], outgather_plain(og[0], og[1], y2[j])):
            raise AssertionError(f"batched outgather vector {j} != "
                                 f"outgather_plain on its y2 ({d})")
    bad = {k: v for k, v in err.items() if not v[0] <= KERNEL_TOL[d]}
    if bad:
        raise AssertionError(f"kernel vs plain ({d}): {bad} "
                             f"(limit {KERNEL_TOL[d]} scaled)")
    return err


def kernel_bytes(op, cs, og, cm):
    """Bytes each kernel must move, computed from its shapes: the streamed
    tables and the output (the x gathers hit L2 and are not counted);
    K2/K4: src, the used slots' perm rows, y2 once and the output."""
    nb = lambda t: t.numel() * t.element_size()
    streams = sum(nb(a[0]) + nb(a[1]) + nb(a[2]) for a in cs)
    out_el = 8 if op.dtype == "f64" else 4
    rows = sum(a[1].shape[0] // a[4] for a in cs)
    kv = cm[0][5] if cm else 1
    used = int((og[0] != op._meta.n_y2_rows).sum())
    return {
        "colsum": streams + rows * 128 * out_el,
        "outgather": (nb(og[0]) + used * 128 + nb(og[2])
                      + op._meta.B_pad * 128 * out_el),
        "colsum_multi": streams + kv * rows * 128 * out_el,
    }


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` of the dtype's arithmetic, at the
    data sheet's peaks."""
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def l2_fit(nbytes):
    """Whether a kernel's tables (its bound's bytes) fit in the L2: where
    they do, ALONE_REPS launches in a row can find them there, and a share
    of the bound above 1 is L2 residence rather than a fault."""
    fit = nbytes <= L2_BYTES
    return (f"{nbytes / 1e6:.1f} MB {'fit in' if fit else 'exceed'} the "
            f"{L2_BYTES / 1e6:.0f} MB L2"
            + (" (a share above 1 can be L2 residence)" if fit else ""))


def colsum_alone(name, op, x2d, card, flops):
    """K1/K3 over every stream of ``op`` (matrix ``name``) on ``x2d``:
    each stream held to colsum_plain bit for bit, then ALONE_REPS passes
    in one graph, with the share of the bound; one [time] line."""
    import torch
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    d = op.dtype
    cs = [(st["wins"], st["vals"], st["idx"], x2d, s)
          for (_, s, _), st in zip(op._meta.streams, op._arrays["streams"])]
    for a in cs:
        if not torch.equal(colsum(*a), colsum_plain(*a)):
            raise AssertionError(f"K1/K3 != colsum_plain ({d}, stride "
                                 f"{a[4]})")
    nb = lambda t: t.numel() * t.element_size()
    out_el = 8 if d == "f64" else 4
    must = (sum(nb(a[0]) + nb(a[1]) + nb(a[2]) for a in cs) + nb(x2d)
            + sum(a[1].shape[0] // a[4] for a in cs) * 128 * out_el)
    ms = time_ms(graphed(lambda: [colsum(*a) for a in cs], ALONE_REPS),
                 5) / ALONE_REPS
    plain = time_ms(lambda: [colsum_plain(*a) for a in cs], 2)
    b_ms, b_by = bound(must, flops, d)
    log(f"[time] {inst('colsum', d)} alone at {name} shapes, {len(cs)} "
        f"streams of {sum(a[0].shape[0] for a in cs)} vregs (graph replay, "
        f"{ALONE_REPS} launches a graph): kernel {ms * 1e3:.2f} us, plain "
        f"{plain * 1e3:.1f} us; == colsum_plain bit for bit; must move "
        f"{must / 1e6:.2f} MB, bound {b_ms * 1e3:.2f} us ({b_by}) at "
        f"{PEAK_BYTES / 1e12} TB/s, {b_ms / ms:.3f} of it; {l2_fit(must)} "
        f"[{card}]")


def resident_bytes(op, csr, kv=1):
    """(bytes one K6 step moves, bytes one K6 call on kv x tables must
    move; kv > 1 is an SpMM pass, its tables read once).  A step
    reads the wins row, vals and idx of every vreg its schedule holds,
    the kernel's tables (schedule, wide rows, incidence, descriptors), src
    and the used slots' perm rows; writes the sell and long rows of y2 and
    the chunk rows and reads each back once; writes out (B_pad * 128
    words); and reads the x table for its gathers, then reads it and
    writes x_scr in the tap (all but the last step of a chain).  A call
    reads each input once (those tables, the residue's, and of each x
    table the words of the columns the matrix ``csr`` holds a nonzero in:
    what this data needs) and writes each of its kv outputs once,
    whatever its number of steps: n_rows words in the type the kernel
    writes (a pass's bf16 Y at 2 bytes a word; f32 for a bf16 step)."""
    import numpy as np
    nb = lambda t: t.numel() * t.element_size()
    meta, arrays = op._meta, op._arrays
    res = arrays["resident"]
    el = 8 if op.dtype == "f64" else 4
    items = res["items"].cpu().numpy()
    vregs = np.bincount(items[:, 0], weights=items[:, 2],
                        minlength=len(meta.streams))
    tables = sum(n * sum(nb(st[k]) for k in ("wins", "vals", "idx")) / NV
                 for (_, _, NV), st, n in zip(meta.streams,
                                              arrays["streams"], vregs))
    tables += (sum(nb(res[k]) for k in ("items", "wide", "inc_ptr",
                                        "inc_tot", "inc_mult", "desc",
                                        "res_ent", "res_task", "res_bptr",
                                        "res_bent", "res_cols", "res_vals"))
               + nb(res["src"])
               + int((res["src"] != meta.n_y2_rows).sum()) * 128)
    x = meta.s_rows * 128 * el
    x_used = np.unique(csr.col_idx).size * el
    out = meta.B_pad * 128 * el
    y_el = 2 if op.dtype == "bf16" and kv > 1 else el
    y2 = (meta.n_y2_rows + res["chunk_rows"]) * 128 * el
    return (int(tables + 3 * x + 2 * y2 + out),
            int(tables + kv * (x_used + meta.n_rows * y_el)))


def compare_resident(op, x2d, steps=(1, 3)):
    """K6 against its plain version on the same card tensors, bit for bit
    (ops/resident.py pins the order of every sum, the residue's
    included).  Returns the worst (scaled, abs) error."""
    import torch
    from dasp_tpu_torch.ops.resident import resident_loop, \
        resident_loop_plain
    worst = [0.0, 0.0]
    for n in steps:
        got = resident_loop(op._meta, op._arrays, x2d, n)
        want = resident_loop_plain(op._meta, op._arrays, x2d, n)
        e = scaled_err(got, want)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"K6 {op.dtype} at {n} steps differs from "
                                 f"its plain version: {e} (scaled, abs)")
        worst = [max(a, b) for a, b in zip(worst, e)]
    return worst


def compare_one_step(op, x2d):
    """The single-vector SpMV (``device_call``: one K6 launch at one
    step) against the plain one step on the same card tensors, y and the
    kernel's y2 bit for bit; the call must launch exactly one K6 of the
    operator's dtype and no other kernel.  Returns y."""
    import torch
    from dasp_tpu_torch.ops.resident import resident_loop, \
        resident_loop_plain, y2_plain
    meta, arrays = op._meta, op._arrays
    moved = launched(lambda: op.device_call(x2d))
    if moved != {inst("resident", op.dtype): 1}:
        raise AssertionError(f"one {op.dtype} SpMV launched {moved}, "
                             f"expected one K6")
    scratch = {}
    y = resident_loop(meta, arrays, x2d, 1, scratch=scratch)
    want = resident_loop_plain(meta, arrays, x2d, 1)
    y2 = scratch["y2"]
    if not (torch.equal(y, want) and torch.equal(y, op.device_call(x2d))
            and torch.equal(y2, y2_plain(meta, arrays, x2d))):
        raise AssertionError(
            f"one-step K6 {op.dtype} differs from its plain version: y "
            f"{scaled_err(y, want)}, y2 "
            f"{scaled_err(y2, y2_plain(meta, arrays, x2d))} (scaled, abs)")
    return y


def one_step_lines(name, op, x, card):
    """K6's phase clock over one step (the single-vector SpMV): A, the
    residue's sums R, C and D (the outgather and the residue's adds), in
    us, as a [phase] line."""
    from dasp_tpu_torch.ops.resident import RES_WARP_MIN
    ph = phase_split(op, op._prep_x(x), 1)
    us = {k: ph[k] / 1e3 for k in ("A", "R", "C", "D")}
    res = op._arrays["resident"]
    log(f"[phase] {name} {op.dtype} K6 one step (a single-vector SpMV, the "
        f"clock's own barrier before R): A {us['A']:.2f} us, residue sums "
        f"R {us['R']:.2f} ({res['res_ent'].shape[0]} rows, "
        f"{res['res_task'].shape[0]} warp tasks, "
        f"{int((res['res_ent'][:, 2] >= RES_WARP_MIN).sum())} rows a "
        f"warp), C "
        f"{us['C']:.2f}, D {us['D']:.2f}; sum {sum(us.values()):.2f} us; "
        f"grid {ph['grid']} [{card}]")
    return us


def compare_spmm(op, tabs):
    """K6's SpMM pass on the kv = len(tabs) x tables ``tabs``, interleaved
    by column, against its plain version on the same card tensors: Y
    (n_rows, kv) and the kernel's y2, one buffer a table, bit for bit (y2
    against y2_plain on the tables), and each column against one K6 step
    on its table, bit for bit; the pass must launch exactly one instance,
    of its kv.  Returns the worst (scaled, abs) error against the plain
    version."""
    import torch
    from dasp_tpu_torch.ops.resident import resident_loop, spmm_loop, \
        spmm_loop_plain, y2_plain
    meta, arrays = op._meta, op._arrays
    kv, x = len(tabs), multi_x(tabs)
    key = f"{inst('resident', op.dtype)}_kv{kv}"
    scratch, out = {}, []
    moved = launched(lambda: out.append(spmm_loop(meta, arrays, x, kv,
                                                  scratch=scratch)))
    if moved != {key: 1}:
        raise AssertionError(f"one {op.dtype} pass of {kv} launched "
                             f"{moved}, expected one {key}")
    y = out[0]
    want = spmm_loop_plain(meta, arrays, x, kv)
    y2 = y2_plain(meta, arrays, torch.stack(tabs))
    got2 = scratch["y2"]
    e = scaled_err(y, want)
    if not (y.dtype == want.dtype and y.shape == (meta.n_rows, kv)
            and torch.equal(y, want) and torch.equal(got2, y2)):
        raise AssertionError(f"{key} differs from its plain version: y {e}, "
                             f"y2 {scaled_err(got2, y2)} (scaled, abs)")
    for j, t in enumerate(tabs):
        if not torch.equal(y[:, j], resident_loop(meta, arrays, t, 1)):
            raise AssertionError(f"{key} column {j} differs from one K6 "
                                 f"step on its table")
    return e


def launched(step):
    """{instance: launches} that one call of ``step`` adds."""
    from dasp_tpu_torch.ops import kernel_launches as read_counts
    before = read_counts()
    step()
    return {k: n - before[k] for k, n in read_counts().items()
            if n != before[k]}


def phase_split(op, x2d, n):
    """K6's phase clock over one chain of ``n`` steps (ops/resident.py's
    STAMPS): {word: value}, the phases' ns summed over the steps."""
    import torch
    from dasp_tpu_torch.ops.resident import STAMP_WORDS, STAMPS, \
        resident_loop
    stamps = torch.zeros(STAMP_WORDS, dtype=torch.int64, device=x2d.device)
    resident_loop(op._meta, op._arrays, x2d, n, stamps=stamps)
    torch.cuda.synchronize()
    return dict(zip(STAMPS, stamps.tolist()))


def spmm_phase_split(op, x, kv):
    """K6's phase clock over one SpMM pass of kv x tables (x interleaved
    by column): {word: value}."""
    import torch
    from dasp_tpu_torch.ops.resident import STAMP_WORDS, STAMPS, spmm_loop
    stamps = torch.zeros(STAMP_WORDS, dtype=torch.int64, device=x.device)
    spmm_loop(op._meta, op._arrays, x, kv, stamps=stamps)
    torch.cuda.synchronize()
    return dict(zip(STAMPS, stamps.tolist()))


def pass_phase_lines(dev, name, csr, plan, dtypes, card):
    """K6's SpMM pass of K_COLS columns on one of phase 7's matrices: its
    phase clock, its graphed time, cuSPARSE A @ X's on the same columns,
    and its bound (the plan's tables and each x table and output once), a
    [phase] line a dtype."""
    import numpy as np
    import torch
    import dasp_tpu_torch as dt
    from dasp_tpu_torch.bench.baselines import cusparse_matrix
    from dasp_tpu_torch.ops import cuda_backend as cb
    X = np.random.default_rng(2).standard_normal((csr.n_cols, K_COLS))
    for d in dtypes:
        op = dt.SpMVOperator(plan, dtype=d, device=dev)
        x = multi_x([op._prep_x(X[:, j]) for j in range(K_COLS)])
        ph = spmm_phase_split(op, x, K_COLS)
        us = {k: ph[k] / 1e3 for k in ("A", "R", "C", "D")}
        g = time_ms(graphed(lambda: cb.spmm_fn(op._meta, op._arrays, x,
                                               K_COLS)), 5)
        nbytes = resident_bytes(op, csr, K_COLS)[1]
        b_ms, b_by = bound(nbytes, K_COLS * 2 * csr.nnz, d)
        lib = "none (bf16)"
        if d != "bf16":
            A, vdt = cusparse_matrix(csr, d, dev)
            Xd = torch.from_numpy(X).to(vdt).to(dev)
            lib = f"{time_ms(graphed(lambda: A @ Xd), 5) * 1e3:.2f} us"
            del A, Xd
        log(f"[phase] {name} {d} K6 SpMM pass of {K_COLS} (the clock's own "
            f"barrier before R): A {us['A']:.2f} us, residue sums R "
            f"{us['R']:.2f}, C {us['C']:.2f}, D {us['D']:.2f}; sum "
            f"{sum(us.values()):.2f} us; graphed pass {g * 1e3:.2f} us, "
            f"cuSPARSE A @ X {lib}; must move {nbytes / 1e6:.2f} MB, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}) at {PEAK_BYTES / 1e12} TB/s, "
            f"{b_ms / g:.3f} of the pass; grid {ph['grid']} [{card}]")
        del op, x


def multi_x(tabs):
    """An SpMM pass's x of the x tables ``tabs`` (S, 128): interleaved by
    column, (S*128, kv), row i word i of every table (made outside any
    timed pass, as matmat makes it on the host)."""
    import torch
    return torch.stack([t.reshape(-1) for t in tabs], 1)


def stacked_x(tabs):
    """K5's x table of the x tables ``tabs``: stacked, (kv*S, 128)."""
    import torch
    return torch.cat(tabs)


def fixed_row(st):
    """A stream's tables with every gather sent to row 0 of its x table,
    at the slot's own lane (q = 0, round 0, window offset 0): the stream
    and the chain of dependent loads as they are, without the spread of
    the gathers over the table."""
    import torch
    return dict(wins=torch.zeros_like(st["wins"]), vals=st["vals"],
                idx=st["idx"] & 127)


def k5_split(op, tabs, name, card):
    """What holds K5 back: K5 alone at kv = 1, 2, 4, 8 over every stream
    of ``op`` as it is and with every gather sent to one fixed row, and K1
    (K3 in f64) on the same streams beside them; ALONE_REPS launches per
    graph, us per pass.  Returns {(variant, kv or "K1"): us}."""
    from dasp_tpu_torch.ops.colsum import colsum
    from dasp_tpu_torch.ops.colsum_multi import KV_SIZES, colsum_multi
    strides = [s for _, s, _ in op._meta.streams]
    variants = {"as is": op._arrays["streams"],
                "fixed row": [fixed_row(st) for st in op._arrays["streams"]]}
    us = {}

    def alone(step):
        return time_ms(graphed(step, ALONE_REPS), 5) / ALONE_REPS * 1e3

    for label, sts in variants.items():
        us[label, "K1"] = alone(lambda: [
            colsum(st["wins"], st["vals"], st["idx"], tabs[0], s)
            for st, s in zip(sts, strides)])
        for kv in KV_SIZES:
            x = stacked_x(tabs[:kv])
            us[label, kv] = alone(lambda: [
                colsum_multi(st["wins"], st["vals"], st["idx"], x, s, kv)
                for st, s in zip(sts, strides)])
    k1 = inst("colsum", op.dtype)
    for label in variants:
        log(f"[time] K5 split {name} {op.dtype}, gathers {label}, us per "
            f"pass over every stream (graph replay): {k1} "
            f"{us[label, 'K1']:.1f}; " + "; ".join(
                f"K5 kv={kv} {us[label, kv]:.1f} ({us[label, kv] / kv:.1f} "
                f"a vector)" for kv in KV_SIZES) + f" [{card}]")
    return us


def spmm_alone(op, csr, tabs, alone, copy_gbs, card):
    """K6's SpMM pass at kv = 2, 4, 8 on the first kv of ``tabs``
    (interleaved by column): ALONE_REPS passes in one graph, its plain
    version, the bytes a pass must move (A's tables once, each x table and
    each output once) and its bound, one cuSPARSE A @ X of the same
    columns (the bench's baseline: for bf16 a bf16 CSR product where this
    build has one, else f32 on the bf16-rounded values), and the device
    kernels of one pass by the profiler, which must be the pass's one
    kernel (bf16's Y is rounded inside it); a [time] line each, and each
    instance's row of the kernels line in ``alone``."""
    import torch
    from dasp_tpu_torch.bench.baselines import TORCH_DTYPE, CuSparseBaseline
    from dasp_tpu_torch.ops.resident import spmm_loop, spmm_loop_plain
    meta, arrays, d = op._meta, op._arrays, op.dtype
    base = CuSparseBaseline(csr, d, tabs[0].device)
    A, vdt = base.mat, TORCH_DTYPE[base.compute_dtype]
    for kv in SPMM_KV:
        x = multi_x(tabs[:kv])
        ms = time_ms(graphed(lambda: spmm_loop(meta, arrays, x, kv),
                             ALONE_REPS), 5) / ALONE_REPS
        plain = time_ms(lambda: spmm_loop_plain(meta, arrays, x, kv), 2)
        own, other = kernel_counts(lambda: spmm_loop(meta, arrays, x, kv))
        if (own, other) != (1, 0):
            raise AssertionError(f"a {d} pass of {kv} ran {own} of the "
                                 f"port's kernels and {other} others, "
                                 f"expected K6's one")
        Xd = torch.randn((csr.n_cols, kv), dtype=vdt, device=x.device)
        lib = time_ms(graphed(lambda: A @ Xd, ALONE_REPS), 5) / ALONE_REPS
        nbytes = resident_bytes(op, csr, kv)[1]
        b_ms, b_by = bound(nbytes, kv * 2 * csr.nnz, d)
        k = f"{inst('resident', d)}_kv{kv}"
        alone[k] = (ms, plain, b_ms, b_by, lib)
        log(f"[time] {k} alone at {csr.n_rows}x{csr.n_cols} (graph replay, "
            f"{ALONE_REPS} passes a graph): a pass of {kv} {ms * 1e3:.2f} us "
            f"({ms * 1e3 / kv:.2f} a column), plain {plain * 1e3:.1f} us; "
            f"cuSPARSE A @ X[:, :{kv}] ({base.compute_dtype}) "
            f"{lib * 1e3:.2f} us; must move {nbytes / 1e6:.2f} MB = "
            f"{nbytes / (ms * 1e6):.0f} GB/s, "
            f"{nbytes / (ms * 1e6) / copy_gbs:.1%} of the copy rate; bound "
            f"{b_ms * 1e3:.2f} us ({b_by}) at {PEAK_BYTES / 1e12} TB/s, "
            f"{b_ms / ms:.3f} of it; {l2_fit(nbytes)}; device kernels a "
            f"pass (profiler): {own} [{card}]")


def kernel_counts(step):
    """Device kernels one call of ``step`` launches, by the profiler:
    (the port's own kernels, every other kernel: the glue's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    own = glue = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and not e.key.startswith("aten::"):
            if any(k in e.key for k in ("colsum", "outgather", "resident",
                                        "spmm_kernel")):
                own += e.count
            else:
                glue += e.count
    return own, glue


def n_streams(meta):
    """Streams of a plan and of its residue sub-plans."""
    return len(meta.streams) + (n_streams(meta.res) if meta.res else 0)


def compare_probes(dev):
    """T1-T3 at the tools' sizes, at 8x and at the sizes the kernels treat
    specially (PROBE_EDGES): every variant against its plain version on the
    same card tensors, and the T2/T3 variants that compute K1's function
    (T2 flane at any P, every T2 variant at P = 1, T3 B at stride 8 and C
    at stride 2) against K1 itself, all bit for bit.  Returns ({instance:
    (scaled, abs) worst error against the plain versions}, the sizes
    held)."""
    import torch
    from dasp_tpu_torch.ops.colsum import colsum
    from dasp_tpu_torch.probes import gather_bench as t1, \
        roundcost_ab as t2, stream_bench2 as t3

    def same(name, what, got, want):
        e = scaled_err(got, want)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {what} differs: {e} (scaled, abs)")
        return e

    edges = probe_edges(t1, t2, t3)
    err = {}
    worst = []
    for rows in edges["gather_bench"]:
        inp = t1.make_inputs(rows, dev)
        worst += [same("T1", f"{body} rows={rows}",
                       t1.gather_probe(inp[body], inp["xw"], body),
                       t1.gather_probe_plain(inp[body], inp["xw"], body))
                  for body in t1.BODIES]
        del inp
    err["gather_bench"] = max(worst)
    worst = []
    for P, nv in edges["roundcost_ab"]:
        args = t2.make_inputs(P, nv, dev)
        for variant in t2.VARIANTS:
            got = t2.roundcost_probe(*args, variant)
            worst.append(same("T2", f"{variant} P={P} NV={nv}", got,
                              t2.roundcost_probe_plain(*args, variant)))
            if P == 1 or variant == "flane":
                same("T2 vs K1", f"{variant} P={P} NV={nv}", got,
                     colsum(*args, 8))
        del args, got
    err["roundcost_ab"] = max(worst)
    worst = []
    for nv in edges["stream_bench2"]:
        vals, x2d, steps = t3.make_inputs(nv, dev)
        for tag, variant, P, stride, _ in t3.LADDER:
            wins, idx = steps[tag[0]]
            got = t3.stream_probe(wins, vals, idx, x2d, variant, stride)
            worst.append(same("T3", f"{tag} NV={nv}", got,
                              t3.stream_probe_plain(wins, vals, idx, x2d,
                                                    variant, stride)))
            if tag[0] in "BC":
                same("T3 vs K1", f"{tag} NV={nv}", got,
                     colsum(wins, vals, idx, x2d, stride))
        del vals, x2d, steps, wins, idx, got
    err["stream_bench2"] = max(worst)
    return err, edges


def probe_edges(t1, t2, t3):
    """The sizes compare_probes holds T1-T3 at: the tools' sizes and
    PROBE_SCALES' multiples of them, and the sizes the kernels treat
    specially.  T1: one 2,048-row block and three (a sublane block's share
    of the chunks ends short of the others'); T2: every P of its sweep,
    P = 2 and P = 5 (a wins row of 6 words, staged a word a thread from
    rows that are not 16-byte aligned); T3: 3 x 128 vregs, not a multiple
    of the persistent grid."""
    ps = sorted(set(t2.PS) | {2, 5})
    return {
        "gather_bench": [t1.ROWS * s for s in PROBE_SCALES]
                        + [t1.B, 3 * t1.B],
        "roundcost_ab": [(P, t2.NV * s) for s in PROBE_SCALES
                         for P in (ps if s == 1 else t2.PS)],
        "stream_bench2": [t3.NV * s for s in PROBE_SCALES] + [3 * 128],
    }


def huge_columns_matrix(rng, n_rows=262_144, n_cols=8_388_608):
    """~2.1M nnz over more columns than the reference puts in one plan
    (its SLAB_COLS is 6,291,456): rows of 1-15 nnz, row i's columns within
    500 of i * n_cols / n_rows, so the rows span the whole column range
    (the matrix of tests/test_torch_slabs.py at size)."""
    import numpy as np
    from dasp_tpu_torch.sparse import CSRMatrix
    lens = rng.integers(1, 16, n_rows)
    rpt = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(lens, out=rpt[1:])
    nnz = int(rpt[-1])
    rows = np.repeat(np.arange(n_rows), lens)
    cols = np.clip(rows * (n_cols // n_rows) + rng.integers(0, 500, nnz),
                   0, n_cols - 1).astype(np.int32)
    order = np.lexsort((cols, rows))
    return CSRMatrix(n_rows, n_cols, rpt, cols[order],
                     rng.standard_normal(nnz))


def bench_phase(dev, arms, card):
    """The bench's run_arm on ``arms`` [(name, csr, plan, dtypes)] into a
    temporary directory: every arm must pass its checks, the records must
    carry the reference's header, a resident and a streamed row per arm
    and one SpMM row, and the summary line must parse.  Returns
    {(name, dtype): ArmResult}."""
    from dasp_tpu_torch.bench.__main__ import ArmInputs, Summary, run_arm
    from dasp_tpu_torch.bench.record import FIELDS
    summary = Summary(sum(len(dts) for *_, dts in arms))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, csr, plan, dtypes in arms:
            inputs = ArmInputs(csr, K_COLS)
            for d in dtypes:
                t = time.perf_counter()
                arm = out[name, d] = run_arm(name, inputs, plan, d, tmp,
                                             device=dev)
                if not arm.ok:
                    raise AssertionError(
                        f"bench arm {name} {d} failed {arm.failures}: "
                        f"{arm.errors}")
                summary.add(name, d, arm)
                us = {k: r.seconds_per_iter * 1e6
                      for k, r in arm.results.items()}
                n = {k: r.timed_iters for k, r in arm.results.items()}
                log(f"[bench] {name} {d} nnz={csr.nnz}: worst error "
                    f"{max(arm.errors.values()):.3e} of "
                    f"{len(arm.errors)} checks; us per SpMV (chain): "
                    + ", ".join(f"{k} {us[k]:.1f} ({n[k]})" for k in
                                ("resident", "streamed", "baseline"))
                    + f"; us per SpMM column of {K_COLS}: spmm "
                    f"{us['spmm']:.1f}, baseline {us['spmm_baseline']:.1f}; "
                    f"baseline in {arm.baseline_dtype}; "
                    f"{time.perf_counter() - t:.2f} s [{card}]")
        for d in DTYPES:
            n_arms = sum(d in dts for *_, dts in arms)
            for kind, variants in (("spmv", ["resident", "streamed"]),
                                   ("spmm", [f"spmm{K_COLS}"])):
                with open(os.path.join(tmp, f"{kind}_{d}_record.csv")) as f:
                    lines = f.read().splitlines()
                got = [ln.split(",")[FIELDS.index("variant")]
                       for ln in lines[1:]]
                if lines[0] != ",".join(FIELDS) or got != variants * n_arms:
                    raise AssertionError(
                        f"{kind}_{d}_record.csv: header or variant rows "
                        f"wrong ({len(lines) - 1} rows: {got})")
    s = json.loads(summary.line())
    if not (s["arms_done"] == s["arms_total"] == len(out) and s["value"] > 0
            and s["vs_baseline"] > 0 and s["metric"] == "spmv_gflops_geomean"):
        raise AssertionError(f"bench summary line wrong: {summary.line()}")
    log(f"[bench] records carry the reference's {len(FIELDS)} fields; "
        f"summary {summary.line()}")
    return out


def examples_phase(dev, card):
    """cg_solve (f32, fp64) at n = 65,536 and pagerank at n = 100,000 to
    the originals' thresholds, with their cost per iteration; each SpMV
    exactly one K6 launch.  Returns the launch counts of that run; then
    times CG's SpMV as one K6 step against the reference-order glue."""
    import numpy as np
    import dasp_tpu_torch as dt
    from dasp_tpu_torch.examples import cg_solver, pagerank
    from dasp_tpu_torch.ops import cuda_backend as cb, \
        kernel_launches as read_counts
    shared = dt.DaspConfig(row_sort="off")
    rng = np.random.default_rng(0)
    n = n_cg = 65_536
    csr = cg_solver.build_spd(n, rng)
    x_true = rng.standard_normal(n)
    b = csr.spmv(x_true)
    plan = dt.build_wplan(csr, shared)
    cg_ops = {}
    for d, limit in (("f32", 1e-3), ("f64", 1e-6)):
        op = cg_ops[d] = dt.SpMVOperator(plan, dtype=d, device=dev,
                                         force_streamed=True)
        x2d = op._prep_x(b)
        moved = launched(lambda: op.device_call(x2d))
        if moved != {inst("resident", d): 1}:
            raise AssertionError(f"cg {d}: one SpMV launched {moved}, "
                                 f"expected one K6")
        t = time.perf_counter()
        if d == "f64":
            x, res, iters = cg_solver.cg_solve_f64(op, b)
        else:
            # the default maxiter of 500 ends before f32 converges at
            # this n (it takes ~1,400 iterations); tol stays the default
            x, res, iters = cg_solver.cg_solve(op, b.astype(np.float32),
                                               maxiter=4000)
        wall = time.perf_counter() - t
        err = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
        if not (x.shape == (n,) and err < limit):
            raise AssertionError(f"cg_solve {d}: solution error {err:.3e} "
                                 f"not under {limit} after {iters} "
                                 f"iterations (residual {res:.3e})")
        ms = cg_solver.iteration_costs(op, b, min(iters, 200))
        log(f"[examples] cg_solve {d} n={n} nnz={csr.nnz}: {iters} "
            f"iterations, residual {res:.3e}, solution error {err:.3e} "
            f"(limit {limit}); {wall:.3f} s with the first call's capture; "
            f"per iteration {ms['synced'] * 1e3:.1f} us with the read-back "
            f"of rs, {ms['device'] * 1e3:.1f} us chained in one graph "
            f"without it, the SpMV alone {ms['spmv'] * 1e3:.1f} us "
            f"({ms['spmv'] / ms['device']:.0%} of the iteration) [{card}]")
    n, iters = 100_000, 50
    csr = pagerank.build_transition(n, np.random.default_rng(0))
    op = dt.SpMVOperator(csr, dtype="f32", config=shared, device=dev,
                         force_streamed=True)
    t = time.perf_counter()
    r = pagerank.pagerank(op, iters=iters)
    first = time.perf_counter() - t
    rh = np.full(n, 1.0 / n)
    for _ in range(iters):
        rh = 0.85 * csr.spmv(rh) + 0.15 / n
        rh = rh / rh.sum()
    rh = 0.85 * csr.spmv(rh) + 0.15 / n
    err = float(np.abs(r - rh).max() / np.abs(rh).max())
    if not (r.shape == (n,) and err < 1e-3):
        raise AssertionError(f"pagerank: rank error {err:.3e} not under "
                             f"1e-3 of the largest rank")
    loop_ms = time_ms(op._pagerank_runs[0.85, iters], 5)
    x2d = op._prep_x(rh)
    spmv_ms = time_ms(graphed(lambda: op.device_call(x2d), ALONE_REPS),
                      5) / ALONE_REPS
    log(f"[examples] pagerank n={n} nnz={csr.nnz}: {iters} iterations, "
        f"rank error {err:.3e} of the largest rank (limit 1e-3); first "
        f"call {first:.3f} s (capture); one replay of the whole loop "
        f"{loop_ms:.3f} ms = {loop_ms / (iters + 1) * 1e3:.1f} us per "
        f"iteration, the SpMV alone {spmv_ms * 1e3:.1f} us "
        f"({spmv_ms * (iters + 1) / loop_ms:.0%} of it) [{card}]")
    counts = read_counts()
    # a small plan: is one K6 step, on a grid sized to the card, slower
    # than the glue it replaced?
    for d, op in cg_ops.items():
        x2d = op._prep_x(b)
        glue = dict(op._arrays, resident=None)
        us = [time_ms(graphed(step, ALONE_REPS), 5) / ALONE_REPS * 1e3
              for step in (lambda: op.device_call(x2d),
                           lambda: cb.spmv_fn(op._meta, glue, x2d))]
        log(f"[examples] cg_solve {d} n={n_cg}: one SpMV as one K6 step "
            f"{us[0]:.2f} us, as the reference-order glue (K1/K3, the "
            f"glue, K2/K4) {us[1]:.2f} us (graph replays of {ALONE_REPS})"
            f" [{card}]")
    return counts


def n_outgathers(meta):
    """Outgather launches of one streamed SpMV: the plan's and each residue
    sub-plan's."""
    return 1 + (n_outgathers(meta.res) if meta.res else 0)


def compare_chip(chip, x2d):
    """One chip's K1/K3 per stream, K2/K4 on the y2 they make and K6 at 1
    and 3 steps against their plain versions on the chip's own x table,
    bit for bit."""
    import torch
    from dasp_tpu_torch.ops import cuda_backend as cb
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    meta, arrays = chip._meta, chip._arrays
    parts = []
    for (_, s, _), st in zip(meta.streams, arrays["streams"]):
        a = (st["wins"], st["vals"], st["idx"], x2d, s)
        parts.append(colsum(*a))
        if not torch.equal(parts[-1], colsum_plain(*a)):
            raise AssertionError(f"a chip's colsum ({chip.dtype}, stride "
                                 f"{s}) differs from its plain version")
    y2, _ = cb.stack_y2(meta, arrays, parts, x2d)
    og = (arrays["out_src"], arrays["out_perm"], y2)
    if not torch.equal(outgather(*og, meta.n_y2_rows), outgather_plain(*og)):
        raise AssertionError(f"a chip's outgather ({chip.dtype}) differs "
                             f"from its plain version")
    compare_resident(chip, x2d)


def multichip_phase(dev, card):
    """Phase 9 (module docstring).  Returns the launch counts of the
    phase's main path."""
    import numpy as np
    import dasp_tpu_torch as dt
    from dasp_tpu_torch.bench.__main__ import ArmInputs, run_multichip_arm
    from dasp_tpu_torch.bench.check import E2E_TOL, golden_mass, scaled_error
    from dasp_tpu_torch.bench.harness import bench_spmv
    from dasp_tpu_torch.bench.suite import build_suite
    from dasp_tpu_torch.ops import kernel_launches as read_counts, \
        zero_kernel_launches as zero_counts
    from dasp_tpu_torch.parallel import MultiChipSpMV
    from dasp_tpu_torch.sparse import powerlaw_like
    devices = [dev] * MC_CHIPS
    rng = np.random.default_rng(11)
    csr = powerlaw_like(100_000, 1.8, 500_000, rng, col_alpha=1.6)
    x = rng.standard_normal(csr.n_cols)
    t = time.perf_counter()
    suite = build_suite(["cop20k_like", "wikitalk_like"], seed=0)
    log(f"[multichip] generated {csr.n_rows}x{csr.n_cols} nnz={csr.nnz} "
        f"and {[(n, m.nnz) for n, m in suite]} in "
        f"{time.perf_counter() - t:.2f} s")

    def held(what, y, golden, scale, d):
        e = scaled_error(y, golden, scale)
        if not e <= E2E_TOL[d]:
            raise AssertionError(f"multichip {what}: error {e:.3e} over the "
                                 f"limit {E2E_TOL[d]} (mass-scaled)")
        return e

    ops = {}
    zero_counts()
    for d in ("f32", "f64"):
        t = time.perf_counter()
        op = MultiChipSpMV(csr, devices=devices, dtype=d)
        build = time.perf_counter() - t
        live = [c for c in op.chips if c is not None]
        if (len(live) != MC_CHIPS or op.stats["balance"] > 1.5
                or not op.resident):
            raise AssertionError(f"multichip {d}: {len(live)} chips with "
                                 f"rows, stats {op.stats}")
        golden, scale = golden_mass(csr, x, d)
        # one call: exactly one K6 (one step) per chip, nothing else
        want = {inst("resident", d): [1] * len(live)}
        before = read_counts()
        t = time.perf_counter()
        y = op(x)
        run = time.perf_counter() - t
        moved = {k: n - before[k] for k, n in read_counts().items()
                 if n != before[k]}
        if moved != {k: sum(v) for k, v in want.items()}:
            raise AssertionError(f"multichip {d}: one call launched {moved},"
                                 f" expected {want} (per chip)")
        e = held(f"{d} y", y, golden, scale, d)
        before = read_counts()
        y_loop = op.stitch(op.timing_loop(CHAIN)(op._prep_x(x)))
        moved = {k: n - before[k] for k, n in read_counts().items()
                 if n != before[k]}
        if moved != {inst("resident", d): MC_CHIPS}:
            raise AssertionError(f"multichip {d}: one timing loop launched "
                                 f"{moved}, expected one K6 per chip")
        e_l = held(f"{d} timing_loop({CHAIN})", y_loop, golden, scale, d)
        e_ls = held(f"{d} loop vs step", y_loop, y, scale, d)
        log(f"[multichip] powerlaw {csr.n_rows}x{csr.n_cols} nnz={csr.nnz} "
            f"{d} x{MC_CHIPS} on {dev}: build {build:.2f} s, first call "
            f"{run:.3f} s; balance {op.stats['balance']:.3f}, slab nnz "
            f"{op.stats['slab_nnz']}, real vregs {op.stats['real_vregs']}, "
            f"pad vregs {op.stats['pad_vregs']}, resident "
            f"{op.stats['resident']}; err {e:.3e}, timing_loop({CHAIN}) "
            f"(K6 per chip) {e_l:.3e}, vs the step {e_ls:.3e} (mass-scaled,"
            f" limit {E2E_TOL[d]}); launches of one call, per chip: "
            f"{want}, of one loop: K6 x{MC_CHIPS}")
        ops[d] = op
    arms = {}
    for name, m in suite:
        inputs = ArmInputs(m, 0)
        for d in ("f32", "f64"):
            t = time.perf_counter()
            arm, op = run_multichip_arm(name, inputs, d, devices,
                                        dt.DEFAULT_CONFIG)
            stats = op.stats
            if not arm.ok or "resident" not in arm.results:
                raise AssertionError(f"multichip arm {name} {d} failed "
                                     f"{arm.failures}: {arm.errors}")
            r = arm.results["resident"]
            arms[name, d] = (arm, op)
            log(f"[multichip] bench arm {name} {d} x{MC_CHIPS}: worst error "
                f"{max(arm.errors.values()):.3e} of {len(arm.errors)} "
                f"checks; {r.gflops:.2f} GFLOP/s, "
                f"{r.seconds_per_iter * 1e6:.2f} us per SpMV (chain "
                f"{r.timed_iters}, spread {r.spread:.3f}); balance "
                f"{stats['balance']:.3f}, real vregs {stats['real_vregs']}; "
                f"{time.perf_counter() - t:.2f} s [{card}]")
    launches = read_counts()
    log(f"[multichip] kernel launches in this phase: {launches}")
    if not (all(launches[inst("resident", d)] for d in ("f32", "f64"))
            and not any(launches[inst(k, d)] for k in ("colsum",
                                                       "outgather")
                        for d in ("f32", "f64"))):
        raise AssertionError(f"the multi-chip path did not run on K6 alone: "
                             f"{launches}")
    t = time.perf_counter()
    for d, op in ops.items():
        for chip, x2d in zip(op.chips, op.gather(op._prep_x(x))):
            compare_chip(chip, x2d)
    log(f"[multichip] every chip's K1/K3, K2/K4 and K6 (1 and 3 steps) == "
        f"their plain versions bit for bit, f32 and f64; "
        f"{time.perf_counter() - t:.2f} s")
    del ops
    # 4 chips on ONE card against one operator, in this one call; the
    # chains start at 10 SpMVs (the harness lengthens them to 2 ms), so
    # that no streamed capture holds 100 steps of four chips' glue
    for name, m in suite:
        t = time.perf_counter()
        x = ArmInputs(m, 0).x
        plan = dt.build_wplan(m)
        # every chip packs with row_sort off, as the reference's chips do
        unsorted = dt.build_wplan(m, dt.DaspConfig(row_sort="off"))
        vregs = lambda p: sum(st.n_vregs for st in p.streams)
        log(f"[multichip] {name} vregs: {MC_CHIPS} chips "
            f"{sum(arms[name, 'f32'][1].stats['real_vregs'])}, one plan "
            f"{vregs(plan)}, one plan with row_sort off {vregs(unsorted)}")
        for d in ("f32", "f64"):
            ops1 = {v: dt.SpMVOperator(plan, d, device=dev,
                                       force_streamed=v == "streamed")
                    for v in ("resident", "streamed")}
            one = {v: bench_spmv(o, x, d, iters=10) for v, o in ops1.items()}
            sop = MultiChipSpMV(m, devices=devices, dtype=d,
                                force_streamed=True)
            four = {"resident": arms[name, d][0].results["resident"],
                    "streamed": bench_spmv(sop, x, d, iters=10)}
            pieces = sop._prep_x(x)
            gather = time_ms(graphed(lambda: sop.gather(pieces), ALONE_REPS),
                             5) / ALONE_REPS
            xb = sop._meta.s_rows * 128 * (8 if d == "f64" else 4)
            log(f"[multichip] {name} {d} us per SpMV, {MC_CHIPS} chips on "
                f"ONE card (partitioning's cost, not scaling) against one "
                f"operator: " + ", ".join(
                    f"{v} {four[v].seconds_per_iter * 1e6:.2f} vs "
                    f"{one[v].seconds_per_iter * 1e6:.2f} ("
                    f"{four[v].seconds_per_iter / one[v].seconds_per_iter:.2f}"
                    f"x)" for v in ("resident", "streamed"))
                + f"; the all-gather alone {gather * 1e3:.2f} us a step "
                f"({MC_CHIPS} x table copies of {xb / 1e6:.2f} MB, graph "
                f"replay of {ALONE_REPS}) [{card}]")
            # K6's phase clock, per step over a chain of LONG_CHAIN: the
            # one operator against each chip
            mop = arms[name, d][1]
            split = [phase_split(ops1["resident"],
                                 ops1["resident"]._prep_x(x), LONG_CHAIN)]
            split += [phase_split(c, x2d, LONG_CHAIN) for c, x2d in
                      zip(mop.chips, mop.gather(mop._prep_x(x)))]
            us = [[ph[k] / LONG_CHAIN / 1e3 for k in ("A", "C", "D")]
                  for ph in split]
            log(f"[multichip] {name} {d} K6 phases per step (us, A / C / "
                f"D+tap): one operator " + " / ".join(
                    f"{v:.2f}" for v in us[0]) + f"; the {MC_CHIPS} chips "
                + ", ".join(" / ".join(f"{v:.2f}" for v in u)
                            for u in us[1:])
                + f", summed " + " / ".join(
                    f"{sum(u[i] for u in us[1:]):.2f}" for i in range(3))
                + f" [{card}]")
        log(f"[multichip] {name} timed in {time.perf_counter() - t:.2f} s")
    return launches


def tile_phase(dev, card, arms):
    """Phase 10 (module docstring) on ``arms`` [(name, csr, WPlan,
    dtypes)], phase 7's plans of the four matrices.  Raises on a failed
    check."""
    import numpy as np
    import torch
    import dasp_tpu_torch as dt
    from dasp_tpu_torch.bench.baselines import CuSparseBaseline
    from dasp_tpu_torch.bench.check import E2E_TOL, golden_mass, scaled_error
    from dasp_tpu_torch.bench.harness import bench_spmv
    from dasp_tpu_torch.ops import cuda_backend as cb, \
        kernel_launches as read_counts, zero_kernel_launches as zero_counts
    from dasp_tpu_torch.ops.xla_backend import TileSpMV
    from dasp_tpu_torch.parallel import MultiChipSpMV
    from dasp_tpu_torch.sparse import mixed_categories, powerlaw_like

    def held(what, y, golden, scale, d):
        e = scaled_error(y, golden, scale)
        if not e <= E2E_TOL[d]:
            raise AssertionError(f"tile {what}: error {e:.3e} over the limit"
                                 f" {E2E_TOL[d]} (mass-scaled)")
        return e

    def no_kernels(what):
        moved = {k: n for k, n in read_counts().items() if n}
        if moved:
            raise AssertionError(f"tile {what}: the tile executor launched "
                                 f"K1-K6: {moved}")

    def tensors_of(tree):
        if torch.is_tensor(tree):
            yield tree
        elif isinstance(tree, (dict, list)):
            for v in (tree.values() if isinstance(tree, dict) else tree):
                yield from tensors_of(v)

    def per_spmv(step):
        """(eager, graph) us per SpMV of a step of CHAIN SpMVs."""
        e, g = eager_and_graph(step, 3)
        return e / CHAIN * 1e3, g / CHAIN * 1e3

    for name, csr, wplan, dtypes in arms:
        t = time.perf_counter()
        plan = dt.build_plan(csr)
        build = time.perf_counter() - t
        slots = plan.stats["fill0_nnz_total"] / csr.nnz
        x = np.random.default_rng(1).standard_normal(csr.n_cols)
        for d in dtypes:
            t = time.perf_counter()
            op = dt.SpMVOperator(plan, d, backend="xla", device=dev)
            lower = time.perf_counter() - t
            if not (isinstance(op, TileSpMV) and op.device.type == "cuda"
                    and all(v.device.type == "cuda"
                            for v in tensors_of(op._arrays))):
                raise AssertionError(f"tile {name} {d}: not on the card")
            golden, scale = golden_mass(csr, x, d)
            x_dev = op._prep_x(x)
            zero_counts()
            y = op(x)
            y_loop = cb._to_host(op.timing_loop(CHAIN - 1)(x_dev))
            torch.cuda.synchronize()
            no_kernels(f"{name} {d}")
            e = held(f"{name} {d} y", y, golden, scale, d)
            e_l = held(f"{name} {d} timing_loop({CHAIN - 1})", y_loop,
                       golden, scale, d)
            tile = per_spmv(lambda loop=op.timing_loop(CHAIN - 1),
                            x_dev=x_dev: loop(x_dev))
            n_kern = sum(kernel_counts(lambda: op.device_call(x_dev)))
            rop = dt.SpMVOperator(wplan, d, device=dev)
            sop = dt.SpMVOperator(wplan, d, device=dev, force_streamed=True)
            base = CuSparseBaseline(csr, d, dev)
            held(f"{name} {d} cuSPARSE", base(x), *golden_mass(csr, x, d), d)
            others = {
                "resident K6 step": per_spmv(
                    lambda loop=rop.timing_loop(CHAIN), x2d=rop._prep_x(x):
                        loop(x2d))[1],
                "streamed (one K6 step a SpMV)": per_spmv(
                    lambda loop=sop.timing_loop(CHAIN - 1),
                    x2d=sop._prep_x(x): loop(x2d))[1],
                f"cuSPARSE ({base.compute_dtype})": per_spmv(
                    lambda loop=base.timing_loop(CHAIN - 1),
                    xb=base._prep_x(x): loop(xb))[1]}
            log(f"[tile] {name} {csr.n_rows}x{csr.n_cols} nnz={csr.nnz} {d}: "
                f"build_plan {build:.2f} s, {slots:.3f} value slots per nnz "
                f"({len(plan.shorts)} short streams, pair13 "
                f"{plan.pair13 is not None}, {len(plan.sell)} sell and "
                f"{len(plan.remainder)} remainder groups, long rows "
                f"{plan.long.n_rows if plan.long else 0}); lower+upload "
                f"{lower:.2f} s; err {e:.3e}, timing_loop {e_l:.3e} "
                f"(mass-scaled, limit {E2E_TOL[d]}); K1-K6 launches 0; us "
                f"per SpMV, chain of {CHAIN}: tile eager {tile[0]:.1f} / "
                f"graph {tile[1]:.1f}; " + ", ".join(
                    f"{k} graph {v:.1f}" for k, v in others.items())
                + f"; device kernels per tile SpMV {n_kern} (profiler) "
                f"[{card}]")
            if d == "f32":
                log(f"[profile] tile {name} {d}, one device_call, eager: "
                    + profile_line(lambda: op.device_call(x_dev), 4))
            del op, rop, sop, base

    # four tile-plan chips on the one card
    devices = [dev] * MC_CHIPS
    rng = np.random.default_rng(11)
    pl = powerlaw_like(100_000, 1.8, 500_000, rng, col_alpha=1.6)
    x_pl = rng.standard_normal(pl.n_cols)
    mixed = mixed_categories(160 * MC_CHIPS, rng)
    x_mx = rng.standard_normal(mixed.n_cols)
    for label, m, x in (("dry run mixed", mixed, x_mx),
                        ("powerlaw", pl, x_pl)):
        for d in ("f32", "f64"):
            t = time.perf_counter()
            op = MultiChipSpMV(m, devices=devices, dtype=d, backend="xla")
            build = time.perf_counter() - t
            zero_counts()
            y = op(x)
            torch.cuda.synchronize()
            no_kernels(f"{label} x{MC_CHIPS} {d}")
            e = held(f"{label} x{MC_CHIPS} {d}", y, *golden_mass(m, x, d), d)
            four = bench_spmv(op, x, d, iters=10)
            win = MultiChipSpMV(m, devices=devices, dtype=d)
            four_w = bench_spmv(win, x, d, iters=10)
            log(f"[tile] MultiChipSpMV(backend=\"xla\") {label} "
                f"{m.n_rows}x{m.n_cols} nnz={m.nnz} {d} x{MC_CHIPS} on {dev}: "
                f"build {build:.2f} s, balance {op.stats['balance']:.3f}; err "
                f"{e:.3e} (mass-scaled, limit {E2E_TOL[d]}); K1-K6 launches "
                f"0; us per SpMV (harness, chain {four.timed_iters}) "
                f"{four.seconds_per_iter * 1e6:.2f}, the windowed 4-chip "
                f"operator ({'resident' if win.resident else 'streamed'}) "
                f"{four_w.seconds_per_iter * 1e6:.2f} [{card}]")
            del op, win


def main():
    t_start = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dasp_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(dasp_tpu_torch/ not found beside this script)")
    sys.path.insert(0, here)
    import numpy as np
    import dasp_tpu_torch as dt
    from dasp_tpu_torch import wplan
    from dasp_tpu_torch.bench.__main__ import card_line
    from dasp_tpu_torch.bench.baselines import cusparse_matrix
    from dasp_tpu_torch.bench.check import E2E_TOL, golden_mass, scaled_error
    from dasp_tpu_torch.bench.harness import copy_rate_gbs, event_seconds
    from dasp_tpu_torch.bench.suite import build_suite
    from dasp_tpu_torch.io.build import ensure_built
    from dasp_tpu_torch.ops import _build, cuda_backend as cb, \
        kernel_launches as read_counts, zero_kernel_launches as zero_counts
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.colsum_multi import KV_SIZES, colsum_multi, \
        colsum_multi_plain, kernel_info
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    from dasp_tpu_torch.ops.resident import INFO_FIELDS, resident_loop, \
        resident_loop_plain, kernel_info as resident_info
    from dasp_tpu_torch.probes import gather_bench as t1, \
        roundcost_ab as t2, resident_probe as t4, stream_bench2 as t3
    from dasp_tpu_torch.sparse import mixed_categories, random_csr

    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()} torch "
        f"{torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    # device-memory copy rate: 1 GiB each way, 20x the 50 MB L2
    copy_gbs = copy_rate_gbs(dev)
    log(f"[device] copy {copy_gbs:.0f} GB/s (read + write, 1 GiB)")

    # -- 2. build ------------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
        f"source, {len(_build.SIGNATURES)} entry points: "
        f"{time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(_build.build(), here)}")
    for name in colsum_multi.launches:
        log(f"[build] K5 {inst('colsum_multi', name)} registers / local "
            f"(stack and spill) bytes a thread / shared bytes a block / "
            f"blocks a SM: " + "; ".join(
                f"stride {s} kv {kv}: {i['registers']} / {i['local_bytes']} "
                f"/ {i['shared_bytes']} / {i['blocks_per_sm']}"
                for s in (2, 4, 8) for kv in KV_SIZES
                for i in [kernel_info(name, s, kv)]))
    log(f"[build] K1/K3, the kv = 1 instances of colsum_multi.cu, registers "
        f"/ local bytes / shared bytes / blocks a SM: " + "; ".join(
            f"{inst('colsum', name)} stride {s}: {i['registers']} / "
            f"{i['local_bytes']} / {i['shared_bytes']} / "
            f"{i['blocks_per_sm']}"
            for name in colsum.launches for s in (2, 4, 8)
            for i in [kernel_info(name, s, 1)]))
    k6_info = {(d, kv): resident_info(d, kv) for d in resident_loop.launches
               for kv in (1,) + SPMM_KV}
    log(f"[build] K6 resident.cu {' / '.join(INFO_FIELDS)}: " + "; ".join(
        f"dasp_resident_{d}{'' if kv == 1 else f'_kv{kv}'}: "
        + " / ".join(str(i[k]) for k in INFO_FIELDS)
        for (d, kv), i in k6_info.items()))
    if k6_info["f64", 1]["local_bytes"]:
        raise AssertionError("dasp_resident_f64 uses local memory (stack "
                             "or spills): its shape is designed for none")
    # the probes' instances as phase 6 launches them
    figures = lambda i: (f"{i['registers']} / {i['local_bytes']} / "
                         f"{i['shared_bytes']} / {i['blocks_per_sm']}")
    log(f"[build] T1 gather_probe registers / local (stack and spill) bytes "
        f"a thread / shared bytes a block / blocks a SM: " + "; ".join(
            f"{b}: {figures(t1.kernel_info(b))}" for b in t1.BODIES)
        + f"; the sublane block holds "
        f"{t1.kernel_info('sublane')['slab_columns']} table columns")
    log(f"[build] T2 colsum_probe registers / local bytes / shared bytes / "
        f"blocks a SM: " + "; ".join(
            f"{v} P={P}: {figures(t2.kernel_info(P, v))}"
            for P in sorted({P for P, _ in
                             probe_edges(t1, t2, t3)["roundcost_ab"]})
            for v in (t2.VARIANTS[:1] if P == 1 else t2.VARIANTS)))
    log(f"[build] T3 colsum_probe registers / local bytes / shared bytes / "
        f"blocks a SM: " + "; ".join(
            f"{tag}: {figures(t3.kernel_info(P, variant, stride))}"
            for tag, variant, P, stride, _ in t3.LADDER))
    # the host library (Matrix Market parser, window router) that the
    # packer loads from native/.  Built here with g++ named explicitly:
    # an exported CXX without OpenMP support fails the Makefile's build,
    # and the numpy fallback packs the webbase_like arm far slower
    t = time.perf_counter()
    if ensure_built(cxx="g++") is None:
        raise RuntimeError("native host library build failed (the reason "
                           "is on stderr)")
    log(f"[build] native host library (make CXX=g++, under a lock, "
        f"renamed whole): "
        f"{time.perf_counter() - t:.2f} s")

    # -- 3. kernels vs plain on the entry fixture ----------------------------
    err = {k: 0.0 for k in INSTANCES}

    def note(errs):
        for k, (_, a) in errs.items():
            err[k] = max(err[k], a)

    def rand_tables(op, seed, n=cb.KV_SPMM):
        rng = np.random.default_rng(seed)
        return [op._prep_x(rng.standard_normal(op.n_cols))
                for _ in range(n)]

    t = time.perf_counter()
    csr = mixed_categories(2048, np.random.default_rng(7))
    plan = dt.build_wplan(csr)
    for d in DTYPES:
        op = dt.SpMVOperator(plan, dtype=d, device=dev)
        errs = compare_kernels(op, rand_tables(op, 3))
        note(errs)
        for kv in KV_SIZES:
            if kv != cb.KV_SPMM:
                e5 = compare_kernels(op, rand_tables(op, 3, kv))
                note({k: v for k, v in e5.items() if "multi" in k})
        if not op.resident:
            raise AssertionError(f"entry fixture {d} is not resident")
        e = compare_resident(op, rand_tables(op, 4)[0])
        note({inst("resident", d): e})
        for kv in SPMM_KV:
            note({f"{inst('resident', d)}_kv{kv}":
                  compare_spmm(op, rand_tables(op, 6, kv))})
        log(f"[kernels] entry fixture {d}: K6 == its plain version bit for "
            f"bit at 1 and 3 steps ({e[1]:.3e} abs), n_long="
            f"{op._meta.n_long} residue={op._meta.overflow_meta}; K6's "
            f"SpMM pass at kv = {list(SPMM_KV)}: y and y2 == its plain "
            f"version, each column == one K6 step, bit for bit")
        log(f"[kernels] entry fixture {csr.n_rows}x{csr.n_cols} "
            f"nnz={csr.nnz} {d} streams={list(op._meta.streams)} "
            f"k_used={op._meta.k_used}: " + ", ".join(
                f"{k} {s:.3e} scaled ({a:.3e} abs)"
                for k, (s, a) in errs.items())
            + f", limit {KERNEL_TOL[d]}; K5 slices == K1/K3 bit for bit at "
            f"kv = {list(KV_SIZES)}, the batched outgather == "
            f"outgather_plain per vector")
    log(f"[kernels] entry fixture done in {time.perf_counter() - t:.2f} s")

    # -- 4. the slice end to end at real size --------------------------------
    t = time.perf_counter()
    suite = build_suite(["cop20k_like", "webbase_like"], seed=0)
    log(f"[suite] generated {[(n, m.nnz) for n, m in suite]} in "
        f"{time.perf_counter() - t:.2f} s")
    router = "native" if wplan._native_router() else "python"
    if router != "native":
        raise RuntimeError("the packer did not load native/libdasp_host.so")

    def check(name, what, y, golden, scale, dtype, shape):
        e = (scaled_error(y, golden, scale) if y.shape == shape
             else float("inf"))
        if not e <= E2E_TOL[dtype]:
            raise AssertionError(f"{name} {what}: y {y.shape} (expected "
                                 f"{shape}), error {e:.3e} over the limit "
                                 f"{E2E_TOL[dtype]} (mass-scaled)")
        return e

    def matmat_counted(op, X):
        """(op.matmat(X), the launches of that call): exactly one K6 SpMM
        pass a pass of up to KV_SPMM columns, at the pass's kv (one K6
        step for a pass of one column), and no other kernel: no K5, K1/K3
        or K2/K4, the residue's sub-plans included."""
        d, k = op.dtype, X.shape[1]
        want = {}
        for c0 in range(0, k, cb.KV_SPMM):
            kv = min(s for s in KV_SIZES if s >= min(k - c0, cb.KV_SPMM))
            key = inst("resident", d) + (f"_kv{kv}" if kv > 1 else "")
            want[key] = want.get(key, 0) + 1
        out = []
        moved = launched(lambda: out.append(op.matmat(X)))
        if moved != want:
            raise AssertionError(f"matmat {d} of {k} columns launched "
                                 f"{moved}, expected {want}")
        return out[0], moved

    def glue_pass_counted(op, X):
        """The glue's SpMM pass (spmm_fn on op's tables without their K6
        schedule) on the columns of X: (Y in original order, launches),
        exactly one K5 a stream and one K2/K4 a plan, the residue
        sub-plans' included."""
        d, meta = op.dtype, op._meta
        glue = dict(op._arrays, resident=None)
        x = multi_x([op._prep_x(X[:, j]) for j in range(X.shape[1])])
        out = []
        moved = launched(lambda: out.append(
            cb.spmm_fn(meta, glue, x, X.shape[1])))
        want = {inst("colsum_multi", d): n_streams(meta),
                inst("outgather", "f64" if d == "f64" else "f32"):
                    n_outgathers(meta)}
        if moved != want:
            raise AssertionError(f"a glue pass {d} launched {moved}, "
                                 f"expected {want}")
        return op.perm_out(cb._to_host(out[0])), moved

    ops, rops, xs, plans = {}, {}, {}, {}
    zero_counts()
    for name, csr in suite:
        t = time.perf_counter()
        plan = dt.build_wplan(csr)
        pack = time.perf_counter() - t
        plan.stats["pack_seconds"] = pack
        plans[name] = plan
        rng = np.random.default_rng(1)
        x = rng.standard_normal(csr.n_cols)
        X = rng.standard_normal((csr.n_cols, K_COLS))
        xs[name] = x
        for d in DTYPES:
            t = time.perf_counter()
            op = dt.SpMVOperator(plan, dtype=d, device=dev,
                                 force_streamed=True)
            pre = time.perf_counter() - t
            t = time.perf_counter()
            y = op(x)
            run = time.perf_counter() - t
            golden, scale = golden_mass(csr, x, d)
            e = check(name, f"{d} SpMV", y, golden, scale, d, (csr.n_rows,))
            m = op._meta
            log(f"[e2e] {name} {csr.n_rows}x{csr.n_cols} nnz={csr.nnz} {d}: "
                f"err {e:.3e} (mass-scaled, limit {E2E_TOL[d]}); pack "
                f"{pack:.2f} s (router {router}, relabel "
                f"{'on' if plan.col_perm is not None else 'off'}, row_sort "
                f"{'on' if plan.row_perm is not None else 'off'}), lower+"
                f"upload {pre:.2f} s; first call {run:.3f} s; "
                f"streams={list(m.streams)} k_used={m.k_used} "
                f"B_pad={m.B_pad} n_long={m.n_long} "
                f"residue={m.overflow_meta} sub_plan={m.res is not None}")
            compare_one_step(op, op._prep_x(x))
            log(f"[e2e] {name} {d}: one SpMV = exactly one K6 launch at one "
                f"step ({op._arrays['resident']['res_ent'].shape[0]} "
                f"residue rows inside it), its y and y2 == the plain one "
                f"step's bit for bit")
            for k in (K_COLS, 4, 2):
                t = time.perf_counter()
                Y, moved = matmat_counted(op, X[:, :k])
                run = time.perf_counter() - t
                es = [check(name, f"{d} matmat column {j} of {k}", Y[:, j],
                            *golden_mass(csr, X[:, j], d), d,
                            (csr.n_rows,)) for j in range(k)]
                log(f"[e2e] {name} {d} matmat {k} columns: worst column "
                    f"err {max(es):.3e} (mass-scaled, limit {E2E_TOL[d]});"
                    f" first call {run:.3f} s; launches of the call: "
                    f"{moved}")
            ops[name, d] = op
            # the resident executor: a default operator's timing loop
            t = time.perf_counter()
            rop = dt.SpMVOperator(plan, dtype=d, device=dev)
            pre = time.perf_counter() - t
            if not rop.resident:
                raise AssertionError(f"{name} {d} is not resident")
            t = time.perf_counter()
            y_r = rop.perm_out(cb._to_host(
                rop.timing_loop(CHAIN)(rop._prep_x(x))))
            run = time.perf_counter() - t
            e = check(name, f"{d} resident", y_r, golden, scale, d,
                      (csr.n_rows,))
            e_s = check(name, f"{d} resident vs streamed", y_r,
                        y.astype(np.float64), scale, d, (csr.n_rows,))
            log(f"[e2e] {name} {d} resident timing_loop({CHAIN}) (K6): err "
                f"{e:.3e}, vs the streamed y {e_s:.3e} (mass-scaled, limit "
                f"{E2E_TOL[d]}); lower+prepare+upload {pre:.2f} s, first "
                f"call {run:.3f} s; n_tot={rop._arrays['resident']['n_tot']}"
                f" incidence entries="
                f"{rop._arrays['resident']['inc_tot'].numel()}")
            rops[name, d] = rop
    launches = read_counts()
    log(f"[e2e] kernel launches in this phase: {launches}")
    if (set(launches) != set(MAIN_PATH + GLUE_PATH)
            or not all(launches[k] for k in MAIN_PATH)
            or any(launches[k] for k in GLUE_PATH)):
        raise AssertionError(f"a kernel of the path never ran, or K1/K3, "
                             f"K5 or K2/K4 ran on it: {launches}")
    # a plan whose residue is repacked as a sub-plan (RES_REPACK_MIN = 1):
    # a matmat pass sums it by its trees in one K6 pass; the glue's pass
    # runs the sub-plan's streams through K5
    t = time.perf_counter()
    repack, cb.RES_REPACK_MIN = cb.RES_REPACK_MIN, 1
    try:
        rng = np.random.default_rng(0)
        sub = random_csr(40_000, 40_000, rng.integers(1, 8, size=40_000),
                         rng)
        sub_plan = dt.build_wplan(sub)
        Xs = rng.standard_normal((sub.n_cols, 5))
        for d in DTYPES:
            op = dt.SpMVOperator(sub_plan, dtype=d, device=dev,
                                 force_streamed=True)
            if op._meta.res is None:
                raise AssertionError("the residue was not repacked")
            Y, moved = matmat_counted(op, Xs)
            Yg, moved_g = glue_pass_counted(op, np.pad(Xs, ((0, 0), (0, 3))))
            es = [check("sub-plan fixture", f"{d} {what} column {j}",
                        Z[:, j], *golden_mass(sub, Xs[:, j], d), d,
                        (sub.n_rows,)) for j in range(Xs.shape[1])
                  for what, Z in (("matmat", Y), ("glue pass", Yg))]
            log(f"[e2e] sub-plan fixture {sub.n_rows}x{sub.n_cols} "
                f"nnz={sub.nnz} {d} matmat 5 columns and a glue pass of 8: "
                f"worst column err {max(es):.3e} (mass-scaled, limit "
                f"{E2E_TOL[d]}); streams={list(op._meta.streams)} + "
                f"sub-plan {list(op._meta.res.streams)}; launches of the "
                f"matmat call: {moved}; of the glue pass: {moved_g}")
    finally:
        cb.RES_REPACK_MIN = repack
    log(f"[e2e] sub-plan fixture done in {time.perf_counter() - t:.2f} s")
    for (name, d), op in ops.items():
        t = time.perf_counter()
        errs = compare_kernels(op, rand_tables(op, 5))
        note(errs)
        note({k: v for k, v in compare_kernels(
            op, rand_tables(op, 5, 4)).items() if "multi" in k})
        for kv in SPMM_KV:
            note({f"{inst('resident', d)}_kv{kv}":
                  compare_spmm(op, rand_tables(op, 5, kv))})
        log(f"[kernels] {name} {d}: " + ", ".join(
            f"{k} {s:.3e} scaled ({a:.3e} abs)"
            for k, (s, a) in errs.items())
            + f", limit {KERNEL_TOL[d]}; K5 also at kv = 4; K6's SpMM pass "
            f"at kv = {list(SPMM_KV)}: y and y2 == its plain version and "
            f"each column == one K6 step, bit for bit; "
            f"{time.perf_counter() - t:.2f} s")
    for (name, d), rop in rops.items():
        x2d = rop._prep_x(xs[name])
        e = compare_resident(rop, x2d)
        note({inst("resident", d): e})
        log(f"[kernels] {name} {d}: K6 == its plain version bit for bit at "
            f"1 and 3 steps ({e[1]:.3e} abs)")
    # K1/K3, K5 and K2/K4 where they still run: the glue path (the same
    # tables without the K6 schedule), on counts of their own: the
    # reference-order single-vector SpMV, each call exactly one K1/K3 a
    # stream and one K2/K4 a plan, and the glue's SpMM pass, exactly one K5
    # a stream and one K2/K4 a plan
    t = time.perf_counter()
    zero_counts()
    for (name, d), op in ops.items():
        glue = dict(op._arrays, resident=None)
        x2d = op._prep_x(xs[name])
        moved = launched(lambda: cb.spmv_fn(op._meta, glue, x2d))
        want = {inst("colsum", d): n_streams(op._meta),
                inst("outgather", "f64" if d == "f64" else "f32"):
                    n_outgathers(op._meta)}
        if moved != want:
            raise AssertionError(f"reference-order {name} {d}: launched "
                                 f"{moved}, expected {want}")
        y = op.perm_out(cb._to_host(cb.spmv_fn(op._meta, glue, x2d)))
        csr = dict(suite)[name]
        check(name, f"{d} reference-order SpMV", y,
              *golden_mass(csr, xs[name], d), d, (csr.n_rows,))
        Xg = np.random.default_rng(3).standard_normal((csr.n_cols, K_COLS))
        Yg, _ = glue_pass_counted(op, Xg)
        for j in range(K_COLS):
            check(name, f"{d} glue pass column {j}", Yg[:, j],
                  *golden_mass(csr, Xg[:, j], d), d, (csr.n_rows,))
    ref_launches = read_counts()
    launches.update({k: ref_launches[k] for k in GLUE_PATH})
    log(f"[e2e] glue path (no schedule): the reference-order single-vector "
        f"SpMV and an SpMM pass of {K_COLS}, launches {ref_launches}, each "
        f"y within E2E_TOL; {time.perf_counter() - t:.2f} s")

    # -- 5. timing -----------------------------------------------------------
    # "eager": each step issued from Python as the operator runs it;
    # "graph": the same step captured once in a CUDA graph and replayed,
    # which removes the host's launch cost and leaves the device time
    alone, pass_lib = {}, {}
    smoke_loops = {}     # (arm, dtype, variant) -> [ms per SpMV, step, SpMVs]
    for name, csr in suite:
        t = time.perf_counter()
        x = xs[name]
        flops = 2 * csr.nnz
        for d in DTYPES:
            op = ops[name, d]
            steps = {}
            for label, plain in (("kernel", False), ("plain", True)):
                x2d = op._prep_x(x)
                steps[label] = (lambda loop=op.timing_loop(CHAIN - 1, plain),
                                x2d=x2d: loop(x2d))
            if d != "bf16":
                A, vdt = cusparse_matrix(csr, d, dev)
                xv = torch.from_numpy(x).to(vdt).to(dev)
                golden, scale = golden_mass(csr, x, d)
                check(name, f"cuSPARSE {d}", (A @ xv).cpu().numpy(), golden,
                      scale, d, (csr.n_rows,))

                def cusparse_loop(A=A, xv=xv):
                    xc = xv.clone()
                    for _ in range(CHAIN - 1):
                        xc.add_((A @ xc)[0] * cb.TAP)
                    return A @ xc
                steps["cusparse"] = cusparse_loop
            row = {}
            for label, step in steps.items():
                e, g = eager_and_graph(step, 2 if label == "plain" else 5)
                row[f"{label} eager"], row[f"{label} graph"] = (
                    e / CHAIN, g / CHAIN)
            smoke_loops[name, d, "streamed"] = [row["kernel graph"],
                                                steps["kernel"], CHAIN]
            log(f"[time] {name} {d} nnz={csr.nnz} per SpMV: " + ", ".join(
                f"{k} {v * 1e3:.1f} us ({flops / (v * 1e6):.2f} GFLOP/s)"
                for k, v in row.items()) + f" [{card}]")
            if d != "bf16":
                log(f"[profile] {name} {d} kernel path, eager, per chain of "
                    f"{CHAIN}: " + profile_line(steps["kernel"], 4))

            # K6: one launch per chain, beside the streamed path above
            rop = rops[name, d]
            x2d = rop._prep_x(x)
            kr = {}
            for n in (CHAIN, LONG_CHAIN):
                step = lambda loop=rop.timing_loop(n), x2d=x2d: loop(x2d)
                e, g = eager_and_graph(step, 5 if n == CHAIN else 2)
                kr[n] = (e / n, g / n)
            smoke_loops[name, d, "resident"] = [kr[LONG_CHAIN][1], step,
                                                LONG_CHAIN]
            lib = row.get("cusparse graph")
            log(f"[time] {name} {d} per SpMV, resident K6 (one launch per "
                f"chain): " + ", ".join(
                    f"chain {n} eager {kr[n][0] * 1e3:.1f} us / graph "
                    f"{kr[n][1] * 1e3:.1f} us ({flops / (kr[n][1] * 1e6):.2f}"
                    f" GFLOP/s)" for n in kr)
                + f"; streamed kernel path chain {CHAIN} eager "
                f"{row['kernel eager'] * 1e3:.1f} us / graph "
                f"{row['kernel graph'] * 1e3:.1f} us; cuSPARSE chain {CHAIN}"
                f" graph " + (f"{lib * 1e3:.1f} us" if lib else "none (bf16)")
                + f" [{card}]")
            step_b, call_b = resident_bytes(rop, csr)
            t_step = kr[LONG_CHAIN][1]
            gbs = step_b / (t_step * 1e6)
            log(f"[time] {inst('resident', d)} alone at {name} shapes: "
                f"{t_step * 1e3:.1f} us per step (chain {LONG_CHAIN}, graph "
                f"replay); a step moves {step_b / 1e6:.2f} MB (computed) "
                f"= {gbs:.0f} GB/s, {gbs / copy_gbs:.1%} of the copy rate, "
                f"bound {step_b / copy_gbs / 1e3:.1f} us at the copy rate; "
                f"a chain-{CHAIN} call must move {call_b / 1e6:.2f} MB, "
                f"bound {bound(call_b, CHAIN * flops, d)[0] * 1e3:.1f} us at "
                f"{PEAK_BYTES / 1e12} TB/s [{card}]")
            ph = phase_split(rop, x2d, LONG_CHAIN)
            us = {k: ph[k] / LONG_CHAIN / 1e3 for k in ("A", "R", "C", "D")}
            split = sum(us.values())
            res = rop._arrays["resident"]
            mid = res["wide"].shape[0] > 0 or rop._meta.n_long_rows > 0
            log(f"[phase] {name} {d} K6 per step: A {us['A']:.2f} us, "
                f"residue sums R {us['R']:.2f}, B none, C {us['C']:.2f}, "
                f"D+tap {us['D']:.2f}; sum "
                f"{split:.2f} us = {split / (t_step * 1e3):.1%} of the "
                f"graphed step {t_step * 1e3:.2f} us (chain {LONG_CHAIN}); "
                f"{3 if mid else 2} grid barriers a step, "
                f"{res['items'].shape[0]} work items, "
                f"{res['wide'].shape[0]} wide rows; grid {ph['grid']}, "
                f"blocks/SM {ph['per_sm']} [{card}]")
            one_step_lines(name, op, x, card)
            # the streamed SpMV: one K6 step, and the chain's tap ops
            moved = launched(steps["kernel"])
            if moved != {inst("resident", d): CHAIN}:
                raise AssertionError(f"{name} {d}: a streamed chain of "
                                     f"{CHAIN} launched {moved}")
            own, glue = kernel_counts(steps["kernel"])
            log(f"[profile] {name} {d} device kernels per streamed SpMV "
                f"(chain of {CHAIN}, eager, profiler): "
                f"{(own + glue) / CHAIN:.1f} ({own / CHAIN:.1f} of the "
                f"port's: K6; {glue / CHAIN:.1f} others: the tap's ops, "
                f"bf16's rounding, the chain's copy of x); our counts: "
                f"{moved}")
            x1 = op._prep_x(x)
            one = eager_and_graph(lambda: op.device_call(x1), 20)
            log(f"[time] {name} {d} single-vector SpMV per call: streamed "
                f"(chain {CHAIN}) graph {row['kernel graph'] * 1e3:.1f} us / "
                f"eager {row['kernel eager'] * 1e3:.1f} us; one "
                f"device_call graph {one[1] * 1e3:.1f} us / eager "
                f"{one[0] * 1e3:.1f} us; resident K6 step (chain "
                f"{LONG_CHAIN}) graph {t_step * 1e3:.1f} us; streamed / "
                f"resident {row['kernel graph'] / t_step:.2f}x; cuSPARSE "
                + (f"graph {lib * 1e3:.1f} us / eager "
                   f"{row['cusparse eager'] * 1e3:.1f} us" if lib
                   else "none (bf16)") + f" [{card}]")
            if name == "cop20k_like":
                plain = time_ms(lambda r=rop, x2d=x2d: resident_loop_plain(
                    r._meta, r._arrays, x2d, CHAIN), 2)
                alone[inst("resident", d)] = (
                    kr[CHAIN][1] * CHAIN, plain,
                    *bound(call_b, CHAIN * flops, d),
                    lib * CHAIN if lib else None)

        # matmat at K_COLS columns: one K6 SpMM pass of 8, and on the glue
        # path (the same tables without their schedule) two K5 passes of 4
        # and one pass of 8, against K_COLS single SpMVs and cuSPARSE A @
        # X, on the same X (no chain), per call and per column
        rng = np.random.default_rng(2)
        X = rng.standard_normal((csr.n_cols, K_COLS))
        for d in DTYPES:
            op = ops[name, d]
            meta, arrays = op._meta, op._arrays
            glue = dict(arrays, resident=None)
            tabs = [op._prep_x(X[:, j]) for j in range(K_COLS)]
            x_all = multi_x(tabs)
            passes = [multi_x(tabs[c:c + 4]) for c in range(0, K_COLS, 4)]
            steps = {
                f"matmat (K6 pass, kv {K_COLS})":
                    lambda x=x_all, m=meta, a=arrays:
                        cb.spmm_fn(m, a, x, K_COLS),
                "glue (K5, kv 4)":
                    lambda ps=passes, m=meta, a=glue: [
                        cb.spmm_fn(m, a, x, 4) for x in ps],
                f"glue (K5, kv {K_COLS})":
                    lambda x=x_all, m=meta, a=glue:
                        cb.spmm_fn(m, a, x, K_COLS),
                f"{K_COLS} x SpMV": lambda tabs=tabs, m=meta, a=arrays: [
                    cb.spmv_fn(m, a, x2) for x2 in tabs],
            }
            if d != "bf16":
                A, vdt = cusparse_matrix(csr, d, dev)
                Xd = torch.from_numpy(X).to(vdt).to(dev)
                Yc = (A @ Xd).cpu().numpy()
                for j in range(K_COLS):
                    check(name, f"cuSPARSE {d} A @ X column {j}", Yc[:, j],
                          *golden_mass(csr, X[:, j], d), d, (csr.n_rows,))
                steps["cuSPARSE A @ X"] = lambda A=A, Xd=Xd: A @ Xd
                # a pass's yardstick: one library call for its columns
                lib_cols = {n: time_ms(graphed(
                    lambda A=A, Xn=Xd[:, :n].contiguous(): A @ Xn), 5)
                    for n in sorted({4, cb.KV_SPMM})}
                pass_lib[name, d] = lib_cols[cb.KV_SPMM]
            row = {k: eager_and_graph(s, 5) for k, s in steps.items()}
            log(f"[time] {name} {d} matmat {K_COLS} columns, per call (per "
                f"column): " + ", ".join(
                    f"{k} eager {e * 1e3:.1f} ({e * 1e3 / K_COLS:.1f}) us / "
                    f"graph {g * 1e3:.1f} ({g * 1e3 / K_COLS:.1f}) us "
                    f"({K_COLS * flops / (g * 1e6):.2f} GFLOP/s graphed)"
                    for k, (e, g) in row.items())
                + ("".join(f"; cuSPARSE A @ X[:, :{n}] graph {v * 1e3:.1f} us"
                           for n, v in lib_cols.items())
                   if d != "bf16" else "")
                + f" [{card}]")
            own8, other8 = kernel_counts(lambda x=x_all, m=meta, a=arrays:
                                         cb.spmm_fn(m, a, x, K_COLS))
            own, other = kernel_counts(lambda x=passes[0], m=meta, a=glue:
                                       cb.spmm_fn(m, a, x, 4))
            own1, other1 = kernel_counts(lambda x=tabs[0], m=meta, a=arrays:
                                         cb.spmv_fn(m, a, x))
            if (own8, other8) != (1, 0):
                raise AssertionError(f"{name} {d}: a K6 SpMM pass of "
                                     f"{K_COLS} ran {own8} + {other8} device "
                                     f"kernels, expected K6's one")
            log(f"[profile] {name} {d} device kernels of one K6 SpMM pass "
                f"of {K_COLS} vectors: {own8} of the port's (K6) + {other8} "
                f"others (Y written by K6, bf16 rounded in it); of one glue "
                f"pass of 4 vectors (stacked there by a transpose): "
                f"{own} of the port's (K5, K2/K4) + {other} of the glue; of "
                f"one spmv_fn (one K6 step): {own1} + {other1}")
            ph = spmm_phase_split(op, x_all, K_COLS)
            us = {k: ph[k] / 1e3 for k in ("A", "R", "C", "D")}
            g = row[f"matmat (K6 pass, kv {K_COLS})"][1] * 1e3
            log(f"[phase] {name} {d} K6 SpMM pass of {K_COLS} (the clock's "
                f"own barrier before R): A {us['A']:.2f} us, residue sums R "
                f"{us['R']:.2f}, C {us['C']:.2f}, D {us['D']:.2f}; sum "
                f"{sum(us.values()):.2f} us against the graphed pass "
                f"{g:.2f} us; grid {ph['grid']}, blocks/SM {ph['per_sm']} "
                f"[{card}]")

        # every kernel instance alone at this matrix's shapes (one SpMV's
        # worth: every stream's colsum, the outgather on its y2; one K5
        # pass of KV_SPMM vectors over every stream)
        for d in DTYPES:
            op = ops[name, d]
            cs, og, cm = kernel_args(op, rand_tables(op, 9))
            nbytes = kernel_bytes(op, cs, og, cm)
            pairs = {
                inst("colsum", d): (
                    "colsum", lambda cs=cs: [colsum(*a) for a in cs],
                    lambda cs=cs: [colsum_plain(*a) for a in cs]),
                inst("colsum_multi", d): (
                    "colsum_multi", lambda cm=cm: [colsum_multi(*a)
                                                   for a in cm],
                    lambda cm=cm: [colsum_multi_plain(*a) for a in cm]),
            }
            if d != "bf16":        # bf16's y2 is f32: the f32 outgather
                pairs[inst("outgather", d)] = (
                    "outgather",
                    lambda og=og, n=op._meta.n_y2_rows: outgather(*og, n),
                    lambda og=og: outgather_plain(*og))
            # the bound reads each input once: the streamed tables and
            # outputs above, plus the x tables the colsums gather from
            x_b = op._meta.s_rows * 128 * (8 if d == "f64" else 4)
            used = int((og[0] != op._meta.n_y2_rows).sum())
            work = {"colsum": (nbytes["colsum"] + x_b, flops),
                    "colsum_multi": (nbytes["colsum_multi"]
                                     + cb.KV_SPMM * x_b, cb.KV_SPMM * flops),
                    "outgather": (nbytes["outgather"], used * 128)}
            for k, (base, kern, plain) in pairs.items():
                # the kernel: ALONE_REPS launches in one graph, so that
                # the host's replay cost does not hide the device time
                got = [time_ms(graphed(kern, ALONE_REPS), 5) / ALONE_REPS,
                       time_ms(graphed(plain), 5)]
                gbs = nbytes[base] / (got[0] * 1e6)
                b_ms, b_by = bound(*work[base], d)
                log(f"[time] {k} alone at {name} shapes (graph replay): "
                    f"kernel {got[0] * 1e3:.2f} us, plain {got[1] * 1e3:.1f} "
                    f"us; eager: kernel {time_ms(kern, 20) * 1e3:.1f} us; "
                    f"kernel moves {nbytes[base] / 1e6:.2f} MB (computed) = "
                    f"{gbs:.0f} GB/s, {gbs / copy_gbs:.1%} of the copy rate, "
                    f"bound {nbytes[base] / copy_gbs / 1e3:.1f} us at the "
                    f"copy rate; with x read once "
                    f"{work[base][0] / 1e6:.2f} MB, bound {b_ms * 1e3:.2f} us "
                    f"({b_by}) at {PEAK_BYTES / 1e12} TB/s, "
                    f"{b_ms / got[0]:.3f} of it; " + l2_fit(work[base][0])
                    + f" [{card}]")
                if name == "cop20k_like":
                    # K5's library column: the pass's yardstick (one
                    # cuSPARSE call for its KV_SPMM columns), not K5's alone
                    alone[k] = (*got, b_ms, b_by,
                                pass_lib.get((name, d))
                                if base == "colsum_multi" else None)
            if d != "bf16":
                # the pass's outgather: one launch over the kv vectors
                # against one launch a vector
                y2 = pass_y2(op, cm)
                Z = op._meta.n_y2_rows
                one, each = (
                    time_ms(graphed(step, ALONE_REPS), 5) / ALONE_REPS * 1e3
                    for step in (
                        lambda: outgather(og[0], og[1], y2, Z),
                        lambda: [outgather(og[0], og[1], y2[j], Z)
                                 for j in range(y2.shape[0])]))
                log(f"[time] {inst('outgather', d)} of one pass of "
                    f"{y2.shape[0]} vectors at {name} shapes (graph replay):"
                    f" one launch {one:.1f} us, one launch a vector "
                    f"{each:.1f} us [{card}]")
            k5_split(op, rand_tables(op, 11, max(KV_SIZES)), name, card)
            if name == "cop20k_like":
                spmm_alone(op, csr, rand_tables(op, 9), alone, copy_gbs,
                           card)
        log(f"[time] {name} done in {time.perf_counter() - t:.2f} s")

    # -- T4: the L2 question, on its own launch count ------------------------
    t = time.perf_counter()
    t4.resident_probe.launches = {"f32": 0}
    nv = round(PROBE_MB * 1e6 / (8 * 128 * t4.SLOT_BYTES))
    args = t4.make_inputs(nv, dev)
    got = t4.resident_probe(*args, iters=3)
    e = scaled_err(got, t4.resident_probe_plain(*args))
    if not torch.equal(got, t4.resident_probe_plain(*args)):
        raise AssertionError(f"T4 differs from its plain version: {e}")
    note({"resident_probe": e})
    plain = time_ms(lambda: t4.resident_probe_plain(*args), 5)
    probe_b = sum(a.numel() * a.element_size() for a in args) + got.numel() * 4
    del args, got
    t4.resident_probe.launches = {"f32": 0}
    sweep = t4.sweep(dev)
    launches["resident_probe"] = t4.resident_probe.launches["f32"]
    for r in sweep:
        log(f"[probe] T4 {r['mb']:.1f} MB stream (nv={r['nv']}): "
            f"{r['us_per_sweep']:.2f} us per sweep (chains of "
            f"{t4.CHAINS[0]} and {t4.CHAINS[1]} differenced) = "
            f"{r['gbs']:.0f} GB/s, {r['gbs'] / copy_gbs:.1%} of the copy "
            f"rate [{card}]")
    row = next(r for r in sweep if round(r["mb"]) == PROBE_MB)
    alone["resident_probe"] = (
        row["us_per_sweep"] / 1e3, plain,
        *bound(probe_b, 2 * nv * 8 * 128, "f32"), None)
    log(f"[probe] T4 == its plain version bit for bit; launches "
        f"{launches['resident_probe']}; {time.perf_counter() - t:.2f} s")

    # -- 6. T1-T3: the colsum's costs, on their own launch counts ------------
    t = time.perf_counter()
    errs, edges = compare_probes(dev)
    for k, e in errs.items():
        note({k: e})
    log(f"[probe] T1 (3 bodies at rows {edges['gather_bench']}), T2 (3 "
        f"variants at (P, NV) {edges['roundcost_ab']}) and T3 (ladder A-F "
        f"at NV {edges['stream_bench2']}) == their plain versions bit for "
        f"bit; T2 flane, T2 P=1, T3 B and C == K1 on the card bit for bit; "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    wrappers = {"gather_bench": t1.gather_probe,
                "roundcost_ab": t2.roundcost_probe,
                "stream_bench2": t3.stream_probe}
    for w in wrappers.values():
        w.launches = {"f32": 0}
    sweeps = {}
    for scale in PROBE_SCALES:
        sweeps["gather_bench", scale] = [
            (r["body"], r) for r in t1.sweep(dev, t1.ROWS * scale)]
        sweeps["roundcost_ab", scale] = [
            (f"{r['variant']} P={r['P']}", r)
            for r in t2.sweep(dev, t2.NV * scale)]
        sweeps["stream_bench2", scale] = [
            (r["tag"], r) for r in t3.sweep(dev, t3.NV * scale)]
    for k, w in wrappers.items():
        launches[k] = w.launches["f32"]
    tool = {"gather_bench": "T1", "roundcost_ab": "T2",
            "stream_bench2": "T3"}
    for (k, scale), rows in sweeps.items():
        for label, r in rows:
            gbs = r["bytes"] / (r["ms"] * 1e6)
            b_ms, b_by = bound(r["move_bytes"], r["flops"], "f32")
            size = (f"rows={r['rows']}" if k == "gather_bench"
                    else f"NV={r['nv']}")
            lib = (f", torch.gather {r['library_ms'] * 1e3:.2f} us"
                   if r.get("library_ms") is not None else "")
            log(f"[probe] {tool[k]} {label} {size} ({scale}x the tool's): "
                f"alone {r['ms'] * 1e3:.2f} us, chained step "
                f"{r['chained_ms'] * 1e3:.2f} us (graph replays){lib}; the "
                f"tool's bytes {r['bytes'] / 1e6:.2f} MB = {gbs:.0f} GB/s, "
                f"{gbs / copy_gbs:.1%} of the copy rate; must move "
                f"{r['move_bytes'] / 1e6:.2f} MB, bound {b_ms * 1e3:.2f} us "
                f"({b_by}) at {PEAK_BYTES / 1e12} TB/s, "
                f"{b_ms / r['ms']:.3f} of it [{card}]")
    # the kernels line's rows: one named variant each, at the tool's size
    reps = {"gather_bench": "sublane", "roundcost_ab": "cur P=32",
            "stream_bench2": "D P4"}
    inp = t1.make_inputs(t1.ROWS, dev)
    a2 = t2.make_inputs(32, t2.NV, dev)
    vals, x2d, steps = t3.make_inputs(t3.NV, dev)
    plains = {
        "gather_bench": lambda: t1.gather_probe_plain(
            inp["sublane"], inp["xw"], "sublane"),
        "roundcost_ab": lambda: t2.roundcost_probe_plain(*a2, "cur"),
        "stream_bench2": lambda: t3.stream_probe_plain(
            steps["D"][0], vals, steps["D"][1], x2d, "B"),
    }
    for k, plain in plains.items():
        r = dict(sweeps[k, 1])[reps[k]]
        alone[k] = (r["ms"], time_ms(graphed(plain), 5),
                    *bound(r["move_bytes"], r["flops"], "f32"),
                    r.get("library_ms"))
    del inp, a2, vals, x2d, steps
    log(f"[probe] T1-T3 sweeps: launches " + ", ".join(
        f"{k} {launches[k]}" for k in wrappers)
        + f"; {time.perf_counter() - t:.2f} s")

    # -- 7. the bench's arm runner ---------------------------------------------
    t = time.perf_counter()
    arms = [(name, csr, plans[name], DTYPES) for name, csr in suite]
    for name in ("scircuit_like", "rmat_like"):
        t1 = time.perf_counter()
        (_, csr), = build_suite([name], seed=0)
        t2 = time.perf_counter()
        plan = dt.build_wplan(csr)
        plan.stats["pack_seconds"] = time.perf_counter() - t2
        log(f"[bench] {name} {csr.n_rows}x{csr.n_cols} nnz={csr.nnz}: "
            f"generated in {t2 - t1:.2f} s, packed in "
            f"{plan.stats['pack_seconds']:.2f} s; residue "
            f"{plan.overflow.nnz if plan.overflow is not None else 0} nnz")
        arms.append((name, csr, plan, DTYPES))
        if name != "rmat_like":
            continue
        # the largest residue of the suite, by trees inside one K6 step
        x = np.random.default_rng(1).standard_normal(csr.n_cols)
        for d in DTYPES:
            op = dt.SpMVOperator(plan, dtype=d, device=dev,
                                 force_streamed=True)
            y = compare_one_step(op, op._prep_x(x))
            e = check(name, f"{d} one-step SpMV",
                      op.perm_out(cb._to_host(y)), *golden_mass(csr, x, d),
                      d, (csr.n_rows,))
            one_step_lines(name, op, x, card)
            log(f"[bench] {name} {d}: one SpMV = one K6 launch, y and y2 == "
                f"the plain one step's bit for bit; err {e:.3e} "
                f"(mass-scaled, limit {E2E_TOL[d]})")
            # K6 past the L2: one SpMV and a chain's step, graphed
            x1 = op._prep_x(x)
            one = time_ms(graphed(lambda: op.device_call(x1)), 5)
            step = time_ms(graphed(lambda: resident_loop(
                op._meta, op._arrays, x1, LONG_CHAIN)), 2) / LONG_CHAIN
            log(f"[time] {name} {d} one device_call graph {one * 1e3:.1f} "
                f"us; resident K6 step (chain {LONG_CHAIN}) graph "
                f"{step * 1e3:.1f} us [{card}]")
            # K1/K3 past the L2: the reference-order colsum on its streams
            colsum_alone(name, op, op._prep_x(x), card, 2 * csr.nnz)
            del op
    t2 = time.perf_counter()
    csr = huge_columns_matrix(np.random.default_rng(5))
    plan = dt.build_wplan(csr)
    plan.stats["pack_seconds"] = time.perf_counter() - t2
    log(f"[bench] huge_columns {csr.n_rows}x{csr.n_cols} nnz={csr.nnz}: "
        f"generated and packed in {plan.stats['pack_seconds']:.2f} s; "
        f"s_rows={plan.s_rows}")
    arms.append(("huge_columns", csr, plan, ("f32", "f64")))
    for name, csr, plan, dtypes in arms[len(suite):]:
        pass_phase_lines(dev, name, csr, plan, dtypes, card)
    # uniform_medium's pass beside them (its bench arm is the full
    # bench's, not this phase's): 8 f64 x tables of 1 MB, 6.3M nnz
    (_, csr), = build_suite(["uniform_medium"], seed=0)
    pass_phase_lines(dev, "uniform_medium", csr, dt.build_wplan(csr),
                     DTYPES, card)
    zero_counts()
    bench_arms = bench_phase(dev, arms, card)
    bench_launches = read_counts()
    log(f"[bench] kernel launches in this phase: {bench_launches}")
    # the bench's SpMM arm runs passes of K_COLS columns: kv = 8 alone
    bench_path = [k for k in MAIN_PATH
                  if not k.endswith(tuple(f"_kv{kv}" for kv in SPMM_KV
                                          if kv != K_COLS))]
    if (not all(bench_launches[k] for k in bench_path)
            or any(bench_launches[k] for k in GLUE_PATH)):
        raise AssertionError(f"a kernel of the bench's path never ran, or "
                             f"K1/K3, K5 or K2/K4 ran on it: "
                             f"{bench_launches}")
    # Two clocks on one loop.  On ONE capture the harness's clock (one
    # replay between two events) and the smoke's (five) must agree within
    # 10 %.  Across captures a resident loop, one launch, must too; a
    # streamed loop's time depends on the capture by 10-16 % (where its
    # intermediates land in the graph's pool; the harness therefore takes
    # every trial from a capture of its own), so its harness figure is
    # held to the nearer of the smoke's two captures within 25 %.
    for (name, d, variant), (ms, step, spmvs) in smoke_loops.items():
        theirs = bench_arms[name, d].results[variant].seconds_per_iter * 1e3
        replay = graphed(step)
        again = time_ms(replay, 5) / spmvs
        clock = statistics.median(
            event_seconds(replay) for _ in range(TRIALS)) * 1e3 / spmvs
        off = min(abs(theirs / ms - 1.0), abs(theirs / again - 1.0))
        log(f"[bench] {name} {d} {variant} us per SpMV: the harness "
            f"{theirs * 1e3:.2f} (median of {TRIALS} captures); the smoke's "
            f"clock {ms * 1e3:.2f} in phase 5 and {again * 1e3:.2f} on a "
            f"new capture, which the harness's clock reads as "
            f"{clock * 1e3:.2f} [{card}]")
        if (abs(clock / again - 1.0) > 0.10
                or off > (0.10 if variant == "resident" else 0.25)):
            raise AssertionError(
                f"{name} {d} {variant}: the harness and the smoke's clock "
                f"disagree on one loop (see the line above)")
    del bench_arms
    log(f"[bench] done in {time.perf_counter() - t:.2f} s")

    # -- 8. the examples ---------------------------------------------------------
    t = time.perf_counter()
    zero_counts()
    ex_launches = examples_phase(dev, card)
    log(f"[examples] kernel launches in this phase: {ex_launches}")
    if not (all(ex_launches[k] for k in ("resident", "resident_f64"))
            and not any(ex_launches[inst(k, d)] for k in (
                "colsum", "outgather") for d in ("f32", "f64"))):
        raise AssertionError(f"the examples' path did not run on K6 alone: "
                             f"{ex_launches}")
    log(f"[examples] done in {time.perf_counter() - t:.2f} s")

    # -- 9. multi-chip --------------------------------------------------------
    t = time.perf_counter()
    multichip_phase(dev, card)
    log(f"[multichip] done in {time.perf_counter() - t:.2f} s")

    # -- 10. the tile plan and its executor ----------------------------------
    t = time.perf_counter()
    tile_phase(dev, card, [a for a in arms if a[0] != "huge_columns"])
    del arms
    log(f"[tile] done in {time.perf_counter() - t:.2f} s")

    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"dasp_tpu_torch/csrc/{s}",
         "replaces": r, "launches": launches[k], "max_abs_err": err[k],
         "ms": alone[k][0], "plain_ms": alone[k][1], "bound_ms": alone[k][2],
         "bound_by": alone[k][3], "library_ms": alone[k][4]}
        for k, (s, r) in INSTANCES.items()]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
