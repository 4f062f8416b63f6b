"""Smoke run of the PyTorch port (dasp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more printed lines each, every one raising on failure:
  1. device: needs torch.cuda; prints the card's name and power limit,
     and the device-memory copy rate (the roofline for the kernels);
  2. build: compiles the CUDA kernels (colsum K1 and its fp64 instance
     K3, outgather K2 and its fp64 instance K4, the multi-vector colsum
     K5, the resident executor K6, the L2 probe T4, and the probes T1
     (gather_probe.cu), T2 and T3 (colsum_probe.cu)) from
     dasp_tpu_torch/csrc with nvcc into one library in
     dasp_tpu_torch/_build, and the packer's native host library
     (native/, make);
  3. kernels vs plain on the card, on the fixture every row family passes
     through (mixed_categories(2048), as __graft_entry__.entry() packs it):
     every kernel instance (K1 f32 and bf16, K3, K2, K4, K5 at kv = 1, 2,
     4 and 8 with f32, bf16 and f64 values) against its plain version on
     the same tensors, each K5 slice against K1 / K3 on its own x, each
     vector of the batched outgather against outgather_plain on its y2,
     and K6 in f32, bf16 and f64 at 1 and 3 steps, all bit for bit; the
     registers, local bytes, shared bytes and blocks a SM of every K5
     instance are printed after the build;
  4. the SpMV end to end at published SuiteSparse sizes (cop20k_like,
     webbase_like from bench/suite.py), one pack per matrix serving all
     dtypes: SpMVOperator on the card in f32, f64 and bf16, and matmat
     with 8 columns in f32, bf16 and f64, on operators built with
     force_streamed=True (the streamed path), and the resident
     timing loop (K6, a chain of 10) of a default operator, each against
     the f64 CSR golden (for bf16 that of the bf16-rounded A and x),
     scaled by the backward-error mass max(|A||x|, 1), and the resident y
     against the streamed y; every kernel instance's launch count over
     this phase must be non-zero, and one matmat call must launch K5 once
     per stream and pass (the residue sub-plan's streams included, checked
     on a fixture whose residue is repacked) and K1/K3 not at all; then
     every instance against its plain version at these shapes (K5 at kv =
     4 and 8);
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
     (two K5 passes of 4, and one pass of 8) against 8 single SpMVs and
     cuSPARSE A @ X, per call and per column, in f32, f64 and bf16, with
     the device kernels one pass and one SpMV launch (the port's and the
     glue's, from the profiler); every kernel instance alone (ALONE_REPS launches
     captured in one graph, so that the host's replay cost does not
     show) beside its plain version, with the bytes it must move and its
     bound; the outgather of one pass as one launch and as one launch a
     vector; the K5 split (K5 alone at kv = 1, 2, 4, 8 as it is and with
     every gather sent to one fixed row of its table, K1/K3 beside them);
     a torch.profiler breakdown of the f32 and f64 streamed kernel
     paths; and the T4 sweep (the rate of a chained re-read of a 6-192 MB
     stream against the copy rate);
  6. the probes T1 (gather_bench: copy, shared-memory and L2 gathers),
     T2 (roundcost_ab: cur/flane/fboth at P = 1..32) and T3
     (stream_bench2: ladder A-F), at the tools' sizes: every variant
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
     Every arm passes the bench's checks (streamed y, resident loop y,
     each matmat column and cuSPARSE against the f64 CSR golden), writes
     its resident, streamed and SpMM rows under the reference's header,
     and the summary line parses; the harness's clock and the smoke's
     must agree within 10 % on one capture of each loop of phase 5, the
     harness's time per SpMV must lie within 10 % of the smoke's for a
     resident loop and within 25 % for a streamed one (whose time depends
     on the capture by 10-16 %); every kernel instance of the path must
     launch;
  8. the examples: cg_solve in f32 and fp64 at n = 65,536 and pagerank at
     n = 100,000 to the originals' thresholds (solution error < 1e-3 f32,
     < 1e-6 fp64; ranks within 1e-3 of the host power iteration), with the
     iterations, the ms per iteration with and without the read-back, and
     the SpMV's share; K1/K3 and K2/K4 must launch.
Phases 4, 7 and 8 each set the kernels' launch counts to 0 before they
run and read them after; the kernels line carries phase 4's.  It then
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

# kernel instance -> (source, the TPU kernel it replaces); the K6
# instances run as TorchSpMV.timing_loop of a resident operator
OPS = "dasp_tpu/ops"
INSTANCES = {
    "colsum": ("colsum.cu", f"{OPS}/pallas_backend.py:121"),
    "colsum_bf16": ("colsum.cu", f"{OPS}/pallas_backend.py:121"),
    "colsum_f64": ("colsum.cu", f"{OPS}/pallas_backend.py:277"),
    "outgather": ("outgather.cu", f"{OPS}/pallas_backend.py:437"),
    "outgather_f64": ("outgather.cu", f"{OPS}/pallas_backend.py:378"),
    "colsum_multi": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:174"),
    "colsum_multi_bf16": ("colsum_multi.cu",
                          f"{OPS}/pallas_backend.py:174"),
    "colsum_multi_f64": ("colsum_multi.cu", f"{OPS}/pallas_backend.py:174"),
    "resident": ("resident.cu", f"{OPS}/resident.py:452"),
    "resident_bf16": ("resident.cu", f"{OPS}/resident.py:452"),
    "resident_f64": ("resident.cu", f"{OPS}/resident.py:452"),
    "resident_probe": ("resident_probe.cu", "tools/resident_probe.py:27"),
    "gather_bench": ("gather_probe.cu", "tools/gather_bench.py:46"),
    "roundcost_ab": ("colsum_probe.cu", "tools/roundcost_ab.py:40"),
    "stream_bench2": ("colsum_probe.cu", "tools/stream_bench2.py:39"),
}
# T1-T4 are probes, not on the SpMV path: their launches are counted over
# their own sweeps (phase 6), every other instance's over phase 4
PROBES = ("resident_probe", "gather_bench", "roundcost_ab", "stream_bench2")
MAIN_PATH = tuple(k for k in INSTANCES if k not in PROBES)
PROBE_MB = 24           # T4's row in the kernels line: a stream that fits L2
PROBE_SCALES = (1, 8)   # T1-T3 at the tools' sizes and 8x (past the L2)


def log(msg):
    print(msg, flush=True)


def inst(base, dtype):
    """Name of a kernel instance: the f32 one bears the bare name."""
    return base if dtype == "f32" else f"{base}_{dtype}"


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
    x3d = multi_x(xs)
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
    on the same card tensors, and each K5 slice against K1/K3 on its own
    table (bit for bit).  Returns {instance: (scaled, abs) worst error}."""
    import torch
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.colsum_multi import colsum_multi, \
        colsum_multi_plain
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    d = op.dtype
    cs, og, cm = kernel_args(op, xs)
    err = {inst("colsum", d): [0.0, 0.0], inst("colsum_multi", d): [0.0, 0.0]}
    for a in cs:
        e = scaled_err(colsum(*a), colsum_plain(*a))
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


def resident_bytes(op):
    """(bytes one K6 step moves, bytes one K6 call must move).  A step
    reads the wins row, vals and idx of every vreg its schedule holds,
    the kernel's tables (schedule, wide rows, incidence, descriptors), src
    and the used slots' perm rows; writes the sell and long rows of y2 and
    the chunk rows and reads each back once; writes out; and reads the x
    table for its gathers, then reads it and writes x_scr in the tap.  A
    call reads each input once (those tables and x) and writes out once,
    whatever its number of steps."""
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
                                        "inc_tot", "inc_mult", "desc"))
               + nb(res["src"])
               + int((res["src"] != meta.n_y2_rows).sum()) * 128)
    x = meta.s_rows * 128 * el
    out = meta.B_pad * 128 * el
    y2 = (meta.n_y2_rows + res["chunk_rows"]) * 128 * el
    return int(tables + 3 * x + 2 * y2 + out), int(tables + x + out)


def compare_resident(op, x2d, steps=(1, 3)):
    """K6 against its plain version on the same card tensors, bit for bit
    (ops/resident.py pins the order of every sum, and the residue
    correction after the loop is the same torch code on both sides).
    Returns the worst (scaled, abs) error."""
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


def multi_x(tabs):
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
            x = multi_x(tabs[:kv])
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
            if any(k in e.key for k in ("colsum", "outgather", "resident")):
                own += e.count
            else:
                glue += e.count
    return own, glue


def n_streams(meta):
    """Streams of a plan and of its residue sub-plans."""
    return len(meta.streams) + (n_streams(meta.res) if meta.res else 0)


def compare_probes(dev):
    """T1-T3 at the tools' sizes: every variant against its plain version
    on the same card tensors, and the T2/T3 variants that compute K1's
    function (T2 flane at any P, every T2 variant at P = 1, T3 B at
    stride 8 and C at stride 2) against K1 itself, all bit for bit.
    Returns {instance: (scaled, abs) worst error against the plain
    versions}."""
    import torch
    from dasp_tpu_torch.ops.colsum import colsum
    from dasp_tpu_torch.probes import gather_bench as t1, \
        roundcost_ab as t2, stream_bench2 as t3

    def same(name, what, got, want):
        e = scaled_err(got, want)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {what} differs: {e} (scaled, abs)")
        return e

    err = {}
    inp = t1.make_inputs(t1.ROWS, dev)
    err["gather_bench"] = max(
        same("T1", body, t1.gather_probe(inp[body], inp["xw"], body),
             t1.gather_probe_plain(inp[body], inp["xw"], body))
        for body in t1.BODIES)
    del inp
    worst = []
    for P in t2.PS:
        args = t2.make_inputs(P, t2.NV, dev)
        for variant in t2.VARIANTS:
            got = t2.roundcost_probe(*args, variant)
            worst.append(same("T2", f"{variant} P={P}", got,
                              t2.roundcost_probe_plain(*args, variant)))
            if P == 1 or variant == "flane":
                same("T2 vs K1", f"{variant} P={P}", got, colsum(*args, 8))
    err["roundcost_ab"] = max(worst)
    vals, x2d, steps = t3.make_inputs(t3.NV, dev)
    worst = []
    for tag, variant, P, stride, _ in t3.LADDER:
        wins, idx = steps[tag[0]]
        got = t3.stream_probe(wins, vals, idx, x2d, variant, stride)
        worst.append(same("T3", tag, got, t3.stream_probe_plain(
            wins, vals, idx, x2d, variant, stride)))
        if tag[0] in "BC":
            same("T3 vs K1", tag, got, colsum(wins, vals, idx, x2d, stride))
    err["stream_bench2"] = max(worst)
    return err


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
    the originals' thresholds, with their cost per iteration."""
    import numpy as np
    import dasp_tpu_torch as dt
    from dasp_tpu_torch.examples import cg_solver, pagerank
    shared = dt.DaspConfig(row_sort="off")
    rng = np.random.default_rng(0)
    n = 65_536
    csr = cg_solver.build_spd(n, rng)
    x_true = rng.standard_normal(n)
    b = csr.spmv(x_true)
    plan = dt.build_wplan(csr, shared)
    for d, limit in (("f32", 1e-3), ("f64", 1e-6)):
        op = dt.SpMVOperator(plan, dtype=d, device=dev, force_streamed=True)
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
    from dasp_tpu_torch.bench.__main__ import build_native_router, card_line
    from dasp_tpu_torch.bench.baselines import cusparse_matrix
    from dasp_tpu_torch.bench.check import E2E_TOL, golden_mass, scaled_error
    from dasp_tpu_torch.bench.harness import copy_rate_gbs, event_seconds
    from dasp_tpu_torch.bench.suite import build_suite
    from dasp_tpu_torch.ops import _build, cuda_backend as cb, \
        kernel_launches as read_counts, zero_kernel_launches as zero_counts
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.colsum_multi import KV_SIZES, colsum_multi, \
        colsum_multi_plain, kernel_info
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    from dasp_tpu_torch.ops.resident import resident_loop, \
        resident_loop_plain
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
    # the host library (Matrix Market parser, window router) that the
    # packer loads from native/.  Built here with g++ named explicitly:
    # an exported CXX without OpenMP support fails the Makefile's build,
    # and the numpy fallback packs the webbase_like arm far slower
    t = time.perf_counter()
    build_native_router()
    log(f"[build] native host library (make CXX=g++): "
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
        log(f"[kernels] entry fixture {d}: K6 == its plain version bit for "
            f"bit at 1 and 3 steps ({e[1]:.3e} abs), n_long="
            f"{op._meta.n_long} residue={op._meta.overflow_meta}")
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
        """(op.matmat(X), K5 launches, K1/K3 launches of that call): one
        K5 launch per stream, of the plan and of its residue sub-plans,
        for each pass of KV_SPMM columns, and no single-vector colsum."""
        d = op.dtype
        n5, n1 = colsum_multi.launches[d], colsum.launches[d]
        Y = op.matmat(X)
        n5, n1 = colsum_multi.launches[d] - n5, colsum.launches[d] - n1
        passes = -(-X.shape[1] // cb.KV_SPMM)
        if (n5, n1) != (passes * n_streams(op._meta), 0):
            raise AssertionError(
                f"matmat {d}: {n5} K5 and {n1} K1/K3 launches, expected "
                f"{passes} x {n_streams(op._meta)} and 0")
        return Y, n5, n1

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
            t = time.perf_counter()
            Y, n5, n1 = matmat_counted(op, X)
            run = time.perf_counter() - t
            es = [check(name, f"{d} matmat column {j}", Y[:, j],
                        *golden_mass(csr, X[:, j], d), d, (csr.n_rows,))
                  for j in range(K_COLS)]
            log(f"[e2e] {name} {d} matmat {K_COLS} columns (kv "
                f"{cb.KV_SPMM}): worst column err {max(es):.3e} "
                f"(mass-scaled, limit {E2E_TOL[d]}); first call {run:.3f} s;"
                f" launches of the call: K5 {n5}, K1/K3 {n1} "
                f"({n_streams(m)} streams with the sub-plan's)")
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
    if set(launches) != set(MAIN_PATH) or not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    # a plan whose residue is repacked as a sub-plan (RES_REPACK_MIN = 1):
    # matmat runs the sub-plan's streams through K5 too
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
            Y, n5, n1 = matmat_counted(op, Xs)
            es = [check("sub-plan fixture", f"{d} matmat column {j}",
                        Y[:, j], *golden_mass(sub, Xs[:, j], d), d,
                        (sub.n_rows,)) for j in range(Xs.shape[1])]
            log(f"[e2e] sub-plan fixture {sub.n_rows}x{sub.n_cols} "
                f"nnz={sub.nnz} {d} matmat 5 columns: worst column err "
                f"{max(es):.3e} (mass-scaled, limit {E2E_TOL[d]}); "
                f"streams={list(op._meta.streams)} + sub-plan "
                f"{list(op._meta.res.streams)}; launches of the call: K5 "
                f"{n5}, K1/K3 {n1}")
    finally:
        cb.RES_REPACK_MIN = repack
    log(f"[e2e] sub-plan fixture done in {time.perf_counter() - t:.2f} s")
    for (name, d), op in ops.items():
        t = time.perf_counter()
        errs = compare_kernels(op, rand_tables(op, 5))
        note(errs)
        note({k: v for k, v in compare_kernels(
            op, rand_tables(op, 5, 4)).items() if "multi" in k})
        log(f"[kernels] {name} {d}: " + ", ".join(
            f"{k} {s:.3e} scaled ({a:.3e} abs)"
            for k, (s, a) in errs.items())
            + f", limit {KERNEL_TOL[d]}; K5 also at kv = 4; "
            f"{time.perf_counter() - t:.2f} s")
    for (name, d), rop in rops.items():
        x2d = rop._prep_x(xs[name])
        e = compare_resident(rop, x2d)
        note({inst("resident", d): e})
        log(f"[kernels] {name} {d}: K6 == its plain version bit for bit at "
            f"1 and 3 steps ({e[1]:.3e} abs)")

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
            step_b, call_b = resident_bytes(rop)
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
            us = {k: ph[k] / LONG_CHAIN / 1e3 for k in ("A", "C", "D")}
            split = sum(us.values())
            res = rop._arrays["resident"]
            mid = res["wide"].shape[0] > 0 or rop._meta.n_long_rows > 0
            log(f"[phase] {name} {d} K6 per step: A {us['A']:.2f} us, B "
                f"none, C {us['C']:.2f}, D+tap {us['D']:.2f}; sum "
                f"{split:.2f} us = {split / (t_step * 1e3):.1%} of the "
                f"graphed step {t_step * 1e3:.2f} us (chain {LONG_CHAIN}); "
                f"{3 if mid else 2} grid barriers a step, "
                f"{res['items'].shape[0]} work items, "
                f"{res['wide'].shape[0]} wide rows; grid {ph['grid']}, "
                f"blocks/SM {ph['per_sm']} [{card}]")
            if name == "cop20k_like":
                plain = time_ms(lambda r=rop, x2d=x2d: resident_loop_plain(
                    r._meta, r._arrays, x2d, CHAIN), 2)
                alone[inst("resident", d)] = (
                    kr[CHAIN][1] * CHAIN, plain,
                    *bound(call_b, CHAIN * flops, d),
                    lib * CHAIN if lib else None)

        # matmat at K_COLS columns: two K5 passes of 4 and one pass of 8
        # against K_COLS single SpMVs and cuSPARSE A @ X, on the same X (no
        # chain), per call and per column
        rng = np.random.default_rng(2)
        X = rng.standard_normal((csr.n_cols, K_COLS))
        for d in DTYPES:
            op = ops[name, d]
            meta, arrays = op._meta, op._arrays
            tabs = [op._prep_x(X[:, j]) for j in range(K_COLS)]
            passes = [multi_x(tabs[c:c + 4]) for c in range(0, K_COLS, 4)]
            steps = {
                "matmat (K5, kv 4)":
                    lambda ps=passes, m=meta, a=arrays: [
                        cb.spmm_fn(m, a, x, 4) for x in ps],
                f"matmat (K5, kv {K_COLS})":
                    lambda x=multi_x(tabs), m=meta, a=arrays:
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
            own, glue = kernel_counts(lambda x=passes[0], m=meta, a=arrays:
                                      cb.spmm_fn(m, a, x, 4))
            own1, glue1 = kernel_counts(lambda x=tabs[0], m=meta, a=arrays:
                                        cb.spmv_fn(m, a, x))
            log(f"[profile] {name} {d} device kernels of one spmm_fn pass of "
                f"4 vectors: {own} of the port's (K5, K2/K4) + "
                f"{glue} of the glue; of one spmv_fn: {own1} + {glue1}")

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
                    f"kernel {got[0] * 1e3:.1f} us, plain {got[1] * 1e3:.1f} "
                    f"us; eager: kernel {time_ms(kern, 20) * 1e3:.1f} us; "
                    f"kernel moves {nbytes[base] / 1e6:.2f} MB (computed) = "
                    f"{gbs:.0f} GB/s, {gbs / copy_gbs:.1%} of the copy rate, "
                    f"bound {nbytes[base] / copy_gbs / 1e3:.1f} us at the "
                    f"copy rate; with x read once "
                    f"{work[base][0] / 1e6:.2f} MB, bound {b_ms * 1e3:.1f} us "
                    f"({b_by}) at {PEAK_BYTES / 1e12} TB/s [{card}]")
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
    for k, e in compare_probes(dev).items():
        note({k: e})
    log(f"[probe] T1 (3 bodies), T2 (3 variants at P = {list(t2.PS)}) and "
        f"T3 (ladder A-F) == their plain versions bit for bit at the tools' "
        f"sizes; T2 flane, T2 P=1, T3 B and C == K1 on the card bit for "
        f"bit; {time.perf_counter() - t:.2f} s")
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
                f"({b_by}) at {PEAK_BYTES / 1e12} TB/s [{card}]")
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
    t2 = time.perf_counter()
    csr = huge_columns_matrix(np.random.default_rng(5))
    plan = dt.build_wplan(csr)
    plan.stats["pack_seconds"] = time.perf_counter() - t2
    log(f"[bench] huge_columns {csr.n_rows}x{csr.n_cols} nnz={csr.nnz}: "
        f"generated and packed in {plan.stats['pack_seconds']:.2f} s; "
        f"s_rows={plan.s_rows}")
    arms.append(("huge_columns", csr, plan, ("f32", "f64")))
    zero_counts()
    bench_arms = bench_phase(dev, arms, card)
    bench_launches = read_counts()
    log(f"[bench] kernel launches in this phase: {bench_launches}")
    if not all(bench_launches.values()):
        raise AssertionError(f"a kernel of the bench's path never ran: "
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
    del arms, bench_arms
    log(f"[bench] done in {time.perf_counter() - t:.2f} s")

    # -- 8. the examples ---------------------------------------------------------
    t = time.perf_counter()
    zero_counts()
    examples_phase(dev, card)
    ex_launches = read_counts()
    log(f"[examples] kernel launches in this phase: {ex_launches}")
    if not all(ex_launches[k] for k in ("colsum", "colsum_f64", "outgather",
                                        "outgather_f64")):
        raise AssertionError(f"a kernel of the examples' path never ran: "
                             f"{ex_launches}")
    log(f"[examples] done in {time.perf_counter() - t:.2f} s")

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
