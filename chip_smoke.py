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
     every kernel instance (K1 f32 and bf16, K3, K2, K4, K5 at kv=4 with
     f32, bf16 and f64 values) against its plain version on the same
     tensors, each K5 slice against K1 / K3 on its own x, and K6 in f32,
     bf16 and f64 at 1 and 3 steps, all bit for bit;
  4. the SpMV end to end at published SuiteSparse sizes (cop20k_like,
     webbase_like from bench/suite.py), one pack per matrix serving all
     dtypes: SpMVOperator on the card in f32, f64 and bf16, and matmat
     with 8 columns in f32, bf16 and f64, on operators built with
     force_streamed=True (the streamed path), and the resident
     timing loop (K6, a chain of 10) of a default operator, each against
     the f64 CSR golden (for bf16 that of the bf16-rounded A and x),
     scaled by the backward-error mass max(|A||x|, 1), and the resident y
     against the streamed y; every kernel instance's launch count over
     this phase must be non-zero; then every instance against its plain
     version at these shapes;
  5. timing with CUDA events (median of trials), each step issued eagerly
     and as a CUDA-graph replay: chained SpMV loops (TorchSpMV.timing_loop
     on the streamed operators: every step adds y[0]*1e-36 into x) in f32,
     f64 and bf16 on the kernel path, the same path with the plain
     versions, and cuSPARSE (torch.sparse_csr_tensor @ x, first held to
     the golden; f32 and f64); K6 at chains of 10 and 100 beside them,
     and alone with the bytes a step moves; matmat at 8 columns (two K5
     passes of 4) against 8 single SpMVs and cuSPARSE A @ X, in f32 and
     f64; every kernel instance alone beside its plain version, with the
     bytes it must move and its bound; a torch.profiler breakdown of the
     f32 and f64 streamed kernel paths; and the T4 sweep (the rate of a
     chained re-read of a 6-192 MB stream against the copy rate);
  6. the probes T1 (gather_bench: copy, shared-memory and L2 gathers),
     T2 (roundcost_ab: cur/flane/fboth at P = 1..32) and T3
     (stream_bench2: ladder A-F), at the tools' sizes: every variant
     against its plain version bit for bit, and the variants that compute
     K1's function against K1 on the card bit for bit; then each sweep,
     graph replays of the kernel alone and of the tools' chained step, at
     the tools' sizes and at 8x, with the bytes, the share of the copy
     rate and the bound, on the probes' own launch counts.
It then prints the kernels' JSON line and, last, the device JSON line.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# kernel vs plain version, on the error scaled by max(|plain|, 1): both
# multiply the same words and sum in the same order, so they should agree
# exactly; the limits allow for reordering by the compiler
KERNEL_TOL = {"f32": 1e-6, "bf16": 1e-6, "f64": 1e-12}
# end to end, on the error scaled by max(|A||x|, 1): f32 as
# __graft_entry__.py:63-77; f64 native fp64 sums of up to ~5k terms;
# bf16 against the golden of the bf16-rounded A and x, where y's own
# rounding is at most 2^-8 of |y| <= the mass and x stays f32 (within
# 2^-8 of the rounded x): at most 2^-7 = 7.8e-3 of the mass in all
E2E_TOL = {"f32": 2e-6, "f64": 1e-10, "bf16": 1e-2}
DTYPES = ("f32", "f64", "bf16")
TRIALS = 5
CHAIN = 10              # SpMVs per timed step (streamed: timing_loop(CHAIN
                        # - 1); resident: timing_loop(CHAIN))
LONG_CHAIN = 100        # the longer resident chain
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


def graphed(step):
    """Capture one call of ``step`` in a CUDA graph (after warm-up on a
    side stream, as torch.cuda.graphs asks) and return its replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    return g.replay


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
    import torch
    from dasp_tpu_torch.ops import cuda_backend as cb
    from dasp_tpu_torch.ops.colsum import colsum
    meta, arrays = op._meta, op._arrays
    cs = [(st["wins"], st["vals"], st["idx"], xs[0], s)
          for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    y2, _ = cb.stack_y2(meta, arrays, [colsum(*a) for a in cs], xs[0])
    x3d = torch.cat(xs)
    cm = [(st["wins"], st["vals"], st["idx"], x3d, s, len(xs))
          for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    return cs, (arrays["out_src"], arrays["out_perm"], y2), cm


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
    bad = {k: v for k, v in err.items() if not v[0] <= KERNEL_TOL[d]}
    if bad:
        raise AssertionError(f"kernel vs plain ({d}): {bad} "
                             f"(limit {KERNEL_TOL[d]} scaled)")
    return err


def kernel_bytes(op, cs, og, cm):
    """Bytes each kernel must move, computed from its shapes: the streamed
    tables and the output (the x gathers hit L2 and are not counted);
    K2/K4: its tables, y2 once and the output."""
    nb = lambda t: t.numel() * t.element_size()
    streams = sum(nb(a[0]) + nb(a[1]) + nb(a[2]) for a in cs)
    out_el = 8 if op.dtype == "f64" else 4
    rows = sum(a[1].shape[0] // a[4] for a in cs)
    kv = cm[0][5] if cm else 1
    return {
        "colsum": streams + rows * 128 * out_el,
        "outgather": sum(nb(t) for t in og) + op._meta.B_pad * 128 * out_el,
        "colsum_multi": streams + kv * rows * 128 * out_el,
    }


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` of the dtype's arithmetic, at the
    data sheet's peaks."""
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def resident_bytes(op):
    """(bytes one K6 step streams, bytes one K6 call must move).  A step
    reads every stream's wins, vals and idx and the outgather's src and
    perm, writes y2 and reads it back, and writes out.  A call reads each
    input once (those tables, the fold and incidence tables, x) and writes
    out once, whatever its number of steps."""
    nb = lambda t: t.numel() * t.element_size()
    meta, arrays = op._meta, op._arrays
    res = arrays["resident"]
    el = 8 if op.dtype == "f64" else 4
    tables = (sum(nb(st[k]) for st in arrays["streams"]
                  for k in ("wins", "vals", "idx"))
              + nb(res["src"]) + nb(arrays["out_perm"]))
    out = meta.B_pad * 128 * el
    step = tables + 2 * (meta.n_y2_rows + 1) * 128 * el + out
    call = (tables + sum(nb(res[k]) for k in ("fold", "inc_ptr", "inc_tot",
                                               "inc_mult", "desc"))
            + meta.s_rows * 128 * el + out)
    return step, call


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
    from dasp_tpu_torch.bench.suite import build_suite
    from dasp_tpu_torch.ops import _build, cuda_backend as cb
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.colsum_multi import colsum_multi, \
        colsum_multi_plain
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    from dasp_tpu_torch.ops.resident import resident_loop, \
        resident_loop_plain
    from dasp_tpu_torch.probes import gather_bench as t1, \
        roundcost_ab as t2, resident_probe as t4, stream_bench2 as t3
    from dasp_tpu_torch.sparse import CSRMatrix, mixed_categories

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    log(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()} torch "
        f"{torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    # device-memory copy rate: 1 GiB each way, 20x the 50 MB L2
    src = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_gbs = 2 * src.numel() * 4 / (time_ms(lambda: dst.copy_(src), 20)
                                      * 1e6)
    del src, dst
    log(f"[device] copy {copy_gbs:.0f} GB/s (read + write, 1 GiB)")

    # -- 2. build ------------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
        f"source, {len(_build.SIGNATURES)} entry points: "
        f"{time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(_build.build(), here)}")
    # the host library (Matrix Market parser, window router) that the
    # packer loads from native/.  Built here with g++ named explicitly:
    # an exported CXX without OpenMP support fails the Makefile's build,
    # and the numpy fallback packs the webbase_like arm far slower
    t = time.perf_counter()
    mk = subprocess.run(["make", "-C", os.path.join(here, "native"),
                         "CXX=g++"], capture_output=True, text=True,
                        timeout=600)
    if mk.returncode != 0:
        raise RuntimeError(f"native host library build failed:\n"
                           f"{mk.stdout}{mk.stderr}")
    log(f"[build] native host library (make CXX=g++): "
        f"{time.perf_counter() - t:.2f} s")

    # -- 3. kernels vs plain on the entry fixture ----------------------------
    err = {k: 0.0 for k in INSTANCES}

    def note(errs):
        for k, (_, a) in errs.items():
            err[k] = max(err[k], a)

    def rand_tables(op, seed):
        rng = np.random.default_rng(seed)
        return [op._prep_x(rng.standard_normal(op.n_cols))
                for _ in range(cb.KV_SPMM)]

    t = time.perf_counter()
    csr = mixed_categories(2048, np.random.default_rng(7))
    plan = dt.build_wplan(csr)
    for d in DTYPES:
        op = dt.SpMVOperator(plan, dtype=d, device=dev)
        errs = compare_kernels(op, rand_tables(op, 3))
        note(errs)
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
            + f", limit {KERNEL_TOL[d]}; K5 slices == K1/K3 bit for bit")
    log(f"[kernels] entry fixture done in {time.perf_counter() - t:.2f} s")

    # -- 4. the slice end to end at real size --------------------------------
    t = time.perf_counter()
    suite = build_suite(["cop20k_like", "webbase_like"], seed=0)
    log(f"[suite] generated {[(n, m.nnz) for n, m in suite]} in "
        f"{time.perf_counter() - t:.2f} s")
    router = "native" if wplan._native_router() else "python"
    if router != "native":
        raise RuntimeError("the packer did not load native/libdasp_host.so")

    def bf16_round(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).double().numpy()

    def golden_mass(csr, x, dtype):
        vals = bf16_round(csr.values) if dtype == "bf16" else csr.values
        x = bf16_round(x) if dtype == "bf16" else x
        g = CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                      vals).spmv(x)
        mass = CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                         np.abs(vals)).spmv(np.abs(x))
        return g, np.maximum(mass, 1.0)

    def check(name, what, y, golden, scale, dtype, shape):
        if y.shape != shape or not np.isfinite(y).all():
            raise AssertionError(f"{name} {what}: y {y.shape} not finite / "
                                 f"not of shape {shape}")
        e = float((np.abs(y.astype(np.float64) - golden) / scale).max())
        if not e <= E2E_TOL[dtype]:
            raise AssertionError(f"{name} {what}: error {e:.3e} over the "
                                 f"limit {E2E_TOL[dtype]} (mass-scaled)")
        return e

    def cusparse_matrix(csr, dtype):
        """(torch CSR matrix on the card for cuSPARSE, its value dtype).
        The suite's rows may repeat a column (the generators clip and draw
        with replacement), which torch's CSR invariants reject; the product
        sums such entries, as the golden does, and is held to it."""
        vdt = torch.float64 if dtype == "f64" else torch.float32
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.row_ptr.astype(np.int64)),
            torch.from_numpy(csr.col_idx.astype(np.int64)),
            torch.from_numpy(csr.values).to(vdt),
            size=(csr.n_rows, csr.n_cols),
            check_invariants=False).to(dev), vdt

    ops, rops, xs = {}, {}, {}
    counters = (("colsum", colsum), ("colsum_multi", colsum_multi),
                ("outgather", outgather), ("resident", resident_loop))
    for _, counter in counters:
        counter.launches = dict.fromkeys(counter.launches, 0)
    for name, csr in suite:
        t = time.perf_counter()
        plan = dt.build_wplan(csr)
        pack = time.perf_counter() - t
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
            Y = op.matmat(X)
            run = time.perf_counter() - t
            es = [check(name, f"{d} matmat column {j}", Y[:, j],
                        *golden_mass(csr, X[:, j], d), d, (csr.n_rows,))
                  for j in range(K_COLS)]
            log(f"[e2e] {name} {d} matmat {K_COLS} columns (kv "
                f"{cb.KV_SPMM}): worst column err {max(es):.3e} "
                f"(mass-scaled, limit {E2E_TOL[d]}); first call {run:.3f} s")
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
    launches = {}
    for base, counter in counters:
        for d, n in counter.launches.items():
            launches[inst(base, d)] = n
    log(f"[e2e] kernel launches in this phase: {launches}")
    if set(launches) != set(MAIN_PATH) or not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    for (name, d), op in ops.items():
        t = time.perf_counter()
        errs = compare_kernels(op, rand_tables(op, 5))
        note(errs)
        log(f"[kernels] {name} {d}: " + ", ".join(
            f"{k} {s:.3e} scaled ({a:.3e} abs)"
            for k, (s, a) in errs.items())
            + f", limit {KERNEL_TOL[d]}; {time.perf_counter() - t:.2f} s")
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
    alone = {}
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
                A, vdt = cusparse_matrix(csr, d)
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
                e, g = eager_and_graph(
                    lambda loop=rop.timing_loop(n), x2d=x2d: loop(x2d),
                    5 if n == CHAIN else 2)
                kr[n] = (e / n, g / n)
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
                f"replay); a step streams {step_b / 1e6:.2f} MB (computed) "
                f"= {gbs:.0f} GB/s, {gbs / copy_gbs:.1%} of the copy rate, "
                f"bound {step_b / copy_gbs / 1e3:.1f} us at the copy rate; "
                f"a chain-{CHAIN} call must move {call_b / 1e6:.2f} MB, "
                f"bound {bound(call_b, CHAIN * flops, d)[0] * 1e3:.1f} us at "
                f"{PEAK_BYTES / 1e12} TB/s [{card}]")
            if name == "cop20k_like":
                plain = time_ms(lambda r=rop, x2d=x2d: resident_loop_plain(
                    r._meta, r._arrays, x2d, CHAIN), 2)
                alone[inst("resident", d)] = (
                    kr[CHAIN][1] * CHAIN, plain,
                    *bound(call_b, CHAIN * flops, d),
                    lib * CHAIN if lib else None)

        # matmat at K_COLS columns: two K5 passes of KV_SPMM against
        # K_COLS single SpMVs and cuSPARSE A @ X, on the same X (no chain)
        rng = np.random.default_rng(2)
        X = rng.standard_normal((csr.n_cols, K_COLS))
        for d in ("f32", "f64"):
            op = ops[name, d]
            meta, arrays = op._meta, op._arrays
            tabs = [op._prep_x(X[:, j]) for j in range(K_COLS)]
            x3ds = [torch.cat(tabs[c:c + cb.KV_SPMM])
                    for c in range(0, K_COLS, cb.KV_SPMM)]
            A, vdt = cusparse_matrix(csr, d)
            Xd = torch.from_numpy(X).to(vdt).to(dev)
            Yc = (A @ Xd).cpu().numpy()
            for j in range(K_COLS):
                check(name, f"cuSPARSE {d} A @ X column {j}", Yc[:, j],
                      *golden_mass(csr, X[:, j], d), d, (csr.n_rows,))
            steps = {
                "matmat (K5)": lambda x3ds=x3ds, m=meta, a=arrays: [
                    cb.spmm_fn(m, a, x3, cb.KV_SPMM) for x3 in x3ds],
                f"{K_COLS} x SpMV": lambda tabs=tabs, m=meta, a=arrays: [
                    cb.spmv_fn(m, a, x2) for x2 in tabs],
                "cuSPARSE A @ X": lambda A=A, Xd=Xd: A @ Xd,
            }
            row = {k: eager_and_graph(s, 5) for k, s in steps.items()}
            log(f"[time] {name} {d} matmat {K_COLS} columns, per call: "
                + ", ".join(f"{k} eager {e * 1e3:.1f} us / graph "
                            f"{g * 1e3:.1f} us ({K_COLS * flops / (g * 1e6):.2f}"
                            f" GFLOP/s graphed)"
                            for k, (e, g) in row.items()) + f" [{card}]")

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
                got = [time_ms(graphed(f), 20 if f is kern else 5)
                       for f in (kern, plain)]
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
                    alone[k] = (*got, b_ms, b_by, None)
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
