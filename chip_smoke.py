"""Smoke run of the PyTorch port (dasp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more printed lines each, every one raising on failure:
  1. device: needs torch.cuda; prints the card's name and power limit,
     and the device-memory copy rate (the roofline for the kernels);
  2. build: compiles the CUDA kernels (colsum K1, outgather K2) from
     dasp_tpu_torch/csrc with nvcc into dasp_tpu_torch/_build, and the
     packer's native host library (native/, make);
  3. kernels vs plain on the card, on the fixture every row family passes
     through (mixed_categories(2048), as __graft_entry__.entry() packs it);
  4. the f32 SpMV end to end at published SuiteSparse sizes (cop20k_like,
     webbase_like from bench/suite.py): SpMVOperator on the card against
     the f64 CSR golden, scaled by the backward-error mass max(|A||x|, 1);
     the kernel launch counts of this phase must be non-zero; K1 and K2
     against their plain versions at these shapes;
  5. timing with CUDA events (median of trials of a chained loop in which
     every step adds y[0]*1e-36 into x), each step issued eagerly and as
     a CUDA-graph replay: the kernel path, the same path with the plain
     versions, cuSPARSE (torch.sparse_csr_tensor @ x, first held to the
     golden), and K1 and K2 alone beside their plain versions; plus a
     torch.profiler breakdown of the kernel path's device time.
It then prints the kernels' JSON line and, last, the device JSON line.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# K1/K2 against their plain versions: both multiply the same f32 words and
# sum in the same order, so they should agree exactly; the limit allows
# for reordering by the compiler
KERNEL_TOL = 1e-6
E2E_TOL = 2e-6          # __graft_entry__.py:63-77 (mass-scaled, f32)
TRIALS = 5


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
    """Median over TRIALS of the per-step device time of ``iters`` steps,
    between two CUDA events, after one warm-up step."""
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


def profile_line(step, iters):
    """Device time per step by kernel (torch.profiler) and the device's
    busy share of the wall time of ``iters`` eager steps."""
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
            f"step (busy {busy / (wall / iters * 1e6):.1%}, under the "
            f"profiler); top: " + "; ".join(
                f"{k[:60]} {v:.1f} us" for k, v in top))


def compare_kernels(op, x2d):
    """K1 per stream and K2 on the resulting y2 against their plain
    versions on the same card tensors; returns the worst (scaled, abs)
    errors of each."""
    from dasp_tpu_torch.ops import cuda_backend as cb
    from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
    meta, arrays = op._meta, op._arrays
    k1 = [0.0, 0.0]
    partials = []
    for (_, stride, _), st in zip(meta.streams, arrays["streams"]):
        args = (st["wins"], st["vals"], st["idx"], x2d, stride)
        got, ref = colsum(*args), colsum_plain(*args)
        k1 = [max(u, v) for u, v in zip(k1, scaled_err(got, ref))]
        partials.append(got)
    y2, _ = cb.stack_y2(meta, arrays, partials, x2d)
    got = outgather(arrays["out_src"], arrays["out_perm"], y2,
                    meta.n_y2_rows)
    ref = outgather_plain(arrays["out_src"], arrays["out_perm"], y2)
    k2 = list(scaled_err(got, ref))
    if not (k1[0] <= KERNEL_TOL and k2[0] <= KERNEL_TOL):
        raise AssertionError(f"kernel vs plain: K1 {k1} K2 {k2} "
                             f"(limit {KERNEL_TOL} scaled)")
    return k1, k2, y2


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
    from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
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
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t:.2f} s -> "
        f"{os.path.relpath(_build.build(), here)}")
    # the host library (Matrix Market parser, window router) that the
    # packer loads from native/.  Built here with g++ named explicitly:
    # an exported CXX without OpenMP support fails the Makefile's build,
    # and the packer's no-library fallback cannot pack long rows (see
    # ROADMAP.md, faults)
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
    t = time.perf_counter()
    csr = mixed_categories(2048, np.random.default_rng(7))
    op = dt.SpMVOperator(csr, dtype="f32", device=dev)
    x2d = op._prep_x(np.random.default_rng(3).standard_normal(csr.n_cols))
    k1, k2, _ = compare_kernels(op, x2d)
    log(f"[kernels] entry fixture {csr.n_rows}x{csr.n_cols} nnz={csr.nnz} "
        f"streams={list(op._meta.streams)} k_used={op._meta.k_used}: "
        f"K1 err {k1[0]:.3e} scaled ({k1[1]:.3e} abs), K2 err {k2[0]:.3e} "
        f"scaled ({k2[1]:.3e} abs), limit {KERNEL_TOL}; "
        f"{time.perf_counter() - t:.2f} s")
    err = {"colsum": k1[1], "outgather": k2[1]}

    # -- 4. the slice end to end at real size --------------------------------
    t = time.perf_counter()
    suite = build_suite(["cop20k_like", "webbase_like"], seed=0)
    log(f"[suite] generated {[(n, m.nnz) for n, m in suite]} in "
        f"{time.perf_counter() - t:.2f} s")
    router = "native" if wplan._native_router() else "python"
    if router != "native":
        raise RuntimeError("the packer did not load native/libdasp_host.so")
    ops, xs, goldens, scales = {}, {}, {}, {}
    colsum.launches = outgather.launches = 0
    for name, csr in suite:
        t = time.perf_counter()
        op = dt.SpMVOperator(csr, dtype="f32", device=dev)
        pre = time.perf_counter() - t
        x = np.random.default_rng(1).standard_normal(csr.n_cols)
        t = time.perf_counter()
        y = op(x)
        run = time.perf_counter() - t
        golden = csr.spmv(x)
        mass = CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                         np.abs(csr.values)).spmv(np.abs(x))
        scale = np.maximum(mass, 1.0)
        if not np.isfinite(y).all() or y.shape != (csr.n_rows,):
            raise AssertionError(f"{name}: y not finite / wrong shape")
        e2e = float((np.abs(y.astype(np.float64) - golden) / scale).max())
        np.testing.assert_allclose(y / scale, golden / scale,
                                   rtol=E2E_TOL, atol=E2E_TOL)
        m = op._meta
        log(f"[e2e] {name} {csr.n_rows}x{csr.n_cols} nnz={csr.nnz}: "
            f"err {e2e:.3e} (mass-scaled, limit {E2E_TOL}); pack+lower+upload "
            f"{pre:.2f} s (router {router}, relabel "
            f"{'on' if op.plan.col_perm is not None else 'off'}, row_sort "
            f"{'on' if op.plan.row_perm is not None else 'off'}); first call "
            f"{run:.3f} s; streams={list(m.streams)} k_used={m.k_used} "
            f"B_pad={m.B_pad} n_long={m.n_long} residue={m.overflow_meta} "
            f"sub_plan={m.res is not None}")
        ops[name], xs[name] = op, x
        goldens[name], scales[name] = golden, scale
    launches = {"colsum": colsum.launches, "outgather": outgather.launches}
    log(f"[e2e] kernel launches in this phase: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    for name, op in ops.items():
        t = time.perf_counter()
        k1, k2, _ = compare_kernels(op, op._prep_x(xs[name]))
        err = {"colsum": max(err["colsum"], k1[1]),
               "outgather": max(err["outgather"], k2[1])}
        log(f"[kernels] {name}: K1 err {k1[0]:.3e} scaled ({k1[1]:.3e} abs), "
            f"K2 err {k2[0]:.3e} scaled ({k2[1]:.3e} abs), limit "
            f"{KERNEL_TOL}; {time.perf_counter() - t:.2f} s")

    # -- 5. timing -----------------------------------------------------------
    # "eager": each step issued from Python as the operator runs it;
    # "graph": the same step captured once in a CUDA graph and replayed,
    # which removes the host's launch cost and leaves the device time
    alone = {}
    for name, op in ops.items():
        t = time.perf_counter()
        csr = dict(suite)[name]
        meta, arrays = op._meta, op._arrays
        steps = {}
        for label, plain in (("kernel", False), ("plain", True)):
            x2d = op._prep_x(xs[name])

            def step(x2d=x2d, plain=plain):
                y = cb.spmv_fn(meta, arrays, x2d, plain)
                x2d.add_(y[0] * 1e-36)
            steps[label] = step
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.row_ptr.astype(np.int64)),
            torch.from_numpy(csr.col_idx.astype(np.int64)),
            torch.from_numpy(csr.values.astype(np.float32)),
            size=(csr.n_rows, csr.n_cols), check_invariants=False).to(dev)
        xv = torch.from_numpy(xs[name].astype(np.float32)).to(dev)
        # the suite's rows may repeat a column (the generators clip and
        # draw with replacement), which torch's CSR invariants reject; the
        # product sums such entries, as the golden does: held to it here
        yc = (A @ xv).double().cpu().numpy()
        np.testing.assert_allclose(yc / scales[name], goldens[name]
                                   / scales[name], rtol=E2E_TOL, atol=E2E_TOL)

        def step_cusparse():
            y = A @ xv
            xv.add_(y[0] * 1e-36)
        steps["cusparse"] = step_cusparse
        row = {}
        for label, step in steps.items():
            row[f"{label} eager"] = time_ms(step, 100)
            row[f"{label} graph"] = time_ms(graphed(step), 100)
        log(f"[time] {name} nnz={csr.nnz} per SpMV: " + ", ".join(
            f"{k} {v * 1e3:.1f} us ({2 * csr.nnz / (v * 1e6):.2f} GFLOP/s)"
            for k, v in row.items()) + f" [{card}]; "
            f"{time.perf_counter() - t:.2f} s")
        log(f"[profile] {name} kernel path, eager: "
            + profile_line(steps["kernel"], 20))

        # K1 and K2 alone at this matrix's shapes (one SpMV's worth: every
        # stream's colsum; the outgather on its y2)
        x2d = op._prep_x(xs[name])
        _, _, y2 = compare_kernels(op, x2d)
        cs_args = [(st["wins"], st["vals"], st["idx"], x2d, s)
                   for (_, s, _), st in zip(meta.streams, arrays["streams"])]
        og = (arrays["out_src"], arrays["out_perm"], y2)
        pairs = {
            "colsum": (lambda: [colsum(*a) for a in cs_args],
                       lambda: [colsum_plain(*a) for a in cs_args]),
            "outgather": (lambda: outgather(*og, meta.n_y2_rows),
                          lambda: outgather_plain(*og)),
        }
        # bytes each kernel must move, computed from the shapes (K1: the
        # streamed tables and its output, not the x gathers, which hit
        # L2; K2: its tables, y2 once and its output)
        nbytes = {
            "colsum": sum(t.numel() * t.element_size()
                          for st in arrays["streams"] for t in st.values())
            + sum(nv * (8 // s) * 128 * 4 for _, s, nv in meta.streams),
            "outgather": sum(t.numel() * t.element_size() for t in og)
            + meta.B_pad * 128 * 4,
        }
        for k, (kern, plain) in pairs.items():
            got = [time_ms(graphed(f), 100) for f in (kern, plain)]
            gbs = nbytes[k] / (got[0] * 1e6)
            log(f"[time] {k} alone at {name} shapes (graph replay): kernel "
                f"{got[0] * 1e3:.1f} us, plain {got[1] * 1e3:.1f} us; eager: "
                f"kernel {time_ms(kern, 100) * 1e3:.1f} us; kernel moves "
                f"{nbytes[k] / 1e6:.2f} MB (computed) = {gbs:.0f} GB/s, "
                f"{gbs / copy_gbs:.1%} of the copy rate [{card}]")
            if name == "cop20k_like":
                alone[k] = got

    replaces = {"colsum": "dasp_tpu/ops/pallas_backend.py:121",
                "outgather": "dasp_tpu/ops/pallas_backend.py:437"}
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"dasp_tpu_torch/csrc/{k}.cu", "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": err[k],
         "ms": alone[k][0], "plain_ms": alone[k][1]}
        for k in ("colsum", "outgather")]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
