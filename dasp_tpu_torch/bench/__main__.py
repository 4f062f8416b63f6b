"""Benchmark CLI of the PyTorch port, on one CUDA card.

    python -m dasp_tpu_torch.bench [--quick] [--names a,b] [--dtypes f32,f64]

Runs the packed SpMV and SpMM on the benchmark suite (or on ``--mtx``
files) against cuSPARSE (``torch.sparse_csr_tensor``, the role it plays in
``main_f64.cu:19-100``), with the timing protocol of ``bench/harness.py``.
It is the port of the JAX package's ``bench.py``, which remains the TPU's
entry point.

Every (matrix, dtype) arm is CHECKED before it is timed: the streamed y,
the resident loop's y and every ``matmat`` column against the f64 CSR
golden on the error scaled by max(|A||x|, 1) (``bench/check.py``), the
resident y against the streamed y, and the baseline's y against the golden
too.  An arm that fails is named on a line of its own, writes no row, and
makes the process exit non-zero at the end.  Nothing else is caught: a
kernel that does not build or launch, or a missing card, raises.

An arm that passes writes two rows to ``<csv-dir>/spmv_<dtype>_record.csv``
(``variant`` "resident": the default operator, whose chained loop is one
launch of the resident executor; "streamed": ``force_streamed=True``) and
one to ``<csv-dir>/spmm_<dtype>_record.csv`` (``variant`` "spmm<cols>",
``dasp_time`` per column), all with the reference's schema
(``bench/record.py:FIELDS``) and the live baseline's columns.

Prints a summary JSON line
  {"metric": "spmv_gflops_geomean", "value": <geomean GFLOP/s of the
   default operator over the arms done>, "unit": "GFLOP/s",
   "vs_baseline": <geomean speedup of f32 over cuSPARSE f32>,
   "arms_done": n, "arms_total": N}
after every arm, and again from a SIGTERM/SIGALRM/SIGINT handler, so a
kill still leaves a record of everything measured so far.  Arm ordering is
dtype-major, cheapest nnz first; the last dtype runs most expensive first.

``--multichip [--chips N]`` times the row-partitioned ``MultiChipSpMV``
(``dasp_tpu_torch/parallel.py``) instead, N chips dealt round-robin over
the cards: each arm's y and chained loop are checked the same way, a
``#`` line gives GFLOP/s, us per SpMV, balance, pad vregs and resident,
the summary's metric is "spmv_multichip_geomean", and no CSV row is
written.  With fewer than 2 chips it prints the summary with
``"skipped": true`` and exits 0.  Chips on several cards are timed under
the host's clock (``harness._runner``); chips sharing one card as one
CUDA graph.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check
from .baselines import CuSparseBaseline
from .harness import (TRIALS, BenchResult, bench_spmm, bench_spmv,
                      copy_rate_gbs)
from .record import append_record, record_from
from .suite import build_suite, geomean
from ..config import DEFAULT_CONFIG, DaspConfig
from ..io import load_matrix
from ..ops import kernel_launches
from ..ops.cuda_backend import _to_host
from ..spmv import SpMVOperator
from ..wplan import WPlan, build_wplan, load_wplan, save_wplan

# bump when the WPlan on-disk format or packer semantics change (carried
# over from bench.py, whose packer the port's copy is)
PLAN_CACHE_VER = 8
# chained steps of the resident loop whose y is checked
CHECK_CHAIN = 10
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PLAN_CACHE_DIR = os.path.join(_ROOT, ".plan_cache")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Summary:
    """Running suite summary, printed after every arm and from the signal
    handlers."""

    def __init__(self, total: int = 0,
                 metric: str = "spmv_gflops_geomean"):
        self.metric = metric
        self.gflops: List[float] = []
        self.ratios: List[float] = []
        self.done = 0
        self.total = total
        self.failed: List[str] = []

    def add(self, name: str, dtype: str, arm: "ArmResult"):
        """Count one finished arm; returns the default operator's result
        (None when the arm wrote no row)."""
        self.done += 1
        if not arm.ok:
            self.failed.append(f"{name} {dtype}")
        res = arm.results.get("resident", arm.results.get("streamed"))
        if res is not None:
            self.gflops.append(res.gflops)
            base = arm.results.get("baseline")
            if dtype == "f32" and base is not None:
                self.ratios.append(res.gflops / base.gflops)
        return res

    def line(self) -> str:
        return json.dumps({
            "metric": self.metric,
            "value": round(geomean(self.gflops), 3),
            "unit": "GFLOP/s",
            "vs_baseline": round(geomean(self.ratios), 3)
            if self.ratios else 0.0,
            "arms_done": self.done, "arms_total": self.total})

    def emit(self) -> None:
        if self.gflops:
            print(self.line(), flush=True)


def install_handlers(summary: Summary, deadline: float):
    """Print the summary and exit 0 on SIGTERM, SIGINT and, after
    ``deadline`` seconds (0: never), SIGALRM.  Returns a callable that
    puts the previous handlers back."""
    def die(signum, frame):
        summary.emit()
        sys.stdout.flush()
        os._exit(0)

    sigs = [signal.SIGTERM, signal.SIGINT]
    if deadline > 0:
        sigs.append(signal.SIGALRM)
    old = {sig: signal.signal(sig, die) for sig in sigs}
    if deadline > 0:
        signal.alarm(int(deadline))

    def restore():
        if deadline > 0:
            signal.alarm(0)
        for sig, handler in old.items():
            signal.signal(sig, handler)
    return restore


def build_native_router() -> None:
    """Build the packer's native host library (``native/``: the Matrix
    Market parser and the window router) with g++ named explicitly: an
    exported CXX without OpenMP support fails the Makefile's own build,
    and the numpy fallback packs the large arms far slower."""
    mk = subprocess.run(["make", "-C", os.path.join(_ROOT, "native"),
                         "CXX=g++"], capture_output=True, text=True,
                        timeout=600)
    if mk.returncode != 0:
        raise RuntimeError(f"native host library build failed:\n"
                           f"{mk.stdout}{mk.stderr}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()


def plan_streams(plan: WPlan) -> str:
    """The plan's streams as (P, stride, vregs), a residue sub-plan's
    (built by the first lowering) after a "+"."""
    own = [(s.P, s.stride, s.n_vregs) for s in plan.streams]
    sub = getattr(plan, "_res_plan", None)
    return f"{own}" + (f" + residue {plan_streams(sub)}" if sub else "")


def get_plan(name: str, csr, config: DaspConfig, cache: bool) -> WPlan:
    """The pack plan of one matrix: dtype-independent, so built ONCE and
    shared by the dtype arms.  With ``cache`` (the suite's arms, which are
    deterministic) it is kept on disk under the gitignored ``.plan_cache/``,
    so that a later call for a subset of the arms does not repack.
    ``plan.stats["pack_seconds"]`` is the time measured when the plan was
    built; the SpMV timing never touches the cache."""
    path = None
    if cache:
        ch = zlib.crc32(json.dumps(dataclasses.asdict(config),
                                   sort_keys=True, default=str).encode())
        path = os.path.join(PLAN_CACHE_DIR, f"{name}_{csr.nnz}_{ch:08x}"
                                            f"_v{PLAN_CACHE_VER}.npz")
        if os.path.exists(path):
            log(f"# {name}: plan cache hit")
            return load_wplan(path)
    t0 = time.perf_counter()
    plan = build_wplan(csr, config)
    plan.stats["pack_seconds"] = time.perf_counter() - t0
    if path:
        os.makedirs(PLAN_CACHE_DIR, exist_ok=True)
        save_wplan(plan, path)
    return plan


class ArmInputs:
    """One matrix's benchmark inputs, shared by its dtype arms: x, the
    ``cols`` columns of X, and their goldens (computed once for f32 and
    f64, once for bf16's rounded A and x)."""

    def __init__(self, csr, cols: int):
        self.csr = csr
        self.x = np.random.default_rng(1).standard_normal(csr.n_cols)
        self.X = np.random.default_rng(2).standard_normal((csr.n_cols, cols))
        self._goldens: Dict[bool, tuple] = {}

    def goldens(self, dtype: str):
        """((golden, scale) of x, [(golden, scale) of each column of X])."""
        key = dtype == "bf16"
        if key not in self._goldens:
            self._goldens[key] = (
                check.golden_mass(self.csr, self.x, dtype),
                [check.golden_mass(self.csr, self.X[:, j], dtype)
                 for j in range(self.X.shape[1])])
        return self._goldens[key]


@dataclasses.dataclass
class ArmResult:
    """What ``run_arm`` found: each check's error, the names of those over
    their limit, and the timings (empty when a check of the port failed)
    by "resident", "streamed", "spmm", "baseline" and "spmm_baseline"."""
    errors: Dict[str, float]
    failures: List[str]
    results: Dict[str, BenchResult]
    baseline_dtype: str

    @property
    def ok(self) -> bool:
        return not self.failures


def _profile(op, x, path: str) -> None:
    """One run of the operator's chained loop of 8 under torch.profiler,
    its trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    loop, x_dev = op.timing_loop(8), op._prep_x(x)
    loop(x_dev)
    acts = [ProfilerActivity.CPU]
    if op.device.type == "cuda":
        torch.cuda.synchronize(op.device)
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        loop(x_dev)
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


def _failures(name: str, dtype: str, errors: Dict[str, float],
              limits: Dict[str, float]) -> List[str]:
    """The checks over their limit, each named on a ``# FAILED`` line."""
    failures = [k for k, e in errors.items() if not e <= limits[k]]
    for k in failures:
        print(f"# FAILED {name} {dtype} {k}: error {errors[k]:.3e} over the "
              f"limit {limits[k]:g} (scaled by max(|A||x|, 1))", flush=True)
    return failures


def run_arm(name: str, inputs: ArmInputs, plan: WPlan, dtype: str,
            csv_dir: str, *, device="cuda", iters: int = 100,
            trials: int = TRIALS,
            profile_dir: Optional[str] = None) -> ArmResult:
    """Check, time and record one (matrix, dtype) arm; see the module
    docstring.  Both operators come from ``plan``."""
    csr, x, X = inputs.csr, inputs.x, inputs.X
    tol = check.E2E_TOL
    (golden, scale), col_goldens = inputs.goldens(dtype)
    pack = float(plan.stats.get("pack_seconds", 0.0))
    rop = SpMVOperator(plan, dtype=dtype, device=device)
    sop = SpMVOperator(plan, dtype=dtype, device=device, force_streamed=True)
    for op in (rop, sop):
        # dasp_pre keeps the reference's semantics: the full pack plus
        # this operator's setup, as if the arm ran standalone
        op.preprocess_seconds += pack
    errors: Dict[str, float] = {}
    limits: Dict[str, float] = {}

    def held(what: str, y, g, s, limit: float) -> None:
        errors[what], limits[what] = check.scaled_error(y, g, s), limit

    y_s = sop(x)
    held("streamed", y_s, golden, scale, tol[dtype])
    y_r = rop.perm_out(_to_host(rop.timing_loop(CHECK_CHAIN)(rop._prep_x(x))))
    held("loop", y_r, golden, scale, tol[dtype])
    held("loop vs streamed", y_r, y_s.astype(np.float64), scale, tol[dtype])
    Y = rop.matmat(X)
    if Y.shape != (csr.n_rows, X.shape[1]):
        errors["matmat"], limits["matmat"] = float("inf"), tol[dtype]
    else:
        for j, (g, s) in enumerate(col_goldens):
            held(f"matmat column {j}", Y[:, j], g, s, tol[dtype])

    base = CuSparseBaseline(csr, dtype, device)
    bdt = base.compute_dtype
    (b_golden, b_scale), b_cols = inputs.goldens(bdt)
    held("baseline", base(x), b_golden, b_scale, tol[bdt])
    Yb = base.matmat(X)
    for j, (g, s) in enumerate(b_cols):
        held(f"baseline matmat column {j}", Yb[:, j], g, s, tol[bdt])

    failures = _failures(name, dtype, errors, limits)
    results: Dict[str, BenchResult] = {}
    if any(not k.startswith("baseline") for k in failures):
        return ArmResult(errors, failures, results, bdt)

    if profile_dir:
        _profile(rop, x, os.path.join(profile_dir, f"{name}_{dtype}.json"))
    if not any(k.startswith("baseline") for k in failures):
        results["baseline"] = bench_spmv(base, x, bdt, iters=iters,
                                         trials=trials)
        results["spmm_baseline"] = bench_spmm(base, X, bdt, trials=trials)
    variants = (("resident", rop), ("streamed", sop)) if rop.resident else (
        ("streamed", sop),)
    for variant, op in variants:
        results[variant] = bench_spmv(op, x, dtype, iters=iters,
                                      trials=trials)
        append_record(
            os.path.join(csv_dir, f"spmv_{dtype}_record.csv"),
            record_from(plan, results[variant], name, dtype,
                        results.get("baseline"), variant=variant,
                        baseline_dtype=bdt))
    results["spmm"] = bench_spmm(rop, X, dtype, trials=trials)
    append_record(
        os.path.join(csv_dir, f"spmm_{dtype}_record.csv"),
        record_from(plan, results["spmm"], name, dtype,
                    results.get("spmm_baseline"),
                    variant=f"spmm{X.shape[1]}", baseline_dtype=bdt))
    return ArmResult(errors, failures, results, bdt)


def multichip_devices(device: torch.device,
                      chips: Optional[int]) -> List[torch.device]:
    """``--chips`` chips dealt round-robin over the cards, several chips
    to a card where there are more chips than cards (the analog of the
    reference's simulated host devices); on the CPU all on it.  Default:
    one chip per card, and one on the CPU."""
    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if device.type == "cuda" else [device])
    n = len(cards) if chips is None else chips
    return [cards[i % len(cards)] for i in range(n)]


def run_multichip_arm(name: str, inputs: ArmInputs, dtype: str, devices,
                      config: DaspConfig, *, iters: int = 100,
                      trials: int = TRIALS):
    """Check and time one (matrix, dtype) arm of ``--multichip``
    (bench.py:195-225): ``MultiChipSpMV``'s y and its chained loop's y
    against the f64 CSR golden and each other (``check.E2E_TOL``), then
    its timing loop through ``bench_spmv``, the result under "resident"
    or "streamed" as the operator runs.  An arm that fails a check is not
    timed.  Returns (the arm, the operator)."""
    from ..parallel import MultiChipSpMV
    tol = check.E2E_TOL[dtype]
    (golden, scale), _ = inputs.goldens(dtype)
    op = MultiChipSpMV(inputs.csr, devices=devices, dtype=dtype,
                       config=config)
    y = op(inputs.x)
    y_loop = op.stitch(op.timing_loop(CHECK_CHAIN)(op._prep_x(inputs.x)))
    errors = {"multichip": check.scaled_error(y, golden, scale),
              "loop": check.scaled_error(y_loop, golden, scale),
              "loop vs multichip": check.scaled_error(y_loop, y, scale)}
    failures = _failures(name, dtype, errors, dict.fromkeys(errors, tol))
    results: Dict[str, BenchResult] = {}
    if not failures:
        results["resident" if op.resident else "streamed"] = bench_spmv(
            op, inputs.x, dtype, iters=iters, trials=trials)
    return ArmResult(errors, failures, results, dtype), op


def run_multichip(args, suite, dtypes: List[str], config: DaspConfig,
                  devices, iters: int) -> Summary:
    """``--multichip``: every (matrix, dtype) arm through
    ``run_multichip_arm``, a ``#`` line each as the reference prints, and
    the summary line (``spmv_multichip_geomean``) after every arm.  No
    CSV row is written, as the reference writes none."""
    summary = Summary(len(suite) * len(dtypes), "spmv_multichip_geomean")
    restore = install_handlers(summary, args.deadline)
    try:
        for dtype in dtypes:
            for name, csr in suite:
                arm, op = run_multichip_arm(
                    name, ArmInputs(csr, 0), dtype, devices, config,
                    iters=iters)
                res, stats = summary.add(name, dtype, arm), op.stats
                if res is not None:
                    log(f"# {name} {dtype} x{len(devices)}: "
                        f"{res.gflops:.2f} GFLOP/s "
                        f"({res.seconds_per_iter * 1e6:.1f} us/iter, "
                        f"balance {stats['balance']:.2f}, pad "
                        f"{sum(stats['pad_vregs'])}/"
                        f"{sum(stats['real_vregs'])} vregs, resident "
                        f"{stats['resident']}); worst error "
                        f"{max(arm.errors.values()):.2e}")
                summary.emit()
    finally:
        restore()
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dasp_tpu_torch.bench")
    ap.add_argument("--quick", action="store_true",
                    help="small suite + few iters (smoke test)")
    ap.add_argument("--dtypes", default="f32,bf16,f64")
    ap.add_argument("--iters", type=int, default=None,
                    help="chained SpMVs a timed loop starts from (it is "
                         "lengthened until one replay lasts 2 ms)")
    ap.add_argument("--names", default=None,
                    help="comma-separated suite subset")
    ap.add_argument("--csv-dir", default="data/h100")
    ap.add_argument("--deadline", type=float,
                    default=float(os.environ.get("DASP_BENCH_DEADLINE",
                                                 3600)),
                    help="self-imposed wall budget (s); the summary is "
                         "printed and the process exits 0 when it fires "
                         "(0 disables)")
    # The reference's tunables were argv[2]/argv[3] before being hardcoded
    # (main_f64.cu:121-125); expose them so they can be swept.
    ap.add_argument("--block-longest", type=int, default=None,
                    help="long-row threshold (reference default 256)")
    ap.add_argument("--threshold", type=float, default=None,
                    help="SELL occupancy target (reference default 0.75)")
    ap.add_argument("--relabel", default=None,
                    choices=["auto", "off", "first_touch"],
                    help="column relabel policy override")
    ap.add_argument("--row-sort", default=None,
                    choices=["auto", "off", "on"],
                    help="row length-grouping policy override")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of one run of "
                         "each arm's chained loop into DIR (the reference "
                         "ships -lineinfo for nsight, Makefile:10)")
    ap.add_argument("--mtx", nargs="*", default=None,
                    help="benchmark these .mtx files instead of the suite")
    ap.add_argument("--device", default="cuda",
                    help="where the arms run (the tests pass cpu)")
    ap.add_argument("--spmm-cols", type=int, default=8,
                    help="columns of the SpMM record's X")
    ap.add_argument("--multichip", action="store_true",
                    help="time the row-partitioned MultiChipSpMV instead "
                         "(checked, no CSV row)")
    ap.add_argument("--chips", type=int, default=None,
                    help="--multichip's chips, dealt round-robin over the "
                         "cards (default: one per card; 1 on the CPU)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                               "False (pass --device cpu to run the plain "
                               "versions on the host)")
        card = card_line()
        print(card, flush=True)
        log(f"# device: {torch.cuda.get_device_name(device)}, torch "
            f"{torch.__version__}, cuda {torch.version.cuda}; copy rate "
            f"{copy_rate_gbs(device):.0f} GB/s (read + write, 1 GiB)")
        build_native_router()
    else:
        print(f"{device.type} (torch {torch.__version__})", flush=True)

    overrides = {k: v for k, v in [
        ("block_longest", args.block_longest),
        ("threshold", args.threshold),
        ("relabel", args.relabel),
        ("row_sort", args.row_sort)] if v is not None}
    config = dataclasses.replace(DEFAULT_CONFIG, **overrides)
    iters = args.iters if args.iters is not None else (50 if args.quick
                                                       else 100)
    dtypes = args.dtypes.split(",")

    if args.mtx:
        suite = [(os.path.basename(p), load_matrix(p)) for p in args.mtx]
    else:
        names = args.names.split(",") if args.names else None
        if args.quick and not names:
            names = ["cop20k_like", "wikitalk_like"]
        suite = build_suite(names)
    # Cheapest arms first: a wall-budget kill then costs the least data.
    suite.sort(key=lambda t: t[1].nnz)

    if args.multichip:
        devices = multichip_devices(device, args.chips)
        if len(devices) < 2:
            log(f"# --multichip: {len(devices)} chip, skipping (pass "
                "--chips N with N >= 2; chips may share a card)")
            print(json.dumps({"metric": "spmv_multichip_geomean",
                              "value": 0.0, "unit": "GFLOP/s",
                              "vs_baseline": 0.0, "skipped": True}),
                  flush=True)
            return 0
        return _finish(run_multichip(args, suite, dtypes, config, devices,
                                     iters))

    summary = Summary(len(suite) * len(dtypes))
    restore = install_handlers(summary, args.deadline)
    try:
        inputs = {name: ArmInputs(csr, args.spmm_cols)
                  for name, csr in suite}
        plans: Dict[str, WPlan] = {}      # kept in host memory
        for dtype in dtypes:
            ordered = (suite if dtype != dtypes[-1]
                       else sorted(suite, key=lambda t: -t[1].nnz))
            for name, csr in ordered:
                if name not in plans:
                    plans[name] = get_plan(name, csr, config,
                                           cache=not args.mtx)
                plan = plans[name]
                t0 = time.perf_counter()
                arm = run_arm(name, inputs[name], plan, dtype, args.csv_dir,
                              device=device, iters=iters,
                              profile_dir=args.profile)
                res = summary.add(name, dtype, arm)
                if res is None:
                    summary.emit()
                    continue
                us = {k: r.seconds_per_iter * 1e6
                      for k, r in arm.results.items()}
                log(f"# {name} {dtype}: {res.gflops:.2f} GFLOP/s; us per "
                    f"SpMV " + ", ".join(
                        f"{k} {us[k]:.1f}" for k in
                        ("resident", "streamed", "baseline") if k in us)
                    + "; us per SpMM column " + ", ".join(
                        f"{k} {us[k]:.1f}" for k in
                        ("spmm", "spmm_baseline") if k in us)
                    + f" (baseline in {arm.baseline_dtype}); worst error "
                    f"{max(arm.errors.values()):.2e}; streams (P, stride, "
                    f"vregs) {plan_streams(plan)}; pack "
                    f"{plan.stats.get('pack_seconds', 0.0):.1f} s, arm "
                    f"{time.perf_counter() - t0:.1f} s")
                summary.emit()
    finally:
        restore()
    return _finish(summary)


def _finish(summary: Summary) -> int:
    """The run's launch counts, and exit code 1 if an arm failed."""
    log(f"# kernel launches of this run: {kernel_launches()}")
    if summary.failed:
        print(f"# {len(summary.failed)} arm(s) failed a check: "
              + ", ".join(summary.failed), flush=True)
        summary.emit()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
