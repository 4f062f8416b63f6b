"""Benchmark harness: the reference's measurement protocol on one CUDA card.

Timing mirrors ``dasp_f64.h:1285-1398`` as ``dasp_tpu/bench/harness.py``
does: chained iterations, fully synchronized, throughput = ``2*nnz/time``
GFLOP/s with padding FLOPs excluded (``dasp_f64.h:1395``), plus the two
bandwidth models (``dasp_f64.h:1162-1172``):
  * model 1: A values + column ids once, x and y once each;
  * model 2: same but x counted once per nonzero.

On a CUDA operator the chained loop (``op.timing_loop(n)``, on the
operator's own x table) is captured in a CUDA graph and a replay is timed
between two CUDA events, so the host's launch cost does not show.  Every
trial times a capture of its own: replays of one graph agree within 1-2 %,
but the same streamed loop captured again (its intermediates at other
addresses of the graph's pool) ran 10-16 % slower or faster on an NVIDIA
H100 80GB HBM3, so the median and the spread are taken over captures.  On
a CPU operator the same protocol runs the loop as it is under
``time.perf_counter``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..utils import graphed

# Reference protocol (dasp_f64.h:1285-1286); override for quick runs.
WARMUP = 100
ITERS = 1000
TRIALS = 5


@dataclasses.dataclass
class BenchResult:
    seconds_per_iter: float
    gflops: float
    bandwidth1_gbs: float
    bandwidth2_gbs: float
    preprocess_seconds: float = 0.0
    # relative max-min range of the per-trial timings (the CSV records it
    # as dasp_spread)
    spread: float = 0.0
    # iteration count the adaptive loop actually timed with
    timed_iters: int = 0
    # wall time up to the first timed replay: the kernels' build on their
    # first use plus every CUDA-graph capture of the adaptive loop (on a
    # CPU operator, the untimed first runs).  Split from the host pack
    # time so the CSV's dasp_pre stays pack + operator setup
    compile_seconds: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _val_bytes(dtype: str) -> int:
    return {"f32": 4, "bf16": 2, "f64": 8}[dtype]


def data_models(n_rows: int, n_cols: int, nnz: int, dtype: str):
    """The two data-volume models of ``dasp_f64.h:1162-1172`` (bytes)."""
    vb = _val_bytes(dtype)
    ib = 4
    data1 = nnz * (vb + ib) + (n_rows + n_cols) * vb
    data2 = nnz * (vb + ib + vb) + n_rows * vb
    return data1, data2


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable[[], object], warmup: int = WARMUP,
            iters: int = ITERS, device="cuda") -> float:
    """Average seconds per eager call, fully synchronized (includes the
    host's per-call launch cost; prefer ``time_loop`` for kernels)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


# Runaway bound for the adaptive loop-length scaling below.
MAX_LOOP_ITERS = 200_000
# One timed replay lasts at least this long, so that the events'
# resolution and the replay's own launch do not show in a per-SpMV time
# of tens of microseconds.
MIN_REPLAY_SECONDS = 2e-3
# A loop that is not one launch is captured node by node: a streamed SpMV
# is its kernels plus up to ~50 small glue kernels.  Its chain is capped
# so that a graph stays under MAX_GRAPH_NODES.
MAX_GRAPH_NODES = 20_000
NODES_PER_STREAMED_SPMV = 50


def _runner(step: Callable[[], object], device) -> Callable[[], float]:
    """``run() -> seconds`` of one execution of ``step`` after an untimed
    one: a CUDA-graph replay between two events on a card
    (``event_seconds``), the call itself under the host's clock on the
    CPU."""
    if torch.device(device).type != "cuda":
        def run_host() -> float:
            step()
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
        return run_host
    replay = graphed(step)
    return lambda: event_seconds(replay)


def event_seconds(replay: Callable[[], object]) -> float:
    """Device seconds of one call of ``replay`` on the current CUDA
    stream, between two CUDA events: the harness's clock.  A first replay
    is queued in front of the timed one and the start event behind it, so
    that the host's launch of the timed replay (for a graph of thousands
    of nodes hundreds of microseconds, and several times that once a
    profiler has been attached to the process) overlaps the first one's
    run instead of counting."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    replay()
    a.record()
    replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e-3


def time_adaptive(make_step: Callable[[int], Callable[[], object]],
                  device, n: int, cap: int, trials: int = TRIALS
                  ) -> Tuple[float, float, int, float]:
    """Time ``make_step(n)()``, a step of n units of work, and return
    ``(median seconds of a step, spread, n, seconds before the first timed
    run)``.  n is at least doubled, up to ``cap``, until one run of the
    step lasts MIN_REPLAY_SECONDS; ``spread`` is (max - min) / median over
    the ``trials`` timed runs, each of a freshly made (on a card: freshly
    captured) step, after one untimed run of it."""
    t0 = time.perf_counter()
    n = max(1, min(n, cap))
    while True:
        run = _runner(make_step(n), device)
        t = run()
        if t >= MIN_REPLAY_SECONDS or n >= cap:
            break
        n = min(cap, max(2 * n, int(1.25 * n * MIN_REPLAY_SECONDS
                                    / max(t, 1e-9)) + 1))
    setup = time.perf_counter() - t0
    ts = [t]
    while len(ts) < trials:
        ts.append(_runner(make_step(n), device)())
    med = statistics.median(ts)
    return med, (max(ts) - min(ts)) / med, n, setup


def loop_spmvs(op, n: int) -> int:
    """SpMVs that ``op.timing_loop(n)`` really runs: n chained steps in a
    resident operator's one launch; n chained products and the one whose
    y is returned on a streamed operator or a library baseline."""
    return n if getattr(op, "resident", False) else n + 1


def _time_loop_stats(op, x_dev, iters: int = ITERS, trials: int = TRIALS):
    """Seconds per SpMV from the operator's chained timing loop.  Returns
    ``(seconds_per_iter, spread, n, compile_seconds)``."""
    resident = getattr(op, "resident", False)
    cap = (MAX_LOOP_ITERS if resident
           else MAX_GRAPH_NODES // NODES_PER_STREAMED_SPMV - 1)
    med, spread, n, setup = time_adaptive(
        lambda k: (lambda loop=op.timing_loop(k): loop(x_dev)),
        x_dev.device, iters, cap, trials)
    return med / loop_spmvs(op, n), spread, n, setup


def time_loop_stats(op, x_dev, iters: int = ITERS, trials: int = TRIALS):
    """See _time_loop_stats; returns (seconds_per_iter, spread, n)."""
    return _time_loop_stats(op, x_dev, iters, trials)[:3]


def time_loop(op, x_dev, iters: int = ITERS, trials: int = TRIALS) -> float:
    return time_loop_stats(op, x_dev, iters, trials)[0]


def _result(op, dtype: str, sec: float, spread: float, n: int,
            setup: float) -> BenchResult:
    d1, d2 = data_models(op.n_rows, op.n_cols, op.nnz, dtype)
    return BenchResult(
        seconds_per_iter=sec,
        gflops=2.0 * op.nnz / sec / 1e9,
        bandwidth1_gbs=d1 / sec / 1e9,
        bandwidth2_gbs=d2 / sec / 1e9,
        preprocess_seconds=getattr(op, "preprocess_seconds", 0.0),
        spread=spread, timed_iters=n, compile_seconds=setup)


def bench_spmv(op, x, dtype: str, warmup: int = WARMUP,
               iters: int = ITERS, trials: int = TRIALS) -> BenchResult:
    """Benchmark an SpMVOperator (or any object with .timing_loop, ._prep_x,
    .n_rows/.n_cols/.nnz)."""
    del warmup  # the runner warms each loop before it times it
    return _result(op, dtype, *_time_loop_stats(op, op._prep_x(x), iters,
                                                trials))


def bench_spmm(op, X, dtype: str, trials: int = TRIALS) -> BenchResult:
    """Benchmark ``op.matmat`` on the columns of X (n_cols, k), for any
    object with ``.spmm_loop(X)`` (the device half of one matmat call) and
    ``.device``.  ``seconds_per_iter`` is the time per COLUMN, so GFLOP/s
    and the bandwidth models read as an SpMV's; ``timed_iters`` counts the
    matmat calls in one timed step."""
    call = op.spmm_loop(np.asarray(X))
    med, spread, n, setup = time_adaptive(
        lambda k: (lambda: [call() for _ in range(k)]),
        op.device, 1, MAX_GRAPH_NODES // NODES_PER_STREAMED_SPMV, trials)
    return _result(op, dtype, med / n / X.shape[1], spread, n, setup)


def copy_rate_gbs(device, nbytes: int = 1 << 30, iters: int = 20,
                  trials: int = TRIALS) -> float:
    """The card's device-memory copy rate in GB/s, read plus write:
    ``copy_`` of ``nbytes`` (1 GiB, 20x the 50 MB L2), the median over
    ``trials`` of ``iters`` eager copies between two CUDA events."""
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize(device)
    ms = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            dst.copy_(src)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / iters)
    return 2 * src.numel() * 4 / (statistics.median(ms) * 1e6)
