"""The one general traffic driver: each mix (``traffic/<mix>.json``) names
a ``kind`` and its parameters, and this module turns them into requests on
the program's operator.

Every kind makes its inputs from the run's seed, warms up every shape it
will use (that counts as set-up), and then serves one request per
``unit()`` call in a closed loop of one client; ``window`` runs those
units back to back for the run's seconds.  After the window a kind hands
its outputs to ``judge``, which compares them with the plain reference;
``control`` puts the control's outputs (the reference one precision
lower) where the kind keeps the program's, for ``benchmark/control.py``.

Kinds (a mix may also name a kind of its own, ``kinds/<kind>.py``, which
``Spec.kind`` finds by name):

* ``cg``: ``cg_solve_f64`` to ``rtol * ||b||`` or ``maxiter``, b cycling
  through a pool of ``pool`` right-hand sides A (1 + u), u ~ U[0, 1),
  which the reference's product makes (its seconds, ``reference_s``,
  are left out of the set-up); a solve at ``maxiter`` fails.  A seeded
  reservoir of ``checked`` solves keeps its x for the check.
* ``chain``: replays of a CUDA graph of ``op.timing_loop(n)`` (one K6
  launch for n SpMVs on a resident operator, n + 1 K6 steps with
  ``force_streamed``), n such that the chain's model-1 time is
  ``replay_model_ms``.
* ``spmm``: replays of a CUDA graph of ``reps`` calls of
  ``op.spmm_loop(X)`` on X (n, kv), reps such that their model-1 time is
  ``replay_model_ms``.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..reference.csr import Csr, product, relative_residual, scaled_error
from ..reference.lower import cg_below, product_below
from . import profile
from .roofline import model1_seconds

QUEUE = 2                  # units in flight on the device at most
STRETCH_AT = 0.3           # the traced stretch starts at this share ...
STRETCH_S = 2.0            # ... and lasts this long, or a third of it


def capture(fn: Callable[[], object], reps: int, device):
    """(replay, output of the last call): ``reps`` calls of ``fn`` in one
    CUDA graph, after three warm-up calls on a side stream; on a CPU
    device the calls themselves."""
    if device.type != "cuda":
        out = [None]

        def run():
            for _ in range(reps):
                out[0] = fn()
        run()
        return run, out
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            out = fn()
    g.replay()
    return g.replay, [out]


class Kind:
    """Counts one kind keeps: ``spmvs`` and ``columns`` done per unit,
    ``failed`` requests, per-request wall times and solver iterations,
    and the seconds its set-up spent in the reference."""
    spmvs_per_unit = 0
    columns_per_unit = 0
    reference_s = 0.0

    def __init__(self):
        self.failed = 0
        self.request_s: list = []
        self.iters: list = []

    def unit(self) -> None:
        raise NotImplementedError

    def alone(self) -> Tuple[Callable[[], object], int, int]:
        """(the operator's device entry, SpMVs or passes a call, kv)."""
        raise NotImplementedError

    def collect(self) -> None:
        """Copy the outputs to judge to the host (before the program's
        state is freed)."""

    def release(self) -> None:
        """Drop every reference to the program's device state."""
        for k in ("op", "x2d", "loop", "fn", "unit", "out"):
            self.__dict__.pop(k, None)

    def judge(self, a: Csr, limits: Dict[str, float]) -> Dict[str, tuple]:
        raise NotImplementedError

    def control(self, a: Csr, below: str, device) -> None:
        """Put the control's outputs where the kind keeps the program's:
        the reference computed in ``below`` (``reference/lower.py``)."""
        raise NotImplementedError


class Cg(Kind):
    def __init__(self, op, a: Csr, p: dict, rng: np.random.Generator):
        super().__init__()
        from dasp_tpu_torch.examples import cg_solver
        self.op, self.p = op, p
        self.solve = cg_solver.cg_solve_f64
        t = time.perf_counter()
        self.pool = [product(a, 1.0 + rng.random(a.n_cols))
                     for _ in range(int(p["pool"]))]
        self.reference_s = time.perf_counter() - t
        self.tols = [float(p["rtol"]) * float(np.linalg.norm(b))
                     for b in self.pool]
        self.pick = np.random.default_rng(rng.integers(1 << 62))
        self.kept: list = []             # (pool index, x) of checked solves
        self.count = 0
        self.x2d = op._prep_x(self.pool[0])
        self._solve(0)                   # warm-up: builds, captures, cuBLAS

    def _solve(self, k: int):
        return self.solve(self.op, self.pool[k], tol=self.tols[k],
                          maxiter=int(self.p["maxiter"]))

    def unit(self) -> None:
        k = self.count % len(self.pool)
        t = time.perf_counter()
        x, res, it = self._solve(k)
        self.request_s.append(time.perf_counter() - t)
        self.iters.append(int(it))
        self.failed += int(it >= int(self.p["maxiter"])
                           and res > self.tols[k])
        # reservoir sample of the solves, drawn from the seed
        n, keep = self.count, int(self.p["checked"])
        if n < keep:
            self.kept.append((k, x))
        else:
            j = int(self.pick.integers(n + 1))
            if j < keep:
                self.kept[j] = (k, x)
        self.count += 1

    def alone(self):
        return (lambda: self.op.device_call(self.x2d)), 1, 1

    def judge(self, a, limits):
        res = max((relative_residual(a, self.pool[k], x)
                   for k, x in self.kept), default=float("inf"))
        return {"residual": (res, limits["residual"]),
                "failed": (self.failed, limits["failed"])}

    def control(self, a, below, device):
        self.kept = [(k, cg_below(a, b, float(self.p["rtol"]),
                                  int(self.p["maxiter"]), below, device)[0])
                     for k, b in enumerate(self.pool)]
        self.failed = 0


class Chain(Kind):
    def __init__(self, op, a: Csr, p: dict, rng: np.random.Generator):
        super().__init__()
        self.op = op
        self.x = rng.standard_normal(a.n_cols).astype(np.float32)
        if op.dtype == "f64":
            self.x = self.x.astype(np.float64)
        self.x2d = op._prep_x(self.x)
        t1 = model1_seconds(a.n_rows, a.n_cols, a.nnz, op.dtype)
        self.n = max(1, math.ceil(float(p["replay_model_ms"]) * 1e-3 / t1))
        self.loop = op.timing_loop(self.n)
        self.spmvs_per_unit = self.n if op.resident else self.n + 1
        self.unit, self.out = capture(lambda: self.loop(self.x2d), 1,
                                      op.device)

    def alone(self):
        if self.op.resident:
            return (lambda: self.loop(self.x2d)), self.n, 1
        return (lambda: self.op.device_call(self.x2d)), 1, 1

    def collect(self):
        self.y = self.op.perm_out(self.out[0].cpu().numpy())

    def judge(self, a, limits):
        return {"y_err": (scaled_error(a, self.x, self.y), limits["y_err"])}

    def control(self, a, below, device):
        self.y = product_below(a, self.x, below)


class Spmm(Kind):
    def __init__(self, op, a: Csr, p: dict, rng: np.random.Generator):
        super().__init__()
        self.op, self.kv = op, int(p["kv"])
        self.X = rng.standard_normal((a.n_cols, self.kv)).astype(
            np.float64 if op.dtype == "f64" else np.float32)
        self.fn = op.spmm_loop(self.X)
        t1 = model1_seconds(a.n_rows, a.n_cols, a.nnz, op.dtype, self.kv)
        self.reps = max(1, math.ceil(float(p["replay_model_ms"]) * 1e-3 /
                                     t1))
        self.columns_per_unit = self.reps * self.kv
        self.unit, self.out = capture(self.fn, self.reps, op.device)

    def alone(self):
        return self.fn, 1, self.kv

    def collect(self):
        y = torch.cat(self.out[0], dim=1)[:, :self.kv]
        self.y = self.op.perm_out(y.cpu().numpy())

    def judge(self, a, limits):
        return {"y_err": (scaled_error(a, self.X, self.y), limits["y_err"])}

    def control(self, a, below, device):
        self.y = product_below(a, self.X, below)


KINDS = {"cg": Cg, "chain": Chain, "spmm": Spmm}


def _close(prof, span) -> dict:
    torch.cuda.synchronize()
    span.__exit__(None, None, None)
    prof.stop()
    return profile.stretch(prof)


def window(kind: Kind, seconds: float, trace: bool, device
           ) -> Tuple[float, int, Optional[dict]]:
    """Run units back to back for ``seconds``, at most QUEUE of them in
    flight; (the window's seconds, units run, the traced stretch's
    reading or None).  The window ends with a synchronize after the last
    unit."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inflight: collections.deque = collections.deque()
    prof, span, reading, units = None, None, None, 0
    stretch_s = min(STRETCH_S, seconds / 3)
    sync()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if trace and cuda and reading is None:
            if prof is None and now >= STRETCH_AT * seconds:
                sync()
                prof = profile.tracer()
                prof.start()
                span = torch.profiler.record_function(profile.STRETCH)
                span.__enter__()
                ts = time.perf_counter() - t0
            elif prof is not None and now - ts >= stretch_s:
                reading, prof = _close(prof, span), None
        kind.unit()
        units += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > QUEUE:
                inflight.popleft().synchronize()
    sync()
    t1 = time.perf_counter()
    if prof is not None:
        reading = _close(prof, span)
    return t1 - t0, units, reading
