"""Conjugate-gradient solve with dasp_tpu_torch -- the canonical SpMV
consumer (the port of ``examples/cg_solver.py``).

Solves A x = b for a symmetric positive-definite A with x, r, p and the
scalars on the operator's device.  The JAX version runs a ``while_loop``
inside one jit; here the loop is Python over device tensors: one CG
iteration is captured once in a CUDA graph (on a CPU operator it runs as
it is), and the host replays it and reads the squared residual back, so
that the stopping test ``rs > tol**2 and it < maxiter`` is evaluated every
iteration and the iteration count is the reference's.  The state, the
graph and its pool are built by an operator's first solve and kept on the
operator for as long as it lives: every later solve copies its b in and
resets them.  ``iteration_costs`` measures what the read-back costs per
iteration.

Usage: python -m dasp_tpu_torch.examples.cg_solver [n] [dtype] [device]
"""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import torch

from .. import DaspConfig, SpMVOperator, from_coo, trace
from ..ops.cuda_backend import _to_host
from ..utils import graphed
from ._common import matvec_into, require_shared_space, x_dtype, x_table


def build_spd(n: int, rng):
    """A = tridiagonal-ish SPD matrix (2D-Laplacian flavored)."""
    rows, cols, vals = [], [], []
    for off, v in ((0, 4.0), (1, -1.0), (-1, -1.0), (64, -1.0), (-64, -1.0)):
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(r.size, v))
    return from_coo(n, n, np.concatenate(rows),
                    np.concatenate(cols).astype(np.int32),
                    np.concatenate(vals), sum_duplicates=True)


class CGIteration:
    """CG's state on the operator's device, in its internal index space
    (a symmetric relabel keeps x and y in one space, and CG's dot products
    are permutation-invariant), and ``step()``, one iteration in place: a
    CUDA-graph replay on a card, ``raw_step`` itself on the CPU.  The graph
    reads and writes these tensors where they lie, so a new solve on the
    same state is ``restart(b)``: nothing is allocated or captured."""

    def __init__(self, op, b_int: np.ndarray):
        kw = {"dtype": x_dtype(op), "device": op.device}
        self.b, self.x, self.r, self.p = (
            torch.zeros(b_int.shape, **kw) for _ in range(4))
        self.rs = torch.zeros((), **kw)
        self.matvec = matvec_into(op, x_table(op))
        self.restart(b_int)
        self.step = self.raw_step
        if op.device.type == "cuda":
            self.step = graphed(self.raw_step)
            self.reset()               # the warm-up calls moved the state

    def restart(self, b_int: np.ndarray) -> None:
        """Start a solve of ``b_int`` (in the internal index space): copy
        it into ``b``, in b's dtype, then ``reset()``."""
        self.b.copy_(torch.from_numpy(np.ascontiguousarray(b_int)))
        self.reset()

    def reset(self) -> None:
        self.x.zero_()
        self.r.copy_(self.b)
        self.p.copy_(self.b)
        self.rs.copy_(torch.dot(self.b, self.b))

    def raw_step(self) -> None:
        x, r, p, rs = self.x, self.r, self.p, self.rs
        ap = self.matvec(p)
        alpha = rs / torch.dot(p, ap)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        rs_new = torch.dot(r, r)
        p.mul_(rs_new / rs).add_(r)
        rs.copy_(rs_new)


def _allocs(device) -> dict:
    """Allocation calls so far on a card: cudaMalloc (the caching
    allocator's ``num_device_alloc``) and cudaHostAlloc (the pinned host
    allocator's ``num_host_alloc``).  The nested statistics: flattening
    them, as ``memory_stats()`` does, took ~200 µs a read on an H100's
    host."""
    mem = torch.cuda.memory
    return {"device_allocs": mem.memory_stats_as_nested_dict(device).get(
                "num_device_alloc", 0),
            "host_allocs": mem.host_memory_stats_as_nested_dict().get(
                "num_host_alloc", 0)}


def cg_solve(op, b: np.ndarray, tol: float = 1e-6, maxiter: int = 500):
    """CG on the operator's device, in its x dtype (f32 for an f32 or bf16
    operator, fp64 for an f64 one).  Returns (x in original order, the
    residual norm, the iterations run).

    The first solve on an operator builds its ``CGIteration`` (the
    vectors, the x table and, on a card, the captured graph and its pool)
    and keeps it on the operator, which holds it as long as it lives.
    Every later solve copies its b into that state and resets it
    (``restart``), allocating, capturing and freeing nothing; it runs the
    same kernels on the same state from the same ``reset()``, so its x,
    residual and iterations are bitwise a fresh operator's.  A lock of
    the operator's holds each solve over its whole span: one solve at a
    time runs on an operator.

    One ``cg.solve`` span (``dasp_tpu_torch.trace``) holds three that tile
    it: ``cg.setup`` (encode and upload b, build the state or restart the
    kept one, read rs; counts ``reused``, 0 where it built the state and 1
    where it restarted it), ``cg.iterate`` (the replays and read-backs;
    counts ``iterations``) and ``cg.finish`` (decode x).  On a card
    ``cg.solve`` counts the solve's allocation calls, ``device_allocs``
    and ``host_allocs`` (``_allocs``); on the CPU, which keeps no
    allocator statistics, it counts ``state_tensors``, the tensors the
    state holds."""
    cuda = op.device.type == "cuda"
    lock = op.__dict__.setdefault("_cg_lock", threading.Lock())
    with lock, trace.span("cg.solve"):
        before = _allocs(op.device) if cuda else None
        with trace.span("cg.setup"):
            require_shared_space(op, "cg_solve()")
            dt = np.float64 if op.dtype == "f64" else np.float32
            # encode b on entry, decode x on exit
            b_int = op.perm_in(np.asarray(b, dtype=dt))
            state = op.__dict__.get("_cg_state")
            if state is None:
                state = op._cg_state = CGIteration(op, b_int)
                trace.count("reused", 0)
            else:
                state.restart(b_int)
                trace.count("reused", 1)
            rs, it = float(state.rs), 0
        with trace.span("cg.iterate"):
            while rs > tol * tol and it < maxiter:
                state.step()
                rs = float(state.rs)   # the iteration's one read-back
                it += 1
            trace.count("iterations", it)
        with trace.span("cg.finish"):
            x = _to_host(state.x)
            # on the CPU that is the kept x itself, which the next solve
            # resets
            x = op.perm_out(x if cuda else x.copy())
        if cuda:
            for key, n in _allocs(op.device).items():
                trace.count(key, n - before[key])
        else:
            trace.count("state_tensors",
                        sum(map(torch.is_tensor, vars(state).values())))
    return x, math.sqrt(rs), it


def cg_solve_f64(op, b: np.ndarray, tol: float = None, maxiter: int = 4000):
    """CG in native fp64 on an operator built with dtype="f64".  f32 CG
    stalls around 1e-3 - 1e-4 relative error on ill-conditioned
    Laplacians; the card has an fp64 datapath, so the state vectors, the
    matvec and the dot products simply run in fp64, where the reference
    carries double-double f32 pairs (``cg_solve_dd``)."""
    if op.dtype != "f64":
        raise ValueError(f"cg_solve_f64() needs a dtype='f64' operator, "
                         f"got {op.dtype!r}")
    if tol is None:
        tol = 1e-10 * float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
    return cg_solve(op, b, tol, maxiter)


# the reference's name for its fp64-grade solver
cg_solve_dd = cg_solve_f64


def iteration_costs(op, b: np.ndarray, iters: int) -> dict:
    """ms per CG iteration on ``op``: "synced", the wall time of the loop
    ``cg_solve`` runs (a step, then the read-back of rs) over ``iters``
    iterations; "device", the same steps chained with no read-back (on a
    card: captured in one graph, timed with events); and "spmv", the
    matvec alone, chained the same way."""
    from ..bench.harness import MAX_GRAPH_NODES, time_adaptive
    dt = np.float64 if op.dtype == "f64" else np.float32
    state = CGIteration(op, op.perm_in(np.asarray(b, dtype=dt)))
    t0 = time.perf_counter()
    for _ in range(iters):
        state.step()
        float(state.rs)
    synced = (time.perf_counter() - t0) / iters
    cap = MAX_GRAPH_NODES // 100

    def per_unit(unit) -> float:
        state.reset()
        med, _, n, _ = time_adaptive(
            lambda k: (lambda: [unit() for _ in range(k)]), op.device, 8, cap)
        return med / n
    device = per_unit(state.raw_step)
    spmv = per_unit(lambda: state.matvec(state.b))
    return {"synced": synced * 1e3, "device": device * 1e3,
            "spmv": spmv * 1e3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 65536
    dtype = argv[1] if len(argv) > 1 else "f64"
    device = argv[2] if len(argv) > 2 else "cuda"
    rng = np.random.default_rng(0)
    csr = build_spd(n, rng)
    # on-device iteration feeds y back into x: keep one shared index
    # space (no independent row grouping)
    op = SpMVOperator(csr, dtype=dtype, config=DaspConfig(row_sort="off"),
                      device=device, force_streamed=True)
    x_true = rng.standard_normal(n)
    b = csr.spmv(x_true)

    if dtype == "f64":
        x, res, iters = cg_solve_f64(op, b)
    else:
        x, res, iters = cg_solve(op, b.astype(np.float32))
    x = np.asarray(x, dtype=np.float64)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    print(f"CG[{dtype}]: n={n} iters={int(iters)} "
          f"residual={float(res):.3e} solution rel err={err:.3e}")
    ms = iteration_costs(op, b, min(max(iters, 1), 200))
    where = (torch.cuda.get_device_name(op.device)
             if op.device.type == "cuda" else "cpu")
    print(f"per iteration on {where}: {ms['synced']:.4f} ms with the "
          f"read-back of rs, {ms['device']:.4f} ms chained without it; the "
          f"SpMV alone {ms['spmv']:.4f} ms "
          f"({ms['spmv'] / ms['device']:.0%} of the iteration)")
    # f32 CG stalls near 1e-3 on ill-conditioned systems; fp64 reaches
    # fp64-grade accuracy
    return 0 if err < (1e-3 if dtype == "f32" else 1e-6) else 1


if __name__ == "__main__":
    sys.exit(main())
