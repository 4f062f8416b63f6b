"""Conjugate-gradient solve with dasp_tpu_torch -- the canonical SpMV
consumer (the port of ``examples/cg_solver.py``).

Solves A x = b for a symmetric positive-definite A with x, r, p and the
scalars on the operator's device.  The JAX version runs a ``while_loop``
inside one jit; here the loop is Python over device tensors.  The stop
test ``rs > tol**2 and it < maxiter`` runs on the device: each iteration
evaluates it before it starts and, once it fails, leaves x, r, rs and the
count as they are (the scalars are masked, not the vectors; on a card the
test and the scalars' updates are two small Triton kernels, whose
launches ``launches`` counts).  ``cg_solve`` captures ``K`` iterations
once in a CUDA graph (on a CPU operator they run as they are); the host
replays the block and reads rs and the count back once a replay, in one
copy, and stops when the same test fails there.  So
the iterations run, x and the residual are bitwise those of a loop that
reads rs back after every iteration, and up to K - 1 iterations a solve
run frozen past the stop.  The state, the graph and its pool are built by
an operator's first solve and kept on the operator for as long as it
lives: every later solve copies its b in, writes its tol and maxiter into
the device's scalars and resets the state.  ``iteration_costs`` measures
what the read-back costs per iteration.

Usage: python -m dasp_tpu_torch.examples.cg_solver [n] [dtype] [device]
"""

from __future__ import annotations

import functools
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


# iterations a replay of the captured graph runs (one read-back each):
# chosen on an H100 at hpcg104_f64 among 4, 8 and 16 (PERF.md)
K = 8


class CGIteration:
    """CG's state on the operator's device, in its internal index space
    (a symmetric relabel keeps x and y in one space, and CG's dot products
    are permutation-invariant), and ``step()``, ``K`` iterations in place:
    ``block``, which ``cg_solve`` replaces on a card by the replay of its
    CUDA graph.  The stop test's scalars are the words of one device
    buffer, ``scalars``: rs, ``count`` (the iterations run), ``tol2``
    (tol**2, fp64 for every dtype, as the host compares) and ``maxiter``.
    The graph reads and writes them where they lie, so a new solve on the
    same state is ``restart(b, tol, maxiter)``: nothing is allocated or
    captured."""

    def __init__(self, op, b_int: np.ndarray, tol: float, maxiter: int):
        kw = {"dtype": x_dtype(op), "device": op.device}
        self.b, self.x, self.r, self.p = (
            torch.zeros(b_int.shape, **kw) for _ in range(4))
        # rs (its bits in the first word), count, tol2 (its bits) and
        # maxiter: one copy reads rs and count back, one writes the rest
        self.scalars = torch.zeros(4, dtype=torch.int64, device=op.device)
        self.rs = self.scalars[:1].view(kw["dtype"])[0]
        self.count = self.scalars[1]
        self.tol2 = self.scalars[2:3].view(torch.float64)[0]
        self.maxiter = self.scalars[3]
        self.live = torch.zeros((), dtype=torch.bool, device=op.device)
        cuda = op.device.type == "cuda"
        self.host = torch.zeros(2, dtype=torch.int64, pin_memory=cuda)
        words = self.host.numpy()
        self._rs_host = words[:1].view(
            np.float64 if kw["dtype"] == torch.float64 else np.float32)
        self._count_host = words[1:]
        self.matvec = matvec_into(op, x_table(op))
        self.restart(b_int, tol, maxiter)
        self.step = self.block

    def restart(self, b_int: np.ndarray, tol: float, maxiter: int) -> None:
        """Start a solve of ``b_int`` (in the internal index space) to
        ``tol`` or ``maxiter``: copy b into ``b``, in b's dtype, write
        tol**2 and maxiter, then ``reset()``."""
        self.b.copy_(torch.from_numpy(np.ascontiguousarray(b_int)))
        words = np.array([0, maxiter], dtype=np.int64)
        words[:1].view(np.float64)[0] = float(tol) * float(tol)
        self.scalars[2:].copy_(torch.from_numpy(words))
        self.reset()

    def reset(self) -> None:
        self.x.zero_()
        self.r.copy_(self.b)
        self.p.copy_(self.b)
        self.rs.copy_(torch.dot(self.b, self.b))
        self.count.zero_()

    def read(self) -> tuple:
        """(rs, count) on the host: one copy of both and one synchronize."""
        self.host.copy_(self.scalars[:2], non_blocking=True)
        if self.scalars.is_cuda:
            torch.cuda.current_stream(self.scalars.device).synchronize()
        return float(self._rs_host[0]), int(self._count_host[0])

    def block(self) -> None:
        for _ in range(K):
            self.raw_step()

    def raw_step(self) -> None:
        """One iteration where the stop test holds; elsewhere alpha and
        p's factor are 0 (x and r keep their values, p becomes r, all
        finite) and rs and count keep theirs."""
        x, r, p = self.x, self.r, self.p
        ap = self.matvec(p)
        alpha = self.alpha(torch.dot(p, ap))
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        p.mul_(self.advance(torch.dot(r, r))).add_(r)

    def alpha(self, pap: torch.Tensor) -> torch.Tensor:
        """The stop test into ``live``, and alpha = rs / (p . Ap) where it
        holds, else 0: one Triton launch on a card, ``alpha_plain`` on
        the CPU."""
        if not pap.is_cuda:
            return self.alpha_plain(pap)
        out = torch.empty_like(pap)
        f64 = pap.dtype == torch.float64
        _scalar_kernels()[0][(1,)](self.rs, pap, self.tol2, self.count,
                                   self.maxiter, self.live, out, f64,
                                   num_warps=1)
        launches["cg_alpha_f64" if f64 else "cg_alpha"] += 1
        return out

    def advance(self, rs_new: torch.Tensor) -> torch.Tensor:
        """p's factor rs_new / rs where ``live`` holds, else 0; there rs
        becomes rs_new and the count grows by one: one Triton launch on a
        card, ``advance_plain`` on the CPU."""
        if not rs_new.is_cuda:
            return self.advance_plain(rs_new)
        out = torch.empty_like(rs_new)
        f64 = rs_new.dtype == torch.float64
        _scalar_kernels()[1][(1,)](self.live, rs_new, self.rs, self.count,
                                   out, f64, num_warps=1)
        launches["cg_advance_f64" if f64 else "cg_advance"] += 1
        return out

    def alpha_plain(self, pap: torch.Tensor) -> torch.Tensor:
        torch.logical_and(torch.gt(self.rs, self.tol2),
                          torch.lt(self.count, self.maxiter), out=self.live)
        return torch.where(self.live, self.rs / pap, 0)

    def advance_plain(self, rs_new: torch.Tensor) -> torch.Tensor:
        factor = torch.where(self.live, rs_new / self.rs, 0)
        torch.where(self.live, rs_new, self.rs, out=self.rs)
        self.count.add_(self.live)
        return factor


# launches of the scalar kernels by instance (the f32 one, which bf16
# operators use too, bears the bare name): one each time ``alpha`` or
# ``advance`` launches, or captures, its kernel
launches = dict.fromkeys(
    ("cg_alpha", "cg_alpha_f64", "cg_advance", "cg_advance_f64"), 0)


@functools.lru_cache(maxsize=None)
def _scalar_kernels():
    """The two scalar kernels of an iteration on a card, in Triton:
    ``CGIteration.alpha_plain`` and ``advance_plain`` bit for bit (the
    divisions rounded to nearest, as PyTorch's), one launch each where
    those take five and four."""
    import triton
    import triton.language as tl

    @triton.jit
    def div(a, b, f64: tl.constexpr):
        # Triton's f32 "/" is approximate; its f64 "/" rounds to nearest
        if f64:
            return a / b
        else:
            return tl.math.div_rn(a, b)

    @triton.jit
    def alpha_kernel(rs_p, pap_p, tol2_p, count_p, maxiter_p, live_p,
                     out_p, f64: tl.constexpr):
        rs = tl.load(rs_p)
        live = ((rs.to(tl.float64) > tl.load(tol2_p))
                & (tl.load(count_p) < tl.load(maxiter_p)))
        tl.store(live_p, live)
        tl.store(out_p, tl.where(live, div(rs, tl.load(pap_p), f64), 0.0))

    @triton.jit
    def advance_kernel(live_p, rs_new_p, rs_p, count_p, out_p,
                       f64: tl.constexpr):
        live = tl.load(live_p)
        rs, rs_new = tl.load(rs_p), tl.load(rs_new_p)
        tl.store(out_p, tl.where(live, div(rs_new, rs, f64), 0.0))
        tl.store(rs_p, tl.where(live, rs_new, rs))
        tl.store(count_p, tl.load(count_p) + live.to(tl.int64))
    return alpha_kernel, advance_kernel


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
    vectors, the x table and, on a card, the graph of its block and the
    graph's pool) and keeps it on the operator, which holds it as long as
    it lives.  Every later solve copies its b into that state and resets it
    (``restart``, with its tol and maxiter), allocating, capturing and
    freeing nothing; it runs the same kernels on the same state from the
    same ``reset()``, so its x, residual and iterations are bitwise a
    fresh operator's.  A lock of
    the operator's holds each solve over its whole span: one solve at a
    time runs on an operator.

    One ``cg.solve`` span (``dasp_tpu_torch.trace``) holds three that tile
    it: ``cg.setup`` (encode and upload b, build the state or restart the
    kept one, read rs; counts ``reused``, 0 where it built the state and 1
    where it restarted it), ``cg.iterate`` (the replays and read-backs;
    counts ``iterations``, ``readbacks``, the replays read back, and
    ``frozen``, the iterations the device ran past the stop,
    ``readbacks * K - iterations``) and ``cg.finish`` (decode x).  On a
    card ``cg.solve`` counts the solve's allocation calls, ``device_allocs``
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
                state = op._cg_state = CGIteration(op, b_int, tol, maxiter)
                if cuda:
                    state.step = graphed(state.block)
                    state.reset()      # the warm-up calls moved the state
                trace.count("reused", 0)
            else:
                state.restart(b_int, tol, maxiter)
                trace.count("reused", 1)
            rs, it = state.read()
        with trace.span("cg.iterate"):
            # the device's test, on what it read back; ``reads * K <
            # maxiter`` is ``it < maxiter`` while the device counts, and
            # ends the loop where it does not
            reads = 0
            while rs > tol * tol and it < maxiter and reads * K < maxiter:
                state.step()
                rs, it = state.read()
                reads += 1
            trace.count("iterations", it)
            trace.count("readbacks", reads)
            trace.count("frozen", reads * K - it)
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
    """ms per CG iteration on ``op``, every iteration live (tol 0):
    "synced", the wall time of the loop ``cg_solve`` ran before its stop
    test moved onto the device (one iteration, captured alone on a card,
    then the read-back of rs) over ``iters`` iterations; "device", the
    iterations chained with no read-back (on a card: captured in one
    graph, timed with events), the stop test on the device included; and
    "spmv", the matvec alone, chained the same way.  A replay of
    ``cg_solve`` holds ``K`` iterations and one read-back."""
    from ..bench.harness import MAX_GRAPH_NODES, time_adaptive
    dt = np.float64 if op.dtype == "f64" else np.float32
    state = CGIteration(op, op.perm_in(np.asarray(b, dtype=dt)), 0.0,
                        sys.maxsize)
    one = state.raw_step
    if op.device.type == "cuda":
        one = graphed(state.raw_step)
        state.reset()
    t0 = time.perf_counter()
    for _ in range(iters):
        one()
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
