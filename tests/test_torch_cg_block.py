"""CG's stop test on the device (``examples/cg_solver.py``): a solve that
replays blocks of ``K`` iterations and reads rs and the count back once a
block is bitwise the loop that reads rs back after every iteration, on
the CPU (the block runs uncaptured there, as the card's graph holds it)."""

import math

import numpy as np
import pytest
import torch

import dasp_tpu_torch as dt
from dasp_tpu_torch.examples import cg_solver
from dasp_tpu_torch.examples.cg_solver import K
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
ensure_built()

N = 512
SHARED = dt.DaspConfig(row_sort="off")


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(23)
    csr = cg_solver.build_spd(N, rng)
    return csr, rng.standard_normal(N)


def _op(csr, dtype):
    return dt.SpMVOperator(csr, dtype=dtype, device="cpu", config=SHARED)


def _b(op, b):
    return np.asarray(b, dtype=np.float64 if op.dtype == "f64"
                      else np.float32)


def _one_at_a_time(op, b, tol, maxiter):
    """The loop before the stop test moved onto the device: an iteration,
    the read-back of rs, the host's test; on a state of its own."""
    state = cg_solver.CGIteration(op, op.perm_in(_b(op, b)), tol, maxiter)
    rs, it = float(state.rs), 0
    while rs > tol * tol and it < maxiter:
        state.raw_step()
        rs = float(state.rs)
        it += 1
    return op.perm_out(state.x.numpy().copy()), math.sqrt(rs), it


def _tol_stopping_at(op, b, m, below=False):
    """A tol at which the loop of one at a time stops after exactly ``m``
    iterations (rs falls at every iteration of these systems); with
    ``below``, tol**2 lies just under rs after m - 1 iterations, closer
    than an f32 rounding step, so the test must be made in fp64."""
    state = cg_solver.CGIteration(op, op.perm_in(_b(op, b)), 0.0, m)
    rs = [float(state.rs)]
    for _ in range(m):
        state.raw_step()
        rs.append(float(state.rs))
    assert all(a > c for a, c in zip(rs, rs[1:])), rs
    if below:
        return math.sqrt(rs[m - 1]) * (1 - 1e-9)
    return math.sqrt(rs[m]) * (1 + 1e-9)


def _iterate_counts():
    """The counts of the last ``cg.iterate`` span."""
    return [r.counts for r in dt.trace.records()
            if r.name == "cg.iterate"][-1]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:], (got[1:], want[1:])


# the iterations each case runs: 2K, 2K + 1 and 3K - 1 (stopped by tol),
# 2K + 2 (tol**2 just under rs after 2K + 1), K + K // 2 (stopped by
# maxiter in the middle of a block) and 0 (b = 0)
CASES = {"stop_0": 2 * K, "stop_1": 2 * K + 1, "stop_K-1": 3 * K - 1,
         "tol2_under_rs": 2 * K + 2, "maxiter": None, "b_zero": 0}


def _case(op, b, case):
    """(b, tol, maxiter, the iterations it must run)."""
    m = CASES[case]
    if case == "b_zero":
        return np.zeros_like(b), 1e-8, 1000, 0
    if case == "maxiter":
        return b, 1e-30, K + K // 2, K + K // 2
    tol = _tol_stopping_at(op, b, m, below=case == "tol2_under_rs")
    return b, tol, 1000, m


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_the_blocked_solve_is_the_loop_of_one_at_a_time(system, dtype,
                                                        case):
    csr, b0 = system
    op = _op(csr, dtype)
    b, tol, maxiter, m = _case(op, b0, case)
    want = _one_at_a_time(op, b, tol, maxiter)
    assert want[2] == m
    got = cg_solver.cg_solve(op, b, tol=tol, maxiter=maxiter)
    _same(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_solve_counts_its_readbacks_and_frozen_iterations(system, case):
    csr, b0 = system
    op = _op(csr, "f64")
    b, tol, maxiter, m = _case(op, b0, case)
    assert cg_solver.cg_solve(op, b, tol=tol, maxiter=maxiter)[2] == m
    reads = -(-m // K)
    assert _iterate_counts() == {"iterations": m, "readbacks": reads,
                                 "frozen": reads * K - m}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_a_kept_state_takes_each_solves_tol_and_maxiter(system, dtype):
    """Solves on one operator's kept state, each with its own tol and
    maxiter, stop where the loop of one at a time stops: the device's
    scalars are written by each solve, not captured with the graph."""
    csr, b0 = system
    op = _op(csr, dtype)
    b1 = np.random.default_rng(5).standard_normal(N)
    runs = [(b1, _tol_stopping_at(op, b1, 2 * K + 1), 1000, 2 * K + 1),
            (b0, 1e-30, K + 3, K + 3),
            (b0, _tol_stopping_at(op, b0, K - 1), 1000, K - 1),
            (b1, 1e-30, 2 * K, 2 * K)]
    for b, tol, maxiter, m in runs:
        got = cg_solver.cg_solve(op, b, tol=tol, maxiter=maxiter)
        assert got[2] == m
        _same(got, _one_at_a_time(op, b, tol, maxiter))
    setups = [r.counts["reused"] for r in dt.trace.records()
              if r.name == "cg.setup"][-len(runs):]
    assert setups == [0, 1, 1, 1]
