"""The port's examples (dasp_tpu_torch.examples) on the CPU at tiny sizes:
the thresholds of tests/test_examples.py, and the same systems through the
JAX package's examples (interpret-mode Pallas), iterate for iterate."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import dasp_tpu
import dasp_tpu_torch as dt
from dasp_tpu_torch.examples import cg_solver, pagerank
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()

EX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EX)

SHARED = dt.DaspConfig(row_sort="off")


def _cg(op, b, tol=None):
    """cg_solve_f64 with its own tolerance where ``tol`` is None."""
    if tol is None:
        return cg_solver.cg_solve_f64(op, b, maxiter=400)
    return cg_solver.cg_solve(op, b, tol=tol, maxiter=300)


def _reused(n):
    """The ``reused`` counts of the last ``n`` ``cg.setup`` spans."""
    return [r.counts.get("reused") for r in dt.trace.records()
            if r.name == "cg.setup"][-n:]


def _same_solve(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:], (got[1:], want[1:])


def _same_matrix(ours, ref):
    assert (ours.n_rows, ours.n_cols) == (ref.n_rows, ref.n_cols)
    np.testing.assert_array_equal(ours.row_ptr, ref.row_ptr)
    np.testing.assert_array_equal(ours.col_idx, ref.col_idx)
    np.testing.assert_array_equal(ours.values, ref.values)


def test_cg_solver_example(rng):
    csr = cg_solver.build_spd(512, rng)
    op = dt.SpMVOperator(csr, dtype="f32", device="cpu")
    b = rng.standard_normal(csr.n_rows)
    x, rnorm, iters = cg_solver.cg_solve(op, b, tol=1e-5, maxiter=300)
    r = b - csr.spmv(np.asarray(x))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4
    assert 0 < iters < 300 and rnorm <= 1e-5


def test_pagerank_example(rng):
    csr = pagerank.build_transition(1500, rng)
    # default config may decouple the x/y spaces (row-sort composition):
    # the on-device loop requires the shared space and must say so
    op_bad = dt.SpMVOperator(csr, dtype="f32", device="cpu")
    if op_bad.plan.row_perm is not None and not np.array_equal(
            op_bad.plan.row_perm, op_bad.plan.col_perm):
        with pytest.raises(ValueError, match="one\\s+index space"):
            pagerank.pagerank(op_bad, iters=2)
    op = dt.SpMVOperator(csr, dtype="f32", device="cpu", config=SHARED)
    r = pagerank.pagerank(op, iters=30)
    assert r.shape == (csr.n_rows,)
    rh = np.full(csr.n_rows, 1.0 / csr.n_rows)
    for _ in range(30):
        rh = 0.85 * csr.spmv(rh) + 0.15 / csr.n_rows
        rh = rh / rh.sum()
    rh = 0.85 * csr.spmv(rh) + 0.15 / csr.n_rows
    assert np.abs(r - rh).max() / np.abs(rh).max() < 1e-3
    # the loop is cached on the operator per (damping, iters)
    assert list(op._pagerank_runs) == [(0.85, 30)]
    np.testing.assert_array_equal(pagerank.pagerank(op, iters=30), r)
    pagerank.pagerank(op, damping=0.9, iters=2)
    assert len(op._pagerank_runs) == 2


def test_shared_space_refusal(rng):
    """An operator whose rows are regrouped apart from its columns is
    refused by both examples, with the reference's message."""
    csr = cg_solver.build_spd(256, rng)
    op = dt.SpMVOperator(csr, dtype="f32", device="cpu", config=SHARED)
    op.plan.row_perm = np.arange(csr.n_rows)[::-1].copy()
    with pytest.raises(ValueError, match="one\\s+index space"):
        cg_solver.cg_solve(op, np.ones(csr.n_rows))
    with pytest.raises(ValueError, match="one\\s+index space"):
        pagerank.pagerank(op, iters=1)


def test_cg_solver_f64(rng):
    """fp64 CG reaches fp64-grade errors where f32 CG stalls; the
    reference's name for it is kept."""
    assert cg_solver.cg_solve_dd is cg_solver.cg_solve_f64
    csr = cg_solver.build_spd(512, rng)
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu")
    x_true = rng.standard_normal(csr.n_rows)
    b = csr.spmv(x_true)
    x, rnorm, iters = cg_solver.cg_solve_dd(op, b, maxiter=400)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    assert x.dtype == np.float64 and err < 1e-6, (err, int(iters))
    with pytest.raises(ValueError, match="dtype='f64'"):
        cg_solver.cg_solve_f64(
            dt.SpMVOperator(csr, dtype="f32", device="cpu"), b)


def test_cg_bf16_operator_runs_in_f32(rng):
    csr = cg_solver.build_spd(256, rng)   # 4 and -1 are exact in bf16
    op = dt.SpMVOperator(csr, dtype="bf16", device="cpu", config=SHARED)
    b = rng.standard_normal(csr.n_rows)
    x, _, iters = cg_solver.cg_solve(op, b, tol=1e-2, maxiter=200)
    assert iters < 200
    assert np.linalg.norm(b - csr.spmv(x)) / np.linalg.norm(b) < 5e-2


def _cg_against_jax(solved_before: bool):
    import cg_solver as ref_cg
    csr = cg_solver.build_spd(512, np.random.default_rng(0))
    ref_csr = ref_cg.build_spd(512, np.random.default_rng(0))
    _same_matrix(csr, ref_csr)
    b = np.random.default_rng(1).standard_normal(512)
    op = dt.SpMVOperator(csr, dtype="f32", device="cpu", config=SHARED)
    ref_op = dasp_tpu.SpMVOperator(ref_csr, dtype="f32", backend="pallas",
                                   config=dasp_tpu.DaspConfig(row_sort="off"))
    if solved_before:
        cg_solver.cg_solve(op, np.random.default_rng(2).standard_normal(512),
                           tol=1e-5, maxiter=300)
    x, res, iters = cg_solver.cg_solve(op, b, tol=1e-5, maxiter=300)
    assert _reused(1) == [int(solved_before)]
    x_ref, res_ref, iters_ref = ref_cg.cg_solve(ref_op, b, tol=1e-5,
                                                maxiter=300)
    x_ref = np.asarray(x_ref, dtype=np.float64)
    assert abs(iters - int(iters_ref)) <= 2, (iters, int(iters_ref))
    assert (np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)) < 1e-4
    assert res <= 1e-5 and float(res_ref) <= 1e-5


def test_cg_matches_jax_example():
    _cg_against_jax(solved_before=False)


def test_cg_on_a_kept_state_matches_jax_example():
    """The path every solve after an operator's first takes, against the
    reference."""
    _cg_against_jax(solved_before=True)


def test_cg_keeps_one_state_per_operator(rng):
    """b1, b2, b1 on one operator: the first solve builds the state, the
    others restart it; the third is bitwise the first, and a later solve
    leaves the caller's b and the x an earlier one returned alone."""
    csr = cg_solver.build_spd(512, rng)
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu", config=SHARED)
    b1, b2 = rng.standard_normal((2, csr.n_rows))
    b1_given = b1.copy()
    first = _cg(op, b1)
    state, x1 = op._cg_state, first[0].copy()
    _cg(op, b2)
    third = _cg(op, b1)
    assert _reused(3) == [0, 1, 1] and op._cg_state is state
    np.testing.assert_array_equal(first[0], x1)
    np.testing.assert_array_equal(b1, b1_given)
    _same_solve(third, first)
    assert first[2] > 0


@pytest.mark.parametrize("dtype,tol", [("f64", None), ("f32", 1e-5),
                                       ("bf16", 1e-2)])
def test_cg_on_a_kept_state_is_a_fresh_operators_solve(rng, dtype, tol):
    csr = cg_solver.build_spd(256, rng)   # 4 and -1 are exact in bf16
    kept = dt.SpMVOperator(csr, dtype=dtype, device="cpu", config=SHARED)
    b1, b2 = rng.standard_normal((2, csr.n_rows))
    _cg(kept, b1, tol)
    got = _cg(kept, b2, tol)
    fresh = dt.SpMVOperator(csr, dtype=dtype, device="cpu", config=SHARED)
    want = _cg(fresh, b2, tol)
    assert _reused(3) == [0, 1, 0]
    _same_solve(got, want)


def test_cg_runs_one_solve_at_a_time_per_operator(rng):
    """Eight threads solving on one operator each get the serial answers:
    the operator's lock holds each solve over its whole span, so none
    runs on the state while another does."""
    csr = cg_solver.build_spd(256, rng)
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu", config=SHARED)
    bs = rng.standard_normal((4, csr.n_rows))
    want = [_cg(op, b) for b in bs]
    got = {}

    def work(i):
        for k in range(3):
            got[i, k] = _cg(op, bs[(i + k) % 4])
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 24
    for (i, k), solve in got.items():
        _same_solve(solve, want[(i + k) % 4])


def test_pagerank_matches_jax_example():
    import pagerank as ref_pr
    csr = pagerank.build_transition(1500, np.random.default_rng(0))
    ref_csr = ref_pr.build_transition(1500, np.random.default_rng(0))
    _same_matrix(csr, ref_csr)
    op = dt.SpMVOperator(csr, dtype="f32", device="cpu", config=SHARED)
    ref_op = dasp_tpu.SpMVOperator(ref_csr, dtype="f32", backend="pallas",
                                   config=dasp_tpu.DaspConfig(row_sort="off"))
    r = pagerank.pagerank(op, iters=30)
    r_ref = np.asarray(ref_pr.pagerank(ref_op, iters=30), dtype=np.float64)
    assert r.shape == r_ref.shape == (1500,)
    assert np.abs(r - r_ref).max() <= 1e-4 * np.abs(r_ref).max()


def test_iteration_costs(rng):
    csr = cg_solver.build_spd(256, rng)
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu", config=SHARED,
                         force_streamed=True)
    ms = cg_solver.iteration_costs(op, csr.spmv(np.ones(256)), 5)
    assert set(ms) == {"synced", "device", "spmv"}
    assert all(v > 0 for v in ms.values())


@pytest.mark.parametrize("mod,argv", [
    (cg_solver, ["256", "f64", "cpu"]), (cg_solver, ["256", "f32", "cpu"]),
    (pagerank, ["1500", "cpu"])])
def test_example_main_exit_code(mod, argv, capsys):
    assert mod.main(argv) == 0
    assert "rel err" in capsys.readouterr().out
