"""On a CUDA card: the CG solver's kept state (``examples/cg_solver.py``).
A later solve on an operator allocates nothing and is bitwise a fresh
operator's solve, and the state goes with its operator.  The graph of a
block of iterations, read back once a replay, is bitwise the loop that
replays one iteration and reads rs back after each.  Without a card
it skips inside the test.  It imports no JAX, so it runs where JAX is
absent, without ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cg_card.py -q
"""

import gc
import math

import numpy as np
import pytest
import torch

import dasp_tpu_torch as dt
from dasp_tpu_torch.examples import cg_solver
from dasp_tpu_torch.utils import graphed

# the packing of the benchmark's hpcg104_f64: x and y in natural order
CONFIG = dt.DaspConfig(row_sort="off", relabel="off")


def _allocated() -> int:
    """Bytes the caching allocator holds for tensors, less cuBLAS's
    workspaces, which it keeps per stream for the process's life."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


@pytest.mark.card
def test_a_later_solve_on_the_card_allocates_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(19)
    csr = cg_solver.build_spd(1 << 16, rng)
    b1, b2 = (csr.spmv(1.0 + rng.random(csr.n_cols)) for _ in range(2))
    before = _allocated()
    op = dt.SpMVOperator(csr, dtype="f64", device="cuda", config=CONFIG)
    cg_solver.cg_solve_f64(op, b1)
    got = cg_solver.cg_solve_f64(op, b2)
    solves = [r for r in dt.trace.records() if r.name == "cg.solve"][-2:]
    setups = [r for r in dt.trace.records() if r.name == "cg.setup"][-2:]
    assert [s.counts["reused"] for s in setups] == [0, 1]
    assert solves[1].counts["device_allocs"] == 0, solves
    assert solves[1].counts["host_allocs"] == 0, solves
    fresh = dt.SpMVOperator(csr, dtype="f64", device="cuda", config=CONFIG)
    want = cg_solver.cg_solve_f64(fresh, b2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] > 0, (got[1:], want[1:])
    del op, fresh
    gc.collect()
    after = _allocated()
    assert after - before <= 1 << 20, (before, after)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_the_graphed_block_on_the_card_is_the_loop_of_one_at_a_time(dtype):
    """In fp64 to cg_solve_f64's tol; in f32 (the vectors of f32 and bf16
    operators) to 1e-6 of |b|, the f32 scalar kernels' path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(23)
    csr = cg_solver.build_spd(1 << 16, rng)
    b1, b2 = (csr.spmv(1.0 + rng.random(csr.n_cols)) for _ in range(2))
    op = dt.SpMVOperator(csr, dtype=dtype, device="cuda", config=CONFIG)
    rtol = 1e-10 if dtype == "f64" else 1e-6
    for b in (b1, b2):
        b = b.astype(np.float64 if dtype == "f64" else np.float32)
        tol = rtol * float(np.linalg.norm(b))
        got = cg_solver.cg_solve(op, b, tol, 4000)
        counts = {r.name: r.counts for r in dt.trace.records()[-4:]}
        # the loop before the stop test moved onto the device: one
        # iteration a replay, its scalars in PyTorch's kernels, then the
        # read-back of rs
        ref = cg_solver.CGIteration(op, op.perm_in(b), tol, 4000)
        ref.alpha, ref.advance = ref.alpha_plain, ref.advance_plain
        one = graphed(ref.raw_step)
        ref.reset()
        rs, it = float(ref.rs), 0
        while rs > tol * tol and it < 4000:
            one()
            rs = float(ref.rs)
            it += 1
        np.testing.assert_array_equal(got[0],
                                      op.perm_out(ref.x.cpu().numpy()))
        assert got[1:] == (math.sqrt(rs), it) and it > cg_solver.K
        reads = -(-it // cg_solver.K)
        assert counts["cg.iterate"]["readbacks"] == reads
        assert counts["cg.iterate"]["frozen"] == reads * cg_solver.K - it
        del ref, one
    assert counts["cg.solve"]["device_allocs"] == 0, counts
    assert counts["cg.solve"]["host_allocs"] == 0, counts


def _scalars(dtype, rs, tol2, count, maxiter):
    """The tensors ``CGIteration``'s scalar kernels read and write."""
    st = cg_solver.CGIteration.__new__(cg_solver.CGIteration)
    st.rs = torch.tensor(rs, dtype=dtype, device="cuda")
    st.tol2 = torch.tensor(tol2, dtype=torch.float64, device="cuda")
    st.count = torch.tensor(count, dtype=torch.int64, device="cuda")
    st.maxiter = torch.tensor(maxiter, dtype=torch.int64, device="cuda")
    st.live = torch.zeros((), dtype=torch.bool, device="cuda")
    return st


def _bits(t):
    return t.view({torch.float64: torch.int64, torch.float32: torch.int32}
                  .get(t.dtype, t.dtype)).item()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_scalar_kernels_are_their_plain_versions(dtype):
    """alpha and advance, one Triton launch each, against alpha_plain and
    advance_plain bit for bit: live, frozen by tol (rs at tol2 too) and by
    the count, and p . Ap = 0 where frozen."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(29)
    eps = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    n = 0
    for _ in range(40):
        rs, pap, rs_new = (float(torch.tensor(10.0 ** rng.uniform(-30, 8),
                                              dtype=dtype))
                           for _ in range(3))
        for tol2 in (rs * 0.5, rs, rs * (1 - eps.eps), rs * 2):
            for count, maxiter in ((3, 10), (10, 10)):
                for q in (pap, 0.0):
                    got = _scalars(dtype, rs, tol2, count, maxiter)
                    want = _scalars(dtype, rs, tol2, count, maxiter)
                    d = {"dtype": dtype, "device": "cuda"}
                    a = got.alpha(torch.tensor(q, **d))
                    b = want.alpha_plain(torch.tensor(q, **d))
                    f = got.advance(torch.tensor(rs_new, **d))
                    g = want.advance_plain(torch.tensor(rs_new, **d))
                    for x, y in ((a, b), (f, g), (got.live, want.live),
                                 (got.rs, want.rs), (got.count, want.count)):
                        assert _bits(x) == _bits(y), (rs, tol2, count, q)
                    n += bool(want.live)
    assert 0 < n < 40 * 16
