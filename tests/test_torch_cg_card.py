"""On a CUDA card: the CG solver's kept state (``examples/cg_solver.py``).
A later solve on an operator allocates nothing and is bitwise a fresh
operator's solve, and the state goes with its operator.  Without a card
it skips inside the test.  It imports no JAX, so it runs where JAX is
absent, without ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cg_card.py -q
"""

import gc

import numpy as np
import pytest
import torch

import dasp_tpu_torch as dt
from dasp_tpu_torch.examples import cg_solver

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
