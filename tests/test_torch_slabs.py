"""Huge column spaces: where the JAX package splits n_cols beyond its x
table budget into column slabs (SlabbedPallasSpMV), the port keeps ONE
plan, its x table living in device memory.  The matrix of
tests/test_wplan.py:test_column_slabs through both, and the golden."""

import numpy as np
import pytest
import torch

from dasp_tpu.ops.pallas_backend import SlabbedPallasSpMV
from dasp_tpu.sparse import CSRMatrix as RefCSR
from dasp_tpu_torch import SpMVOperator
from dasp_tpu_torch.sparse import CSRMatrix
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()


def _slab_matrix(rng, n=128, m=180_000):
    # columns spread over all slabs but locally clustered (fast routing)
    lens = rng.integers(1, 30, n)
    rpt = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=rpt[1:])
    rows = np.repeat(np.arange(n), lens)
    cols = np.clip(rows * (m // n) + rng.integers(0, 500, int(lens.sum())),
                   0, m - 1).astype(np.int32)
    order = np.lexsort((cols, rows))
    return CSRMatrix(n, m, rpt, cols[order],
                     rng.standard_normal(int(lens.sum())))


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("f64", 1e-10)])
def test_one_plan_matches_column_slabs(rng, dtype, tol):
    csr = _slab_matrix(rng)
    ref = SlabbedPallasSpMV(
        RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx, csr.values),
        dtype=dtype, slab_cols=64_000)
    assert len(ref.slabs) == 3
    op = SpMVOperator(csr, dtype=dtype, device="cpu")
    # one plan whose x table spans every slab's columns
    assert op._meta.n_cols == csr.n_cols
    assert op._meta.s_rows * 128 >= csr.n_cols > 2 * 64_000
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    scale = np.maximum(np.abs(golden), 1.0)
    y = op(x)
    y_ref = np.asarray(ref(x), dtype=np.float64)
    assert (np.abs(y - golden) / scale).max() <= tol
    assert (np.abs(y - y_ref) / scale).max() <= 2 * tol
    # the resident loop and matmat on the same plan
    y_loop = op.perm_out(op.timing_loop(2)(op._prep_x(x)).numpy())
    assert op.resident and (np.abs(y_loop - golden) / scale).max() <= tol
    X = rng.standard_normal((csr.n_cols, 3))
    Y = op.matmat(X)
    for j in range(3):
        g = csr.spmv(X[:, j])
        assert (np.abs(Y[:, j] - g) / np.maximum(np.abs(g), 1.0)
                ).max() <= tol
