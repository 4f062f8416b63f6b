"""The port on an R-MAT graph (``benchmark/matrices/rmat.py``), the pattern
of the benchmark's ``rmat_f32`` configuration: the generator against the
suite's ``rmat_like`` at wiki-Talk's size, the f32 SpMM pass on a small
graph of the same kind (empty rows, rows of 1-4 entries, long rows and a
COO residue) against the plain reference, and the counts of the lowered
tables on the ``op.lower`` span against the plan and K6's schedule."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from dasp_tpu_torch import DaspConfig, SpMVOperator, build_wplan, trace
from dasp_tpu_torch.bench.suite import PUBLISHED, SUITE
from dasp_tpu_torch.io.build import ensure_built
from dasp_tpu_torch.ops import cuda_backend
from dasp_tpu_torch.sparse import CSRMatrix
from dasp_tpu_torch.wplan import LANES, SUB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference.csr import Csr, product  # noqa: E402

torch.set_num_threads(1)
ensure_built()

_spec = importlib.util.spec_from_file_location(
    "_rmat_generator", os.path.join(ROOT, "benchmark", "matrices",
                                    "rmat.py"))
rmat = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rmat)

SKEW = {"a": 0.57, "b": 0.19, "c": 0.19}
# wiki-Talk's 2.1 entries a row, at a size that packs in about a second
SMALL = dict(SKEW, n=200_000, nnz=420_000, pattern_seed=0)
F32_TOL = 2e-5


@pytest.fixture(scope="module")
def small():
    """(the matrix as the reference holds it, its plan)."""
    n, _, row_ptr, col_idx = rmat.pattern(SMALL)
    vals = rmat.values(len(col_idx), 11).astype(np.float32)
    plan = build_wplan(CSRMatrix(n, n, row_ptr, col_idx, vals),
                       DaspConfig())
    return Csr(n, n, row_ptr, col_idx, vals), plan


def test_the_small_graph_has_every_kind_of_row(small):
    a, plan = small
    lens = np.diff(a.row_ptr)
    c = plan.census
    assert a.nnz == SMALL["nnz"] and a.n_rows == SMALL["n"]
    assert c["row_zero"] == int((lens == 0).sum()) > a.n_rows // 2
    assert c["row_long"] > 0 and c["nnz_long"] > 0
    assert min(c[f"short_row_{k}"] for k in range(1, 5)) > 0
    assert plan.overflow is not None and plan.overflow.nnz > 0
    assert plan.row_perm is not None and plan.col_perm is not None
    assert not np.array_equal(plan.row_perm, plan.col_perm)


@pytest.mark.parametrize("k", [8, 3])
def test_the_f32_pass_matches_the_plain_reference(small, k):
    """k = 8: one pass of 8; k = 3: a short pass, padded to 4 tables."""
    a, plan = small
    op = SpMVOperator(plan, dtype="f32", device="cpu")
    X = np.random.default_rng(k).standard_normal((a.n_cols, k)).astype(
        np.float32)
    Y = op.matmat(X)
    golden = product(a, X)
    assert Y.shape == golden.shape and Y.dtype == np.float32
    err = np.abs(Y - golden) / np.maximum(np.abs(golden), 1.0)
    assert float(err.max()) <= F32_TOL


def test_the_generator_draws_the_suites_rmat_like_at_wiki_talks_size():
    n, _, nnz, _ = PUBLISHED["wiki-Talk"]
    assert (n, nnz) == (2_394_385, 5_021_410)
    n_rows, n_cols, row_ptr, col_idx = rmat.pattern(
        dict(SKEW, n=n, nnz=nnz, pattern_seed=0))
    assert (n_rows, n_cols, int(row_ptr[-1])) == (n, n, nnz)
    suite = SUITE["rmat_like"](np.random.default_rng(0))
    assert row_ptr.dtype == suite.row_ptr.dtype == np.int64
    assert col_idx.dtype == suite.col_idx.dtype == np.int32
    assert np.array_equal(row_ptr, suite.row_ptr)
    assert np.array_equal(col_idx, suite.col_idx)


@pytest.mark.parametrize("repack_min", [cuda_backend.RES_REPACK_MIN, 512])
def test_op_lower_counts_what_the_tables_hold(small, repack_min,
                                              monkeypatch):
    """At 512 the residue is repacked as a sub-plan, which K6 does not
    read: the slots stay those of its schedule."""
    a, plan = small
    monkeypatch.setattr(cuda_backend, "RES_REPACK_MIN", repack_min)
    n0 = len(trace.records())
    op = SpMVOperator(plan, dtype="f32", device="cpu")
    lower = [r for r in trace.records()[n0:] if r.name == "op.lower"]
    assert len(lower) == 1
    counts = lower[0].counts
    assert (op._meta.res is not None) == (plan.overflow.nnz >= repack_min)
    res = op._arrays["resident"]
    read = (int(res["items"][:, 2].sum()) * SUB * LANES
            + int(res["res_ent"][:, 1].sum()))
    assert counts == {"slots": read, "nnz": a.nnz,
                      "residue_nnz": plan.overflow.nnz,
                      "long_nnz": plan.census["nnz_long"]}
    assert counts["slots"] >= a.nnz
