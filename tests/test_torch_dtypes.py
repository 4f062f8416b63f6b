"""The port's bf16 and f64 SpMV paths end to end, on the CPU:
``SpMVOperator(dtype=...)`` (device="cpu", the plain versions of K1/K3 and
K2/K4 under the same glue) against the JAX package's
``PallasSpMV(dtype=..., force_streamed=True)`` in interpret mode, and both
against the CSR golden.

Tolerances, on the error scaled by max(|golden|, 1):
- f64 1e-10 (tests/test_wplan.py:228,245): the port is native fp64, the
  reference double-double (~2^-44 per operation), both far inside it;
- bf16 5e-2 against the golden of the bf16-rounded A and x
  (tests/test_spmv.py:16-33,49): y itself is rounded to bf16 (2^-8 of
  |y|) and x stays f32 (within 2^-8 of the rounded x the golden uses);
  port against reference 1e-2: the same bf16 values and f32 x, sums that
  differ only in order, then one rounding to bf16 each, which can land
  one bf16 step (at most 2^-7 of |y|) apart.

Not mirrored, because they test the reference's double-double storage
tiers, which the port's native fp64 does not have: test_spmv_dd_lo_bf16_gate
(the bf16 store of the lo values), test_spmv_dd_f32_colsum_tier (f32
colsums in a dd plan) and test_spmv_strict_f64_disables_tiers (the flag
that turns both off; the port accepts ``strict_f64`` and is always strict,
see test_strict_f64_changes_nothing).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from dasp_tpu.config import DaspConfig as RefConfig
from dasp_tpu.ops import pallas_backend as pb
from dasp_tpu.sparse import CSRMatrix as RefCSR
import dasp_tpu_torch as dt
from dasp_tpu_torch import sparse as tsp
from dasp_tpu_torch.config import DaspConfig
from dasp_tpu_torch.ops import cuda_backend as cb

torch.set_num_threads(1)
TOL = {"f32": 2e-5, "f64": 1e-10, "bf16": 5e-2}
TOL_BF16_VS_REF = 1e-2

# tests/test_spmv.py:36-42
GOLDEN_CASES = {
    "mixed": lambda rng: tsp.mixed_categories(700, rng),
    "fem": lambda rng: tsp.fem_like(500, 30, rng),
    "powerlaw": lambda rng: tsp.powerlaw_like(600, 1.8, 5000, rng),
    "all_short": lambda rng: tsp.random_csr(
        900, 900, rng.integers(0, 5, size=900), rng),
}
# tests/test_wplan.py:96-101
DD_CASES = {
    "tiny": lambda rng: tsp.random_csr(10, 12, np.array(
        [0, 1, 2, 3, 4, 5, 9, 2, 0, 7]), rng),
    "mixed": lambda rng: tsp.mixed_categories(500, rng),
    "powerlaw": lambda rng: tsp.powerlaw_like(400, 1.8, 3000, rng),
}


def _ref(csr):
    return RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  csr.values)


def _pallas(csr_or_plan, dtype, config=None):
    """The reference operator on its streamed path, the path the port
    runs."""
    return pb.PallasSpMV(csr_or_plan, dtype=dtype, config=config,
                         force_streamed=True)


def _golden(csr, x, dtype):
    """The CSR golden; for bf16 that of the bf16-rounded A and x."""
    if dtype != "bf16":
        return csr.spmv(x)
    r = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)
    return tsp.CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                         r(csr.values)).spmv(r(x))


def _check(y_port, y_ref, golden, dtype):
    y_port = np.asarray(y_port, dtype=np.float64)
    y_ref = np.asarray(y_ref).astype(np.float64)
    scale = np.maximum(np.abs(golden), 1.0)
    tol = TOL[dtype]
    np.testing.assert_allclose(y_port / scale, golden / scale,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(y_ref / scale, golden / scale,
                               rtol=tol, atol=tol)
    tol = TOL_BF16_VS_REF if dtype == "bf16" else tol
    np.testing.assert_allclose(y_port / scale, y_ref / scale,
                               rtol=tol, atol=tol)


def _run(csr, x, dtype, **kw):
    y = dt.SpMVOperator(csr, dtype=dtype, device="cpu", **kw)(x)
    assert y.shape == (csr.n_rows,)
    assert y.dtype == (np.float64 if dtype == "f64" else np.float32)
    if dtype == "bf16":     # bf16 values carried as float32
        np.testing.assert_array_equal(
            y, y.astype(ml_dtypes.bfloat16).astype(np.float32))
    return y


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
@pytest.mark.parametrize("dtype", ["f64", "bf16"])
def test_spmv_golden(name, dtype):
    """The f64 and bf16 arms of tests/test_spmv.py:test_spmv_golden."""
    rng = np.random.default_rng(0)
    csr = GOLDEN_CASES[name](rng)
    x = rng.standard_normal(csr.n_cols)
    _check(_run(csr, x, dtype), _pallas(_ref(csr), dtype)(x),
           _golden(csr, x, dtype), dtype)


@pytest.mark.parametrize("name", list(DD_CASES))
def test_pallas_f64_dd_precision(name):
    """tests/test_wplan.py:test_pallas_f64_dd_precision at 1e-10."""
    rng = np.random.default_rng(0)
    csr = DD_CASES[name](rng)
    x = rng.standard_normal(csr.n_cols)
    _check(_run(csr, x, "f64"), _pallas(_ref(csr), "f64")(x), csr.spmv(x),
           "f64")


def test_f64_precision_beats_f32():
    """One 4096-long row of +-1e7 pairs that cancel to 1.0: f64 recovers
    it (tests/test_spmv.py:test_f64_precision_beats_f32), f32 cannot."""
    rng = np.random.default_rng(0)
    n = 4096
    csr = tsp.random_csr(1, n, np.array([n]), rng)
    v = np.zeros(n)
    v[0::2] = 1e7
    v[1::2] = -1e7
    v[1] += 1.0
    csr.values = v
    x = np.ones(n)
    golden = csr.spmv(x)
    y64 = _run(csr, x, "f64")
    assert abs(y64[0] - golden[0]) < 1e-6
    assert abs(_pallas(_ref(csr), "f64")(x)[0] - golden[0]) < 1e-6
    y32 = _run(csr, x, "f32")
    assert abs(float(y32[0]) - golden[0]) > abs(y64[0] - golden[0])


def test_spmv_long_rows_only():
    """tests/test_spmv.py:test_spmv_long_rows_only[f64], at 1e-10."""
    rng = np.random.default_rng(0)
    csr = tsp.random_csr(6, 4000, np.array([256, 300, 1000, 2048, 257,
                                            4000]), rng)
    x = rng.standard_normal(csr.n_cols)
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu")
    assert op._meta.n_long, "fixture must take the long-row path"
    _check(op(x), _pallas(_ref(csr), "f64")(x), csr.spmv(x), "f64")


def test_scattered_long_stays_static():
    """tests/test_wplan.py:test_scattered_long_stays_static, f64 at
    1e-10: scattered long rows over 400k columns, P up to 32."""
    rng = np.random.default_rng(0)
    csr = tsp.random_csr(200, 400_000, np.where(
        np.arange(200) % 50 == 0, 2000, 3), rng)
    op = dt.SpMVOperator(csr, dtype="f64", config=DaspConfig(relabel="off"),
                         device="cpu")
    assert all(P <= 32 for P, _, _ in op._meta.streams)
    assert any(P >= 16 for P, _, _ in op._meta.streams)
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(_ref(csr), "f64", RefConfig(relabel="off"))
    _check(op(x), ref(x), csr.spmv(x), "f64")


def _residue_fixture():
    rng = np.random.default_rng(0)
    n = 40_000
    return tsp.random_csr(n, n, rng.integers(1, 8, size=n), rng), rng


def test_pallas_residue_subplan_matches_golden(monkeypatch):
    """The f64 case of tests/test_wplan.py:
    test_pallas_residue_subplan_matches_golden (RES_REPACK_MIN=1 in both
    packages), at 1e-10."""
    monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
    monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    csr, rng = _residue_fixture()
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu")
    assert op._meta.res is not None, "sub-plan path not taken"
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(pb.build_wplan(_ref(csr)), "f64")
    assert ref._meta.res is not None
    _check(op(x), ref(x), csr.spmv(x), "f64")


def test_bf16_residue_subplan_joins_in_f32(monkeypatch):
    """A bf16 plan's residue sub-plan y is added to y in f32 and the sum
    rounded once.  The reference rounds the sub-plan's y to bf16 before
    adding it (pallas_backend.py:1012), a defect the port does not copy:
    that order would give another y on this fixture.  The sub-plan joins
    in the reference-order glue (``spmv_fn`` on the tables without their
    K6 schedule, and ``spmm_fn``); ``op(x)``, one K6 step that sums the
    residue by its trees and runs no sub-plan, is held to the golden."""
    monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
    monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    csr, rng = _residue_fixture()
    op = dt.SpMVOperator(csr, dtype="bf16", device="cpu")
    meta = op._meta
    assert meta.res is not None, "sub-plan path not taken"
    x = rng.standard_normal(csr.n_cols)
    x2d = op._prep_x(x)
    glue = dict(op._arrays, resident=None)
    y = cb.spmv_fn(meta, glue, x2d)
    assert y.dtype == torch.bfloat16
    wide = cb._wide(meta, op._arrays, x2d.unsqueeze(0), False, False)[0]
    assert wide.dtype == torch.float32
    assert torch.equal(y, wide.to(torch.bfloat16))
    # the reference's order: the sub-plan's y rounded to bf16 first
    orig = cb._wide

    def rounded_sub(m, arrays, xt, plain, multi):
        ys = orig(m, arrays, xt, plain, multi)
        return ys.to(torch.bfloat16).float() if m is meta.res else ys
    monkeypatch.setattr(cb, "_wide", rounded_sub)
    assert not torch.equal(cb.spmv_fn(meta, glue, x2d), y), \
        "fixture no longer tells the two orders apart"
    monkeypatch.setattr(cb, "_wide", orig)
    golden = _golden(csr, x, "bf16")
    scale = np.maximum(np.abs(golden), 1.0)
    np.testing.assert_allclose(op(x) / scale, golden / scale,
                               rtol=TOL["bf16"], atol=TOL["bf16"])


def test_prebuilt_wplan_shared_across_dtypes():
    """One WPlan serves every dtype (tests/test_spmv.py:
    test_prebuilt_wplan_shared_across_dtypes), here with bf16 too; the
    reference's operators on this fixture are held in test_spmv_golden."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    plan = dt.build_wplan(csr)
    x = rng.standard_normal(csr.n_cols)
    for dtype in ("f32", "bf16", "f64"):
        op = dt.SpMVOperator(plan, dtype=dtype, device="cpu")
        assert op.plan is plan and op.dtype == dtype
        tol = TOL[dtype]
        golden = _golden(csr, x, dtype)
        scale = np.maximum(np.abs(golden), 1.0)
        np.testing.assert_allclose(op(x) / scale, golden / scale,
                                   rtol=tol, atol=tol)


def test_strict_f64_changes_nothing():
    """DaspConfig(strict_f64=True) is accepted; the port's f64 is always
    strict, so y is the same bit for bit."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    x = rng.standard_normal(csr.n_cols)
    y = dt.SpMVOperator(csr, dtype="f64", device="cpu")(x)
    ys = dt.SpMVOperator(csr, dtype="f64", device="cpu",
                         config=DaspConfig(strict_f64=True))(x)
    np.testing.assert_array_equal(y, ys)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_timing_loop_chain(dtype, monkeypatch):
    """On the streamed path (force_streamed; the resident one is held in
    tests/test_torch_resident.py), timing_loop(iters) runs iters chained
    SpMVs, each adding y[0]*TAP into (a copy of) x in x's dtype, then
    returns one more SpMV's y.  TAP is raised from 1e-36 so that a skipped
    or misplaced tap shows."""
    monkeypatch.setattr(cb, "TAP", 0.25)
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu", force_streamed=True)
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    keep = x2d.clone()
    got = op.timing_loop(3)(x2d)
    assert torch.equal(x2d, keep), "timing_loop must not write its input"
    x = x2d.clone()
    for _ in range(3):
        y = op.device_call(x)
        x = x + y[0].to(x.dtype) * 0.25
    want = op.device_call(x)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert not torch.equal(got, op.device_call(x2d))
    assert torch.equal(op.timing_loop(0)(x2d), op.device_call(x2d))
