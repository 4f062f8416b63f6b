"""The port's f32 SpMV slice end to end, on the CPU: ``SpMVOperator``
(device="cpu", the plain versions of K1/K2 under the same glue) against
the JAX package's ``PallasSpMV(dtype="f32")`` in interpret mode, and
both against the CSR golden.

Tolerance 2e-5 on the error scaled by max(|golden|, 1), the f32 rule of
tests/test_wplan.py:195-204.
"""

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
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = 2e-5

CASES = {
    "tiny": lambda rng: tsp.random_csr(10, 12, np.array(
        [0, 1, 2, 3, 4, 5, 9, 2, 0, 7]), rng),
    "fem": lambda rng: tsp.fem_like(400, 20, rng),
    "powerlaw": lambda rng: tsp.powerlaw_like(400, 1.8, 3000, rng),
    "mixed": lambda rng: tsp.mixed_categories(500, rng),
    "empty": lambda rng: tsp.random_csr(50, 50, np.zeros(50, np.int64), rng),
    "identity": lambda rng: tsp.CSRMatrix(
        300, 300, np.arange(301, dtype=np.int64),
        np.arange(300, dtype=np.int32), np.ones(300)),
    "wide_cols": lambda rng: tsp.random_csr(
        64, 300_000, rng.integers(1, 40, 64), rng),
    "powerlaw_deg": lambda rng: tsp.powerlaw_like(20_000, 1.7, 20_000, rng,
                                                  col_alpha=1.6),
    "circuit": lambda rng: tsp.circuit_like(6000, rng),
}
RELABEL_CASES = {k: CASES[k] for k in ("powerlaw", "powerlaw_deg",
                                        "circuit")}


def _ref(csr):
    return RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  csr.values)


def _pallas(csr_or_plan, config=None):
    """The reference operator on its streamed path, the path the port
    runs (the port skips the resident executor's set-up, which also
    fails on a matrix with no nonzeros)."""
    return pb.PallasSpMV(csr_or_plan, dtype="f32", config=config,
                         force_streamed=True)


def _check(y_port, y_ref, golden):
    scale = np.maximum(np.abs(golden), 1.0)
    np.testing.assert_allclose(y_port / scale, golden / scale,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y_ref / scale, golden / scale,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y_port / scale, y_ref / scale,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_slice_matches_pallas_and_golden(name):
    rng = np.random.default_rng(0)
    csr = CASES[name](rng)
    x = rng.standard_normal(csr.n_cols)
    op = dt.SpMVOperator(csr, dtype="f32", device="cpu")
    y = op(x)
    assert y.shape == (csr.n_rows,) and y.dtype == np.float32
    _check(y, _pallas(_ref(csr))(x), csr.spmv(x))
    if name == "empty":
        np.testing.assert_array_equal(y, np.zeros(50))
    if name == "identity":
        np.testing.assert_allclose(y, x.astype(np.float32), rtol=1e-6)


@pytest.mark.parametrize("name", list(RELABEL_CASES))
def test_slice_relabel_matches_pallas_and_golden(name):
    """config.relabel is transparent (test_relabel_matches_golden)."""
    rng = np.random.default_rng(0)
    csr = RELABEL_CASES[name](rng)
    op = dt.SpMVOperator(csr, config=DaspConfig(relabel="first_touch"),
                         device="cpu")
    assert op.plan.col_perm is not None
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(_ref(csr), RefConfig(relabel="first_touch"))
    _check(op(x), ref(x), csr.spmv(x))


@pytest.mark.parametrize("tier,name", [("scatter", "scattered"),
                                       ("route", "scattered_long")])
def test_slice_residue_tiers(tier, name):
    """The COO residue's terminal tiers: the sorted scatter (fb_rows) and
    the y2 lane-table route through a free outgather slot."""
    rng = np.random.default_rng(0)
    if name == "scattered":
        csr = tsp.random_csr(300, 5000, rng.integers(1, 60, 300), rng)
    else:     # long rows over 400k columns (tests/test_wplan.py:113)
        csr = tsp.random_csr(200, 400_000, np.where(
            np.arange(200) % 50 == 0, 2000, 3), rng)
    op = dt.SpMVOperator(csr, config=DaspConfig(relabel="off"),
                         device="cpu")
    assert op._meta.overflow_meta == (tier,)
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(_ref(csr), RefConfig(relabel="off"))
    _check(op(x), ref(x), csr.spmv(x))


def test_slice_relabel_symmetric_square():
    """Square matrices relabel symmetrically: x and y share one internal
    space (test_relabel_symmetric_square)."""
    rng = np.random.default_rng(0)
    csr = tsp.powerlaw_like(1500, 1.7, 1500, rng, col_alpha=1.6)
    op = dt.SpMVOperator(csr, config=DaspConfig(relabel="first_touch",
                                                row_sort="off"),
                         device="cpu")
    assert op.plan.row_perm is not None
    assert np.array_equal(op.plan.row_perm, op.plan.col_perm)
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    ref = _pallas(_ref(csr), RefConfig(relabel="first_touch",
                                       row_sort="off"))
    _check(op(x), ref(x), golden)
    v = rng.standard_normal(csr.n_cols)
    np.testing.assert_array_equal(op.perm_out(op.perm_in(v)), v)
    # the raw device call's y is in the shared internal space
    y_dev = op.device_call(op._prep_x(x)).numpy()
    y_int = np.empty_like(golden)
    y_int[op.plan.row_perm] = golden
    si = np.maximum(np.abs(y_int), 1.0)
    np.testing.assert_allclose(y_dev / si, y_int / si, rtol=TOL, atol=TOL)


def test_slice_row_sort_composes_with_sym_relabel():
    """Length-grouping composes on top of the symmetric relabel
    (row_perm != col_perm) and stays transparent
    (test_row_sort_composes_with_sym_relabel)."""
    rng = np.random.default_rng(0)
    csr = tsp.powerlaw_like(2000, 1.7, 2000, rng, col_alpha=1.5)
    op = dt.SpMVOperator(csr, config=DaspConfig(relabel="first_touch"),
                         device="cpu")
    assert op.plan.col_perm is not None and op.plan.row_perm is not None
    assert not np.array_equal(op.plan.row_perm, op.plan.col_perm)
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(_ref(csr), RefConfig(relabel="first_touch"))
    _check(op(x), ref(x), csr.spmv(x))


def test_slice_prebuilt_wplan():
    """A prebuilt WPlan is accepted as it is (no repack)."""
    rng = np.random.default_rng(0)
    csr = CASES["mixed"](rng)
    plan = dt.build_wplan(csr)
    op = dt.SpMVOperator(plan, device="cpu")
    assert op.plan is plan
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(pb.build_wplan(_ref(csr)))
    _check(op(x), ref(x), csr.spmv(x))


def test_slice_residue_subplan(monkeypatch):
    """Large COO residues run as a repacked sub-plan (WMeta.res), forced
    by RES_REPACK_MIN=1 in both packages
    (test_pallas_residue_subplan_matches_golden)."""
    monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
    monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    rng = np.random.default_rng(0)
    n = 40_000
    csr = tsp.random_csr(n, n, rng.integers(1, 8, size=n), rng)
    op = dt.SpMVOperator(csr, device="cpu")
    assert op.plan.overflow is not None and op.plan.overflow.nnz
    assert op._meta.res is not None, "sub-plan path not taken"
    x = rng.standard_normal(csr.n_cols)
    ref = _pallas(pb.build_wplan(_ref(csr)))
    assert ref._meta.res is not None
    _check(op(x), ref(x), csr.spmv(x))


def test_slice_runs_reference_tables():
    """The reference's lowered tables, carried across (without a K6
    schedule, so ``spmv_fn`` runs the reference-order glue on them), give
    the same y, bit for bit, as the port's own tables without their
    schedule; the port's one-step K6 y, which sums in another order,
    agrees at TOL."""
    rng = np.random.default_rng(0)
    csr = CASES["mixed"](rng)
    op = dt.SpMVOperator(csr, device="cpu")
    x = rng.standard_normal(csr.n_cols)
    x2d = op._prep_x(x)
    meta, arrays = cb.arrays_from_reference(
        *pb.plan_to_arrays(pb.build_wplan(_ref(csr)), "f32"), "cpu")
    assert arrays["resident"] is None
    y = cb.spmv_fn(meta, arrays, x2d)
    np.testing.assert_array_equal(
        y.numpy(), cb.spmv_fn(op._meta, dict(op._arrays, resident=None),
                              x2d).numpy())
    golden = csr.spmv(x)
    _check(op.perm_out(op.device_call(x2d).numpy()),
           op.perm_out(y.numpy()), golden)


def test_operator_dtypes_and_entry_points():
    rng = np.random.default_rng(0)
    csr = CASES["fem"](rng)
    for dtype in ("f16", "fp8", "f32x2"):
        with pytest.raises(ValueError):
            dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    x = rng.standard_normal(csr.n_cols)
    y = dt.spmv(csr, x, device="cpu")
    assert dt.verify(csr, y, x, rtol=TOL)
    # bf16 and f64 are ported (tests/test_torch_dtypes.py); both run here
    assert dt.verify(csr, dt.spmv(csr, x, "f64", device="cpu"), x,
                     rtol=1e-10)
    assert dt.spmv(csr, x, "bf16", device="cpu").dtype == np.float32
