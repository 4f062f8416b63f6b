"""The port's SpMM: the multi-vector colsum K5 (``colsum_multi``, its plain
version on the CPU) against the JAX package's ``_make_colsum_multi`` in
interpret mode, and ``SpMVOperator.matmat`` against ``PallasSpMV.matmat``
(``force_streamed=True``) and the CSR golden, in f32, bf16 and f64.  The
batched glue of a pass is held in tests/test_torch_spmm_glue.py.

Tolerances, on the error scaled by max(|ref|, 1):
- K5 against the reference 1e-6 (f32 and bf16 values): the same f32
  words, sums of at most 8 terms in another order;
- K5 against K1/K3 per vector: equal, bit for bit (the same products in
  the same order), which is also what the card is held to;
- K5-f64 against the reference's K3 (``_make_colsum_dd``) per vector
  1e-10: the reference has no fp64 multi-vector kernel, and its
  double-double sums are good to ~2^-44;
- matmat against the golden: f32 2e-5, f64 1e-10, bf16 5e-2 against the
  golden of the bf16-rounded A and X (as tests/test_torch_dtypes.py);
  against the reference's dd SpMM tier 2e-6 (that tier keeps ~2^-24 of
  the row's mass, tests/test_wplan.py:300-317).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from dasp_tpu.config import DaspConfig as RefConfig
from dasp_tpu.ops import dd, pallas_backend as pb
from dasp_tpu.sparse import CSRMatrix as RefCSR
import dasp_tpu_torch as dt
from dasp_tpu_torch import sparse as tsp
from dasp_tpu_torch.config import DaspConfig
from dasp_tpu_torch.ops import cuda_backend as cb
from dasp_tpu_torch.ops.colsum import colsum
from dasp_tpu_torch.ops.colsum_multi import colsum_multi
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = {"f32": 2e-5, "f64": 1e-10, "bf16": 5e-2}
KERNEL_TOL = 1e-6
KERNEL_TOL_F64 = 1e-10

# circuit: P=6 at stride 2; short4: one P=3 stream at stride 4; mixed:
# stride 8 and 2 streams with long rows
KERNEL_CASES = {
    "circuit": lambda rng: tsp.circuit_like(6000, rng),
    "short4": lambda rng: tsp.random_csr(3000, 3000, np.full(3000, 4), rng),
    "mixed": lambda rng: tsp.mixed_categories(500, rng),
}


def _ref(csr):
    return RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  csr.values)


def _scaled_err(ours, ref):
    ref = np.asarray(ref, dtype=np.float64)
    ours = np.asarray(ours, dtype=np.float64)
    return float((np.abs(ours - ref) / np.maximum(np.abs(ref), 1.0)).max(
        initial=0.0))


def _lowered(csr, dtype):
    ref_meta, ref_arrays = pb.plan_to_arrays(pb.build_wplan(_ref(csr)), dtype)
    meta, arrays = cb.arrays_from_reference(ref_meta, ref_arrays, "cpu")
    return ref_arrays, meta, arrays


@pytest.mark.parametrize("name", list(KERNEL_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_colsum_multi_plain_matches_pallas(name, dtype):
    """K5 at kv=4 on the reference's tables against _make_colsum_multi."""
    rng = np.random.default_rng(0)
    csr = KERNEL_CASES[name](rng)
    ref_arrays, meta, arrays = _lowered(csr, dtype)
    S, kv = meta.s_rows, 4
    x3d = rng.standard_normal((kv * S, 128)).astype(np.float32)
    xt = torch.from_numpy(x3d)
    for (P, stride, nv), st, ref_st in zip(meta.streams, arrays["streams"],
                                           ref_arrays["streams"]):
        ref = pb._make_colsum_multi(P, S, nv, True, stride, kv=kv)(
            ref_st["wins"], ref_st["vals"], ref_st["idx"], x3d)
        ours = colsum_multi(st["wins"], st["vals"], st["idx"], xt, stride,
                            kv)
        assert ours.shape == (kv, nv * 8 // stride, 128)
        assert ours.dtype == torch.float32
        assert _scaled_err(ours.numpy(), ref) <= KERNEL_TOL, (P, stride)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("kv", [1, 2, 4, 8])
def test_colsum_multi_equals_colsum_per_vector(dtype, kv):
    """Slice j of K5 is K1 (K3 for f64) on table j, bit for bit; table j
    starts at row j*S of the stack and the windows are per-table rows."""
    rng = np.random.default_rng(0)
    csr = KERNEL_CASES["mixed"](rng)
    _, meta, arrays = _lowered(csr, dtype)
    S = meta.s_rows
    xdt = torch.float64 if dtype == "f64" else torch.float32
    x3d = torch.from_numpy(rng.standard_normal((kv * S, 128))).to(xdt)
    for (_, stride, _), st in zip(meta.streams, arrays["streams"]):
        multi = colsum_multi(st["wins"], st["vals"], st["idx"], x3d, stride,
                             kv)
        assert multi.dtype == xdt
        for j in range(kv):
            one = colsum(st["wins"], st["vals"], st["idx"],
                         x3d[j * S:(j + 1) * S], stride)
            assert torch.equal(multi[j], one), (stride, j)


def test_colsum_multi_f64_matches_pallas_dd_per_vector():
    """K5-f64 against the reference's K3 (_make_colsum_dd) run on each
    vector: the reference has no fp64 multi-vector kernel."""
    rng = np.random.default_rng(0)
    csr = KERNEL_CASES["circuit"](rng)
    ref_arrays, meta, arrays = _lowered(csr, "f64")
    S, kv = meta.s_rows, 2
    x3d = rng.standard_normal((kv * S, 128))
    xt = torch.from_numpy(x3d)
    for (P, stride, nv), st, ref_st in zip(meta.streams, arrays["streams"],
                                           ref_arrays["streams"]):
        ours = colsum_multi(st["wins"], st["vals"], st["idx"], xt, stride,
                            kv)
        call = pb._make_colsum_dd(P, S, nv, True, stride)
        for j in range(kv):
            xh, xl = dd.from_f64(x3d[j * S:(j + 1) * S])
            oh, ol = call(ref_st["wins"], ref_st["vals_hi"],
                          ref_st["vals_lo"], ref_st["idx"], xh, xl)
            ref = dd.to_f64(np.asarray(oh), np.asarray(ol))
            assert _scaled_err(ours[j].numpy(), ref) <= KERNEL_TOL_F64


def test_colsum_multi_refuses_bad_kv():
    wins = torch.zeros((1, 2), dtype=torch.int32)
    idx = torch.zeros((8, 128), dtype=torch.int16)
    vals = torch.zeros((8, 128), dtype=torch.float32)
    for kv, rows in ((3, 24), (16, 128), (4, 30)):
        with pytest.raises(ValueError, match="kv"):
            colsum_multi(wins, vals, idx, torch.zeros((rows, 128)), 8, kv)


def _golden(csr, X, dtype):
    """Column-wise CSR golden; for bf16 that of the bf16-rounded A and X."""
    if dtype == "bf16":
        r = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)
        csr = tsp.CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr,
                            csr.col_idx, r(csr.values))
        X = r(X)
    return np.stack([csr.spmv(X[:, j]) for j in range(X.shape[1])], axis=1)


def _glue_call(op, x2d):
    """The reference-order single-vector SpMV (K1/K3, the glue, K2/K4):
    ``spmv_fn`` on the operator's tables without their K6 schedule."""
    return cb.spmv_fn(op._meta, dict(op._arrays, resident=None), x2d)


def _check_cols(Y, G, tol):
    scale = np.maximum(np.abs(G), 1.0)
    np.testing.assert_allclose(np.asarray(Y, np.float64) / scale, G / scale,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_matmat_multivector(dtype):
    """tests/test_wplan.py:test_matmat_multivector (4 columns) in every
    dtype: the port against the golden and against PallasSpMV.matmat."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(500, rng)
    X = rng.standard_normal((csr.n_cols, 4))
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    Y = op.matmat(X)
    assert Y.shape == (csr.n_rows, 4) and Y.dtype == np.float64
    _check_cols(Y, _golden(csr, X, dtype), TOL[dtype])
    if dtype != "f64":        # the f64 reference is held in the next test
        ref = pb.PallasSpMV(_ref(csr), dtype=dtype, force_streamed=True)
        Yr = np.asarray(ref.matmat(X)).astype(np.float64)
        scale = np.maximum(np.abs(Yr), 1.0)
        tol = 1e-2 if dtype == "bf16" else TOL[dtype]
        np.testing.assert_allclose(Y / scale, Yr / scale, rtol=tol, atol=tol)


def test_matmat_f64_dd_tier():
    """tests/test_wplan.py:test_matmat_f64_dd_tier with k=5, which runs
    as one pass of kv=8 padded with three zero tables: the port is one
    fp64 pass at 1e-10 against the golden, and within 2e-6 of the
    reference's dd cross-product tier; the padding leaks into no column
    (each equals the one-step K6 SpMV, op(x), bit for bit)."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(500, rng)
    X = rng.standard_normal((csr.n_cols, 5))
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu")
    Y = op.matmat(X)
    assert Y.shape == (csr.n_rows, 5) and Y.dtype == np.float64
    _check_cols(Y, _golden(csr, X, "f64"), TOL["f64"])
    ref = pb.PallasSpMV(_ref(csr), dtype="f64", force_streamed=True)
    assert ref._spmm_dd_kv() > 1, "reference must take its dd SpMM tier"
    _check_cols(Y, ref.matmat(X), 2e-6)
    for j in range(5):
        np.testing.assert_array_equal(Y[:, j], op(X[:, j]))
    _check_cols(np.stack([op(X[:, j]) for j in range(5)], 1), Y,
                TOL["f64"])


def test_matmat_interface_parity():
    """tests/test_spmv.py:test_matmat_interface_parity: matmat on every
    dtype of the operator, with the reference's output dtypes (float64
    for f64 operators and a float64 X, else X's dtype)."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    X = rng.standard_normal((csr.n_cols, 2))
    for dtype in ("f32", "bf16", "f64"):
        op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
        _check_cols(op.matmat(X), _golden(csr, X, dtype), TOL[dtype])
        Y32 = op.matmat(X.astype(np.float32))
        assert Y32.dtype == (np.float64 if dtype == "f64" else np.float32)
        assert op.matmat(X).dtype == np.float64


def test_relabel_f64_matmat():
    """tests/test_wplan.py:test_relabel_f64_matmat: f64 SpMV and the
    multi-vector SpMM both honour the column relabel, the latter in f32
    and (in the port) f64 as well."""
    rng = np.random.default_rng(0)
    csr = tsp.powerlaw_like(400, 1.8, 3000, rng)
    cfg = DaspConfig(relabel="first_touch")
    op = dt.SpMVOperator(csr, dtype="f64", config=cfg, device="cpu")
    assert op.plan.col_perm is not None
    x = rng.standard_normal(csr.n_cols)
    _check_cols(op(x)[:, None], csr.spmv(x)[:, None], TOL["f64"])
    X = rng.standard_normal((csr.n_cols, 3))
    G = _golden(csr, X, "f64")
    _check_cols(op.matmat(X), G, TOL["f64"])
    Y = dt.SpMVOperator(csr, dtype="f32", config=cfg, device="cpu").matmat(X)
    _check_cols(Y, G, TOL["f32"])
    ref = pb.PallasSpMV(_ref(csr), dtype="f32",
                        config=RefConfig(relabel="first_touch"),
                        force_streamed=True)
    _check_cols(Y, np.asarray(ref.matmat(X), np.float64), TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_spmm_fn_equals_spmv_fn(dtype):
    """On the device side, on the tables without their K6 schedule,
    spmm_fn's column j equals the reference-order spmv_fn on table j bit for
    bit (K5 slice j is K1/K3 on it, and the glue is the same code with the
    vector as a batch dimension).  ``device_call``, one K6 step, sums in
    another order: it is held to the golden at TOL, as column j is, on the
    error scaled by the row's mass max(|A||x|, 1) (x stays f32 in bf16,
    so a row's error follows its mass, and some rows here cancel)."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    X = rng.standard_normal((csr.n_cols, cb.KV_SPMM))
    xs = [op._prep_x(X[:, j]) for j in range(cb.KV_SPMM)]
    x = torch.stack([t.reshape(-1) for t in xs], 1)   # interleaved
    Y = cb.spmm_fn(op._meta, dict(op._arrays, resident=None), x)
    assert Y.shape == (csr.n_rows, cb.KV_SPMM)
    G = _golden(csr, X, dtype)
    absA = tsp.CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                         np.abs(csr.values))
    mass = np.maximum(_golden(absA, np.abs(X), dtype), 1.0)
    for j, x2d in enumerate(xs):
        assert torch.equal(Y[:, j], _glue_call(op, x2d))
        for y in (op.device_call(x2d), Y[:, j]):
            err = np.abs(op.perm_out(cb._to_host(y)) - G[:, j]) / mass[:, j]
            assert err.max() <= TOL[dtype]
    with pytest.raises(ValueError, match="kv"):
        cb.spmm_fn(op._meta, op._arrays, x, 4)


def test_k5_levers_variants_match_the_source():
    """probes/k5_levers.py builds k5_levers.cu once per variant: every
    switch a variant sets is one the source reads, with a default, and
    the shipped variant sets none."""
    import re
    from dasp_tpu_torch.probes import k5_levers
    src = open(k5_levers.SOURCE).read()
    defaults = dict(re.findall(r"#ifndef (K5_\w+)\n#define \1 (\d+)", src))
    assert k5_levers.VARIANTS["shipped"] == ()
    for name, flags in k5_levers.VARIANTS.items():
        for flag in flags:
            macro, value = re.fullmatch(r"-D(K5_\w+)=(\d+)", flag).groups()
            assert macro in defaults, (name, macro)
            assert value != defaults[macro], f"{name}: {flag} is the default"
