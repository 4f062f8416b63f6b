"""The batched glue of an SpMM pass on tables without a K6 schedule
(``cuda_backend.spmm_fn`` on ``dict(op._arrays, resident=None)``: one K5
launch per stream, then ``stack_y2`` / ``_assemble_y`` once with the
vector as a batch dimension, one outgather, the residue sub-plan as an
SpMM) on fixtures that reach every branch of it, in f32, bf16 and f64:
against the reference-order single-vector SpMV per vector (``spmv_fn`` on
the same tables: K1/K3, the same glue, K2/K4).  ``matmat`` on the
scheduled tables (one K6 launch a pass, tests/test_torch_spmm_resident.py)
against the one-step K6 SpMV that ``op(x)`` runs, against
``PallasSpMV.matmat`` (``force_streamed=True``) and against the CSR
golden.

Tolerances, on the error scaled by max(|ref|, 1):
- a glue column against the reference-order ``spmv_fn`` on its own
  table: equal, bit for bit.  The batched reductions run on contiguous
  (kv, rows, 128) partials and give each vector the sums, in the order,
  that the single-vector call gives;
- a matmat column against ``op(x)`` on it (one K6 step, which folds in
  K6's order and sums the residue by trees): equal, bit for bit;
- a column against itself when its neighbours and the zero padding
  change: equal, bit for bit (a column depends on no other);
- matmat against the golden: f32 2e-5 and f64 1e-10; bf16 1e-2 against
  the golden of the bf16-rounded A and X, on the error scaled by the
  row's mass max(|A||x|, 1): x stays f32 in the port (within 2^-9 of the
  rounded x) and y is rounded once (2^-9 of |y|), so a row's error follows
  its mass, not |y| (5 and 8 columns of these fixtures hold rows that
  cancel to |y| << mass);
- against the reference's matmat: f32 2e-5, bf16 1e-2 (both keep x in f32
  and round y once to bf16), f64 2e-6 (the reference's dd cross-product
  tier keeps ~2^-24 of the row's mass).
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
from dasp_tpu_torch.ops import outgather as og
from dasp_tpu_torch.ops import resident
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = {"f32": 2e-5, "f64": 1e-10, "bf16": 1e-2}
REF_TOL = {"f32": 2e-5, "f64": 2e-6, "bf16": 1e-2}

# name -> (matrix, relabel, RES_REPACK_MIN forced to 1, what the fixture
# must reach)
GLUE_CASES = {
    # cross-stride segments (F = 2, 4), slices of 32 vregs, long rows
    "mixed": (lambda rng: tsp.mixed_categories(500, rng), None, False,
              dict(F=4, w8=32, long=True)),
    # a multi-round stream (P = 6) with long rows
    "circuit": (lambda rng: tsp.circuit_like(6000, rng), None, False,
                dict(F=4, long=True)),
    # a relabeled, row-sorted plan
    "relabel": (lambda rng: tsp.powerlaw_like(400, 1.8, 3000, rng),
                "first_touch", False, dict(relabel=True, long=True)),
    # the residue's sorted scatter (fb_rows)
    "scatter": (lambda rng: tsp.random_csr(
        300, 5000, rng.integers(1, 60, 300), rng), "off", False,
        dict(residue="scatter", fb=True)),
    # the residue's lane-table rows of y2
    "route": (lambda rng: tsp.random_csr(200, 400_000, np.where(
        np.arange(200) % 50 == 0, 2000, 3), rng), "off", False,
        dict(residue="route", lanes=True, long=True)),
    # the residue repacked as a sub-plan
    "subplan": (lambda rng: tsp.random_csr(
        10_000, 10_000, rng.integers(1, 8, size=10_000), rng), None, True,
        dict(res=True)),
}


def _operator(name, dtype, monkeypatch, rng):
    make, relabel, repack, _ = GLUE_CASES[name]
    if repack:
        monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
        monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    csr = make(rng)
    cfg = DaspConfig(relabel=relabel) if relabel else None
    return csr, dt.SpMVOperator(csr, dtype=dtype, config=cfg, device="cpu")


def _reference(name, csr, dtype):
    relabel = GLUE_CASES[name][1]
    cfg = RefConfig(relabel=relabel) if relabel else None
    ref = RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                 csr.values)
    return pb.PallasSpMV(ref, dtype=dtype, config=cfg, force_streamed=True)


def _spmm(csr, values, X):
    m = tsp.CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                      values)
    return np.stack([m.spmv(X[:, j]) for j in range(X.shape[1])], axis=1)


def _close(Y, G, tol, scale=None):
    scale = np.maximum(np.abs(G), 1.0) if scale is None else scale
    np.testing.assert_allclose(np.asarray(Y, np.float64) / scale, G / scale,
                               rtol=0, atol=tol)


def _glue(op):
    """The operator's tables without their K6 schedule: the glue path."""
    return dict(op._arrays, resident=None)


def _interleave(tabs):
    """x tables (s_rows, 128) -> an SpMM pass's x, interleaved by column:
    (s_rows*128, kv), row i word i of every table."""
    return torch.stack([t.reshape(-1) for t in tabs], 1)


def _glue_call(op, x2d):
    """The reference-order single-vector SpMV: ``spmv_fn`` on the
    operator's tables without their K6 schedule."""
    return cb.spmv_fn(op._meta, _glue(op), x2d)


def _check_golden(csr, X, Y, dtype):
    """Y against the CSR golden at TOL[dtype]; bf16 against the golden of
    the bf16-rounded A and X, scaled by the row's mass."""
    if dtype != "bf16":
        return _close(Y, _spmm(csr, csr.values, X), TOL[dtype])
    r = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)
    mass = _spmm(csr, np.abs(r(csr.values)), np.abs(r(X)))
    _close(Y, _spmm(csr, r(csr.values), r(X)), TOL[dtype],
           np.maximum(mass, 1.0))


@pytest.mark.parametrize("name", list(GLUE_CASES))
def test_glue_fixture_reaches_its_branch(name, monkeypatch):
    """Each fixture reaches the branch of the glue it is listed for."""
    _, op = _operator(name, "f32", monkeypatch, np.random.default_rng(0))
    meta, arrays, want = op._meta, op._arrays, GLUE_CASES[name][3]
    folds = {(8 // meta.streams[s][1]) // (8 // stride)
             for s, _, _, _, stride in meta.sell_segs}
    assert want.get("F", 1) in folds
    assert max(w8 for _, _, _, w8, _ in meta.sell_segs) >= want.get("w8", 1)
    assert bool(meta.n_long) >= want.get("long", False)
    assert (op.plan.col_perm is not None) >= want.get("relabel", False)
    assert (meta.res is not None) == want.get("res", False)
    o = arrays["overflow"]
    if "residue" in want:
        assert meta.overflow_meta == (want["residue"],)
    if want.get("fb"):
        assert o["fb_rows"].shape[0] > 0
    if want.get("lanes"):
        assert o["lane_table"].shape[0] > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("name", list(GLUE_CASES))
def test_spmm_fn_batched_matches_spmv_fn_and_pallas(name, dtype,
                                                    monkeypatch):
    """One batched glue pass per fixture and dtype: each column equals
    the reference-order spmv_fn on its table bit for bit; matmat (one K6
    launch a pass) equals op(x) (one K6 step) column for column bit for
    bit, and both match the golden and PallasSpMV.matmat (5 columns: one
    pass of 8, padded)."""
    rng = np.random.default_rng(0)
    csr, op = _operator(name, dtype, monkeypatch, rng)
    X = rng.standard_normal((csr.n_cols, 5))
    kv = 4
    xs = [op._prep_x(X[:, j]) for j in range(kv)]
    Y4 = cb.spmm_fn(op._meta, _glue(op), _interleave(xs), kv)
    assert Y4.shape == (csr.n_rows, kv)
    for j, x2d in enumerate(xs):
        assert torch.equal(Y4[:, j], _glue_call(op, x2d)), j
    Y = op.matmat(X)
    assert Y.shape == (csr.n_rows, 5) and Y.dtype == np.float64
    for j in range(5):
        np.testing.assert_array_equal(Y[:, j], op(X[:, j]))
    _check_golden(csr, X, Y, dtype)
    _check_golden(csr, X, np.stack([op(X[:, j]) for j in range(5)], 1),
                  dtype)
    Yr = np.asarray(_reference(name, csr, dtype).matmat(X[:, :kv]),
                    np.float64)
    _close(Y[:, :kv], Yr, REF_TOL[dtype])


@pytest.mark.parametrize("k", [1, 5, 8, 11])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_matmat_column_counts(dtype, k):
    """k = 1, 5, 8 and 11 columns (a pass of kv = 1; a padded pass of 8;
    a full one; a full one and a padded pass of 4): every column is op(x)
    (one K6 step) on it, bit for bit, and matches the golden."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    X = rng.standard_normal((csr.n_cols, k))
    Y = op.matmat(X)
    assert Y.shape == (csr.n_rows, k)
    _check_golden(csr, X, Y, dtype)
    for j in range(k):
        np.testing.assert_array_equal(Y[:, j], op(X[:, j]))
    _check_golden(csr, X, np.stack([op(X[:, j]) for j in range(k)], 1),
                  dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("name", ["mixed", "scatter", "route", "subplan"])
def test_spmm_column_independent_of_neighbours(name, dtype, monkeypatch):
    """Column j of a glue pass (the tables without their K6 schedule)
    does not change, bit for bit, when the other columns change (to other
    vectors, to zero padding), at kv = 4 and 8; it is the reference-order
    spmv_fn on its table, and op(x) (one K6 step) matches the golden."""
    rng = np.random.default_rng(0)
    csr, op = _operator(name, dtype, monkeypatch, rng)
    xh = rng.standard_normal(csr.n_cols)
    x = op._prep_x(xh)
    want = None
    for kv in (4, 8):
        for j in (0, kv - 1):
            for fill in ("random", "zero"):
                xb = torch.zeros((kv, *x.shape), dtype=x.dtype)
                if fill == "random":
                    xb.copy_(torch.from_numpy(
                        rng.standard_normal(tuple(xb.shape))))
                xb[j] = x
                y = cb.spmm_fn(op._meta, _glue(op), _interleave(xb),
                               kv)[:, j]
                want = y if want is None else want
                assert torch.equal(y, want), (kv, j, fill)
    assert torch.equal(want, _glue_call(op, x))
    _check_golden(csr, xh[:, None], op(xh)[:, None], dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_matmat_subplan_runs_no_single_vector_colsum(dtype, monkeypatch):
    """On a plan whose residue is repacked as a sub-plan, a matmat pass
    is one fused K6 pass (``resident.spmm_loop``, whose trees sum the whole
    residue) and calls no colsum and no outgather; on the same tables
    without their schedule a glue pass runs the sub-plan through the
    multi-vector colsum too: once per stream of the plan and of its
    sub-plan, and the single-vector colsum not at all."""
    rng = np.random.default_rng(0)
    csr, op = _operator("subplan", dtype, monkeypatch, rng)
    calls = dict.fromkeys(("single", "multi", "outgather", "fused"), 0)

    def counted(fn, key):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(cb, "colsum", counted(cb.colsum, "single"))
    monkeypatch.setattr(cb, "colsum_multi",
                        counted(cb.colsum_multi, "multi"))
    monkeypatch.setattr(cb, "outgather", counted(cb.outgather, "outgather"))
    monkeypatch.setattr(resident, "spmm_loop",
                        counted(resident.spmm_loop, "fused"))
    X = rng.standard_normal((csr.n_cols, 5))
    Y = op.matmat(X)
    passes = -(-5 // cb.KV_SPMM)
    assert passes == 1
    assert calls == {"single": 0, "multi": 0, "outgather": 0,
                     "fused": passes}
    _check_golden(csr, X, Y, dtype)
    calls.update(fused=0)
    Xp = np.pad(X, ((0, 0), (0, cb.KV_SPMM - 5)))     # zero padding
    x = _interleave([op._prep_x(Xp[:, j]) for j in range(cb.KV_SPMM)])
    Yg = cb.spmm_fn(op._meta, _glue(op), x)
    streams = len(op._meta.streams) + len(op._meta.res.streams)
    assert calls == {"single": 0, "multi": streams, "outgather": 2,
                     "fused": 0}
    _check_golden(csr, X, op.perm_out(cb._to_host(Yg))[:, :5], dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_outgather_batched_equals_per_vector(dtype):
    """outgather on the (kv, rows, 128) y2 of a pass gives vector j what
    it gives on y2[j] alone, bit for bit, and refuses another rank."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    meta, arrays = op._meta, op._arrays
    x3d = torch.cat([op._prep_x(rng.standard_normal(csr.n_cols))
                     for _ in range(4)])
    parts = [cb.colsum_multi(st["wins"], st["vals"], st["idx"], x3d, s, 4)
             for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    y2, _ = cb.stack_y2(meta, arrays, parts, x3d.view(4, -1, 128))
    assert y2.dim() == 3 and not y2[:, meta.n_y2_rows].any()
    out = og.outgather(arrays["out_src"], arrays["out_perm"], y2,
                       meta.n_y2_rows)
    assert out.shape == (4, meta.B_pad, 128)
    for j in range(4):
        assert torch.equal(out[j], og.outgather(
            arrays["out_src"], arrays["out_perm"], y2[j], meta.n_y2_rows))
    with pytest.raises(ValueError, match="y2"):
        og.outgather(arrays["out_src"], arrays["out_perm"], y2[None],
                     meta.n_y2_rows)
