"""The port's tile-plan executor (dasp_tpu_torch.ops.xla_backend, the
operator SpMVOperator(backend="xla") returns, and MultiChipSpMV(backend=
"xla")) on the CPU, against the JAX package's XLA executor on the very same
plan (carried across by plan_from_reference) and against the CSR golden.

Tolerances, on the error scaled by max(|golden|, 1):
- f32: 2e-5 against the JAX package, 1e-5 against the golden
  (tests/test_spmv.py:44);
- bf16: 1e-2 against the JAX package's bf16 tile path, jitted (both
  multiply bf16 values and x in f32, XLA eliding the rounding of each
  product that its _Alg.mul writes; their f32 sums differ in order), 0.05
  against the golden of the bf16-rounded A and x
  (tests/test_spmv.py:16-33,44);
- f64: the port's native fp64 within 1e-10 of the golden, the JAX
  package's double-double within 1e-9 of it (tests/test_spmv.py:44).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu
import dasp_tpu.parallel as ref_par
from dasp_tpu.ops import dd
from dasp_tpu.ops import xla_backend as rxb
from dasp_tpu.plan import build_plan as ref_build_plan
from dasp_tpu.sparse import CSRMatrix as RefCSR
import dasp_tpu_torch as dt
from dasp_tpu_torch import parallel as par
from dasp_tpu_torch.bench import append_record, bench_spmv, record_from
from dasp_tpu_torch.bench.check import bf16_round
from dasp_tpu_torch.bench.harness import time_loop, time_loop_stats
from dasp_tpu_torch.ops import kernel_launches, zero_kernel_launches
from dasp_tpu_torch.ops import xla_backend as xb
from dasp_tpu_torch.ops.cuda_backend import TorchSpMV
from dasp_tpu_torch.sparse import (CSRMatrix, fem_like, mixed_categories,
                                   powerlaw_like, random_csr)
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()

DTYPES = ("f32", "bf16", "f64")
VS_JAX = {"f32": 2e-5, "bf16": 1e-2}
VS_GOLDEN = {"f32": 1e-5, "bf16": 0.05, "f64": 1e-10}
JAX_VS_GOLDEN_F64 = 1e-9

# the fixtures of tests/test_spmv.py:36-58
CASES = {
    "mixed": lambda rng: mixed_categories(700, rng),
    "fem": lambda rng: fem_like(500, 30, rng),
    "powerlaw": lambda rng: powerlaw_like(600, 1.8, 5000, rng),
    "all_short": lambda rng: random_csr(900, 900,
                                        rng.integers(0, 5, size=900), rng),
    "long_only": lambda rng: random_csr(
        6, 4000, np.array([256, 300, 1000, 2048, 257, 4000]), rng),
}


def _ref(csr):
    return RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  csr.values)


def _golden(csr, x, dtype):
    """A x in f64; for bf16 that of the bf16-rounded A and x."""
    if dtype != "bf16":
        return csr.spmv(x)
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                     bf16_round(csr.values)).spmv(bf16_round(x))


def _err(y, golden):
    assert y.shape == golden.shape
    if not y.size:
        return 0.0
    return float((np.abs(np.asarray(y, np.float64) - golden)
                  / np.maximum(np.abs(golden), 1.0)).max())


def _jax_x(dtype, x):
    """x as the JAX package's executor takes it (its _prep_x)."""
    if dtype == "f64":
        hi, lo = dd.from_f64(np.asarray(x, np.float64))
        return dict(hi=jnp.asarray(hi), lo=jnp.asarray(lo))
    want = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return jnp.asarray(x).astype(want)


def _jax_y(dtype, y):
    if dtype == "f64":
        return dd.to_f64(np.asarray(y["hi"]), np.asarray(y["lo"]))
    return np.asarray(y.astype(jnp.float32), dtype=np.float64)


def _check(ours, theirs, golden, dtype):
    if dtype == "f64":
        assert _err(theirs, golden) <= JAX_VS_GOLDEN_F64
    else:
        assert _err(ours, theirs) <= VS_JAX[dtype]
    assert _err(ours, golden) <= VS_GOLDEN[dtype]


@pytest.mark.parametrize("fn", ["spmv_fn", "spmv_scatter_fn"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CASES)
def test_executor_matches_jax(name, dtype, fn):
    """The port's spmv_fn / spmv_scatter_fn and the JAX package's on one
    plan and one x."""
    rng = np.random.default_rng(0)
    csr = CASES[name](rng)
    x = rng.standard_normal(csr.n_cols)
    ref_plan = ref_build_plan(_ref(csr))
    lower = {"spmv_fn": "plan_to_arrays",
             "spmv_scatter_fn": "plan_to_scatter_arrays"}[fn]
    meta, arrays = getattr(xb, lower)(xb.plan_from_reference(ref_plan),
                                      dtype, "cpu")
    y = xb._to_host(getattr(xb, fn)(
        meta, arrays, xb.prep_x(dtype, x, csr.n_cols, csr.n_cols)))
    assert y.dtype == (np.float64 if dtype == "f64" else np.float32)
    rmeta, rarrays = getattr(rxb, lower)(ref_plan, dtype)
    y_ref = _jax_y(dtype, jax.jit(getattr(rxb, fn), static_argnums=0)(
        rmeta, rarrays, _jax_x(dtype, x)))
    _check(y, y_ref, _golden(csr, x, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_operator_matches_jax_operator(dtype):
    """SpMVOperator(backend="xla") against dasp_tpu.SpMVOperator(backend=
    "xla") on one matrix, each packing its own (identical) plan; the
    tables stay on the device asked for."""
    rng = np.random.default_rng(1)
    csr = mixed_categories(700, rng)
    x = rng.standard_normal(csr.n_cols)
    op = dt.SpMVOperator(csr, dtype, backend="xla", device="cpu")
    ref = dasp_tpu.SpMVOperator(_ref(csr), dtype, backend="xla")
    assert isinstance(op, xb.TileSpMV) and op.backend == ref.backend == "xla"
    assert (op.n_rows, op.n_cols, op.nnz) == (ref.n_rows, ref.n_cols,
                                              ref.nnz)
    assert op.preprocess_seconds > 0
    tensors = [v for st in op._arrays["sell"] for v in st.values()]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    _check(op(x), ref(x), _golden(csr, x, dtype), dtype)
    np.testing.assert_array_equal(op.perm_in(x), x)
    np.testing.assert_array_equal(op.perm_out(x), x)


def test_dispatch_rules():
    """backend="xla" or a DaspPlan: the tile operator; "pallas", "auto" or
    a WPlan: the windowed one (the reference's "auto" takes the tile
    executor off a TPU, the port's stays windowed); anything else raises,
    as dasp_tpu/spmv.py:73-74 does."""
    csr = mixed_categories(300, np.random.default_rng(2))
    plan = dt.build_plan(csr)
    wplan = dt.build_wplan(csr)
    tile = lambda *a, **k: isinstance(dt.SpMVOperator(*a, device="cpu", **k),
                                      xb.TileSpMV)
    assert tile(csr, backend="xla")
    assert tile(plan) and tile(plan, backend="auto") and tile(plan, "f64")
    assert dt.SpMVOperator(plan, device="cpu").plan is plan
    for args, kw in (((csr,), {}), ((csr,), {"backend": "auto"}),
                     ((csr,), {"backend": "pallas"}), ((wplan,), {}),
                     ((wplan,), {"backend": "xla"})):
        op = dt.SpMVOperator(*args, device="cpu", **kw)
        assert isinstance(op, TorchSpMV) and op.backend == "pallas"
    with pytest.raises(ValueError, match="backend"):
        dt.SpMVOperator(csr, backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        dt.SpMVOperator(csr, "f16", backend="xla", device="cpu")


def test_runs_on_the_card_unless_asked_for_the_cpu():
    """The default device is the card: without one the tile operator
    raises instead of falling back to the CPU."""
    csr = mixed_categories(200, np.random.default_rng(3))
    if torch.cuda.is_available():
        op = dt.SpMVOperator(csr, backend="xla")
        assert op.device.type == "cuda"
        assert op._arrays["inv_perm"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            dt.SpMVOperator(csr, backend="xla")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_timing_loop_matches_jax_loop(dtype):
    """timing_loop(3) chains three SpMVs through perturb_x and runs a
    fourth: its y agrees with one SpMV and with the JAX loop (the 1e-36
    taps are below f32 resolution); x is never written; no kernel of the
    windowed path launches."""
    rng = np.random.default_rng(4)
    csr = mixed_categories(700, rng)
    x = rng.standard_normal(csr.n_cols)
    op = dt.SpMVOperator(csr, dtype, backend="xla", device="cpu")
    ref = dasp_tpu.SpMVOperator(_ref(csr), dtype, backend="xla")
    x_dev = op._prep_x(x)
    kept = x_dev.clone()
    zero_kernel_launches()
    y_loop = xb._to_host(op.timing_loop(3)(x_dev))
    assert not any(kernel_launches().values())
    assert torch.equal(x_dev, kept)
    y_ref = _jax_y(dtype, ref.timing_loop(3)(ref._prep_x(x)))
    _check(y_loop, y_ref, csr.spmv(x), dtype)
    np.testing.assert_allclose(y_loop, op(x), rtol=2e-6, atol=1e-6)


def test_perturb_x_taps_y0():
    x = torch.tensor([1.0, 0.0], dtype=torch.float64)
    y = torch.tensor([1e6, 5.0], dtype=torch.float64)
    tap = 1e6 * 1e-36
    np.testing.assert_array_equal(xb.perturb_x(x, y).numpy(),
                                  [1.0 + tap, tap])
    xb16 = torch.zeros(2, dtype=torch.bfloat16)
    out = xb.perturb_x(xb16, y.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and float(out[0]) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_matmat(dtype):
    """matmat loops columns, as the reference's; every column against its
    golden and the JAX operator's matmat."""
    rng = np.random.default_rng(5)
    csr = mixed_categories(300, rng)
    X = rng.standard_normal((csr.n_cols, 3))
    op = dt.SpMVOperator(csr, dtype, backend="xla", device="cpu")
    Y = op.matmat(X)
    Y_ref = dasp_tpu.SpMVOperator(_ref(csr), dtype,
                                  backend="xla").matmat(X)
    assert Y.shape == (csr.n_rows, 3)
    for j in range(3):
        _check(Y[:, j], np.asarray(Y_ref[:, j], np.float64),
               _golden(csr, X[:, j], dtype), dtype)


def test_empty_matrix():
    rng = np.random.default_rng(6)
    csr = random_csr(50, 50, np.zeros(50, dtype=np.int64), rng)
    for dtype in DTYPES:
        op = dt.SpMVOperator(csr, dtype, backend="xla", device="cpu")
        np.testing.assert_array_equal(op(rng.standard_normal(50)),
                                      np.zeros(50))


def test_identity():
    n = 300
    csr = CSRMatrix(n, n, np.arange(n + 1, dtype=np.int64),
                    np.arange(n, dtype=np.int32), np.ones(n))
    x = np.random.default_rng(7).standard_normal(n)
    np.testing.assert_allclose(
        dt.spmv(csr, x, backend="xla", device="cpu"), x.astype(np.float32),
        rtol=1e-6)
    np.testing.assert_array_equal(
        dt.spmv(csr, x, "f64", backend="xla", device="cpu"), x)


def test_f64_cancellation():
    """+1e7/-1e7 pairs plus a residual of 1 in one long row: native fp64
    keeps the residual (tests/test_spmv.py:135-149 holds the JAX
    package's double-double to 1e-6)."""
    n = 4096
    csr = random_csr(1, n, np.array([n]), np.random.default_rng(8))
    v = np.zeros(n)
    v[0::2] = 1e7
    v[1::2] = -1e7
    v[1] += 1.0
    csr.values = v
    x = np.ones(n)
    y = dt.SpMVOperator(csr, "f64", backend="xla", device="cpu")(x)
    assert abs(y[0] - csr.spmv(x)[0]) < 1e-6


def test_bench_on_tile_operator(tmp_path):
    """The harness times a tile operator (its chained loop on the host's
    clock on the CPU) and record_from reads a DaspPlan, as
    tests/test_bench.py:10-25 does for the JAX package."""
    rng = np.random.default_rng(9)
    csr = mixed_categories(300, rng)
    x = rng.standard_normal(csr.n_cols)
    op = dt.SpMVOperator(csr, "f32", backend="xla", device="cpu")
    res = bench_spmv(op, x, "f32", iters=3, trials=2)
    assert res.seconds_per_iter > 0 and res.gflops > 0
    assert res.timed_iters >= 3
    sec, spread, n = time_loop_stats(op, op._prep_x(x), iters=2, trials=2)
    assert sec > 0 and spread >= 0 and n >= 2
    assert time_loop(op, op._prep_x(x), iters=2, trials=2) > 0
    row = record_from(op.plan, res, "t", "f32")
    assert row["nnzA"] == csr.nnz and row["rowA"] == csr.n_rows
    assert row["common_13"] == op.plan.census["common_13"]
    assert row["coo_residue"] == 0 and row["relabel"] == "off"
    p = tmp_path / "rec.csv"
    append_record(str(p), row)
    append_record(str(p), row)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("filename")


def _dryrun_mixed(n_devices):
    """The dry run's second input, __graft_entry__.py:54-59,90-93:
    mixed_categories(160 * n) drawn from its generator (seed 11) after the
    power-law matrix and its x."""
    rng = np.random.default_rng(11)
    first = powerlaw_like(max(100_000, 13_000 * n_devices), 1.8,
                          max(500_000, 65_000 * n_devices), rng,
                          col_alpha=1.6)
    rng.standard_normal(first.n_cols)
    return mixed_categories(160 * n_devices, rng), rng


MULTICHIP = {
    "mixed_900_f32": (lambda rng: mixed_categories(900, rng), "f32"),
    "mixed_900_f64": (lambda rng: mixed_categories(900, rng), "f64"),
    "powerlaw_800_f32": (lambda rng: powerlaw_like(800, 1.8, 4000, rng),
                         "f32"),
    "dryrun_mixed_1280_f32": (None, "f32"),
}


@pytest.mark.parametrize("case", MULTICHIP)
def test_multichip_matches_jax_multichip(case):
    """MultiChipSpMV(backend="xla") on eight chips that share the CPU
    against the JAX package's on the eight simulated host devices: the
    same strips, and y within the tolerances of each other and of the
    golden."""
    make, dtype = MULTICHIP[case]
    if make is None:
        csr, rng = _dryrun_mixed(8)
    else:
        rng = np.random.default_rng(0)
        csr = make(rng)
    x = rng.standard_normal(csr.n_cols)
    assert len(jax.devices()) == 8, "conftest must provide 8 host devices"
    theirs = ref_par.MultiChipSpMV(_ref(csr), dtype=dtype, backend="xla")
    ours = par.MultiChipSpMV(csr, devices=["cpu"] * 8, dtype=dtype,
                             backend="xla")
    assert ours.strips == theirs.strips
    assert ours.stats["slab_nnz"] == theirs.stats["slab_nnz"]
    assert ours.stats["balance"] == theirs.stats["balance"]
    assert ours.stats["resident"] is False and not ours.resident
    y = ours(x)
    assert y.dtype == np.float64
    _check(y, theirs(x), csr.spmv(x), dtype)
