"""The port's bench (dasp_tpu_torch.bench) on the CPU: the data models and
the record against the JAX package's, the timing protocol's divisor, the
cuSPARSE-through-PyTorch baseline against the golden and the JAX package's
BCOO baseline, and the CLI in-process on a tiny Matrix Market file."""

import json
import time

import numpy as np
import pytest
import torch

import dasp_tpu.bench as ref_bench
from dasp_tpu.bench.harness import BenchResult as RefBenchResult
from dasp_tpu.sparse import CSRMatrix as RefCSR
from dasp_tpu_torch import SpMVOperator, build_wplan, write_mtx
from dasp_tpu_torch.bench import (BenchResult, CuSparseBaseline,
                                  DenseBaseline, append_record, bench_spmm,
                                  bench_spmv, check, data_models, geomean,
                                  harness, record_from)
from dasp_tpu_torch.bench import __main__ as cli
from dasp_tpu_torch.bench.record import FIELDS
from dasp_tpu_torch.sparse import mixed_categories
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()

DTYPES = ("f32", "bf16", "f64")


def _scaled(y, golden):
    return np.abs(y - golden) / np.maximum(np.abs(golden), 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_data_models_match_reference(dtype):
    for n_rows in (1, 300, 121_192):
        for n_cols in (1, 512, 8_388_608):
            for nnz in (0, 19_661, 68_993_773):
                assert (data_models(n_rows, n_cols, nnz, dtype)
                        == ref_bench.data_models(n_rows, n_cols, nnz, dtype))


def test_record_from_matches_reference(rng):
    plan = build_wplan(mixed_categories(300, rng))
    plan.stats["pack_seconds"] = 1.25
    vals = dict(seconds_per_iter=3.3e-5, gflops=41.5, bandwidth1_gbs=301.2,
                bandwidth2_gbs=512.9, preprocess_seconds=2.5, spread=0.0123,
                timed_iters=128, compile_seconds=0.75)
    base = dict(vals, seconds_per_iter=2.9e-5, gflops=47.0,
                preprocess_seconds=0.125)
    ours = record_from(plan, BenchResult(**vals), "m", "bf16",
                       BenchResult(**base), variant="resident",
                       baseline_dtype="f32")
    ref = ref_bench.record_from(plan, RefBenchResult(**vals), "m", "bf16",
                                RefBenchResult(**base), variant="resident",
                                baseline_dtype="f32")
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k] == ref[k], k
    assert set(ours) <= set(FIELDS) and ours["baseline_dtype"] == "f32"
    # without a baseline its columns stay out of the row
    assert "baseline_time" not in record_from(plan, BenchResult(**vals),
                                              "m", "f32")


def test_append_record_header_rows_and_rotation(rng, tmp_path):
    plan = build_wplan(mixed_categories(300, rng))
    row = record_from(plan, BenchResult(1e-5, 1.0, 2.0, 3.0), "t", "f32")
    p = tmp_path / "sub" / "rec.csv"
    append_record(str(p), row)
    append_record(str(p), row)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 3 and lines[0] == ",".join(FIELDS)
    assert lines[1] == lines[2] and lines[1].startswith("t,300,300,")
    # a file with another header is rotated, not appended to
    p.write_text("filename,old_schema\nx,1\n")
    append_record(str(p), row)
    assert (tmp_path / "sub" / "rec.csv.v1").read_text().startswith(
        "filename,old_schema")
    assert p.read_text().strip().splitlines()[0] == ",".join(FIELDS)
    assert len(p.read_text().strip().splitlines()) == 2


@pytest.mark.parametrize("force_streamed", [False, True])
def test_bench_spmv_runs(rng, force_streamed):
    csr = mixed_categories(300, rng)
    x = rng.standard_normal(csr.n_cols)
    op = SpMVOperator(csr, dtype="f32", device="cpu",
                      force_streamed=force_streamed)
    assert op.resident != force_streamed
    res = bench_spmv(op, x, "f32", iters=3, trials=3)
    assert res.seconds_per_iter > 0 and res.gflops > 0
    assert res.timed_iters >= 3 and res.spread >= 0
    assert res.gflops == pytest.approx(
        2.0 * csr.nnz / res.seconds_per_iter / 1e9)
    d1, d2 = data_models(csr.n_rows, csr.n_cols, csr.nnz, "f32")
    assert res.bandwidth1_gbs == pytest.approx(
        d1 / res.seconds_per_iter / 1e9)
    assert res.bandwidth2_gbs == pytest.approx(
        d2 / res.seconds_per_iter / 1e9)
    assert res.preprocess_seconds == op.preprocess_seconds


class _SleepOp:
    """An operator whose chained loop sleeps PER seconds for every SpMV
    it would run: n on a resident operator, n + 1 on a streamed one."""
    PER = 4e-3
    n_rows = n_cols = 10
    nnz = 100

    def __init__(self, resident):
        self.resident = resident
        self.loops = []

    def _prep_x(self, x):
        return torch.zeros(1)

    def timing_loop(self, n):
        self.loops.append(n)
        k = n if self.resident else n + 1
        return lambda x_dev: time.sleep(k * self.PER)


@pytest.mark.parametrize("resident", [True, False])
def test_bench_spmv_divides_by_the_spmvs_the_loop_runs(resident):
    op = _SleepOp(resident)
    res = bench_spmv(op, None, "f32", iters=4, trials=3)
    assert harness.loop_spmvs(op, 4) == (4 if resident else 5)
    # one loop for the search, then one a trial: each is made anew
    assert op.loops == [4, 4, 4] and res.timed_iters == 4
    # a streamed loop divided by n would read 1.25 PER
    assert res.seconds_per_iter == pytest.approx(op.PER, rel=0.1)


def test_time_adaptive_lengthens_short_steps(monkeypatch):
    """The search on a deterministic clock: the runner reads a step of k
    units as k * 0.2 ms (what the step returns), so no assertion depends
    on the host's load."""
    seen = []

    def make(k):
        seen.append(k)
        return lambda: k * 2e-4
    monkeypatch.setattr(harness, "_runner", lambda step, device: step)
    med, spread, n, setup = harness.time_adaptive(make, "cpu", 1, 64,
                                                  trials=3)
    assert seen[0] == 1 and seen == sorted(seen) and n == seen[-1]
    search = sorted(set(seen))
    assert all(b >= 2 * a for a, b in zip(search, search[1:]))
    # the search's last step is trial 1; the other trials are made anew
    assert seen.count(n) == 3 and len(seen) == len(search) + 2
    assert med >= harness.MIN_REPLAY_SECONDS and n <= 64 and setup >= 0
    assert med == pytest.approx(n * 2e-4) and spread == 0
    # the cap ends the search whatever the step lasts
    assert harness.time_adaptive(lambda k: (lambda: 1e-6), "cpu", 1, 8,
                                 trials=2)[2] == 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_bench_spmm_times_per_column(rng, dtype):
    csr = mixed_categories(300, rng)
    X = rng.standard_normal((csr.n_cols, 5))
    op = SpMVOperator(csr, dtype=dtype, device="cpu", force_streamed=True)
    ys = op.spmm_loop(X)()
    assert [tuple(y.shape) for y in ys] == [(8, csr.n_rows)]
    res = bench_spmm(op, X, dtype, trials=2)
    assert res.seconds_per_iter > 0 and res.timed_iters >= 1
    assert res.gflops == pytest.approx(
        2.0 * csr.nnz / res.seconds_per_iter / 1e9)


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("f64", 1e-10),
                                       ("bf16", 2e-5)])
def test_cusparse_baseline_matches_golden(rng, dtype, tol):
    csr = mixed_categories(200, rng)
    x = rng.standard_normal(csr.n_cols)
    X = rng.standard_normal((csr.n_cols, 3))
    base = CuSparseBaseline(csr, dtype, device="cpu")
    assert (base.n_rows, base.n_cols, base.nnz) == (csr.n_rows, csr.n_cols,
                                                    csr.nnz)
    assert base.preprocess_seconds > 0
    # a dtype the library lacks on this build runs in f32, and says so
    assert base.compute_dtype == ("f32" if dtype == "bf16" else dtype)
    assert _scaled(base(x), csr.spmv(x)).max() <= tol
    Y = base.matmat(X)
    for j in range(3):
        assert _scaled(Y[:, j], csr.spmv(X[:, j])).max() <= tol


def test_cusparse_timing_loop_matches_bcoo_baseline(rng):
    csr = mixed_categories(200, rng)
    x = rng.standard_normal(csr.n_cols)
    base = CuSparseBaseline(csr, "f32", device="cpu")
    ref = ref_bench.BCOOBaseline(
        RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx, csr.values),
        "f32")
    y = base.timing_loop(3)(base._prep_x(x)).numpy()
    y_ref = np.asarray(ref.timing_loop(3)(ref._prep_x(x)))
    assert _scaled(y, y_ref.astype(np.float64)).max() <= 2e-5
    assert _scaled(y, csr.spmv(x)).max() <= 2e-5


def test_dense_baseline(rng):
    csr = mixed_categories(64, rng)
    x = rng.standard_normal(csr.n_cols)
    base = DenseBaseline(csr, "f32", device="cpu")
    y = base.device_call(base._prep_x(x)).numpy()
    assert _scaled(y, csr.spmv(x)).max() <= 2e-5


def test_check_helpers(rng):
    csr = mixed_categories(100, rng)
    x = rng.standard_normal(csr.n_cols)
    g, mass = check.golden_mass(csr, x, "f64")
    np.testing.assert_array_equal(g, csr.spmv(x))
    assert (mass >= 1.0).all() and (mass >= np.abs(g) - 1e-9).all()
    gb, _ = check.golden_mass(csr, x, "bf16")
    assert 0 < check.scaled_error(gb, g, mass) < 1e-2
    assert check.scaled_error(g, g, mass) == 0.0
    assert check.scaled_error(g[:-1], g, mass) == float("inf")
    bad = g.copy()
    bad[3] = np.nan
    assert check.scaled_error(bad, g, mass) == float("inf")
    assert set(check.E2E_TOL) == set(DTYPES)


@pytest.fixture
def tiny_mtx(rng, tmp_path):
    path = tmp_path / "tiny.mtx"
    write_mtx(str(path), mixed_categories(200, rng))
    return str(path)


def _rows(path):
    lines = path.read_text().strip().splitlines()
    assert lines[0] == ",".join(FIELDS)
    return [dict(zip(FIELDS, ln.split(","))) for ln in lines[1:]]


def test_cli_writes_records_and_summary(tiny_mtx, tmp_path, capsys):
    out = tmp_path / "csv"
    rc = cli.main(["--device", "cpu", "--mtx", tiny_mtx, "--iters", "2",
                   "--csv-dir", str(out), "--deadline", "0",
                   "--spmm-cols", "3"])
    assert rc == 0
    for dtype in DTYPES:
        rows = _rows(out / f"spmv_{dtype}_record.csv")
        assert [r["variant"] for r in rows] == ["resident", "streamed"]
        for r in rows:
            assert r["filename"] == "tiny.mtx" and r["rowA"] == "200"
            assert float(r["dasp_time"]) > 0 and float(r["dasp_gflops"]) > 0
            assert float(r["baseline_time"]) > 0
            assert r["baseline_dtype"] == ("f32" if dtype == "bf16"
                                           else dtype)
            assert int(r["timed_iters"]) >= 2
        (spmm,) = _rows(out / f"spmm_{dtype}_record.csv")
        assert spmm["variant"] == "spmm3" and float(spmm["dasp_time"]) > 0
        assert float(spmm["baseline_time"]) > 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["metric"] == "spmv_gflops_geomean"
    assert summary["unit"] == "GFLOP/s" and summary["value"] > 0
    assert summary["vs_baseline"] > 0
    assert summary["arms_done"] == summary["arms_total"] == 3
    # one summary line after every arm
    assert sum(ln.startswith('{"metric"') for ln in lines) == 3


def test_cli_failed_check_writes_no_row(tiny_mtx, tmp_path, capsys,
                                        monkeypatch):
    monkeypatch.setitem(check.E2E_TOL, "f32", 0.0)
    out = tmp_path / "csv"
    rc = cli.main(["--device", "cpu", "--mtx", tiny_mtx, "--iters", "2",
                   "--csv-dir", str(out), "--deadline", "0",
                   "--dtypes", "f32,f64"])
    assert rc != 0
    assert not (out / "spmv_f32_record.csv").exists()
    assert not (out / "spmm_f32_record.csv").exists()
    assert len(_rows(out / "spmv_f64_record.csv")) == 2
    text = capsys.readouterr().out
    assert "# FAILED tiny.mtx f32 streamed" in text
    assert "1 arm(s) failed a check: tiny.mtx f32" in text
    assert json.loads(text.strip().splitlines()[-1])["arms_done"] == 2


def test_cli_cuda_without_a_card_raises(tiny_mtx, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="--device cuda"):
        cli.main(["--mtx", tiny_mtx, "--csv-dir", str(tmp_path)])


def test_cli_multichip_checks_arms_and_writes_no_row(tiny_mtx, tmp_path,
                                                    capsys):
    out = tmp_path / "csv"
    rc = cli.main(["--multichip", "--chips", "4", "--device", "cpu",
                   "--mtx", tiny_mtx, "--iters", "2", "--csv-dir", str(out),
                   "--deadline", "0"])
    assert rc == 0
    assert not out.exists()
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["metric"] == "spmv_multichip_geomean"
    assert summary["unit"] == "GFLOP/s" and summary["value"] > 0
    assert summary["arms_done"] == summary["arms_total"] == 3
    assert sum(ln.startswith('{"metric"') for ln in lines) == 3
    for dtype in DTYPES:
        line = next(ln for ln in cap.err.splitlines()
                    if ln.startswith(f"# tiny.mtx {dtype} x4: "))
        assert "pad 0/" in line and "resident True" in line


def test_cli_multichip_failed_check(tiny_mtx, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(check.E2E_TOL, "f32", 0.0)
    rc = cli.main(["--multichip", "--chips", "3", "--device", "cpu",
                   "--mtx", tiny_mtx, "--iters", "2", "--deadline", "0",
                   "--dtypes", "f32,f64", "--csv-dir", str(tmp_path)])
    assert rc == 1
    text = capsys.readouterr().out
    assert "# FAILED tiny.mtx f32 multichip" in text
    assert "1 arm(s) failed a check: tiny.mtx f32" in text
    assert json.loads(text.strip().splitlines()[-1])["arms_done"] == 2


@pytest.mark.parametrize("chips", [None, "1"])
def test_cli_multichip_skips_below_two_chips(tiny_mtx, capsys, chips):
    argv = ["--multichip", "--device", "cpu", "--mtx", tiny_mtx]
    assert cli.main(argv + (["--chips", chips] if chips else [])) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "metric": "spmv_multichip_geomean", "value": 0.0,
        "unit": "GFLOP/s", "vs_baseline": 0.0, "skipped": True}


def test_multichip_devices_deal_chips_round_robin(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert cli.multichip_devices(cuda, None) == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    assert cli.multichip_devices(cuda, 5) == [
        torch.device("cuda", i % 2) for i in range(5)]
    cpu = torch.device("cpu")
    assert cli.multichip_devices(cpu, None) == [cpu]
    assert cli.multichip_devices(cpu, 3) == [cpu] * 3


def test_runner_on_several_devices_times_the_call():
    calls = []
    run = harness._runner(lambda: (calls.append(1), time.sleep(0.01)),
                          (torch.device("cpu"), torch.device("cpu")))
    assert run() == pytest.approx(0.01, abs=8e-3) and len(calls) == 2


def test_plan_cache_round_trip(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "PLAN_CACHE_DIR", str(tmp_path / "cache"))
    csr = mixed_categories(200, rng)
    built = cli.get_plan("m", csr, cli.DEFAULT_CONFIG, cache=True)
    assert built.stats["pack_seconds"] > 0
    loaded = cli.get_plan("m", csr, cli.DEFAULT_CONFIG, cache=True)
    assert loaded is not built
    # the pack time is the one measured when the plan was built
    assert loaded.stats["pack_seconds"] == built.stats["pack_seconds"]
    x = rng.standard_normal(csr.n_cols)
    np.testing.assert_array_equal(
        SpMVOperator(loaded, device="cpu", force_streamed=True)(x),
        SpMVOperator(built, device="cpu", force_streamed=True)(x))
    assert not (tmp_path / "nocache").exists()
    cli.get_plan("m", csr, cli.DEFAULT_CONFIG, cache=False)
    assert len(list((tmp_path / "cache").iterdir())) == 1


def test_summary_and_handlers_restore():
    import signal
    s = cli.Summary(4)
    assert json.loads(s.line())["value"] == 0.0
    s.gflops += [1.0, 4.0]
    s.ratios.append(2.0)
    s.done = 2
    assert json.loads(s.line()) == {
        "metric": "spmv_gflops_geomean", "value": 2.0, "unit": "GFLOP/s",
        "vs_baseline": 2.0, "arms_done": 2, "arms_total": 4}
    before = {sig: signal.getsignal(sig)
              for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)}
    restore = cli.install_handlers(s, 1000.0)
    assert signal.getsignal(signal.SIGALRM) is not before[signal.SIGALRM]
    restore()
    assert {sig: signal.getsignal(sig) for sig in before} == before
    assert signal.alarm(0) == 0


def test_geomean():
    assert abs(geomean([1.0, 4.0]) - 2.0) < 1e-12
    assert geomean([]) == 0.0
