"""The ``rmat_f32`` configuration, shrunk, under the ``spmm`` kind of the
``spmm8`` mix, added to a throwaway copy of the benchmark as new files and
entries only: it holds to the published-size rule, runs on the CPU
correct with both host-pack counters above 0, the control fails its limit
where the program passes it, and the counters' metrics stay silent on a
program that counts nothing."""

import json
import os
import shutil
import sys
import types

import pytest

from benchmark.control import readings
from benchmark.harness import cell
from benchmark.harness.spec import Spec
from conftest import ROOT, problems
from test_cells_spec import reduced_problems

import dasp_tpu_torch

CONFIG, TRAFFIC, CELL = "rmat_t", "spmm8_rmat_t", "rmat_t.spmm8_rmat_t"
LIKE = "rmat_f32.spmm8"
# wiki-Talk's 2.1 entries a row at 200,000 rows: long rows, rows of 1-4
# entries and a COO residue, as at the published size
SHRUNK = {"n": 200_000, "nnz": 420_000}
COUNTERS = ("table_slots_per_nnz", "residue_share")
SECONDS = 0.3
SEED = 2 ** 32 + 2 ** 31 + 99


@pytest.fixture(scope="module")
def rmat_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rmat_root"))
    bench = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    with open(os.path.join(bench, "configs", "rmat_f32.json")) as f:
        cfg = json.load(f)
    for k in ("rows", "nnz"):              # the published sizes
        cfg.pop(k)
    cfg.update(name=CONFIG, params=dict(cfg["params"], **SHRUNK),
               reduced=sorted(SHRUNK))
    with open(os.path.join(bench, "traffic", "spmm8.json")) as f:
        mix = dict(json.load(f), replay_model_ms=1e-5)
    for path, data in ((("configs", f"{CONFIG}.json"), cfg),
                       (("traffic", f"{TRAFFIC}.json"), mix)):
        with open(os.path.join(bench, *path), "w") as f:
            json.dump(data, f)
    shutil.copy(os.path.join(bench, "limits", f"{LIKE}.json"),
                os.path.join(bench, "limits", f"{CELL}.json"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    data["configs"].append({
        "name": CONFIG, "source": "https://example.org/rmat",
        "file": f"benchmark/configs/{CONFIG}.json",
        "reduced": sorted(SHRUNK), "why": "a CPU test's size"})
    data["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
        "why": "a CPU test"})
    for m in data["end_to_end"] + data["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f, indent=1)
    return root


def test_the_shrunk_config_holds_to_the_published_size_rule(rmat_root):
    with open(os.path.join(rmat_root, "BENCHMARK.json")) as f:
        data = json.load(f)
    assert problems(data, rmat_root) == []
    assert reduced_problems(data, rmat_root) == []
    full = Spec(ROOT).cell(LIKE).config
    assert full["reduced"] == [] and full["params"]["n"] == full["rows"]
    assert full["params"]["nnz"] == full["nnz"]
    assert Spec(rmat_root).cell(CELL).traffic["kind"] == "spmm"


@pytest.mark.parametrize("trace", [False, True])
def test_the_shrunk_cell_runs_correct(rmat_root, trace):
    spec = Spec(rmat_root)
    out = cell.run(spec, CELL, SEED, SECONDS, trace, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["checks"]) == ["y_err"]
    c = spec.cell(CELL)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:     # no device trace on the CPU: those metrics stay out
        want = {m for m in want if not m.startswith(("k6_", "device_"))}
        assert set(COUNTERS) <= want
    else:
        assert want == {"setup_s", "spmm_gflops"}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    if trace:
        assert out["metrics"]["table_slots_per_nnz"]["value"] >= 1
        assert out["metrics"]["residue_share"]["value"] < 100


def test_the_control_fails_and_the_program_passes(rmat_root):
    spec = Spec(rmat_root)
    limit = spec.cell(CELL).limits["y_err"]
    got = list(readings(spec, [CELL], [1, 2], [1], SECONDS, "cpu"))
    assert [(side, seed) for _, side, seed, _ in got] == [
        ("program", 1), ("control", 1), ("program", 2)]
    for _, side, _, checks in got:
        assert (checks["y_err"] > limit) == (side == "control"), checks


@pytest.mark.parametrize("records", ["none", "no counts", "no recorder"])
def test_without_the_counts_the_metrics_are_silent(rmat_root, records,
                                                   monkeypatch):
    """As on a program that counts nothing on ``op.lower``: no value, no
    exception."""
    spec = Spec(rmat_root)
    if records == "no recorder":
        monkeypatch.delattr(dasp_tpu_torch, "trace")
        monkeypatch.setitem(sys.modules, "dasp_tpu_torch.trace", None)
    else:
        rec = dasp_tpu_torch.trace.Recorder()
        if records == "no counts":
            with rec.span("op.setup"):
                with rec.span("op.lower"):
                    pass
        monkeypatch.setattr(dasp_tpu_torch.trace, "records", rec.records)
    run = types.SimpleNamespace(nnz=SHRUNK["nnz"])
    for name in COUNTERS:
        assert spec.reader(name)(run) is None, name
