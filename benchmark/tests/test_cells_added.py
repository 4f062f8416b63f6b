"""A configuration, a request kind, a traffic mix and a cell added to a
throwaway copy of the benchmark as new files and entries only (the files
under ``added/``): the harness finds each by name, the published-size rule
holds the configuration to its ``reduced``, the cell runs on the CPU, and
the control comes from the kind's own ``control``."""

import json
import os
import shutil

import pytest

from benchmark.control import readings
from benchmark.harness import cell, drive
from benchmark.harness.spec import Spec
from conftest import ROOT, problems
from test_cells_spec import reduced_problems

ADDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "added")
CONFIG, KIND, CELL = "added_rmat", "added_pool", "added_rmat.added_pool"
SECONDS = 0.3
SEED = 2 ** 33 + 77


@pytest.fixture(scope="module")
def added_root(tmp_path_factory):
    """BENCHMARK.json and a copy of benchmark/, with ``added/`` copied in
    as new files and the configuration and cell as new entries."""
    root = str(tmp_path_factory.mktemp("added_root"))
    bench = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    for d, dirs, files in os.walk(ADDED):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            dst = os.path.join(bench, os.path.relpath(os.path.join(d, f),
                                                      ADDED))
            assert not os.path.exists(dst), dst      # new files only
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(os.path.join(d, f), dst)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    data["configs"].append({
        "name": CONFIG, "source": "https://example.org/rmat",
        "file": f"benchmark/configs/{CONFIG}.json", "reduced": ["scale"],
        "why": "a CPU test's R-MAT graph"})
    data["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": KIND, "chips": 1,
        "why": "a CPU test of a kind added as a file"})
    for m in data["end_to_end"]:
        if m["name"] == "spmv_gflops":
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(data, f, indent=1)
    return root


def test_an_added_cell_is_files_and_entries_only(added_root):
    with open(os.path.join(added_root, "BENCHMARK.json")) as f:
        assert problems(json.load(f), added_root) == []
    spec = Spec(added_root)
    kind = spec.kind(KIND)
    assert issubclass(kind, drive.Kind) and kind not in drive.KINDS.values()
    assert "control" in vars(kind)
    assert spec.kind("cg") is drive.Cg and spec.kind("spmm") is drive.Spmm


def _problems_with(root, tmp_path, name, reduced, params):
    """``reduced_problems`` of ``root`` with config ``name``'s ``reduced``
    (entry and file) and ``params`` changed, in a copy under tmp_path."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        data = json.load(f)
    for c in data["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        if c["name"] == name:
            if reduced is not None:
                c["reduced"] = cfg["reduced"] = reduced
            cfg["params"].update(params)
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    return reduced_problems(data, str(tmp_path))


@pytest.mark.parametrize("name,reduced,params,found", [
    (CONFIG, None, {}, None),                           # as added
    (CONFIG, [], {}, "scale"),                          # cut, not listed
    ("graph500s20_f32", [], {}, "scale"),
    (CONFIG, None, {"edgefactor": 4}, "edgefactor"),    # a second cut
    (CONFIG, ["scale", "pattern_seed"], {}, "pattern_seed"),  # unpublished
])
def test_the_published_size_rule(added_root, tmp_path, name, reduced,
                                 params, found):
    got = _problems_with(added_root, tmp_path, name, reduced, params)
    if found is None:
        assert got == []
    else:
        assert got and all(p.startswith(f"{name}: ") for p in got)
        assert any(found in p for p in got), got


@pytest.mark.parametrize("trace", [False, True])
def test_the_added_cell_runs_by_name(added_root, trace):
    spec = Spec(added_root)
    out = cell.run(spec, CELL, SEED, SECONDS, trace, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["checks"]) == ["y_err"]
    c = spec.cell(CELL)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) == want
    if not trace:
        assert want == {"setup_s", "spmv_gflops"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_the_control_is_the_added_kinds_own(added_root):
    calls = []

    class Recording(Spec):
        def kind(self, name):
            base = super().kind(name)

            class Recorded(base):
                def control(self, a, below, device):
                    calls.append(below)
                    return super().control(a, below, device)
            return Recorded

    spec = Recording(added_root)
    limit = spec.cell(CELL).limits["y_err"]
    got = list(readings(spec, [CELL], [1, 2], [1], SECONDS, "cpu"))
    assert [(w, side, seed) for w, side, seed, _ in got] == [
        (CELL, "program", 1), (CELL, "control", 1), (CELL, "program", 2)]
    assert calls == ["tf32"]
    for _, side, _, checks in got:
        assert (checks["y_err"] > limit) == (side == "control"), checks


def test_a_kind_without_a_control_fails_loudly(added_root):
    class Bare(Spec):
        def kind(self, name):
            return type("Bare", (super().kind(name),),
                        {"control": drive.Kind.control})

    with pytest.raises(NotImplementedError):
        list(readings(Bare(added_root), [CELL], [], [1], SECONDS, "cpu"))
