"""BENCHMARK.json against its contract, and every file it names found by
name."""

import copy
import json
import os
import re

import pytest

from benchmark.harness.spec import Spec
from conftest import NAME, problems

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_its_contract(data):
    assert set(data) == KEYS
    assert problems(data, ROOT) == []
    assert data["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= data["run_seconds"] <= 51
    assert all(0.01 <= m["bound"] <= 0.25 for m in data["end_to_end"])
    assert any(m["name"] == "setup_s" for m in data["end_to_end"])
    used = {w["config"] for w in data["workloads"]}
    assert used == {c["name"] for c in data["configs"]}
    assert len({(w["config"], w["traffic"]) for w in data["workloads"]}) \
        == len(data["workloads"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


@pytest.mark.parametrize("group,key,bad", [
    ("workloads", "name", "a cell"), ("workloads", "traffic", "a/b"),
    ("end_to_end", "unit", "tokens per second"),
    ("end_to_end", "name", "µs_step"), ("per_layer", "layer", "a\tb"),
    ("configs", "name", "x" * 65)])
def test_a_broken_name_is_found(data, group, key, bad):
    broken = copy.deepcopy(data)
    broken[group][0][key] = bad
    assert problems(broken, ROOT)


def test_every_cell_reports_setup_another_metric_and_a_layer(data):
    spec = Spec(ROOT)
    for w in data["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        assert cell.limits and cell.traffic["kind"]
        gen = spec.generator(cell.config["generator"])
        assert callable(gen.generate)


def test_files_under_paths_are_named_from_name_characters(data):
    for base in data["paths"]:
        for d, dirs, files in os.walk(os.path.join(ROOT, base)):
            dirs[:] = [x for x in dirs
                       if x not in ("__pycache__", ".cache")]
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
                assert NAME.fullmatch(f), rel


def reduced_problems(data: dict, root: str) -> list:
    """Where a configuration's ``reduced`` misses a cut, whatever its
    name; empty when all is well.  ``reduced`` is the same list in its
    ``BENCHMARK.json`` entry and in its file, each name in it is a key of
    the file's ``params`` and of its ``published``, and every key of
    ``params`` whose value differs from ``published``'s is in it."""
    out = []
    for c in data["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        reduced = set(c["reduced"])
        if set(cfg.get("reduced", ())) != reduced:
            out.append(f"{c['name']}: reduced {sorted(reduced)} in "
                       f"BENCHMARK.json, {cfg.get('reduced')} in its file")
        params, published = cfg["params"], cfg.get("published", {})
        for k in sorted(reduced - (params.keys() & published.keys())):
            out.append(f"{c['name']}: reduced {k} is not a key of both "
                       f"params and published")
        for k in sorted(params.keys() & published.keys()):
            if params[k] != published[k] and k not in reduced:
                out.append(f"{c['name']}: {k} is {params[k]}, published "
                           f"{published[k]}, and not in reduced")
    return out


def test_configs_hold_their_published_sizes(data):
    spec = Spec(ROOT)
    hpcg = spec.cell("hpcg104_f64.cg").config
    n = hpcg["params"]["nx"]
    assert (hpcg["params"]["ny"], hpcg["params"]["nz"]) == (n, n) == (104,
                                                                      104)
    assert hpcg["rows"] == n ** 3 and hpcg["nnz"] == (3 * n - 2) ** 3
    g = spec.cell("graph500s20_f32.chain").config
    assert g["params"]["edgefactor"] == 16
    assert g["rows"] == 2 ** g["params"]["scale"]
    assert g["published"]["scale"] == 26
    reduced = {c["name"]: c["reduced"] for c in data["configs"]}
    assert reduced["hpcg104_f64"] == [] and hpcg["reduced"] == []
    assert reduced["graph500s20_f32"] == ["scale"]
    assert g["reduced"] == ["scale"]
    assert reduced_problems(data, ROOT) == []


def test_a_split_metric_falls_back_to_its_base_file(tmp_path):
    spec = Spec(ROOT)
    metrics = os.path.join(spec.dir, "metrics")
    assert spec.metric_file("k6_roofline.cg") == os.path.join(
        metrics, "k6_roofline.py")
    assert spec.metric_file("device_idle.spmm") == os.path.join(
        metrics, "device_idle.py")
    assert spec.metric_file("spmv_gflops") == os.path.join(
        metrics, "spmv_gflops.py")
    assert not os.path.isfile(spec.metric_file("no_such.metric"))
