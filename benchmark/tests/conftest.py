"""Fixtures of the benchmark's CPU tests: a throwaway copy of the benchmark
with small cells added as files and entries only, run on the CPU through
the program's plain kernel versions."""

import json
import os
import re
import shutil
import sys

import pytest

from benchmark.harness.spec import Spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small configurations and traffic mixes of the four kinds, each judged by
# the limits of the full-size cell of its kind
TINY_CONFIGS = {
    "tiny_hpcg": ("hpcg104_f64.json", {"nx": 12, "ny": 10, "nz": 8}),
    "tiny_graph": ("graph500s20_f32.json",
                   {"scale": 11, "edgefactor": 16, "pattern_seed": 5}),
}
TINY_TRAFFIC = {
    "cg_t": ({"kind": "cg", "rtol": 1e-8, "maxiter": 1000, "pool": 2,
              "checked": 4}, "hpcg104_f64.cg"),
    "chain_t": ({"kind": "chain", "force_streamed": False,
                 "replay_model_ms": 1e-5}, "graph500s20_f32.chain"),
    "streamed_t": ({"kind": "chain", "force_streamed": True,
                    "replay_model_ms": 1e-5}, "graph500s20_f32.chain"),
    "spmm8_t": ({"kind": "spmm", "kv": 8, "replay_model_ms": 1e-5},
                "hpcg104_f64.spmm8"),
}
TINY_CELLS = {"tiny_hpcg.cg_t": "cg_t", "tiny_hpcg.spmm8_t": "spmm8_t",
              "tiny_graph.chain_t": "chain_t",
              "tiny_graph.streamed_t": "streamed_t"}


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\r\n]{1,200}")
BETTER = ("lower", "higher")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
BENCH_DIR = "benchmark"
def problems(data: dict, root: str) -> list:
    """What in a BENCHMARK.json breaks the naming rules or names a file
    that is not there; empty when all is well."""
    out = []
    d = os.path.join(root, BENCH_DIR)

    def name(what, v):
        if not isinstance(v, str) or not NAME.fullmatch(v):
            out.append(f"{what}: bad name {v!r}")

    def line(what, v):
        if not isinstance(v, str) or not LINE.fullmatch(v):
            out.append(f"{what}: not one line of 1-200 characters: {v!r}")
    cfgs = {c["name"] for c in data["configs"]}
    for c in data["configs"]:
        name("config", c["name"])
        line(f"{c['name']}.source", c["source"])
        line(f"{c['name']}.why", c["why"])
        for k in c["reduced"]:
            name(f"{c['name']}.reduced", k)
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"{c['name']}: no file {c['file']}")
    for w in data["workloads"]:
        name("workload", w["name"])
        name(f"{w['name']}.traffic", w["traffic"])
        line(f"{w['name']}.why", w["why"])
        if w["config"] not in cfgs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        for f in (os.path.join(d, "traffic", f"{w['traffic']}.json"),
                  os.path.join(d, "limits", f"{w['name']}.json")):
            if not os.path.isfile(f):
                out.append(f"{w['name']}: no file {f}")
    for m in data["end_to_end"] + data["per_layer"]:
        name("metric", m["name"])
        if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in BETTER or m["source"] not in SOURCES:
            out.append(f"{m['name']}: bad better or source")
        if not os.path.isfile(Spec(root).metric_file(m["name"])):
            out.append(f"{m['name']}: no file in metrics/")
        for w in m.get("workloads", []):
            if w not in {w["name"] for w in data["workloads"]}:
                out.append(f"{m['name']}: unknown workload {w}")
    for m in data["per_layer"]:
        line(f"{m['name']}.layer", m["layer"])
        if m["moves"] not in {e["name"] for e in data["end_to_end"]}:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in data[group]]
        if len(names) != len(set(names)):
            out.append(f"{group}: a name twice")
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")


def _write(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout-like root: BENCHMARK.json and a copy of benchmark/, with
    the tiny configurations, mixes and cells added as new files and new
    entries; nothing that was there is edited but BENCHMARK.json's
    lists, which gain entries."""
    root = str(tmp_path_factory.mktemp("bench_root"))
    bench = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        data = json.load(f)
    for name, (base, params) in TINY_CONFIGS.items():
        with open(os.path.join(bench, "configs", base)) as f:
            cfg = json.load(f)
        for k in ("rows", "nnz"):          # the published sizes
            cfg.pop(k)
        _write(os.path.join(bench, "configs", f"{name}.json"),
               dict(cfg, name=name, params=params))
        data["configs"].append({
            "name": name, "source": "https://example.org/tiny",
            "file": f"benchmark/configs/{name}.json",
            "reduced": ["params"], "why": "a CPU test's size"})
    for name, (params, like) in TINY_TRAFFIC.items():
        _write(os.path.join(bench, "traffic", f"{name}.json"), params)
    for cell, traffic in TINY_CELLS.items():
        like = TINY_TRAFFIC[traffic][1]
        shutil.copy(os.path.join(bench, "limits", f"{like}.json"),
                    os.path.join(bench, "limits", f"{cell}.json"))
        data["workloads"].append({
            "name": cell, "config": cell.split(".")[0], "traffic": traffic,
            "chips": 1, "why": "a CPU test"})
        for m in data["end_to_end"] + data["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    _write(os.path.join(root, "BENCHMARK.json"), data)
    return root
