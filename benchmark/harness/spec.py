"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is a configuration under a traffic mix.
Everything that belongs to one of them sits in a file of its own under
the benchmark's folder, so a later change adds a cell by adding files and
entries and never edits a file that is there:

* ``configs/<config>.json`` (the path in the config's ``file``): the
  matrix's generator and its parameters, the dtype, the packing options;
* ``matrices/<generator>.py``: the generator, plain NumPy;
* ``traffic/<traffic>.json``: the parameters of one traffic mix, read by
  the one general driver (``harness/drive.py``); its ``kind`` names a
  kind of ``drive.KINDS`` or a file of its own:
* ``kinds/<kind>.py``: ``KIND``, a subclass of ``drive.Kind`` that makes
  a request kind's inputs, serves its requests, judges its outputs and
  puts its control in the program's place;
* ``limits/<workload>.json``: the limit of each number the run compares;
* ``metrics/<metric>.py``: ``read(run)``, the arithmetic of one metric;
  a metric named ``<base>.<part>`` (one quantity split by the end-to-end
  metric it moves) falls back to ``metrics/<base>.py`` where it has no
  file of its own.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration's file, as run
    traffic_name: str
    traffic: dict           # the traffic mix's parameters
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]  # BENCHMARK.json's metrics that this cell reports
    per_layer: List[dict]


class Spec:
    """``root``/BENCHMARK.json and ``root``/benchmark/..."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, BENCH_DIR)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def cell(self, workload: str) -> Cell:
        w = next((w for w in self.data["workloads"]
                  if w["name"] == workload), None)
        if w is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        entry = next(c for c in self.data["configs"]
                     if c["name"] == w["config"])
        with open(os.path.join(self.root, entry["file"])) as f:
            config = json.load(f)

        def mine(metrics):
            return [m for m in metrics
                    if workload in m.get("workloads", [workload])]
        return Cell(workload, config, w["traffic"],
                    self._json("traffic", f"{w['traffic']}.json"),
                    int(w["chips"]), self._json("limits", f"{workload}.json"),
                    mine(self.data["end_to_end"]),
                    mine(self.data["per_layer"]))

    def metric_file(self, metric: str) -> str:
        """``metrics/<metric>.py``, else ``metrics/<base>.py`` of a metric
        named ``<base>.<part>``."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        if not os.path.isfile(path) and "." in metric:
            path = os.path.join(self.dir, "metrics",
                                f"{metric.split('.')[0]}.py")
        return path

    def _module(self, folder: str, name: str, path: str = None):
        path = path or os.path.join(self.dir, folder, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"_bench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable[[object], Optional[float]]:
        """``read(run)`` of the metric's file (``metric_file``)."""
        return self._module("metrics", metric,
                            self.metric_file(metric)).read

    def generator(self, name: str):
        """``matrices/<name>.py``: ``generate(params, seed)`` and
        ``VALUES_SEEDED``."""
        return self._module("matrices", name)

    def kind(self, name: str) -> type:
        """The request kind a traffic mix names: ``drive.KINDS[name]``,
        else ``KIND`` of ``kinds/<name>.py``."""
        from . import drive
        if name in drive.KINDS:
            return drive.KINDS[name]
        kind = self._module("kinds", name).KIND
        if not (isinstance(kind, type) and issubclass(kind, drive.Kind)):
            raise TypeError(f"kinds/{name}.py: KIND is not a drive.Kind")
        return kind
