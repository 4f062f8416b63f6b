"""The per-layer metrics that read the program's own spans
(``harness/spans.py``), in traced runs of throwaway cells on the CPU; and
each of them silent, not failing, where the program records no spans."""

import sys
import time
import types

import pytest

from torch.profiler import ProfilerActivity, profile

from benchmark.harness import cell, drive
from benchmark.harness.spec import Spec

import dasp_tpu_torch

SECONDS = 0.3
SEED = 2 ** 31 + 777
CG = ("cg_setup_ms", "cg_iterate_ms", "cg_finish_ms", "cg_allocs")
SETUP = ("pack_order_s", "pack_rows_s", "pack_tables_s", "pack_check_s",
         "op_lower_s", "op_schedule_s", "op_upload_s")


def _traced(root, workload, monkeypatch):
    """(result, the kind that served the window) of a traced CPU run."""
    kinds = []
    window = drive.window

    def keep(kind, *args):
        kinds.append(kind)
        return window(kind, *args)
    monkeypatch.setattr(drive, "window", keep)
    out = cell.run(Spec(root), workload, SEED, SECONDS, True, "cpu")
    return out, kinds[0]


@pytest.mark.parametrize("workload,names", [
    ("tiny_hpcg.cg_t", CG + SETUP), ("tiny_graph.chain_t", SETUP)])
def test_a_traced_run_reports_each_span_metric_it_lists(
        tiny_root, workload, names, monkeypatch):
    out, _ = _traced(tiny_root, workload, monkeypatch)
    listed = {m["name"] for m in Spec(tiny_root).cell(workload).per_layer}
    assert listed & set(CG + SETUP) == set(names)
    for name in names:
        assert out["metrics"][name]["value"] > 0, name


def test_the_cg_phases_sum_to_the_mean_solve(tiny_root, monkeypatch):
    out, kind = _traced(tiny_root, "tiny_hpcg.cg_t", monkeypatch)
    phases = sum(out["metrics"][n]["value"] for n in CG[:3])
    mean_ms = sum(kind.request_s) / len(kind.request_s) * 1e3
    assert abs(phases - mean_ms) <= 0.03 * mean_ms, (phases, mean_ms)


def test_the_setup_phases_sum_to_pack_and_operator(tiny_root, monkeypatch):
    """The pack's phases against the harness's clock; the operator's
    against its span, which the harness's clock holds: at this size the
    operator takes ~10 ms, of which a collection of the test process's
    heap outside the span can be most."""
    out, _ = _traced(tiny_root, "tiny_graph.chain_t", monkeypatch)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    pack = sum(m[n] for n in SETUP[:4])
    op = sum(m[n] for n in SETUP[4:])
    setup = [r for r in dasp_tpu_torch.trace.records()
             if r.name == "op.setup"][-1]
    assert abs(pack - m["pack_s"]) <= 0.02 * m["pack_s"], (pack, m)
    assert abs(op - setup.seconds) <= 0.05 * setup.seconds, (op, setup)
    assert setup.seconds <= m["operator_s"], (setup, m)


def test_without_the_recorder_the_metrics_are_silent(tiny_root,
                                                     monkeypatch):
    """As on a program that records no spans: no value, no exception."""
    spec = Spec(tiny_root)
    run = types.SimpleNamespace(request_s=[0.01, 0.02], iters=[3, 3])
    monkeypatch.delattr(dasp_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "dasp_tpu_torch.trace", None)
    for name in CG + SETUP:
        assert spec.reader(name)(run) is None, name


def test_with_no_spans_recorded_the_metrics_are_silent(tiny_root,
                                                       monkeypatch):
    spec = Spec(tiny_root)
    run = types.SimpleNamespace(request_s=[0.01], iters=[3])
    monkeypatch.setattr(dasp_tpu_torch.trace, "records", lambda: [])
    for name in CG + SETUP:
        assert spec.reader(name)(run) is None, name


def test_the_cg_readers_leave_out_the_profiled_solves(tiny_root,
                                                      monkeypatch):
    """Solves that ran under a profiler (a traced run's stretch) carry its
    cost and stay out of the means; with none left the reading is None."""
    rec = dasp_tpu_torch.trace.Recorder()

    def solve(setup_s):
        with rec.span("cg.solve"):
            with rec.span("cg.setup"):
                time.sleep(setup_s)
            with rec.span("cg.iterate"):
                pass
            with rec.span("cg.finish"):
                pass
    solve(0.001)
    with profile(activities=[ProfilerActivity.CPU]):
        solve(0.03)
    solve(0.001)
    monkeypatch.setattr(dasp_tpu_torch.trace, "records", rec.records)
    spec = Spec(tiny_root)
    setups = [r.seconds * 1e3 for r in rec.records()
              if r.name == "cg.setup"]
    run = types.SimpleNamespace(request_s=[0.01] * 3, iters=[3] * 3)
    got = spec.reader("cg_setup_ms")(run)
    assert got == pytest.approx((setups[0] + setups[2]) / 2)
    run.request_s = [0.01]               # the window: the last solve only
    assert spec.reader("cg_setup_ms")(run) == pytest.approx(setups[2])
    rec.records()[-1].profiled = True    # every window solve profiled
    for name in CG:
        assert spec.reader(name)(run) is None, name
