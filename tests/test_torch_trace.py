"""The port's span recorder (dasp_tpu_torch.trace) and the spans the
program records: CG's solve, the pack and the operator's set-up, on the
CPU; with no profiler no record_function is entered, under one each span
is a user annotation on the profiler's clock."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dasp_tpu_torch import DaspConfig, SpMVOperator, build_wplan, trace
from dasp_tpu_torch.examples.cg_solver import K, build_spd, cg_solve
from dasp_tpu_torch.io.build import ensure_built
from dasp_tpu_torch.sparse import mixed_categories

torch.set_num_threads(1)
ensure_built()

N = 1024
GAP_NS = 1_000_000          # what spans that tile another may leave out


def _since(n_before: int, names=None) -> list:
    """Spans finished after the ring held ``n_before`` (the ring is far
    from full in these tests)."""
    recs = trace.records()[n_before:]
    return [r for r in recs if names is None or r.name in names]


def _kids(recs, parent) -> list:
    return sorted((r for r in recs if r.parent == parent.id),
                  key=lambda r: r.start_ns)


def _assert_tiles(parent, kids, names):
    assert [k.name for k in kids] == list(names)
    assert parent.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= parent.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    covered = sum(k.end_ns - k.start_ns for k in kids)
    assert parent.end_ns - parent.start_ns - covered < GAP_NS


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(3)
    csr = build_spd(N, rng)
    b = csr.spmv(rng.standard_normal(N))
    op = SpMVOperator(csr, dtype="f64", config=DaspConfig(row_sort="off"),
                      device="cpu")
    return op, b


def test_each_cg_solve_is_one_span_tiled_by_its_three_phases(spd):
    op, b = spd
    n0 = len(trace.records())
    its = [cg_solve(op, b, tol=1e-8 * np.linalg.norm(b), maxiter=400)[2]
           for _ in range(2)]
    recs = _since(n0)
    solves = [r for r in recs if r.name == "cg.solve"]
    assert len(solves) == 2
    for s, it in zip(solves, its):
        assert s.parent is None
        kids = _kids(recs, s)
        _assert_tiles(s, kids, ("cg.setup", "cg.iterate", "cg.finish"))
        reads = -(-it // K)
        assert kids[1].counts == {"iterations": it, "readbacks": reads,
                                  "frozen": reads * K - it} and it > 0
        # on the CPU, which keeps no allocator statistics: the tensors
        # of the solve's state (b, x, r, p; the device's scalars, rs and
        # count their views, tol2, maxiter, live; the host's copy of
        # scalars)
        assert s.counts == {"state_tensors": 11}
        assert not any(r.profiled for r in [s] + kids)


def test_build_wplan_records_pack_tiled_by_its_four_phases():
    csr = mixed_categories(600, np.random.default_rng(5))
    n0 = len(trace.records())
    build_wplan(csr)
    recs = _since(n0)
    packs = [r for r in recs if r.name == "pack"]
    assert len(packs) == 1 and packs[0].parent is None
    _assert_tiles(packs[0], _kids(recs, packs[0]),
                  ("pack.order", "pack.rows", "pack.tables", "pack.check"))


@pytest.mark.parametrize("given", ["plan", "csr"])
def test_an_operator_records_op_setup_tiled_by_its_phases(given):
    csr = mixed_categories(600, np.random.default_rng(6))
    src = build_wplan(csr) if given == "plan" else csr
    n0 = len(trace.records())
    op = SpMVOperator(src, dtype="f32", device="cpu")
    recs = _since(n0)
    setup = [r for r in recs if r.name == "op.setup"]
    assert len(setup) == 1 and setup[0].parent is None
    names = ("op.lower", "op.schedule", "op.upload")
    if given == "csr":           # the constructor's own pack nests in it
        names = ("pack",) + names
    _assert_tiles(setup[0], _kids(recs, setup[0]), names)
    assert op.preprocess_seconds == setup[0].seconds > 0


def test_no_record_function_without_a_profiler(spd, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    op, b = spd
    n0 = len(trace.records())
    cg_solve(op, b, tol=1e-6 * np.linalg.norm(b), maxiter=50)
    build_wplan(mixed_categories(300, np.random.default_rng(7)))
    assert len(_since(n0, {"cg.solve", "pack"})) == 2


def test_each_span_is_a_user_annotation_under_a_profiler(spd):
    op, b = spd
    n0 = len(trace.records())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cg_solve(op, b, tol=1e-6 * np.linalg.norm(b), maxiter=50)
        build_wplan(mixed_categories(300, np.random.default_rng(8)))
    recs = _since(n0)
    assert len(recs) == 9        # 4 of the solve, 5 of the pack
    assert all(r.profiled for r in recs)
    notes = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            notes.setdefault(e.name(), []).append(e)
    for r in recs:
        assert len(notes.get(r.name, ())) == 1, r.name
        e = notes[r.name][0]
        assert abs(e.start_ns() - r.start_ns) < 1_000_000, r
        assert abs(e.end_ns() - r.end_ns) < 1_000_000, r


def test_the_ring_keeps_at_most_its_capacity():
    rec = trace.Recorder(capacity=8)
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
    got = rec.records()
    assert [r.name for r in got] == [f"s{i}" for i in range(12, 20)]
    assert [r.id for r in got] == list(range(13, 21))


def test_phases_end_with_their_span_and_counts_go_innermost():
    rec = trace.Recorder()
    rec.count("lost")                          # outside every span
    with rec.span("outer", bytes=3) as outer:
        rec.phase("a")
        rec.count("items", 2)
        with rec.span("inner"):
            rec.count("items")
        rec.phase("b")
        rec.count("items", 5)
    rec.count("lost")
    by = {r.name: r for r in rec.records()}
    assert sorted(by) == ["a", "b", "inner", "outer"]
    assert by["outer"].counts == {"bytes": 3} and by["outer"] is outer
    assert by["a"].counts == {"items": 2} and by["b"].counts == {"items": 5}
    assert by["inner"].counts == {"items": 1}
    assert by["a"].parent == by["b"].parent == outer.id
    assert by["inner"].parent == by["a"].id
    assert by["a"].end_ns <= by["b"].start_ns
    assert by["b"].end_ns <= outer.end_ns


def test_a_raising_span_closes_with_its_phases():
    rec = trace.Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            rec.phase("a")
            raise ValueError
    assert [r.name for r in rec.records()] == ["a", "outer"]
    with rec.span("next") as nxt:
        pass
    assert nxt.parent is None
