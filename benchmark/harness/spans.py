"""What the per-layer metrics read from the program's own spans
(``dasp_tpu_torch.trace``) after a run.

Only the run's own spans: for CG the last ``len(run.request_s)``
``cg.solve`` spans, which are the window's solves (the warm-up solve
comes before them and nothing after the window solves), each with its
children, less those of a traced run's profiled stretch (``profiled``:
each span there is also a ``record_function`` and the profiler slows the
solve); for set-up the last main ``pack`` span (one that no ``op.lower``
holds: a residue sub-plan is packed while lowering) and the last
``op.setup`` span, each with its children.  Every function returns None
where the program records no such span (a program without the recorder
included), and never raises for that.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _records() -> Optional[list]:
    try:
        from dasp_tpu_torch import trace
    except ImportError:
        return None
    return trace.records()


def _children(recs: list, parents: set) -> Dict[int, Dict[str, object]]:
    kids: Dict[int, Dict[str, object]] = {}
    for r in recs:
        if r.parent in parents:
            kids.setdefault(r.parent, {})[r.name] = r
    return kids


def solves(run) -> Optional[List[tuple]]:
    """[(cg.solve span, {child name: span})] of the window's solves that
    ran with no profiler on."""
    recs = _records()
    n = len(run.request_s)
    if not recs or not n:
        return None
    mine = [r for r in recs if r.name == "cg.solve"][-n:]
    if len(mine) < n:
        return None
    mine = [r for r in mine if not r.profiled]
    kids = _children(recs, {r.id for r in mine})
    return [(r, kids.get(r.id, {})) for r in mine]


def cg_phase_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the child ``name`` over the window's solves."""
    got = solves(run)
    if not got or not all(name in kids for _, kids in got):
        return None
    return sum(kids[name].seconds for _, kids in got) / len(got) * 1e3


def cg_counts(run, keys) -> Optional[float]:
    """Mean over the window's solves of the sum of ``keys`` in each
    ``cg.solve`` span's counts; None where no solve counts any of them."""
    got = solves(run)
    if not got or not any(k in s.counts for s, _ in got for k in keys):
        return None
    return sum(s.counts.get(k, 0) for s, _ in got for k in keys) / len(got)


def setup_phase_s(root: str, name: str) -> Optional[float]:
    """Seconds of the child ``name`` of the last main ``root`` span
    (``pack`` or ``op.setup``)."""
    recs = _records()
    if not recs:
        return None
    lowering = {r.id for r in recs if r.name == "op.lower"}
    roots = [r for r in recs if r.name == root
             and r.parent not in lowering]
    if not roots:
        return None
    kid = _children(recs, {roots[-1].id}).get(roots[-1].id, {}).get(name)
    return None if kid is None else kid.seconds
