"""Spans and counters of the port's phases, on the clock of
``torch.profiler``'s trace.

A span records its name, an id, the id of the span open around it, its
start and end in nanoseconds of ``time.time_ns()`` (the epoch clock onto
which kineto puts host events and CUPTI's device events alike, so that a
span lies beside the device's kernels and idle gaps), and counts.  Spans
mark phases: a few a CG solve (``cg.solve``: ``cg.setup``,
``cg.iterate``, ``cg.finish``), a few a pack (``pack``: ``pack.order``,
``pack.rows``, ``pack.tables``, ``pack.check``) and a few an operator
(``op.setup``: ``op.lower``, ``op.schedule``, ``op.upload``); nothing is
recorded per iteration, per launch or per SpMV.  Finished spans go to a
ring of fixed capacity that drops the oldest; ``records()`` returns them,
oldest first.

There is no switch.  While a ``torch.profiler`` session is active, each
span is also a ``record_function`` of its name, shows on the trace's
host timeline and is marked ``profiled`` (it carries the profiler's
cost, which a reader may leave out); otherwise no ``record_function`` is entered (it costs
~14 µs a call even with no profiler, the flag ~0.3 µs)::

    with trace.span("cg.solve"):
        ...
        trace.count("iterations", it)

``phase(name)`` ends the phase open in the innermost span, if any, and
begins the next: a long function marks its parts where they begin, and
its last phase ends with the span around it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Dict, List, Optional

import torch.autograd.profiler as _profiler

CAPACITY = 65536


class Span:
    """One span: ``end_ns`` is None while it is open; ``profiled`` is true
    where it was also a ``record_function`` (a profiler session was on
    when it opened)."""
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counts",
                 "phase", "profiled", "_annotation")

    def __init__(self, name: str, id_: int, parent: Optional[int],
                 counts: Dict[str, int], phase: bool):
        self.name, self.id, self.parent = name, id_, parent
        self.counts, self.phase = counts, phase
        self.start_ns = self.end_ns = None
        self.profiled = False
        self._annotation = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.start_ns}..{self.end_ns}, {self.counts})")


class Recorder:
    """Open spans on one stack, finished ones in a ring of ``capacity``."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._stack: List[Span] = []

    def _open(self, name: str, counts: Dict[str, int], phase: bool) -> Span:
        stack = self._stack
        rec = Span(name, next(self._ids), stack[-1].id if stack else None,
                   counts, phase)
        # the span holds its annotation: a process's first one takes
        # ~1 ms to enter, the others ~30 µs
        rec.start_ns = time.time_ns()
        if _profiler._is_profiler_enabled:
            rec.profiled = True
            rec._annotation = _profiler.record_function(name)
            rec._annotation.__enter__()
        stack.append(rec)
        return rec

    def _close(self) -> None:
        rec = self._stack.pop()
        if rec._annotation is not None:
            rec._annotation.__exit__(None, None, None)
            rec._annotation = None
        rec.end_ns = time.time_ns()
        self._ring.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, **counts: int):
        """A span around the ``with`` block (or, as a decorator, around
        each call); yields its record, whose ``seconds`` is set on exit."""
        rec = self._open(name, dict(counts), False)
        try:
            yield rec
        finally:
            while self._stack[-1] is not rec:    # phases opened inside it
                self._close()
            self._close()

    def phase(self, name: str) -> Span:
        """End the phase open in the innermost span and begin ``name``."""
        if self._stack and self._stack[-1].phase:
            self._close()
        return self._open(name, {}, True)

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` to ``key`` of the innermost open span (nothing outside
        every span)."""
        if self._stack:
            counts = self._stack[-1].counts
            counts[key] = counts.get(key, 0) + n

    def records(self) -> List[Span]:
        """The finished spans the ring holds, oldest first."""
        return list(self._ring)


RECORDER = Recorder()
span = RECORDER.span
phase = RECORDER.phase
count = RECORDER.count
records = RECORDER.records
