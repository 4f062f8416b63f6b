"""What the benchmark reads from ``torch.profiler``'s device trace.

Two readings, each inside a span of the benchmark's own
(``record_function``), so that they never depend on a kernel's name:

* ``stretch``: over a steady stretch of the window, the seconds in which
  some operation ran on the device (the union of kernels, copies and
  fills), the stretch's length, the device operations that took most
  time, and the idle gaps by what the host was doing meanwhile (the
  innermost host event, an ATen op, a CUDA runtime call or a span of the
  benchmark's, that covers the middle of each gap);
* ``device_seconds``: the summed device time of every operation that
  ``calls`` eager calls of an entry issue, timed alone.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "bench.stretch"
ALONE = "bench.alone"
BUSY_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 120


def tracer() -> profile:
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm() -> None:
    """Start and stop the profiler once: its first start takes seconds,
    which belong to the set-up and not to the traced window."""
    with tracer():
        torch.cuda.synchronize()


def _on_device(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in BUSY_KINDS
    return not e.is_user_annotation() and e.name() not in (STRETCH, ALONE)


def _span(events, name: str) -> Tuple[int, int]:
    host = [e for e in events if e.name() == name
            and e.device_type() != torch.autograd.DeviceType.CUDA]
    if not host:
        raise RuntimeError(f"the trace holds no span {name!r}")
    return host[0].start_ns(), host[0].end_ns()


def _top(acc: Dict[str, float]) -> List[list]:
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]]


def stretch(prof: profile) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of the STRETCH span."""
    events = prof.profiler.kineto_results.events()
    s0, s1 = _span(events, STRETCH)
    dev = sorted((max(e.start_ns(), s0), min(e.end_ns(), s1), e.name())
                 for e in events if _on_device(e)
                 and e.end_ns() > s0 and e.start_ns() < s1)
    ops: Dict[str, float] = defaultdict(float)
    gaps, busy, reach = [], 0, s0
    for a, b, name in dev:
        ops[name] += (b - a) / 1e9
        if a > reach:
            gaps.append((reach, a))
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    if s1 > reach:
        gaps.append((reach, s1))
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if e.device_type() != torch.autograd.DeviceType.CUDA
                  and e.name() != STRETCH)
    idle: Dict[str, float] = defaultdict(float)
    active, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        inner = min(active, key=lambda h: h[1] - h[0], default=None)
        idle[inner[2] if inner else "no host event"] += (b - a) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (s1 - s0) / 1e9,
            "device_ops": _top(ops), "idle_gaps": _top(idle)}


def device_seconds(fn: Callable[[], object], calls: int) -> float:
    """Device seconds of every operation that ``calls`` calls of ``fn``
    (warm) issue, summed over the ALONE span."""
    fn()
    torch.cuda.synchronize()
    with tracer() as prof:
        with record_function(ALONE):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    _span(events, ALONE)          # the session holds that span alone
    return sum(e.duration_ns() for e in events if _on_device(e)) / 1e9
