"""Argument checks and CUDA-graph timing shared by the T1-T3 probes."""

from __future__ import annotations

import statistics

import torch


def check_args(fn: str, specs) -> torch.device:
    """Raise ValueError unless every (name, tensor, dtype, shape) of
    ``specs`` is a contiguous tensor of that dtype and shape on the first
    one's device, and that device is the CPU or the current CUDA device;
    return the device."""
    dev = specs[0][1].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    for name, t, dt, shape in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dt} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        # the kernel library launches on the current device's context
        raise ValueError(f"{fn}: {dev} is not the current CUDA device "
                         "(use torch.cuda.device(...))")
    return dev


def graph_ms(step, iters: int = 20, trials: int = 5) -> float:
    """Median over ``trials`` of the device time of one replay of ``step``
    captured in a CUDA graph (``iters`` replays between two CUDA events,
    after a warm-up on a side stream, as torch.cuda.graphs asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    g.replay()
    torch.cuda.synchronize()
    got = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            g.replay()
        b.record()
        b.synchronize()
        got.append(a.elapsed_time(b) / iters)
    return statistics.median(got)


def require_cuda(fn: str) -> torch.device:
    """The current CUDA device; raise SystemExit where there is none (the
    probes measure the card and have nothing to say about the CPU)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{fn}: needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())
