"""Shared runtime utilities (the JAX compile-cache helper of
``dasp_tpu.utils`` has no counterpart here)."""

from __future__ import annotations

import functools
import gc


def gc_paused(fn):
    """Run ``fn`` with the cyclic GC paused (re-enabled afterwards).

    The packers allocate hundreds of thousands of small numpy views
    (per-vreg tiles); every gen-2 collection walks all of them, and the
    allocation rate triggers collections constantly.  Measured on the
    1-vCPU build box: webbase_like pack 22s -> 4.7s with GC off — the
    actual garbage is reclaimed by refcounting, so pausing is safe.
    The reference's all-native packers have no analog cost
    (dasp_f16.h:1162-1446)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        was = gc.isenabled()
        gc.disable()
        try:
            return fn(*args, **kwargs)
        finally:
            if was:
                gc.enable()
    return wrapper


def graphed(step, reps: int = 1):
    """Capture ``reps`` calls of ``step`` in one CUDA graph (after warm-up
    on a side stream, as torch.cuda.graphs asks) and return its replay.
    The warm-up calls also build the kernels on their first use.  What
    ``step`` allocates lives in the graph's own pool: a tensor it returned
    during capture is overwritten by every replay and stays valid while
    the replay callable is alive."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            step()
    return g.replay
