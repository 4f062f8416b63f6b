"""Allocation calls per solve of the window: the ``device_allocs`` and
``host_allocs`` that the program counts on each ``cg.solve`` span on a
card (its cudaMalloc and cudaHostAlloc calls).  On the CPU, which keeps
no allocator statistics, the program counts ``state_tensors`` instead,
the tensors of the solve's state, and this reads those: the benchmark's
CPU tests ask every metric a cell lists for a value."""

from benchmark.harness.spans import cg_counts


def read(run):
    got = cg_counts(run, ("device_allocs", "host_allocs"))
    return cg_counts(run, ("state_tensors",)) if got is None else got
