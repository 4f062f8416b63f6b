"""Iterations per solve that the device ran past the stop: the mean over
the window's solves of the ``frozen`` count on each one's ``cg.iterate``
span (``examples/cg_solver.py:cg_solve``: a replay runs a block of
iterations, each left without effect once the stop test fails, so the
last replay of a solve runs up to a block less one past it).  None where
no solve counts it."""

from benchmark.harness.spans import solves


def read(run):
    got = solves(run)
    loops = [kids.get("cg.iterate") for _, kids in got or ()]
    if not loops or not all(s is not None and "frozen" in s.counts
                            for s in loops):
        return None
    return sum(s.counts["frozen"] for s in loops) / len(loops)
