"""Share of the window's solves that ran on the operator's kept CG state:
the mean over the window's solves of the ``reused`` count on each one's
``cg.setup`` span (``examples/cg_solver.py:cg_solve``: 0 where the solve
built the state, 1 where it restarted the kept one).  None where no solve
counts it (a program that builds the state anew in every solve)."""

from benchmark.harness.spans import solves


def read(run):
    got = solves(run)
    setups = [kids.get("cg.setup") for _, kids in got or ()]
    if not any(s is not None and "reused" in s.counts for s in setups):
        return None
    return sum(s.counts.get("reused", 0) for s in setups
               if s is not None) / len(setups)
