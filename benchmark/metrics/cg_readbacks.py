"""Host read-backs per solve in the window: the mean over the window's
solves of the ``readbacks`` count on each one's ``cg.iterate`` span
(``examples/cg_solver.py:cg_solve``: one a replay of the captured block
of iterations, the read-back that ends the set-up left out).  None where
no solve counts it (a program that reads rs back after every iteration
counts none)."""

from benchmark.harness.spans import solves


def read(run):
    got = solves(run)
    loops = [kids.get("cg.iterate") for _, kids in got or ()]
    if not loops or not all(s is not None and "readbacks" in s.counts
                            for s in loops):
        return None
    return sum(s.counts["readbacks"] for s in loops) / len(loops)
