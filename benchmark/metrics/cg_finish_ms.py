"""Mean milliseconds of ``cg.finish``, the program's span inside each solve
of the window (``examples/cg_solver.py:cg_solve``)."""

from benchmark.harness.spans import cg_phase_ms


def read(run):
    return cg_phase_ms(run, "cg.finish")
