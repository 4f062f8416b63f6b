"""Seconds of ``pack.rows``, the program's span inside the run's pack
(``wplan.py:build_wplan``)."""

from benchmark.harness.spans import setup_phase_s


def read(run):
    return setup_phase_s("pack", "pack.rows")
