"""Benchmark inputs: the calibrated SuiteSparse stand-ins of ``suite.py``
(numpy-only).  The JAX package's timing harness and BCOO baseline have
no counterpart here yet."""

from .suite import SUITE, build_suite, geomean  # noqa: F401
