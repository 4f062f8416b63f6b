"""Seconds of ``op.lower``, the program's span inside the run's operator
set-up (``ops/cuda_backend.py:TorchSpMV.__init__``)."""

from benchmark.harness.spans import setup_phase_s


def read(run):
    return setup_phase_s("op.setup", "op.lower")
