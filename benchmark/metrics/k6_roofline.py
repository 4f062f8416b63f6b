"""K6's share of its bandwidth roofline, in percent: DASP's model-1 bytes
of one SpMV (of one pass over kv vectors) at the card's published HBM
rate, over the device time of every operation that one call of the
operator's device entry issues, timed alone in a profiler span."""

from benchmark.harness.roofline import model1_seconds


def read(run):
    if run.alone is None or run.alone["device_s"] <= 0:
        return None
    return 100.0 * model1_seconds(run.n_rows, run.n_cols, run.nnz, run.dtype,
                                  run.alone["kv"]) / run.alone["device_s"]
