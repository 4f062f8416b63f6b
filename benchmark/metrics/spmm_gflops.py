"""GFLOP/s of SpMM: 2 nnz for each column completed in the window, over
the window's seconds (which end with a synchronize)."""


def read(run):
    if not run.columns:
        return None
    return 2.0 * run.nnz * run.columns / run.window_s / 1e9
