"""GFLOP/s of SpMVs: 2 nnz for each SpMV completed in the window, over
the window's seconds (which end with a synchronize)."""


def read(run):
    if not run.spmvs:
        return None
    return 2.0 * run.nnz * run.spmvs / run.window_s / 1e9
