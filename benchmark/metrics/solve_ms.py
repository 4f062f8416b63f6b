"""Milliseconds per solve: the wall time of every solve in the window over
the solves that converged (a solve at ``maxiter`` counts as failed)."""


def read(run):
    ok = len(run.request_s) - run.failed
    if not run.request_s or ok <= 0:
        return None
    return sum(run.request_s) / ok * 1e3
