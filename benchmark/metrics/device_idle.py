"""Percent of the traced stretch of the window in which no operation
(kernel, copy or fill) ran on the device: 100 (1 - busy_s / window_s)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
