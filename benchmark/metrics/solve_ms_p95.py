"""The 95th percentile of every solve's wall time in the window, in
milliseconds (linear between the two nearest solves)."""

import numpy as np


def read(run):
    if not run.request_s:
        return None
    return float(np.percentile(run.request_s, 95)) * 1e3
