"""An R-MAT graph (Chakrabarti, Zhan and Faloutsos, SDM 2004) as the
adjacency matrix an SpMV reads: N = 2^scale vertices, edgefactor * N edges
each dropped into one of four quadrants per level with probabilities
a, b, c and 1 - a - b - c, repeats merged.  The pattern comes from the
configuration's ``pattern_seed``, the values (standard normal) from the
run's seed.

Plain NumPy: imports nothing of the program.
"""

import numpy as np

VALUES_SEEDED = True


def generate(params: dict, seed: int):
    """(n_rows, n_cols, row_ptr int64, col_idx int32, values float64)."""
    scale = int(params["scale"])
    n, m = 1 << scale, int(params["edgefactor"]) << scale
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    rng = np.random.default_rng(int(params["pattern_seed"]))
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        u = rng.random(m)
        down = u >= a + b
        right = ((u >= a) & (u < a + b)) | (u >= a + b + c)
        rows = 2 * rows + down
        cols = 2 * cols + right
    keys = np.unique(rows * n + cols)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys // n, minlength=n), out=row_ptr[1:])
    values = np.random.default_rng(seed).standard_normal(len(keys))
    return n, n, row_ptr, (keys % n).astype(np.int32), values
