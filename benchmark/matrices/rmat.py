"""An R-MAT graph (Chakrabarti, Zhan and Faloutsos, "R-MAT: A Recursive
Model for Graph Mining", SDM 2004) as the adjacency matrix that an SpMV
reads, at any number of vertices and an exact number of edges.

Each edge picks one of four quadrants per level, with probabilities a, b,
c and 1 - a - b - c, over ``levels = (n - 1).bit_length()`` levels; each
level's split carries +-10 % noise (one draw a level, shared by its
edges), so degrees stay off the recursion's exact powers.  Edges that
fall outside n x n are rejected, repeats merged (a simple directed graph,
self-loops kept), more drawn until there are ``nnz``, and a random excess
dropped to reach exactly ``nnz``.  The pattern (``pattern``) comes from
the configuration's ``pattern_seed`` and is the same in every run, so the
harness keeps it on disk; the values (``values``), standard normal, come
from the run's seed.

Plain NumPy: imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

VALUES_SEEDED = True


def _draw(m: int, n: int, levels: int, a: float, b: float, c: float,
          rng: np.random.Generator) -> np.ndarray:
    """Up to m edges as fused keys row * n + col, those out of range
    rejected."""
    r = np.zeros(m, np.int64)
    q = np.zeros(m, np.int64)
    ab = a + b
    for _ in range(levels):
        noise = 1.0 + (rng.random(2) - 0.5) * 0.2
        a_l, ab_l = a * noise[0], min(ab * noise[1], 0.97)
        down = rng.random(m) >= ab_l            # the c|d half
        u = rng.random(m)
        right = np.where(down, u >= (c / max(1 - ab_l, 1e-9)),
                         u >= (a_l / ab_l))
        r = (r << 1) | down
        q = (q << 1) | right
    ok = (r < n) & (q < n)
    return r[ok] * n + q[ok]


def pattern(params: dict):
    """(n_rows, n_cols, row_ptr int64, col_idx int32)."""
    n, nnz = int(params["n"]), int(params["nnz"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    if not 0 < nnz <= n * n:
        raise ValueError(f"R-MAT: {nnz} edges do not fit {n} x {n}")
    rng = np.random.default_rng(int(params["pattern_seed"]))
    levels = int(n - 1).bit_length()
    keys = np.unique(_draw(int(nnz * 1.45) + 1024, n, levels, a, b, c, rng))
    while keys.size < nnz:
        keys = np.union1d(keys, _draw(int((nnz - keys.size) * 2) + 1024, n,
                                      levels, a, b, c, rng))
    if keys.size > nnz:
        keys = keys[np.sort(rng.choice(keys.size, nnz, replace=False))]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys // n, minlength=n), out=row_ptr[1:])
    return n, n, row_ptr, (keys % n).astype(np.int32)


def values(nnz: int, seed: int) -> np.ndarray:
    """float64, standard normal."""
    return np.random.default_rng(seed).standard_normal(nnz)


def generate(params: dict, seed: int):
    """(n_rows, n_cols, row_ptr int64, col_idx int32, values float64)."""
    n_rows, n_cols, row_ptr, col_idx = pattern(params)
    return n_rows, n_cols, row_ptr, col_idx, values(len(col_idx), seed)
