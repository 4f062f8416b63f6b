"""Graph500's Kronecker graph as the adjacency matrix that an SpMV reads.

The edge list is the Graph500 specification's ``kronecker_generator``
(Graph 500 Benchmark, section 3.2, its Octave reference): N = 2^scale
vertices and M = edgefactor * N edges, each edge setting one bit of its
start and end vertex per level with the initiator probabilities
A = 0.57, B = 0.19, C = 0.19 (D = 0.05); then a random permutation of
the vertex labels (which the permutation of the edge list leaves out,
since a CSR matrix sorts its entries anyway).  Kernel 1's graph is
undirected: the matrix holds each edge in both directions, once, and no
self-loops, as the specification lets kernel 1 drop them.  The pattern
(``pattern``) comes from the configuration's fixed ``pattern_seed`` and
is the same in every run, so the harness keeps it on disk; the values
(``values``), uniform in [0, 1) as Graph500's edge weights, come from the
run's seed.

Plain NumPy: imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

VALUES_SEEDED = True
INITIATOR = (0.57, 0.19, 0.19)


def edges(scale: int, edgefactor: int, rng: np.random.Generator):
    """The specification's edge list (start, end), 0-based int64; the
    bits of each level are drawn in float32."""
    n, m = 1 << scale, edgefactor << scale
    a, b, c = INITIATOR
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    thr = np.array([a_norm, c_norm], dtype=np.float32)
    ij = np.zeros((2, m), dtype=np.int32)
    for ib in range(scale):
        ii_bit = rng.random(m, dtype=np.float32) > ab
        jj_bit = rng.random(m, dtype=np.float32) > thr[ii_bit.view(np.int8)]
        ij[0] |= ii_bit.view(np.int8).astype(np.int32) << ib
        ij[1] |= jj_bit.view(np.int8).astype(np.int32) << ib
    return rng.permutation(n)[ij].astype(np.int64)


def pattern(params: dict):
    """(n_rows, n_cols, row_ptr int64, col_idx int32)."""
    scale = int(params["scale"])
    n = 1 << scale
    start, end = edges(scale, int(params["edgefactor"]),
                       np.random.default_rng(int(params["pattern_seed"])))
    loop = start == end
    start, end = start[~loop], end[~loop]
    keys = np.unique(np.concatenate([start * n + end, end * n + start]))
    rows = keys >> scale
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    return n, n, row_ptr, (keys & (n - 1)).astype(np.int32)


def values(nnz: int, seed: int) -> np.ndarray:
    """float64, uniform in [0, 1)."""
    return np.random.default_rng(seed).random(nnz)


def generate(params: dict, seed: int):
    """(n_rows, n_cols, row_ptr int64, col_idx int32, values float64)."""
    n_rows, n_cols, row_ptr, col_idx = pattern(params)
    return n_rows, n_cols, row_ptr, col_idx, values(len(col_idx), seed)
