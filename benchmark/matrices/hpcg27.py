"""HPCG's problem matrix: the 27-point stencil on an nx x ny x nz grid.

As HPCG's reference ``GenerateProblem_ref.cpp`` builds it for one rank:
row i = ix + nx * (iy + ny * iz); its columns are the grid points at
offsets (dz, dy, dx) in {-1, 0, 1}^3 that lie inside the grid, in that
(ascending) order; the diagonal is 26 and every other entry -1.  Interior
rows have 27 entries, face rows 18, edge rows 12, corner rows 8, and a
cube of side n has (3n - 2)^3 entries in all.  HPCG fixes every value, so
nothing here depends on a run's seed.

Plain NumPy: imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

VALUES_SEEDED = False      # HPCG fixes the values; the seed makes vectors


def generate(params: dict, seed: int):
    """(n_rows, n_cols, row_ptr int64, col_idx int32, values float64)."""
    nx, ny, nz = int(params["nx"]), int(params["ny"]), int(params["nz"])
    n = nx * ny * nz
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    iz, iy, ix = iz.ravel(), iy.ravel(), ix.ravel()
    rows = np.arange(n, dtype=np.int64)
    cols = np.empty((n, 27), dtype=np.int32)
    keep = np.empty((n, 27), dtype=bool)
    diag = np.zeros(27, dtype=bool)
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                keep[:, k] = ((ix + dx >= 0) & (ix + dx < nx)
                              & (iy + dy >= 0) & (iy + dy < ny)
                              & (iz + dz >= 0) & (iz + dz < nz))
                cols[:, k] = rows + dx + nx * (dy + ny * dz)
                diag[k] = dz == dy == dx == 0
                k += 1
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=row_ptr[1:])
    values = np.broadcast_to(np.where(diag, 26.0, -1.0), (n, 27))[keep]
    return n, n, row_ptr, cols[keep], np.ascontiguousarray(values)
