"""The plain reference: a CSR matrix, its product, and the numbers that
judge the program's outputs.

Plain NumPy, independent of the program: it imports nothing of it and is
given only the inputs the benchmark made (the matrix and the vectors),
never a table, permutation or plan that the program built.  Products run
in blocks of rows, so that a matrix of tens of millions of entries times
eight vectors fits in a few hundred MB of host memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK_NNZ = 1 << 22          # entries per block of rows


@dataclasses.dataclass(frozen=True)
class Csr:
    n_rows: int
    n_cols: int
    row_ptr: np.ndarray      # int64 (n_rows + 1,)
    col_idx: np.ndarray      # int32 (nnz,)
    values: np.ndarray       # (nnz,), as the program is given them

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])


def _row_blocks(a: Csr):
    """(first row, end row) of consecutive row ranges of <= BLOCK_NNZ
    entries each (a longer row is a block of its own)."""
    r0 = 0
    while r0 < a.n_rows:
        r1 = int(np.searchsorted(a.row_ptr, a.row_ptr[r0] + BLOCK_NNZ,
                                 side="right")) - 1
        r1 = min(max(r1, r0 + 1), a.n_rows)
        yield r0, r1
        r0 = r1


def product(a: Csr, x: np.ndarray, dtype=np.float64,
            values: np.ndarray = None) -> np.ndarray:
    """A @ x for x of shape (n_cols,) or (n_cols, k): each product
    vals[e] * x[col[e]] rounded to ``dtype``, and each row's products
    summed left to right in ``dtype`` (float64 for the reference, a lower
    type for the control).  ``values`` replaces A's values (|A|, or values
    rounded for the control)."""
    vals = np.asarray(a.values if values is None else values, dtype=dtype)
    x = np.asarray(x, dtype=dtype)
    out = np.zeros((a.n_rows,) + x.shape[1:], dtype=dtype)
    for r0, r1 in _row_blocks(a):
        e0, e1 = int(a.row_ptr[r0]), int(a.row_ptr[r1])
        if e0 == e1:
            continue
        v = vals[e0:e1]
        prod = (v[:, None] if x.ndim == 2 else v) * x[a.col_idx[e0:e1]]
        lens = np.diff(a.row_ptr[r0:r1 + 1])
        nonempty = np.flatnonzero(lens)
        starts = (a.row_ptr[r0:r1] - e0)[nonempty]
        out[r0 + nonempty] = np.add.reduceat(prod, starts, axis=0)
    return out


def scaled_error(a: Csr, x: np.ndarray, y: np.ndarray) -> float:
    """max |y - A x| / max(|A| |x|, 1) over every entry of y (every row of
    every column): the error of y against the float64 product, in units
    of the magnitude the row's sum passes through.  inf when y has another
    shape or an entry that is not finite."""
    y = np.asarray(y, dtype=np.float64)
    golden = product(a, x)
    if y.shape != golden.shape or not np.isfinite(y).all():
        return float("inf")
    if not y.size:
        return 0.0
    mass = product(a, np.abs(np.asarray(x, np.float64)),
                   values=np.abs(np.asarray(a.values, np.float64)))
    return float((np.abs(y - golden) / np.maximum(mass, 1.0)).max())


def relative_residual(a: Csr, b: np.ndarray, x: np.ndarray) -> float:
    """||b - A x|| / ||b|| in float64; inf for an x of another shape or
    with an entry that is not finite."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape != (a.n_cols,) or not np.isfinite(x).all():
        return float("inf")
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b - product(a, x)) / np.linalg.norm(b))
