"""CSR container, golden reference SpMV, and synthetic matrix generators.

The CSR triple (row_ptr, col_idx, values) mirrors what the reference's loader
produces (``mmio_highlevel.h:608-774``).  The golden SpMV plays the role
cuSPARSE plays in the reference (``main_f64.cu:19-100``): an independent
implementation every packed kernel is verified against.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row matrix on the host.

    row_ptr: int32/int64 array of shape (n_rows + 1,)
    col_idx: int32 array of shape (nnz,)
    values:  float array of shape (nnz,)
    """

    n_rows: int
    n_cols: int
    row_ptr: np.ndarray
    col_idx: np.ndarray
    values: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def row_lengths(self) -> np.ndarray:
        # Cached: the packer and the relabel policies read this repeatedly
        # and an np.diff over multi-M rows is a full memory pass each time.
        # CSRMatrix is treated as immutable everywhere (permutations build
        # new instances), so memoization is safe.
        rl = self.__dict__.get("_row_lengths")
        if rl is None:
            rl = np.diff(self.row_ptr)
            self.__dict__["_row_lengths"] = rl
        return rl

    def check(self) -> None:
        """Validate structural invariants."""
        assert self.row_ptr.shape == (self.n_rows + 1,)
        assert self.row_ptr[0] == 0
        assert np.all(np.diff(self.row_ptr) >= 0), "row_ptr must be monotone"
        assert self.col_idx.shape == (self.nnz,)
        assert self.values.shape == (self.nnz,)
        if self.nnz:
            assert self.col_idx.min() >= 0
            assert self.col_idx.max() < self.n_cols

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.float64)
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths)
        # Duplicate (row, col) entries accumulate, matching SpMV semantics.
        np.add.at(out, (rows, self.col_idx), self.values.astype(np.float64))
        return out

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Golden CSR SpMV in float64 on the host (the verification oracle,
        playing the role of cuSPARSE in ``main_f64.cu:146``)."""
        x = np.asarray(x, dtype=np.float64)
        prod = self.values.astype(np.float64) * x[self.col_idx]
        # Segment-sum per row via reduceat; guard empty rows.
        y = np.zeros(self.n_rows, dtype=np.float64)
        if self.nnz == 0:
            return y
        starts = self.row_ptr[:-1]
        nonempty = np.flatnonzero(np.diff(self.row_ptr) > 0)
        if nonempty.size:
            sums = np.add.reduceat(prod, starts[nonempty])
            y[nonempty] = sums
        return y


def from_coo(n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray,
             vals: np.ndarray, sum_duplicates: bool = False) -> CSRMatrix:
    """Build CSR from COO triplets (counting sort by row, stable in column
    order of appearance), mirroring ``mmio_highlevel.h:702-756``."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        order2 = np.lexsort((cols, rows))
        rows, cols, vals = rows[order2], cols[order2], vals[order2]
        keep = np.ones(rows.size, dtype=bool)
        keep[1:] = (np.diff(rows) != 0) | (np.diff(cols) != 0)
        group_ids = np.cumsum(keep) - 1
        summed = np.zeros(int(group_ids[-1]) + 1, dtype=np.float64)
        np.add.at(summed, group_ids, vals.astype(np.float64))
        rows, cols = rows[keep], cols[keep]
        vals = summed.astype(vals.dtype)
    counts = np.bincount(rows, minlength=n_rows)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSRMatrix(n_rows, n_cols, row_ptr, cols, vals)


# ---------------------------------------------------------------------------
# Synthetic matrix generators (test & benchmark inputs).
#
# The reference benchmarks on SuiteSparse .mtx files (README.md:21); this
# environment has no network, so we synthesize matrices with the same
# structural archetypes: FEM-banded (cop20k_A-like), circuit/short-row
# (scircuit-like), and power-law graphs (wiki-Talk-like).
# ---------------------------------------------------------------------------


def random_csr(n_rows: int, n_cols: int, row_lengths: np.ndarray,
               rng: np.random.Generator, dtype=np.float64,
               sorted_cols: bool = True) -> CSRMatrix:
    """CSR with the given per-row nnz counts and uniform-random columns."""
    row_lengths = np.minimum(np.asarray(row_lengths, dtype=np.int64), n_cols)
    nnz = int(row_lengths.sum())
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_lengths, out=row_ptr[1:])
    col_idx = rng.integers(0, n_cols, size=nnz).astype(np.int32)
    if sorted_cols:
        # Sort columns within each row (typical of SuiteSparse CSR).
        rows = np.repeat(np.arange(n_rows), row_lengths)
        order = np.lexsort((col_idx, rows))
        col_idx = col_idx[order]
    values = rng.standard_normal(nnz).astype(dtype)
    return CSRMatrix(n_rows, n_cols, row_ptr, col_idx, values)


def fem_like(n: int, band: int, rng: np.random.Generator,
             dtype=np.float64) -> CSRMatrix:
    """Banded FEM-style matrix: medium rows with clustered columns."""
    lengths = rng.integers(max(2, band // 2), band + 1, size=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    rows = np.repeat(np.arange(n), lengths)
    offsets = rng.integers(-band, band + 1, size=nnz)
    col_idx = np.clip(rows + offsets, 0, n - 1).astype(np.int32)
    order = np.lexsort((col_idx, rows))
    col_idx = col_idx[order]
    values = rng.standard_normal(nnz).astype(dtype)
    return CSRMatrix(n, n, row_ptr, col_idx, values)


def powerlaw_like(n: int, alpha: float, max_len: int,
                  rng: np.random.Generator, dtype=np.float64,
                  col_alpha: float = 0.0) -> CSRMatrix:
    """Power-law (Zipf) row-length distribution: many 1-4 nnz rows plus a few
    very long rows — exercises the short AND long strategies.

    ``col_alpha > 0`` additionally draws *columns* from a Zipf-like
    popularity distribution (scaled to [0, n)), matching real web/social
    graphs where in-degree is power-law too (wiki-Talk, soc-LiveJournal1);
    0 keeps uniform columns (adversarial worst case for locality).
    """
    lengths = np.minimum(rng.zipf(alpha, size=n), max_len)
    if col_alpha <= 0:
        return random_csr(n, n, lengths, rng, dtype=dtype)
    lengths = np.minimum(np.asarray(lengths, dtype=np.int64), n)
    nnz = int(lengths.sum())
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    # ranks ~ Zipf: column id = popularity rank, i.e. a degree-sorted
    # labeling (SNAP/LAW graph dumps are commonly published this way).
    col_idx = (np.minimum(rng.zipf(col_alpha, size=nnz), n) - 1).astype(
        np.int32)
    rows = np.repeat(np.arange(n), lengths)
    order = np.lexsort((col_idx, rows))
    col_idx = col_idx[order]
    values = rng.standard_normal(nnz).astype(dtype)
    return CSRMatrix(n, n, row_ptr, col_idx, values)


def circuit_like(n: int, rng: np.random.Generator, spread: int = 300,
                 dtype=np.float64) -> CSRMatrix:
    """Circuit-simulation style: mostly 1-8 nnz rows whose columns sit near
    the diagonal (netlist locality), plus a few denser rail/supply rows —
    the scircuit archetype of BASELINE config 3."""
    lengths = rng.choice([1, 2, 3, 4, 5, 6, 8, 16],
                         p=[.2, .2, .15, .15, .1, .1, .05, .05], size=n)
    rails = rng.choice(n, size=max(1, n // 2000), replace=False)
    lengths[rails] = rng.integers(200, 2000, size=rails.size)
    lengths = np.minimum(lengths.astype(np.int64), n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    rows = np.repeat(np.arange(n), lengths)
    offs = rng.integers(-spread, spread + 1, size=nnz)
    col_idx = np.clip(rows + offs, 0, n - 1).astype(np.int32)
    order = np.lexsort((col_idx, rows))
    col_idx = col_idx[order]
    values = rng.standard_normal(nnz).astype(dtype)
    return CSRMatrix(n, n, row_ptr, col_idx, values)


def mixed_categories(n: int, rng: np.random.Generator,
                     dtype=np.float64, block_longest: int = 256) -> CSRMatrix:
    """Every row category represented: zero, 1..4, medium spread, long."""
    lengths = np.empty(n, dtype=np.int64)
    kinds = rng.integers(0, 8, size=n)
    lengths[kinds == 0] = 0
    for k in (1, 2, 3, 4):
        lengths[kinds == k] = k
    med = kinds == 5
    lengths[med] = rng.integers(5, block_longest, size=int(med.sum()))
    med2 = kinds == 6
    lengths[med2] = rng.integers(5, 64, size=int(med2.sum()))
    lng = kinds == 7
    lengths[lng] = rng.integers(block_longest, block_longest * 8,
                                size=int(lng.sum()))
    return random_csr(n, n, lengths, rng, dtype=dtype)
