"""Row-category analyzer.

One vectorized pass over CSR row lengths, mirroring the reference's two-pass
categorization loop (``dasp_f64.h:499-594``): rows are split into
  * zero   (0 nnz)            -> y preset to 0
  * short1 (1 nnz), short2 (2), short3 (3), short4 (4)
  * long   (>= block_longest) -> chunked + segmented reduction
  * medium (everything else)  -> SELL slices (the reference's "row-block")
plus the census statistics that feed the CSV record schema
(``dasp_f64.h:1440-1441``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .config import DaspConfig, DEFAULT_CONFIG
from .sparse import CSRMatrix


@dataclasses.dataclass
class RowCategories:
    """Row ids per category (original row indices, ascending)."""

    zero: np.ndarray
    short1: np.ndarray
    short2: np.ndarray
    short3: np.ndarray
    short4: np.ndarray
    medium: np.ndarray
    long: np.ndarray
    row_lengths: np.ndarray

    @property
    def census(self) -> Dict[str, int]:
        """Per-category row/nnz counts (CSV schema fields,
        ``dasp_f64.h:1440``)."""
        lens = self.row_lengths
        return {
            "row_zero": int(self.zero.size),
            "short_row_1": int(self.short1.size),
            "short_row_2": int(self.short2.size),
            "short_row_3": int(self.short3.size),
            "short_row_4": int(self.short4.size),
            "row_block": int(self.medium.size),
            "row_long": int(self.long.size),
            "nnz_short": int(self.short1.size + 2 * self.short2.size
                             + 3 * self.short3.size + 4 * self.short4.size),
            "nnz_block": int(lens[self.medium].sum()) if self.medium.size else 0,
            "nnz_long": int(lens[self.long].sum()) if self.long.size else 0,
        }


def categorize(csr: CSRMatrix,
               config: DaspConfig = DEFAULT_CONFIG) -> RowCategories:
    lens = csr.row_lengths
    ids = np.arange(csr.n_rows, dtype=np.int64)
    is_long = lens >= config.block_longest
    return RowCategories(
        zero=ids[lens == 0],
        short1=ids[lens == 1],
        short2=ids[lens == 2],
        short3=ids[lens == 3],
        short4=ids[lens == 4],
        medium=ids[(lens >= 5) & ~is_long],
        long=ids[is_long],
        row_lengths=np.asarray(lens),
    )
