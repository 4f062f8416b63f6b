"""The bytes an SpMV must move, and the card's published peak.

DASP's model 1 (``dasp_f64.h:1162-1172``): A's values and 4-byte column
indices read once, x read once and y written once, at the value width.
A pass over kv vectors reads A once and kv x's and y's.  The count
depends on the matrix alone, never on how a program packs or pads it, so
a share of it compares any two implementations of the same product.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet: HBM3 at 3.35 TB/s (at its 700 W limit)
PEAK_HBM_BYTES_S = 3.35e12
VALUE_BYTES = {"f32": 4, "f64": 8}
INDEX_BYTES = 4


def model1_bytes(n_rows: int, n_cols: int, nnz: int, dtype: str,
                 kv: int = 1) -> int:
    vb = VALUE_BYTES[dtype]
    return nnz * (vb + INDEX_BYTES) + kv * (n_rows + n_cols) * vb


def model1_seconds(n_rows: int, n_cols: int, nnz: int, dtype: str,
                   kv: int = 1) -> float:
    """The least time the card's HBM allows for those bytes."""
    return model1_bytes(n_rows, n_cols, nnz, dtype, kv) / PEAK_HBM_BYTES_S
