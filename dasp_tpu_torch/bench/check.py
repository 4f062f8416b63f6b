"""The end-to-end check every benchmarked and smoke-run arm passes before
it is timed: y against the f64 CSR golden, on the error scaled by the
backward-error mass max(|A||x|, 1)."""

from __future__ import annotations

import numpy as np
import torch

from ..sparse import CSRMatrix

# Limits on max |y - golden| / max(|A||x|, 1): f32 as
# __graft_entry__.py:63-77; f64 native fp64 sums of up to ~5k terms;
# bf16 against the golden of the bf16-rounded A and x, where y's own
# rounding is at most 2^-8 of |y| <= the mass and x stays f32 (within
# 2^-8 of the rounded x): at most 2^-7 = 7.8e-3 of the mass in all
E2E_TOL = {"f32": 2e-6, "f64": 1e-10, "bf16": 1e-2}


def bf16_round(a) -> np.ndarray:
    """float64 values of ``a`` rounded to bfloat16 (through float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).double().numpy()


def golden_mass(csr: CSRMatrix, x, dtype: str):
    """(A x in f64, max(|A||x|, 1)) for the check of a ``dtype`` arm: for
    bf16, of the bf16-rounded A and x."""
    vals = bf16_round(csr.values) if dtype == "bf16" else csr.values
    x = bf16_round(x) if dtype == "bf16" else x
    g = CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  vals).spmv(x)
    mass = CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                     np.abs(vals)).spmv(np.abs(x))
    return g, np.maximum(mass, 1.0)


def scaled_error(y, golden, scale) -> float:
    """max |y - golden| / scale; inf for a y of another shape or with a
    value that is not finite."""
    y = np.asarray(y)
    if y.shape != golden.shape or not np.isfinite(y).all():
        return float("inf")
    if not y.size:
        return 0.0
    return float((np.abs(y.astype(np.float64) - golden) / scale).max())
