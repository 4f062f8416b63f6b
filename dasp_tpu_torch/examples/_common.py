"""What the two examples share."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_backend as cb
from ..wplan import LANES


def require_shared_space(op, who: str) -> None:
    """An on-device iteration feeds y back into x: the operator must carry
    ONE shared x/y index space.  The default row_sort="auto" may compose
    an independent row length-grouping on top of a symmetric relabel
    (wplan.py), decoupling the spaces -- pack with row_sort="off"."""
    pl = op.plan
    if pl.row_perm is not None and (
            pl.col_perm is None
            or not np.array_equal(pl.row_perm, pl.col_perm)):
        raise ValueError(
            f"{who} iterates on-device and needs x and y in one "
            "index space: build the operator with "
            "DaspConfig(row_sort='off')")


def x_dtype(op) -> torch.dtype:
    """The dtype of the operator's x table and of the iteration's vectors:
    fp64 for an f64 operator, f32 otherwise (bf16 values take an f32 x)."""
    return torch.float64 if op.dtype == "f64" else torch.float32


def matvec_into(op, table: torch.Tensor):
    """v (n,) on the device -> A v (n,) in the operator's internal index
    space: v is re-laid into ``table``, the zeroed (s_rows, 128) x table
    the caller keeps, and goes through ``cuda_backend.spmv_fn`` (what
    ``op.device_call`` runs); a bf16 operator's y comes back in f32."""
    meta, arrays, n = op._meta, op._arrays, op.n_cols
    flat = table.view(-1)

    def matvec(v: torch.Tensor) -> torch.Tensor:
        flat[:n].copy_(v)
        return cb.spmv_fn(meta, arrays, table).to(table.dtype)
    return matvec


def x_table(op) -> torch.Tensor:
    """A zeroed (s_rows, 128) x table on the operator's device."""
    return torch.zeros((op._meta.s_rows, LANES), dtype=x_dtype(op),
                       device=op.device)
