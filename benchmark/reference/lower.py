"""The control: the reference put in the program's place and computed one
precision below the configuration's.

float32 stands below float64, and TF32 (float32 with 10 mantissa bits in
the multiplicands, sums in float32, as the card's tensor cores round)
below float32 with TF32 off.  A comparison that passes this control cannot
tell the configuration's precision from the next one down, so every limit
of the benchmark must fail it (``benchmark/control.py`` reads it).

Plain NumPy and PyTorch: imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import Csr, product

# the configuration's dtype -> the precision its control computes in
BELOW = {"f64": "f32", "f32": "tf32"}


def tf32(a) -> np.ndarray:
    """float32 values rounded to nearest even at TF32's 10 mantissa bits."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))
         ) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def _operands(a: Csr, x, below: str):
    vals = np.asarray(a.values, np.float32)
    x = np.asarray(x, np.float32)
    if below == "tf32":
        vals, x = tf32(vals), tf32(x)
    return vals, x


def product_below(a: Csr, x, below: str) -> np.ndarray:
    """A @ x with the operands in ``below`` ("f32" or "tf32") and every
    product and sum rounded to float32."""
    vals, x = _operands(a, x, below)
    return product(a, x, dtype=np.float32, values=vals)


def cg_below(a: Csr, b, rtol: float, maxiter: int, below: str,
             device="cpu") -> tuple:
    """Unpreconditioned CG from x = 0 in float32 (operands rounded to
    ``below``), stopped as the program's solve is, when the recursive
    residual falls to rtol * ||b|| or after ``maxiter`` iterations.
    Returns (x as float64 numpy, iterations).  Runs on ``device`` with
    plain PyTorch ops: a gather, a product and an ``index_add_``."""
    vals, _ = _operands(a, np.zeros(0), below)
    dev = torch.device(device)
    rows = torch.from_numpy(np.repeat(np.arange(a.n_rows),
                                      np.diff(a.row_ptr))).to(dev)
    cols = torch.from_numpy(a.col_idx.astype(np.int64)).to(dev)
    v = torch.from_numpy(vals).to(dev)

    def matvec(p):
        pp = p
        if below == "tf32":
            pp = torch.from_numpy(tf32(p.cpu().numpy())).to(dev)
        return torch.zeros(a.n_rows, dtype=torch.float32,
                           device=dev).index_add_(0, rows, v * pp[cols])

    bt = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    x = torch.zeros_like(bt)
    r, p = bt.clone(), bt.clone()
    rs = torch.dot(r, r)
    tol2 = float(rtol * np.linalg.norm(np.asarray(b, np.float64))) ** 2
    it = 0
    while float(rs) > tol2 and it < maxiter:
        ap = matvec(p)
        alpha = rs / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x.double().cpu().numpy(), it
