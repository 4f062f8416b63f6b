"""Real FEM matrix: P1 stiffness assembly on an unstructured Delaunay mesh.

The reference's benchmark inputs are real SuiteSparse matrices
(``reference README.md:21``, exemplar ``test/cop20k_A.mtx`` — a 3D
accelerator-cavity FEM).  This environment has no network access, so the
suite's "real FEM" arm is RECONSTRUCTED deterministically: a genuine
Galerkin P1 stiffness matrix of the Poisson problem on an unstructured
Delaunay tetrahedralization of seeded random points.  Unlike the
``fem_like`` synthetic (random columns in a band), this matrix has the
true structural signature of FEM discretizations — mesh-neighbor
sparsity, symmetric pattern, variable row degree from the mesh's vertex
valences — which is exactly the window-locality structure the packer is
tuned to (bench.py records its census next to the archetypes so the
generators can be validated against it; see docs/DESIGN.md).

Deterministic: same seed + size -> identical matrix.  The assembled CSR
is cached under data/ (npz) because Delaunay on ~10^5 points costs tens
of seconds of host time.
"""

from __future__ import annotations

import os

import numpy as np

from ..sparse import CSRMatrix


def poisson3d_fem(n_points: int = 110_000, seed: int = 7,
                  cache_dir: str = "data") -> CSRMatrix:
    """3D P1 Poisson stiffness matrix on a Delaunay mesh of ``n_points``
    seeded-random points in the unit cube (~15-16 nnz/row, symmetric —
    the cop20k_A class)."""
    cache = os.path.join(cache_dir, f"fem_poisson3d_{n_points}_{seed}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return CSRMatrix(int(z["n"]), int(z["n"]), z["row_ptr"],
                         z["col_idx"], z["values"])
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 3))
    tri = Delaunay(pts)
    simp = tri.simplices                       # (n_tet, 4)

    # P1 stiffness: per tet, gradients of the barycentric basis.
    # For tet with vertices x0..x3: grad(phi_i) rows of inv(E)^T where
    # E = [x1-x0; x2-x0; x3-x0]; K_local = vol * G @ G^T.
    x0 = pts[simp[:, 0]]
    E = np.stack([pts[simp[:, k]] - x0 for k in (1, 2, 3)], axis=1)
    detE = np.linalg.det(E)
    keep = np.abs(detE) > 1e-12                # drop degenerate slivers
    simp, E, detE = simp[keep], E[keep], detE[keep]
    vol = np.abs(detE) / 6.0
    Einv = np.linalg.inv(E)                    # (n, 3, 3)
    G123 = np.transpose(Einv, (0, 2, 1))       # grad(phi_1..3) rows
    G0 = -G123.sum(axis=1, keepdims=True)
    G = np.concatenate([G0, G123], axis=1)     # (n, 4, 3)
    K = np.einsum("tic,tjc->tij", G, G) * vol[:, None, None]

    rows = np.repeat(simp, 4, axis=1).reshape(-1)
    cols = np.tile(simp, (1, 4)).reshape(-1)
    vals = K.reshape(-1)

    # assemble: sum duplicate (row, col) pairs into CSR
    n = n_points
    key = rows.astype(np.int64) * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    first = np.r_[True, key[1:] != key[:-1]]
    uk = key[first]
    sums = np.add.reduceat(vals, np.flatnonzero(first))
    r, c = (uk // n).astype(np.int64), (uk % n).astype(np.int32)
    lens = np.bincount(r, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=row_ptr[1:])
    csr = CSRMatrix(n, n, row_ptr, c, sums)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(cache, n=n, row_ptr=row_ptr, col_idx=c,
                            values=sums)
    except OSError:
        pass
    return csr
