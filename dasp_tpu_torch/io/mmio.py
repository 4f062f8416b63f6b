"""Matrix Market (.mtx) reader/writer producing CSR.

Re-implements the semantics of the reference loader ``mmio_allinone``
(``mmio_highlevel.h:608-774``) on top of vectorized numpy:
  * banner parse: object=matrix, format=coordinate, field in
    {real, integer, pattern, complex}, symmetry in
    {general, symmetric, skew-symmetric, hermitian};
  * ``%`` comment lines skipped (``mmio.h:441-448``);
  * pattern entries get value 1.0, complex keeps the real part, matching
    ``mmio_highlevel.h:670-687``;
  * 1-based indices shifted to 0-based (``mmio_highlevel.h:689-691``);
  * symmetric/hermitian/skew expansion duplicates off-diagonal entries with
    swapped (i, j) (``mmio_highlevel.h:702-746``); skew-symmetric negates the
    mirrored value.

A native C++ fast path (``dasp_tpu/io/native.py``) is used automatically for
large files when the shared library is built; this module is the portable
fallback and the semantics oracle the native parser is tested against.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np

from ..sparse import CSRMatrix, from_coo

_FIELDS = ("real", "integer", "pattern", "complex")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


class MatrixMarketError(ValueError):
    pass


def _parse_banner(line: bytes):
    parts = line.decode("ascii", "replace").strip().lower().split()
    if len(parts) != 5 or parts[0] != "%%matrixmarket":
        raise MatrixMarketError(f"bad MatrixMarket banner: {line!r}")
    _, obj, fmt, field, sym = parts
    if obj != "matrix":
        raise MatrixMarketError(f"unsupported object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise MatrixMarketError(f"unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise MatrixMarketError(f"unsupported field {field!r}")
    if sym not in _SYMMETRIES:
        raise MatrixMarketError(f"unsupported symmetry {sym!r}")
    return fmt, field, sym


def read_mtx(path_or_file, dtype=np.float64) -> CSRMatrix:
    """Read a Matrix Market file into CSR (symmetry expanded)."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        if isinstance(data, str):
            data = data.encode()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    return _parse_bytes(data, dtype=dtype)


def _parse_bytes(data: bytes, dtype=np.float64) -> CSRMatrix:
    buf = _io.BytesIO(data)
    banner = buf.readline()
    fmt, field, sym = _parse_banner(banner)
    # Skip comments / blank lines to the size line.
    while True:
        pos = buf.tell()
        line = buf.readline()
        if not line:
            raise MatrixMarketError("missing size line")
        s = line.strip()
        if s and not s.startswith(b"%"):
            break
    size_parts = s.split()
    rest = data[buf.tell():]

    if fmt == "array":
        if len(size_parts) != 2:
            raise MatrixMarketError(f"bad array size line: {s!r}")
        m, n = int(size_parts[0]), int(size_parts[1])
        ncols_per_entry = 2 if field == "complex" else 1
        body = np.loadtxt(_io.BytesIO(rest), dtype=np.float64).reshape(-1)
        vals = body.reshape(-1, ncols_per_entry)[:, 0]
        if vals.size != m * n:
            raise MatrixMarketError("array body size mismatch")
        dense = vals.reshape(n, m).T  # column-major on disk
        if sym in ("symmetric", "hermitian", "skew-symmetric"):
            lower = np.tril(dense, -1)
            dense = dense + (-(lower.T) if sym == "skew-symmetric" else lower.T)
        rows, cols = np.nonzero(dense)
        return from_coo(m, n, rows, cols.astype(np.int32),
                        dense[rows, cols].astype(dtype))

    if len(size_parts) != 3:
        raise MatrixMarketError(f"bad coordinate size line: {s!r}")
    m, n, nnz_decl = (int(p) for p in size_parts)

    # Vectorized body parse.  Comment lines inside the body are rare but
    # legal; strip them only if present.
    if b"%" in rest:
        rest = b"\n".join(ln for ln in rest.split(b"\n")
                          if not ln.lstrip().startswith(b"%"))
    ncols = {"pattern": 2, "real": 3, "integer": 3, "complex": 4}[field]
    body = np.loadtxt(_io.BytesIO(rest), dtype=np.float64, ndmin=2)
    if body.size == 0:
        body = body.reshape(0, ncols)
    if body.shape[0] != nnz_decl:
        raise MatrixMarketError(
            f"declared nnz {nnz_decl} != parsed {body.shape[0]}")
    if body.shape[1] < ncols:
        raise MatrixMarketError(
            f"expected {ncols} columns for field {field!r}, got {body.shape[1]}")

    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(body.shape[0], dtype=np.float64)
    else:
        vals = body[:, 2]  # complex: real part, mmio_highlevel.h:676-678
    if rows.size and (rows.min() < 0 or rows.max() >= m
                      or cols.min() < 0 or cols.max() >= n):
        raise MatrixMarketError("index out of declared bounds")

    if sym in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        mr, mc, mv = cols[off], rows[off], vals[off]
        if sym == "skew-symmetric":
            mv = -mv
        rows = np.concatenate([rows, mr])
        cols = np.concatenate([cols, mc])
        vals = np.concatenate([vals, mv])

    return from_coo(m, n, rows, cols.astype(np.int32), vals.astype(dtype))


def write_mtx(path, csr: CSRMatrix, field: str = "real",
              comment: str = "generated by dasp_tpu") -> None:
    """Write CSR as a general coordinate Matrix Market file."""
    rows = np.repeat(np.arange(csr.n_rows), csr.row_lengths) + 1
    cols = csr.col_idx.astype(np.int64) + 1
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"% {comment}\n")
        f.write(f"{csr.n_rows} {csr.n_cols} {csr.nnz}\n")
        if field == "pattern":
            np.savetxt(f, np.column_stack([rows, cols]), fmt="%d %d")
        else:
            np.savetxt(f, np.column_stack([rows, cols, csr.values]),
                       fmt="%d %d %.17g")


def load_matrix(path, dtype=np.float64, prefer_native: bool = True) -> CSRMatrix:
    """Load a .mtx file, using the native C++ parser when available."""
    if prefer_native:
        try:
            from . import native
            if native.available():
                return native.read_mtx(path, dtype=dtype)
        except Exception:
            pass
    return read_mtx(path, dtype=dtype)
