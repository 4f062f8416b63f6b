"""ctypes binding to the native C++ Matrix Market parser (libdasp_host).

The reference's loader is native C (``mmio.h``, ``mmio_highlevel.h``); ours
is C++ (see ``native/``), exposed through a C ABI and loaded here.  Falls
back cleanly when the shared library has not been built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..sparse import CSRMatrix

_LIB = None
_TRIED = False


def _stale(so_path: str, srcdir: str) -> bool:
    """The .so predates a source file (make only reruns on first use)."""
    try:
        so_m = os.path.getmtime(so_path)
        return any(os.path.getmtime(os.path.join(srcdir, f)) > so_m
                   for f in os.listdir(srcdir)
                   if f.endswith(".cpp") or f == "Makefile")
    except OSError:
        return False


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    srcdir = os.path.join(os.path.dirname(here), "native")
    candidates = [
        os.path.join(here, "_native", "libdasp_host.so"),
        os.path.join(srcdir, "libdasp_host.so"),
    ]
    for c in candidates:
        if os.path.exists(c) and not _stale(c, srcdir):
            return c
    # The .so is a build artifact (gitignored); (re)build it on first use
    # so a fresh checkout never silently falls back to the slow Python
    # router, and a stale .so never hides new native entry points.  The
    # build runs under a lock and lands whole (build.ensure_built).
    from .build import ensure_built
    return ensure_built(srcdir=srcdir)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.dasp_read_mtx.restype = ctypes.c_void_p
    lib.dasp_read_mtx.argtypes = [ctypes.c_char_p]
    lib.dasp_csr_dims.restype = None
    lib.dasp_csr_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.dasp_csr_export.restype = None
    lib.dasp_csr_export.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_double)]
    lib.dasp_csr_free.restype = None
    lib.dasp_csr_free.argtypes = [ctypes.c_void_p]
    for name in ("dasp_sym_perm", "dasp_col_perm", "dasp_first_touch"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = None
    if hasattr(lib, "dasp_pack_long"):
        P = ctypes.POINTER
        lib.dasp_pack_long.restype = ctypes.c_void_p
        lib.dasp_pack_long.argtypes = [
            ctypes.c_int64, P(ctypes.c_int64), P(ctypes.c_int64),
            P(ctypes.c_int64), P(ctypes.c_double), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.dasp_pack_long_dims.restype = None
        lib.dasp_pack_long_dims.argtypes = [
            ctypes.c_void_p, P(ctypes.c_int64), P(ctypes.c_int64),
            P(ctypes.c_int64)]
        lib.dasp_pack_long_export.restype = None
        lib.dasp_pack_long_export.argtypes = [
            ctypes.c_void_p, P(ctypes.c_double), P(ctypes.c_int32),
            P(ctypes.c_int32), P(ctypes.c_int64), P(ctypes.c_int32),
            P(ctypes.c_int64)]
        lib.dasp_pack_long_free.restype = None
        lib.dasp_pack_long_free.argtypes = [ctypes.c_void_p]
    try:
        lib.dasp_route_vregs.restype = None
        lib.dasp_route_vregs.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
    except AttributeError:
        pass
    if hasattr(lib, "dasp_deal_cascade"):
        P = ctypes.POINTER
        lib.dasp_deal_cascade.restype = None
        lib.dasp_deal_cascade.argtypes = [
            ctypes.c_int64, P(ctypes.c_uint8), P(ctypes.c_int64),
            P(ctypes.c_int64), P(ctypes.c_int64)]
    _LIB = lib
    return lib


def route_vregs(offsets, lane, ipref, col, val, p_cap, strides=None):
    """Batch-route vregs via the C++ router.  Returns (vals_tiles
    (V,8,128), idx_tiles (V,8,128) int64, wins (V,p_cap) int64,
    win_counts (V,), overflow bool (n,)).  strides: optional (V,) int32
    per-vreg sublane stride (None = 8)."""
    lib = _load()
    V = offsets.size - 1
    n = int(offsets[-1])
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lane = np.ascontiguousarray(lane, dtype=np.int32)
    ipref = np.ascontiguousarray(ipref, dtype=np.int32)
    col = np.ascontiguousarray(col, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float64)
    vals_tiles = np.zeros((V, 8, 128), dtype=np.float64)
    idx_tiles = np.zeros((V, 8, 128), dtype=np.int32)
    wins = np.zeros((V, p_cap), dtype=np.int32)
    win_counts = np.zeros(V, dtype=np.int32)
    overflow = np.zeros(max(n, 1), dtype=np.uint8)
    P = ctypes.POINTER
    if strides is None:
        strides_p = None
    else:
        strides = np.ascontiguousarray(strides, dtype=np.int32)
        strides_p = strides.ctypes.data_as(P(ctypes.c_int32))
    lib.dasp_route_vregs(
        V, offsets.ctypes.data_as(P(ctypes.c_int64)),
        lane.ctypes.data_as(P(ctypes.c_int32)),
        ipref.ctypes.data_as(P(ctypes.c_int32)),
        col.ctypes.data_as(P(ctypes.c_int64)),
        val.ctypes.data_as(P(ctypes.c_double)),
        p_cap, strides_p,
        vals_tiles.ctypes.data_as(P(ctypes.c_double)),
        idx_tiles.ctypes.data_as(P(ctypes.c_int32)),
        wins.ctypes.data_as(P(ctypes.c_int32)),
        win_counts.ctypes.data_as(P(ctypes.c_int32)),
        overflow.ctypes.data_as(P(ctypes.c_uint8)))
    return (vals_tiles, idx_tiles, wins, win_counts,
            overflow[:n].astype(bool))


def sym_perm(row_ptr, col_idx, values, newpos):
    """Native A' = P A P^T: returns (row_ptr', col_idx', values') with
    columns ascending within each row.  None if the library lacks it."""
    lib = _load()
    if lib is None or not hasattr(lib, "dasp_sym_perm"):
        return None
    n = row_ptr.size - 1
    nnz = int(row_ptr[-1])
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    newpos = np.ascontiguousarray(newpos, dtype=np.int64)
    out_ptr = np.empty(n + 1, dtype=np.int64)
    out_col = np.empty(nnz, dtype=np.int32)
    out_val = np.empty(nnz, dtype=np.float64)
    P = ctypes.POINTER
    lib.dasp_sym_perm(
        n, row_ptr.ctypes.data_as(P(ctypes.c_int64)),
        col_idx.ctypes.data_as(P(ctypes.c_int32)),
        values.ctypes.data_as(P(ctypes.c_double)),
        newpos.ctypes.data_as(P(ctypes.c_int64)),
        out_ptr.ctypes.data_as(P(ctypes.c_int64)),
        out_col.ctypes.data_as(P(ctypes.c_int32)),
        out_val.ctypes.data_as(P(ctypes.c_double)))
    return out_ptr, out_col, out_val


def first_touch(col_idx, n_cols: int, hub_min_deg: int):
    """Native first-touch column relabel (relabel.first_touch_perm
    semantics: hubs by descending degree, touched tail in first-touch
    traversal order, untouched last).  Returns ``newpos`` int64 or None
    if the library lacks the entry point."""
    lib = _load()
    if lib is None or not hasattr(lib, "dasp_first_touch"):
        return None
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    newpos = np.empty(n_cols, dtype=np.int64)
    P = ctypes.POINTER
    lib.dasp_first_touch(
        n_cols, col_idx.size,
        col_idx.ctypes.data_as(P(ctypes.c_int32)),
        hub_min_deg, newpos.ctypes.data_as(P(ctypes.c_int64)))
    return newpos


def col_perm(row_ptr, col_idx, values, newpos):
    """Native column relabel + within-row re-sort.  Returns (col_idx',
    values'); row_ptr is unchanged.  None if the library lacks it."""
    lib = _load()
    if lib is None or not hasattr(lib, "dasp_col_perm"):
        return None
    n = row_ptr.size - 1
    nnz = int(row_ptr[-1])
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    newpos = np.ascontiguousarray(newpos, dtype=np.int64)
    out_col = np.empty(nnz, dtype=np.int32)
    out_val = np.empty(nnz, dtype=np.float64)
    P = ctypes.POINTER
    lib.dasp_col_perm(
        n, row_ptr.ctypes.data_as(P(ctypes.c_int64)),
        col_idx.ctypes.data_as(P(ctypes.c_int32)),
        values.ctypes.data_as(P(ctypes.c_double)),
        newpos.ctypes.data_as(P(ctypes.c_int64)),
        out_col.ctypes.data_as(P(ctypes.c_int32)),
        out_val.ctypes.data_as(P(ctypes.c_double)))
    return out_col, out_val


def pack_long(row_start, row_end, col, val, win_cap, p_cap, dyn_pad_max):
    """Pack + route all long rows natively (wplan's long_elems/long_route
    phases in one C++ call, OpenMP over rows).  Row r's elements live at
    (col, val)[row_start[r]:row_end[r]] — rows need not be contiguous, so
    long rows route ZERO-COPY from the full CSR streams.  Columns must be
    sorted ascending within each row.  Returns (vals_tiles (V,8,128) f64,
    idx_tiles (V,8,128) i32, wins_cat i32, win_off (V+1,) i64,
    owner (V,) i32 row ordinals, dregs i64 absolute element indices).
    None when the library lacks the entry point."""
    lib = _load()
    if lib is None or not hasattr(lib, "dasp_pack_long"):
        return None
    n_rows = row_start.size
    row_start = np.ascontiguousarray(row_start, dtype=np.int64)
    row_end = np.ascontiguousarray(row_end, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float64)
    P = ctypes.POINTER
    h = lib.dasp_pack_long(
        n_rows, row_start.ctypes.data_as(P(ctypes.c_int64)),
        row_end.ctypes.data_as(P(ctypes.c_int64)),
        col.ctypes.data_as(P(ctypes.c_int64)),
        val.ctypes.data_as(P(ctypes.c_double)),
        win_cap, p_cap, dyn_pad_max)
    try:
        nv = ctypes.c_int64()
        nw = ctypes.c_int64()
        nd = ctypes.c_int64()
        lib.dasp_pack_long_dims(h, ctypes.byref(nv), ctypes.byref(nw),
                                ctypes.byref(nd))
        vals_tiles = np.empty((nv.value, 8, 128), dtype=np.float64)
        idx_tiles = np.empty((nv.value, 8, 128), dtype=np.int32)
        wins_cat = np.empty(nw.value, dtype=np.int32)
        win_off = np.empty(nv.value + 1, dtype=np.int64)
        owner = np.empty(nv.value, dtype=np.int32)
        dregs = np.empty(nd.value, dtype=np.int64)
        lib.dasp_pack_long_export(
            h, vals_tiles.ctypes.data_as(P(ctypes.c_double)),
            idx_tiles.ctypes.data_as(P(ctypes.c_int32)),
            wins_cat.ctypes.data_as(P(ctypes.c_int32)),
            win_off.ctypes.data_as(P(ctypes.c_int64)),
            owner.ctypes.data_as(P(ctypes.c_int32)),
            dregs.ctypes.data_as(P(ctypes.c_int64)))
    finally:
        lib.dasp_pack_long_free(h)
    return vals_tiles, idx_tiles, wins_cat, win_off, owner, dregs


def has_pack_long() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "dasp_pack_long")


def has_router() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "dasp_route_vregs")


def deal_cascade(newr, w8, ce):
    """Native window-dealing feasibility waves (wplan._deal_windows):
    exact replica of the forward/backward numpy wave loops, parallel
    over rows.  Returns (ce, pos) or None if the library lacks it."""
    lib = _load()
    if lib is None or not hasattr(lib, "dasp_deal_cascade"):
        return None
    n = int(ce.size)
    newr = np.ascontiguousarray(newr, dtype=np.uint8)
    w8 = np.ascontiguousarray(w8, dtype=np.int64)
    ce = np.ascontiguousarray(ce, dtype=np.int64)
    pos = np.zeros(max(n, 1), dtype=np.int64)
    P = ctypes.POINTER
    lib.dasp_deal_cascade(
        n, newr.ctypes.data_as(P(ctypes.c_uint8)),
        w8.ctypes.data_as(P(ctypes.c_int64)),
        ce.ctypes.data_as(P(ctypes.c_int64)),
        pos.ctypes.data_as(P(ctypes.c_int64)))
    return ce, pos[:n]


def available() -> bool:
    return _load() is not None


def read_mtx(path, dtype=np.float64) -> CSRMatrix:
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser not built")
    handle = lib.dasp_read_mtx(os.fsencode(path))
    if not handle:
        raise ValueError(f"native parser failed on {path}")
    try:
        m = ctypes.c_int64()
        n = ctypes.c_int64()
        nnz = ctypes.c_int64()
        lib.dasp_csr_dims(handle, ctypes.byref(m), ctypes.byref(n),
                          ctypes.byref(nnz))
        row_ptr = np.empty(m.value + 1, dtype=np.int64)
        col_idx = np.empty(nnz.value, dtype=np.int32)
        values = np.empty(nnz.value, dtype=np.float64)
        lib.dasp_csr_export(
            handle,
            row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    finally:
        lib.dasp_csr_free(handle)
    return CSRMatrix(int(m.value), int(n.value), row_ptr, col_idx,
                     values.astype(dtype, copy=False))
