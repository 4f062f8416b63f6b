"""Build and load the hand-written CUDA kernels of ``dasp_tpu_torch/csrc``.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ONE shared library with a plain C interface,
which is loaded with ``ctypes``.  This avoids ``torch.utils.cpp_extension.load``:
sources that include PyTorch's headers take minutes to compile, a plain
C interface takes seconds.

The library lands in ``dasp_tpu_torch/_build/`` (gitignored), named by a
hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  The build happens on first use, never
at import: a machine without ``nvcc`` imports the package and runs the
plain PyTorch versions on CPU tensors.  A failed build raises; nothing
falls back.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()`` cast to int; ``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C name -> argument types (pointers and the stream as c_void_p, so a
# 64-bit address is never cut to a 32-bit int)
_COLSUM = (_P, _P, _P, _P, _P, _I, _I, _I, _P)
_COLSUM_MULTI = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_OUTGATHER = (_P, _P, _P, _P, _I, _I, _I, _I, _L, _P)
_RESIDENT = (_P, _P, _I, _P, _I, _P,    # desc, items, n_items, wide, n_wide,
                                        # cbuf
             _P, _P, _P, _I, _I,        # inc_ptr, inc_tot, inc_mult,
                                        # n_long, n_long_rows
             _P, _P, _I, _I, _I,        # src, perm, B, K, zero row Z
             _P, _P, _L,                # x, x_scr, x words
             _P, _P, _P,                # y2, tot, out
             _P, _P, _I, _P, _P, _P,    # res_ent, res_task, n_res_tasks,
                                        # res_cols, res_vals, rsum
             _P, _P,                    # res_bptr, res_bent
             _I, _D, _P, _P)            # iters, tap, stamps, stream
_PROBE = (_P, _P, _P, _P, _L, _I, _P)
_ROUNDCOST = (_P, _P, _P, _P, _P, _I, _I, _I, _P)
_STREAM = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_GATHER = (_P, _P, _P, _I, _I, _P)
SIGNATURES = {
    # wins, vals, idx, x2d, out, nv, P, stride, stream
    "dasp_colsum_f32": _COLSUM,
    "dasp_colsum_bf16": _COLSUM,
    "dasp_colsum_f64": _COLSUM,
    # wins, vals, idx, x3d, out, nv, P, stride, S, kv, stream
    "dasp_colsum_multi_f32": _COLSUM_MULTI,
    "dasp_colsum_multi_bf16": _COLSUM_MULTI,
    "dasp_colsum_multi_f64": _COLSUM_MULTI,
    # value type (0 f32, 1 bf16, 2 f64), stride, kv, int[4] out
    "dasp_colsum_multi_info": (_I, _I, _I, _P),
    # src, perm, y2, out, B, K, zero_row, batch, y2 words a vector, stream
    "dasp_outgather_f32": _OUTGATHER,
    "dasp_outgather_f64": _OUTGATHER,
    # K6, one cooperative launch for `iters` chained SpMVs (ops/resident.py)
    "dasp_resident_f32": _RESIDENT,
    "dasp_resident_bf16": _RESIDENT,
    "dasp_resident_f64": _RESIDENT,
    # T4: vals, idx, x (64,128), out, nv, iters, stream
    "dasp_resident_probe": _PROBE,
    # T1: idx, xw (2048,128), out, rows, body, stream
    "dasp_gather_probe": _GATHER,
    # T2: wins, vals, idx, x2d, out, nv, P, variant, stream
    "dasp_roundcost_probe": _ROUNDCOST,
    # T3: wins, vals, idx, x2d, out, nv, P, variant, stride, stream
    "dasp_stream_probe": _STREAM,
    # what the build gave T1 (body; int[5] out), T2 (P, variant) and T3
    # (P, variant, stride; int[4] out)
    "dasp_gather_probe_info": (_I, _P),
    "dasp_roundcost_probe_info": (_I, _I, _P),
    "dasp_stream_probe_info": (_I, _I, _I, _P),
}


def sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources():
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libdasp_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library of the same sources exists;
    return its path.  Raises RuntimeError with nvcc's output on failure."""
    out = _library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [f for f in sources() if f.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(f)}.o" for f in cu]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, f]
                         for f, o in zip(cu, objs))]
    try:
        runs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        if all(rc == 0 for _, _, rc in runs):
            r = subprocess.run(link, capture_output=True, text=True)
            runs.append((link, r.stdout + r.stderr, r.returncode))
        for cmd, text, rc in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                                   f"{text}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)          # atomic: a concurrent build never sees
    return out                    # a half-written library


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.dasp_cuda_error_name.argtypes = [ctypes.c_int]
    lib.dasp_cuda_error_name.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        what = library().dasp_cuda_error_name(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({what}) at launch")
