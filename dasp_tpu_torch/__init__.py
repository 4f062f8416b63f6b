"""dasp_tpu_torch — the windowed-gather SpMV of ``dasp_tpu`` on PyTorch.

The port runs the same packed plan (``build_wplan``) as the JAX package;
its device side is PyTorch tensors.  SpMV runs in f32, bf16 and f64
(native fp64), SpMM (``matmat``) in all three, and chained SpMVs
(``timing_loop``) in one launch of the resident executor, through kernels
hand-written in CUDA C++ for Hopper (``csrc/``: colsum, its fp64 and
multi-vector instances, outgather, the resident executor), which run as
their plain PyTorch versions on CPU tensors.  ``python -m
dasp_tpu_torch.bench`` benchmarks it against cuSPARSE and writes the
reference's CSV schema; ``dasp_tpu_torch.examples`` holds the CG and
PageRank consumers, whose iterations stay on the device.  The JAX
package's second plan format, the tile plan (``build_plan``, the DASP
paper's own row categories), runs through its portable executor,
PyTorch ops without a kernel of their own: ``SpMVOperator(csr,
backend="xla")`` or a prebuilt ``DaspPlan``.  It imports no JAX.

Quick start::

    import dasp_tpu_torch as dt
    csr = dt.load_matrix("matrix.mtx")
    op = dt.SpMVOperator(csr, dtype="f64")   # on the card; f32, bf16, f64
    y = op(x)                 # y = A x, in original row order
    Y = op.matmat(X)          # Y = A X, X of shape (n_cols, k)
"""

from .config import DaspConfig, DEFAULT_CONFIG
from .sparse import CSRMatrix, from_coo
from .analyze import categorize, RowCategories
from .plan import DaspPlan, build_plan
from .wplan import WPlan, build_wplan
from .spmv import SpMVOperator, spmv
from .io import load_matrix, read_mtx, write_mtx

__version__ = "0.1.0"


def verify(csr: CSRMatrix, y, x, rtol: float = 1e-5) -> bool:
    """Element-wise verification against the CPU CSR golden — the enabled
    version of the reference's ``verify_new`` (main_f64.cu:3-16, whose call
    is commented out at :157).  Prints a summary and returns pass/fail."""
    import numpy as np
    golden = csr.spmv(x)
    scale = np.maximum(np.abs(golden), 1.0)
    err = np.abs((np.asarray(y, dtype=np.float64) - golden) / scale)
    ok = bool((err <= rtol).all())
    worst = float(err.max()) if err.size else 0.0
    print(f"Y({csr.n_rows}), compute {'succeed' if ok else 'FAILED'}! "
          f"max rel err {worst:.3e} (tol {rtol:g})")
    return ok


__all__ = [
    "DaspConfig", "DEFAULT_CONFIG", "CSRMatrix", "from_coo", "categorize",
    "RowCategories", "DaspPlan", "build_plan", "WPlan", "build_wplan",
    "SpMVOperator", "spmv", "load_matrix", "read_mtx", "write_mtx",
    "verify", "__version__",
]
