"""Competitor baselines.

cuSPARSE, reached through ``torch.sparse_csr_tensor @ x``, is the
vendor-stack general-purpose sparse baseline, as it is for the reference
(``main_f64.cu:19-100``); ``dasp_tpu/bench/baselines.py`` gives that role
to ``jax.experimental.sparse`` BCOO.  It runs live on every arm: there is
no cache of baseline results.
"""

from __future__ import annotations

import functools
import time
import warnings

import numpy as np
import torch

from ..ops.cuda_backend import TAP, _to_host
from ..sparse import CSRMatrix

TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f64": torch.float64}


def cusparse_matrix(csr: CSRMatrix, dtype: str, device):
    """(torch CSR matrix on ``device`` for cuSPARSE, its value dtype): f64
    values for "f64", f32 otherwise.  The suite's rows may repeat a column
    (the generators clip and draw with replacement), which torch's CSR
    invariants reject; the product sums such entries, as the golden does,
    and is held to it."""
    vdt = torch.float64 if dtype == "f64" else torch.float32
    with warnings.catch_warnings():
        # torch says once per process that sparse CSR support is in beta
        # and that the invariant checks are off
        warnings.filterwarnings("ignore", message="Sparse ",
                                category=UserWarning)
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.row_ptr.astype(np.int64)),
            torch.from_numpy(csr.col_idx.astype(np.int64)),
            torch.from_numpy(csr.values).to(vdt),
            size=(csr.n_rows, csr.n_cols),
            check_invariants=False)
    return A.to(device), vdt


@functools.lru_cache(maxsize=None)
def sparse_bf16_runs(device_type: str) -> bool:
    """Whether this build of PyTorch multiplies a bf16 CSR matrix by a
    bf16 vector on ``device_type``.  Probed once per process on a 2 x 2
    matrix, and said on a line of its own."""
    try:
        A = torch.sparse_csr_tensor(
            torch.tensor([0, 1, 2]), torch.tensor([0, 1]),
            torch.ones(2, dtype=torch.bfloat16), size=(2, 2),
            check_invariants=False).to(device_type)
        ok = bool(torch.equal(
            (A @ torch.ones(2, dtype=torch.bfloat16, device=device_type)
             ).float().cpu(), torch.ones(2)))
    except (RuntimeError, NotImplementedError):
        ok = False
    print(f"# cuSPARSE baseline: a bf16 CSR product "
          f"{'runs' if ok else 'does not run'} on {device_type} with torch "
          f"{torch.__version__}; the bf16 arms' baseline computes in "
          f"{'bf16' if ok else 'f32'}", flush=True)
    return ok


class CuSparseBaseline:
    """cuSPARSE SpMV and SpMM with the interface of SpMVOperator
    (``BCOOBaseline`` of the JAX package).  ``compute_dtype`` names what
    the library computes in, for the record's ``baseline_dtype``: f32 and
    f64 run natively, and bf16 does where this build supports it and runs
    in f32 otherwise -- the reference's own convention for a dtype its
    vendor library lacks (``main_f16.cu:57-58``)."""

    def __init__(self, csr: CSRMatrix, dtype: str = "f32", device="cuda"):
        t0 = time.perf_counter()
        self.n_rows, self.n_cols, self.nnz = csr.n_rows, csr.n_cols, csr.nnz
        self.dtype = dtype
        self.device = torch.device(device)
        self.compute_dtype = dtype
        if dtype == "bf16" and not sparse_bf16_runs(self.device.type):
            self.compute_dtype = "f32"
        self.mat, _ = cusparse_matrix(csr, self.compute_dtype, self.device)
        if self.compute_dtype == "bf16":
            self.mat = self.mat.to(torch.bfloat16)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.preprocess_seconds = time.perf_counter() - t0

    def _prep_x(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)).to(
            TORCH_DTYPE[self.compute_dtype]).to(self.device)

    def device_call(self, x_dev: torch.Tensor) -> torch.Tensor:
        return self.mat @ x_dev

    def timing_loop(self, iters: int):
        """x -> y after ``iters`` chained products, each adding y[0] * TAP
        into x, and one more: the chain of ``TorchSpMV.timing_loop`` on
        its streamed path."""
        mat = self.mat

        def run(x_dev: torch.Tensor) -> torch.Tensor:
            x = x_dev.clone()
            for _ in range(iters):
                x.add_((mat @ x)[0] * TAP)
            return mat @ x
        return run

    def spmm_loop(self, X):
        """The device half of ``matmat(X)``: one library call ``A @ X``."""
        Xd = self._prep_x(X).contiguous()
        return lambda: self.mat @ Xd

    def matmat(self, X) -> np.ndarray:
        return _to_host(self.spmm_loop(X)())

    def __call__(self, x) -> np.ndarray:
        return _to_host(self.device_call(self._prep_x(x)))


class DenseBaseline:
    """Dense matmul roofline probe (only for small n): what the tensor
    cores would do if the matrix were dense."""

    def __init__(self, csr: CSRMatrix, dtype: str = "f32", device="cuda"):
        self.n_rows, self.n_cols, self.nnz = csr.n_rows, csr.n_cols, csr.nnz
        self.dtype = dtype
        self.device = torch.device(device)
        self.mat = torch.from_numpy(csr.to_dense()).to(
            TORCH_DTYPE[dtype]).to(self.device)
        self.preprocess_seconds = 0.0

    def _prep_x(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)).to(
            TORCH_DTYPE[self.dtype]).to(self.device)

    def device_call(self, x_dev: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.mat, x_dev)
