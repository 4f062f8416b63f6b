"""User-facing SpMV operator of the PyTorch port.

``SpMVOperator`` packs once at construction (host side, ``build_wplan``),
keeps the lowered tables on an explicit ``device``, and runs the windowed
kernels on every call, returning y in original row order — the port of
``dasp_tpu/spmv.py``'s operator on its windowed (Pallas) path.  The legacy
tile plan and its XLA executor (``plan.py``, ``ops/xla_backend.py``) are
not ported: the windowed path runs on CPU tensors too.
"""

from __future__ import annotations

from .config import DaspConfig
from .ops.cuda_backend import TorchSpMV
from .sparse import CSRMatrix

DTYPES = ("f32", "bf16", "f64")


class SpMVOperator(TorchSpMV):
    """Packed SpMV for one matrix: ``y = op(x)``.

    Args:
      csr: host CSR matrix, or a prebuilt WPlan.
      dtype: "f32".  "bf16" and "f64" are not ported yet (ROADMAP.md
        queue 1, modules 4 and 5) and raise NotImplementedError.
      config: packing tunables (ignored for a prebuilt WPlan).
      device: where the tables live and the kernels run ("cuda", "cpu",
        a torch.device); CUDA tensors run the hand-written kernels, CPU
        tensors their plain PyTorch versions.
    """

    def __init__(self, csr, dtype: str = "f32",
                 config: DaspConfig | None = None, *, device):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}")
        if dtype != "f32":
            raise NotImplementedError(
                f"dtype {dtype!r} is not ported yet (ROADMAP.md queue 1, "
                f"module {4 if dtype == 'bf16' else 5})")
        super().__init__(csr, device, config)


def spmv(csr: CSRMatrix, x, dtype: str = "f32",
         config: DaspConfig | None = None, *, device):
    """One-shot convenience wrapper: pack + run once."""
    return SpMVOperator(csr, dtype, config, device=device)(x)
