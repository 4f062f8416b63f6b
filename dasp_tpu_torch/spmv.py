"""User-facing SpMV operator of the PyTorch port.

``SpMVOperator`` packs once at construction (host side, ``build_wplan``),
keeps the lowered tables on a device (the CUDA card unless the caller asks
for another), and runs the windowed kernels on every call, returning y in
original row order — the port of
``dasp_tpu/spmv.py``'s operator on its windowed (Pallas) path.  The legacy
tile plan and its XLA executor (``plan.py``, ``ops/xla_backend.py``) are
not ported: the windowed path runs on CPU tensors too.
"""

from __future__ import annotations

from .config import DaspConfig
from .ops.cuda_backend import DTYPES, TorchSpMV  # noqa: F401 (DTYPES)
from .sparse import CSRMatrix


class SpMVOperator(TorchSpMV):
    """Packed SpMV for one matrix: ``y = op(x)``, ``Y = op.matmat(X)``.

    Args:
      csr: host CSR matrix, or a prebuilt WPlan (one plan serves every
        dtype).
      dtype: "f32"; "bf16" (bf16 values, f32 x and sums, y rounded to
        bf16 and returned as float32, numpy having no bfloat16); or "f64"
        (native fp64 throughout, returned as float64).
      config: packing tunables (ignored for a prebuilt WPlan);
        ``strict_f64`` is accepted and changes nothing, the f64 path
        being strict fp64 always.
      device: where the tables live and the kernels run ("cuda" by
        default, "cpu", a torch.device); CUDA tensors run the hand-written
        kernels, CPU tensors their plain PyTorch versions.
      force_streamed: run ``timing_loop`` as ``iters + 1`` single-vector
        SpMVs (one K6 step each) even where the plan could run the whole
        chain in one launch (``resident`` is then False), as the
        reference's ``PallasSpMV(force_streamed=True)``.
    """

    def __init__(self, csr, dtype: str = "f32",
                 config: DaspConfig | None = None, *, device="cuda",
                 force_streamed: bool = False):
        super().__init__(csr, device, config, dtype, force_streamed)


def spmv(csr: CSRMatrix, x, dtype: str = "f32",
         config: DaspConfig | None = None, *, device="cuda"):
    """One-shot convenience wrapper: pack + run once (one single-vector
    SpMV: one K6 step on the card)."""
    return SpMVOperator(csr, dtype, config, device=device)(x)
