"""User-facing SpMV operator of the PyTorch port.

``SpMVOperator`` packs once at construction (host side), keeps the lowered
tables on a device (the CUDA card unless the caller asks for another), and
runs them on every call, returning y in original row order — the port of
``dasp_tpu/spmv.py``'s operator.  Two executors, as there:

* the windowed kernels (``build_wplan``, ``ops/cuda_backend.TorchSpMV``;
  the reference's Pallas path), for ``backend="pallas"`` or ``"auto"`` or
  a prebuilt ``WPlan``;
* the tile plan's executor (``build_plan``, ``ops/xla_backend.TileSpMV``;
  the reference's XLA path), PyTorch ops with no kernel of their own, for
  ``backend="xla"`` or a prebuilt ``DaspPlan``.

One divergence: the reference's ``"auto"`` takes the XLA executor off a
TPU (:60-66); here the windowed kernels run on the card, so ``"auto"``
stays windowed.
"""

from __future__ import annotations

from .config import DaspConfig
from .ops.cuda_backend import DTYPES, TorchSpMV  # noqa: F401 (DTYPES)
from .ops.xla_backend import TileSpMV
from .plan import DaspPlan
from .sparse import CSRMatrix
from .wplan import WPlan

BACKENDS = ("xla", "pallas", "auto")


def _tile(csr, backend: str) -> bool:
    """Whether ``csr`` and ``backend`` select the tile executor."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} must be one of {BACKENDS}")
    return not isinstance(csr, WPlan) and (backend == "xla"
                                           or isinstance(csr, DaspPlan))


class SpMVOperator(TorchSpMV):
    """Packed SpMV for one matrix: ``y = op(x)``, ``Y = op.matmat(X)``.

    Args:
      csr: host CSR matrix, or a prebuilt WPlan or DaspPlan (one plan
        serves every dtype).
      dtype: "f32"; "bf16" (bf16 values; y rounded to bf16 and returned as
        float32, numpy having no bfloat16; the windowed path keeps x and
        sums in f32, the tile path rounds x and each product to bf16, as
        the reference's XLA executor does); or "f64" (native fp64
        throughout, returned as float64).
      config: packing tunables (ignored for a prebuilt plan);
        ``strict_f64`` is accepted and changes nothing, the f64 path
        being strict fp64 always.
      backend: "pallas" or "auto" (the windowed kernels) or "xla" (the
        tile executor, ``ops/xla_backend.TileSpMV``, which this
        constructor then returns); a WPlan always runs windowed and a
        DaspPlan on the tile executor.  Any other value raises ValueError.
      device: where the tables live and the kernels run ("cuda" by
        default, "cpu", a torch.device); CUDA tensors run the hand-written
        kernels, CPU tensors their plain PyTorch versions.
      force_streamed: run ``timing_loop`` as ``iters + 1`` single-vector
        SpMVs (one K6 step each) even where the plan could run the whole
        chain in one launch (``resident`` is then False), as the
        reference's ``PallasSpMV(force_streamed=True)``; windowed only.
    """

    backend = "pallas"

    def __new__(cls, csr, dtype: str = "f32",
                config: DaspConfig | None = None, backend: str = "auto", *,
                device="cuda", force_streamed: bool = False):
        if _tile(csr, backend):
            return TileSpMV(csr, dtype, config, device=device)
        return super().__new__(cls)

    def __init__(self, csr, dtype: str = "f32",
                 config: DaspConfig | None = None, backend: str = "auto", *,
                 device="cuda", force_streamed: bool = False):
        super().__init__(csr, device, config, dtype, force_streamed)


def spmv(csr: CSRMatrix, x, dtype: str = "f32",
         config: DaspConfig | None = None, backend: str = "auto", *,
         device="cuda"):
    """One-shot convenience wrapper: pack + run once (windowed: one
    single-vector SpMV, one K6 step on the card)."""
    return SpMVOperator(csr, dtype, config, backend, device=device)(x)
