"""outgather (K2, and its fp64 instance K4): y-block assembly kernel and
its plain version.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_outgather`` (:437) and, in
fp64, ``_make_outgather_dd`` (:378); the CUDA source is
``dasp_tpu_torch/csrc/outgather.cu``, whose header note says what bounds
it on Hopper and why one launch covers every ``og_ranges`` range; its
body, one warp per output block, is ``csrc/outgather_common.cuh``, which
K6's phase D runs too.  The instance follows y2's dtype: f32 (K2) or f64
(K4).

Both take one y2 (rows,128) or the (kv,rows,128) of an SpMM pass, whose
vectors share src and perm: the kernel then runs the batch as a second
grid dimension of one launch, and vector k's output is what the single
call gives on y2[k].

``outgather`` takes a CPU tensor to ``outgather_plain`` and a CUDA tensor
to the kernel; there is no fallback from one to the other.
``outgather.launches`` counts kernel launches per dtype.
"""

from __future__ import annotations

import torch

from ..wplan import LANES
from . import _build

DTYPES = {torch.float32: "f32", torch.float64: "f64"}   # y2 -> instance


def outgather_plain(src: torch.Tensor, perm: torch.Tensor,
                    y2: torch.Tensor) -> torch.Tensor:
    """(src (B,K) i32, perm (K,B,128) i8, y2 (R2,128) or (kv,R2,128), f32
    or f64) -> (B,128) or (kv,B,128) in y2's dtype:
    out[b, l] = sum_k y2[src[b,k], perm[k,b,l]], summed in slot order
    (the emulator semantics of tests/test_wplan.py:83-88, in tensors)."""
    lead = y2.shape[:-2]

    def slot(k):
        lanes = perm[k].long().expand(*lead, -1, -1)
        return torch.gather(y2[..., src[:, k].long(), :], -1, lanes)

    acc = slot(0)
    for k in range(1, src.shape[1]):
        acc = acc + slot(k)
    return acc


def outgather(src: torch.Tensor, perm: torch.Tensor, y2: torch.Tensor,
              zero_row: int) -> torch.Tensor:
    """K2 (K4 for f64 y2) on CUDA tensors, ``outgather_plain`` on CPU
    tensors.  For a slot whose source is ``zero_row`` (the all-zero y2
    row) the kernel reads no perm row and adds a zero, and a block with no
    other slot writes zeros at once; the plain version adds the zero row,
    with the same result."""
    if y2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"outgather: unsupported device {y2.device}")
    if y2.dtype not in DTYPES:
        raise ValueError(f"outgather: unsupported y2 dtype {y2.dtype}")
    B, K = src.shape
    dev = y2.device
    if y2.dim() not in (2, 3):
        raise ValueError(f"outgather: y2 must be (rows, {LANES}) or (kv, "
                         f"rows, {LANES}), got {tuple(y2.shape)}")
    lead, rows = tuple(y2.shape[:-2]), y2.shape[-2]
    for name, t, dt, shape in (
            ("src", src, torch.int32, (B, K)),
            ("perm", perm, torch.int8, (K, B, LANES)),
            ("y2", y2, y2.dtype, lead + (rows, LANES))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"outgather: {name} must be a contiguous {dt} {shape} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 <= zero_row < rows:
        raise ValueError(f"outgather: zero_row {zero_row} outside y2")
    if dev.type == "cpu":
        return outgather_plain(src, perm, y2)
    if dev.index != torch.cuda.current_device():
        # the kernel library launches on the current device's context
        raise ValueError(f"outgather: {dev} is not the current "
                         "CUDA device (use torch.cuda.device(...))")
    if perm.data_ptr() % 4:
        raise ValueError("outgather: perm must be 4-byte aligned (the "
                         "kernel reads four lane ids at a time)")
    out = torch.empty(lead + (B, LANES), dtype=y2.dtype, device=dev)
    entry = f"dasp_outgather_{DTYPES[y2.dtype]}"
    rc = getattr(_build.library(), entry)(
        src.data_ptr(), perm.data_ptr(), y2.data_ptr(), out.data_ptr(),
        B, K, zero_row, lead[0] if lead else 1, rows * LANES,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry)
    outgather.launches[DTYPES[y2.dtype]] += 1
    return out


outgather.launches = {"f32": 0, "f64": 0}
