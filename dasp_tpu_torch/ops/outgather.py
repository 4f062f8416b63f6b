"""outgather (K2): y-block assembly kernel and its plain version.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_outgather`` (:437); the
CUDA source is ``dasp_tpu_torch/csrc/outgather.cu``, whose header note
says what bounds it on Hopper and why one launch covers every
``og_ranges`` range.

``outgather`` takes a CPU tensor to ``outgather_plain`` and a CUDA tensor
to the kernel; there is no fallback from one to the other.
``outgather.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..wplan import LANES
from . import _build


def outgather_plain(src: torch.Tensor, perm: torch.Tensor,
                    y2: torch.Tensor) -> torch.Tensor:
    """(src (B,K) i32, perm (K,B,128) i8, y2 (R2,128) f32) -> (B,128) f32:
    out[b, l] = sum_k y2[src[b,k], perm[k,b,l]], summed in slot order
    (the emulator semantics of tests/test_wplan.py:83-88, in tensors)."""
    acc = torch.gather(y2[src[:, 0].long()], 1, perm[0].long())
    for k in range(1, src.shape[1]):
        acc = acc + torch.gather(y2[src[:, k].long()], 1, perm[k].long())
    return acc


def outgather(src: torch.Tensor, perm: torch.Tensor, y2: torch.Tensor,
              zero_row: int) -> torch.Tensor:
    """K2 on CUDA tensors, ``outgather_plain`` on CPU tensors.  A slot
    whose source is ``zero_row`` (the all-zero y2 row) is skipped by the
    kernel; the plain version adds the zero row, with the same result."""
    if y2.device.type == "cpu":
        return outgather_plain(src, perm, y2)
    if y2.device.type != "cuda":
        raise ValueError(f"outgather: unsupported device {y2.device}")
    if y2.device.index != torch.cuda.current_device():
        # the kernel library launches on the current device's context
        raise ValueError(f"outgather: {y2.device} is not the current "
                         "CUDA device (use torch.cuda.device(...))")
    B, K = src.shape
    dev = y2.device
    for name, t, dt, shape in (
            ("src", src, torch.int32, (B, K)),
            ("perm", perm, torch.int8, (K, B, LANES)),
            ("y2", y2, torch.float32, (y2.shape[0], LANES))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"outgather: {name} must be a contiguous {dt} {shape} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 <= zero_row < y2.shape[0]:
        raise ValueError(f"outgather: zero_row {zero_row} outside y2")
    out = torch.empty((B, LANES), dtype=torch.float32, device=dev)
    rc = _build.library().dasp_outgather_f32(
        src.data_ptr(), perm.data_ptr(), y2.data_ptr(), out.data_ptr(),
        B, K, zero_row, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dasp_outgather_f32")
    outgather.launches += 1
    return out


outgather.launches = 0
