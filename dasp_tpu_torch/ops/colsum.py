"""colsum (K1): the per-stream windowed-gather kernel and its plain version.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_colsum`` (:121); the CUDA
source is ``dasp_tpu_torch/csrc/colsum.cu``, whose header note says what
bounds it on Hopper and how its design answers that.

``colsum`` takes a CPU tensor to ``colsum_plain`` and a CUDA tensor to the
kernel; there is no fallback from one to the other.  ``colsum.launches``
counts kernel launches (the plain path does not count).
"""

from __future__ import annotations

import torch

from ..wplan import SUB, LANES
from . import _build


def colsum_plain(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                 x2d: torch.Tensor, stride: int) -> torch.Tensor:
    """(wins (NV,P+1) i32, vals (NV*8,128) f32, idx (NV*8,128) i16,
    x2d (S,128) f32) -> per-level column sums (NV*8/stride, 128) f32.

    Slot (i, j) of vreg v gathers x2d[wins[v, 1+c] + q, lam] with
    lam = idx[v,i,j] & 127 and q, c read at the cell (i, lam); the emulator
    semantics of tests/test_wplan.py:_emulate, in tensors.  Each level sums
    its ``stride`` sublanes in sublane order, as the kernel does."""
    nv, P = wins.shape[0], wins.shape[1] - 1
    R = SUB // stride
    tile = idx.view(nv, SUB, LANES).long()
    lam = tile & 127
    cell = torch.gather(tile, 2, lam)
    q = (cell >> 7) & 7
    c = (cell >> 10).clamp_(max=P - 1)
    w = torch.gather(wins.long(), 1, 1 + c.view(nv, SUB * LANES))
    xv = x2d.reshape(-1)[(w.view(nv, SUB, LANES) + q) * LANES + lam]
    prod = (vals.view(nv, SUB, LANES) * xv).view(nv, R, stride, LANES)
    acc = prod[:, :, 0]
    for s in range(1, stride):
        acc = acc + prod[:, :, s]
    return acc.reshape(nv * R, LANES)


def colsum(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
           x2d: torch.Tensor, stride: int) -> torch.Tensor:
    """K1 on CUDA tensors, ``colsum_plain`` on CPU tensors."""
    if x2d.device.type == "cpu":
        return colsum_plain(wins, vals, idx, x2d, stride)
    if x2d.device.type != "cuda":
        raise ValueError(f"colsum: unsupported device {x2d.device}")
    if x2d.device.index != torch.cuda.current_device():
        # the kernel library launches on the current device's context
        raise ValueError(f"colsum: {x2d.device} is not the current "
                         "CUDA device (use torch.cuda.device(...))")
    nv, P = wins.shape[0], wins.shape[1] - 1
    dev = x2d.device
    for name, t, dt, shape in (
            ("wins", wins, torch.int32, (nv, P + 1)),
            ("vals", vals, torch.float32, (nv * SUB, LANES)),
            ("idx", idx, torch.int16, (nv * SUB, LANES)),
            ("x2d", x2d, torch.float32, (x2d.shape[0], LANES))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"colsum: {name} must be a contiguous {dt} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if stride not in (2, 4, SUB) or P < 1:
        raise ValueError(f"colsum: stride {stride} / P {P} not supported")
    out = torch.empty((nv * (SUB // stride), LANES), dtype=torch.float32,
                      device=dev)
    rc = _build.library().dasp_colsum_f32(
        wins.data_ptr(), vals.data_ptr(), idx.data_ptr(), x2d.data_ptr(),
        out.data_ptr(), nv, P, stride,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dasp_colsum_f32")
    colsum.launches += 1
    return out


colsum.launches = 0
