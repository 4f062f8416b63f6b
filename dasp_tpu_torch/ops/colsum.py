"""colsum (K1, and its fp64 instance K3): the per-stream windowed-gather
kernel and its plain version.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_colsum`` (:121) and, in
fp64, ``_make_colsum_dd`` (:277); the CUDA source is
``dasp_tpu_torch/csrc/colsum.cu``, whose header note says what bounds it
on Hopper and how its design answers that.

Value types: f32 and bf16 values with an f32 x table and f32 sums; f64
values with an f64 x table and f64 sums (native fp64 in place of the
reference's double-double pairs).

``colsum`` takes a CPU tensor to ``colsum_plain`` and a CUDA tensor to the
kernel; there is no fallback from one to the other.  ``colsum.launches``
counts kernel launches per value type (the plain path does not count).
"""

from __future__ import annotations

import torch

from ..wplan import SUB, LANES
from . import _build

# value dtype -> (name of the instance, x / sum / output dtype)
VALUE_TYPES = {torch.float32: ("f32", torch.float32),
               torch.bfloat16: ("bf16", torch.float32),
               torch.float64: ("f64", torch.float64)}


def colsum_plain(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                 x2d: torch.Tensor, stride: int) -> torch.Tensor:
    """(wins (NV,P+1) i32, vals (NV*8,128) f32/bf16/f64, idx (NV*8,128)
    i16, x2d (S,128) f32, or f64 for f64 vals) -> per-level column sums
    (NV*8/stride, 128) in x2d's dtype.

    Slot (i, j) of vreg v gathers x2d[wins[v, 1+c] + q, lam] with
    lam = idx[v,i,j] & 127 and q, c read at the cell (i, lam); the emulator
    semantics of tests/test_wplan.py:_emulate, in tensors.  bf16 values
    are upcast (exactly) before the product.  Each level sums its
    ``stride`` sublanes in sublane order, as the kernel does."""
    nv, R = wins.shape[0], SUB // stride
    xv = x2d.reshape(-1)[_gather_index(wins, idx)]
    prod = (vals.view(nv, SUB, LANES).to(x2d.dtype) * xv).view(
        nv, R, stride, LANES)
    acc = prod[:, :, 0]
    for s in range(1, stride):
        acc = acc + prod[:, :, s]
    return acc.reshape(nv * R, LANES)


def _gather_index(wins: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(NV,8,128) int64 flat index into the x table of every slot:
    (wins[v, 1+c] + q) * 128 + lam, with q and c read at the cell."""
    nv, P = wins.shape[0], wins.shape[1] - 1
    tile = idx.view(nv, SUB, LANES).long()
    lam = tile & 127
    cell = torch.gather(tile, 2, lam)
    q = (cell >> 7) & 7
    c = (cell >> 10).clamp_(max=P - 1)
    w = torch.gather(wins.long(), 1, 1 + c.view(nv, SUB * LANES))
    return (w.view(nv, SUB, LANES) + q) * LANES + lam


def check_stream_args(fn: str, wins, vals, idx, x, stride: int):
    """Validate a colsum-family call (device, dtype, shape, contiguity);
    return the value type's (instance name, x dtype)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if vals.dtype not in VALUE_TYPES:
        raise ValueError(f"{fn}: unsupported value dtype {vals.dtype}")
    name, xdt = VALUE_TYPES[vals.dtype]
    nv, P = wins.shape[0], wins.shape[1] - 1
    for arg, t, dt, shape in (
            ("wins", wins, torch.int32, (nv, P + 1)),
            ("vals", vals, vals.dtype, (nv * SUB, LANES)),
            ("idx", idx, torch.int16, (nv * SUB, LANES)),
            ("x", x, xdt, (x.shape[0], LANES))):
        if (t.device != x.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{fn}: {arg} must be a contiguous {dt} {shape} tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if stride not in (2, 4, SUB) or P < 1:
        raise ValueError(f"{fn}: stride {stride} / P {P} not supported")
    if (x.device.type == "cuda"
            and x.device.index != torch.cuda.current_device()):
        # the kernel library launches on the current device's context
        raise ValueError(f"{fn}: {x.device} is not the current CUDA "
                         "device (use torch.cuda.device(...))")
    return name, xdt


def colsum(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
           x2d: torch.Tensor, stride: int) -> torch.Tensor:
    """K1 (K3 for f64 values) on CUDA tensors, ``colsum_plain`` on CPU
    tensors."""
    name, xdt = check_stream_args("colsum", wins, vals, idx, x2d, stride)
    if x2d.device.type == "cpu":
        return colsum_plain(wins, vals, idx, x2d, stride)
    nv, P = wins.shape[0], wins.shape[1] - 1
    out = torch.empty((nv * (SUB // stride), LANES), dtype=xdt,
                      device=x2d.device)
    entry = f"dasp_colsum_{name}"
    rc = getattr(_build.library(), entry)(
        wins.data_ptr(), vals.data_ptr(), idx.data_ptr(), x2d.data_ptr(),
        out.data_ptr(), nv, P, stride,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, entry)
    colsum.launches[name] += 1
    return out


colsum.launches = {"f32": 0, "bf16": 0, "f64": 0}
