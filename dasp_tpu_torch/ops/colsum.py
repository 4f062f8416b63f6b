"""colsum (K1, and its fp64 instance K3): the per-stream windowed-gather
kernel, the plain versions of the colsum family, and the launch that K1,
K3 and K5 share.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_colsum`` (:121) and, in
fp64, ``_make_colsum_dd`` (:277).  K1 and K3 are the kv = 1 instance of
K5's kernel, ``dasp_tpu_torch/csrc/colsum_multi.cu``: at kv = 1 it
computes K1's function in K1's order, so one source serves both.  What
bounds that instance on an H100 is what bounded K5 (``colsum_multi.py``):
not the bytes it streams but the SM's load path and the two loads in front
of every x gather (the cell of the idx tile and the window offset).  The
kernel stages both for the next vreg with ``cp.async`` while it computes
the current one, keeps the gathers of all 8 sublanes in flight before the
first product, and runs a persistent grid of one-vreg blocks: 0.58-0.83
of the bound on cop20k_like, where K1's first kernel, a block of 4 vregs
that staged its tile and exited, reached 0.49-0.62 (``PERF.md`` §6).

Value types: f32 and bf16 values with an f32 x table and f32 sums; f64
values with an f64 x table and f64 sums (native fp64 in place of the
reference's double-double pairs).

``colsum`` takes a CPU tensor to ``colsum_plain`` and a CUDA tensor to the
kernel; there is no fallback from one to the other.  ``colsum.launches``
counts its launches per value type (the plain path does not count, and
neither does ``colsum_multi``, which counts its own).
"""

from __future__ import annotations

import torch

from ..wplan import SUB, LANES
from . import _build

# value dtype -> (name of the instance, x / sum / output dtype)
VALUE_TYPES = {torch.float32: ("f32", torch.float32),
               torch.bfloat16: ("bf16", torch.float32),
               torch.float64: ("f64", torch.float64)}
MAX_P = 32              # windows of a vreg: the packer's cap, the kernel's


def colsum_plain(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                 x2d: torch.Tensor, stride: int) -> torch.Tensor:
    """(wins (NV,P+1) i32, vals (NV*8,128) f32/bf16/f64, idx (NV*8,128)
    i16, x2d (S,128) f32, or f64 for f64 vals) -> per-level column sums
    (NV*8/stride, 128) in x2d's dtype.

    Slot (i, j) of vreg v gathers x2d[wins[v, 1+c] + q, lam] with
    lam = idx[v,i,j] & 127 and q, c read at the cell (i, lam); the emulator
    semantics of tests/test_wplan.py:_emulate, in tensors.  bf16 values
    are upcast (exactly) before the product.  Each level sums its
    ``stride`` sublanes in sublane order, as the kernel does: it is
    ``colsum_multi_plain`` on one table."""
    return colsum_multi_plain(wins, vals, idx, x2d, stride, 1)[0]


def colsum_multi_plain(wins: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor, x3d: torch.Tensor, stride: int,
                       kv: int) -> torch.Tensor:
    """(wins, vals, idx as for colsum_plain; x3d (kv*S,128), kv tables
    of S rows) -> (kv, NV*8/stride, 128) in x3d's dtype: slice j is
    ``colsum_plain`` on table j, the same products summed in the same
    order."""
    nv, R = wins.shape[0], SUB // stride
    xv = x3d.reshape(kv, -1)[:, _gather_index(wins, idx)]
    prod = (vals.view(1, nv, SUB, LANES).to(x3d.dtype) * xv).view(
        kv, nv, R, stride, LANES)
    acc = prod[:, :, :, 0]
    for s in range(1, stride):
        acc = acc + prod[:, :, :, s]
    return acc.reshape(kv, nv * R, LANES)


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
    """Validate a colsum-family call (device, dtype, shape, contiguity,
    stride and P, the same on the CPU as on the card); return the value
    type's (instance name, x dtype)."""
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
    if stride not in (2, 4, SUB) or not 1 <= P <= MAX_P:
        raise ValueError(f"{fn}: stride {stride} / P {P} not supported "
                         f"(strides 2, 4, 8; P 1 to {MAX_P}, the packer's "
                         "cap)")
    if (x.device.type == "cuda"
            and x.device.index != torch.cuda.current_device()):
        # the kernel library launches on the current device's context
        raise ValueError(f"{fn}: {x.device} is not the current CUDA "
                         "device (use torch.cuda.device(...))")
    return name, xdt


def launch(fn: str, name: str, xdt, wins, vals, idx, x3d, stride: int,
           kv: int) -> torch.Tensor:
    """One launch of the colsum kernel (``csrc/colsum_multi.cu``) at kv
    on CUDA tensors that ``check_stream_args`` passed -> (kv, NV*8/stride,
    128).  The caller counts it."""
    if idx.data_ptr() % 16:
        raise ValueError(f"{fn}: idx must be 16-byte aligned (the kernel "
                         "copies 16 bytes a thread)")
    nv, P = wins.shape[0], wins.shape[1] - 1
    out = torch.empty((kv, nv * (SUB // stride), LANES), dtype=xdt,
                      device=x3d.device)
    entry = f"dasp_colsum_multi_{name}"
    rc = getattr(_build.library(), entry)(
        wins.data_ptr(), vals.data_ptr(), idx.data_ptr(), x3d.data_ptr(),
        out.data_ptr(), nv, P, stride, x3d.shape[0] // kv, kv,
        torch.cuda.current_stream(x3d.device).cuda_stream)
    _build.check(rc, entry)
    return out


def colsum(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
           x2d: torch.Tensor, stride: int) -> torch.Tensor:
    """K1 (K3 for f64 values), the kv = 1 instance of the colsum kernel,
    on CUDA tensors; ``colsum_plain`` on CPU tensors."""
    name, xdt = check_stream_args("colsum", wins, vals, idx, x2d, stride)
    if x2d.device.type == "cpu":
        return colsum_plain(wins, vals, idx, x2d, stride)
    out = launch("colsum", name, xdt, wins, vals, idx, x2d, stride, 1)[0]
    colsum.launches[name] += 1
    return out


colsum.launches = {"f32": 0, "bf16": 0, "f64": 0}
