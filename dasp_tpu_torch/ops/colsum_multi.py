"""colsum_multi (K5): the multi-vector colsum of SpMM and its plain version.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_colsum_multi`` (:174); the
CUDA source is ``dasp_tpu_torch/csrc/colsum_multi.cu``, whose header note
says what bounds it on Hopper and how its design answers that.

It is K1 (K3 for f64 values) against ``kv`` x tables stacked as
(kv*S, 128): each slot's value and idx word is read once for all kv
tables, and slice j of the (kv, NV*8/stride, 128) output is K1 on table j.

``colsum_multi`` takes a CPU tensor to ``colsum_multi_plain`` and a CUDA
tensor to the kernel; there is no fallback from one to the other.
``colsum_multi.launches`` counts kernel launches per value type.
"""

from __future__ import annotations

import torch

from ..wplan import SUB, LANES
from . import _build
from .colsum import _gather_index, check_stream_args

KV_SIZES = (1, 2, 4, 8)


def colsum_multi_plain(wins: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor, x3d: torch.Tensor, stride: int,
                       kv: int) -> torch.Tensor:
    """(wins, vals, idx as for colsum_plain; x3d (kv*S,128), kv tables
    of S rows) -> (kv, NV*8/stride, 128) in x3d's dtype: slice j is
    ``colsum_plain`` on table j, the same products summed in the same
    order."""
    nv, R = wins.shape[0], SUB // stride
    xv = x3d.view(kv, -1)[:, _gather_index(wins, idx)]
    prod = (vals.view(1, nv, SUB, LANES).to(x3d.dtype) * xv).view(
        kv, nv, R, stride, LANES)
    acc = prod[:, :, :, 0]
    for s in range(1, stride):
        acc = acc + prod[:, :, :, s]
    return acc.reshape(kv, nv * R, LANES)


def colsum_multi(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                 x3d: torch.Tensor, stride: int, kv: int) -> torch.Tensor:
    """K5 on CUDA tensors, ``colsum_multi_plain`` on CPU tensors."""
    name, xdt = check_stream_args("colsum_multi", wins, vals, idx, x3d,
                                  stride)
    if kv not in KV_SIZES or x3d.shape[0] % kv:
        raise ValueError(f"colsum_multi: kv {kv} must be one of {KV_SIZES} "
                         f"and divide the {x3d.shape[0]} rows of x3d")
    if x3d.device.type == "cpu":
        return colsum_multi_plain(wins, vals, idx, x3d, stride, kv)
    nv, P = wins.shape[0], wins.shape[1] - 1
    out = torch.empty((kv, nv * (SUB // stride), LANES), dtype=xdt,
                      device=x3d.device)
    entry = f"dasp_colsum_multi_{name}"
    rc = getattr(_build.library(), entry)(
        wins.data_ptr(), vals.data_ptr(), idx.data_ptr(), x3d.data_ptr(),
        out.data_ptr(), nv, P, stride, x3d.shape[0] // kv, kv,
        torch.cuda.current_stream(x3d.device).cuda_stream)
    _build.check(rc, entry)
    colsum_multi.launches[name] += 1
    return out


colsum_multi.launches = {"f32": 0, "bf16": 0, "f64": 0}
