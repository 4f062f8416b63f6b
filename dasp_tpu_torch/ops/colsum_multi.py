"""colsum_multi (K5): the multi-vector colsum of SpMM.

Replaces ``dasp_tpu/ops/pallas_backend.py:_make_colsum_multi`` (:174); the
CUDA source is ``dasp_tpu_torch/csrc/colsum_multi.cu``.  Its plain version
(``colsum_multi_plain``) and its launch live in ``colsum.py``, beside K1/K3,
which are the kernel's kv = 1 instance.

It is K1 (K3 for f64 values) against ``kv`` x tables stacked as
(kv*S, 128): each slot's value and idx word is read once for all kv
tables, and slice k of the (kv, NV*8/stride, 128) output is K1 on table k,
bit for bit.

What bounds the kernel on an H100 (``chip_smoke.py``'s split,
``probes/k5_levers.py`` and ``PERF.md``): not the bytes it streams but
what a SM's load path can serve.  Each further vector cost 3.3-4.2 us of a
pass in f32 wherever its gathers landed, and the gathers live on the L1
(sent past it a pass is 1.3-2.7x slower).  So the kernel keeps the L1 for
the x windows: blocks of one vreg with 4 KB of shared memory, a persistent
grid whose next vreg's idx tile and wins row are staged with ``cp.async``
while the current one is computed, the values straight from device
memory, a level's kv sums stored as soon as the level ends.  An x table
interleaved by vector, (S, 128, kv) with one vector load a slot, was
measured too: within 4 % at kv = 4 and 9-20 % slower at kv = 8 on
cop20k_like, so the tables stay stacked, as the reference has them.  The
source's header note has the rest.

``colsum_multi`` takes a CPU tensor to ``colsum_multi_plain`` and a CUDA
tensor to the kernel; there is no fallback from one to the other.
``colsum_multi.launches`` counts kernel launches per value type.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .colsum import check_stream_args, colsum_multi_plain, launch

KV_SIZES = (1, 2, 4, 8)


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
    out = launch("colsum_multi", name, xdt, wins, vals, idx, x3d, stride, kv)
    colsum_multi.launches[name] += 1
    return out


colsum_multi.launches = {"f32": 0, "bf16": 0, "f64": 0}


def kernel_info(name: str, stride: int, kv: int) -> dict:
    """What the build gave one K5 instance (value type ``name``): registers
    a thread, local (stack and spill) bytes a thread, shared bytes a block
    and co-resident blocks a SM.  Builds the library: needs the card."""
    out = (ctypes.c_int * 4)()
    rc = _build.library().dasp_colsum_multi_info(
        tuple(colsum_multi.launches).index(name), stride, kv,
        ctypes.addressof(out))
    _build.check(rc, "dasp_colsum_multi_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), out))
