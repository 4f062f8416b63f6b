"""The colsum probe body that T2 (``roundcost_ab``) and T3
(``stream_bench2``) share: its forms, its plain PyTorch version, the check
of its arguments, its launch and what the build gave it.  The kernel is
``csrc/colsum_probe.cu``, whose header note gives each form's gather.
"""

from __future__ import annotations

import ctypes

import torch

from ..wplan import SUB, LANES
from ..ops import _build
from ._common import check_args

INFO = ("registers", "local_bytes", "shared_bytes", "blocks_per_sm")


def colsum_probe_plain(wins: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor, x2d: torch.Tensor, form: str,
                       stride: int) -> torch.Tensor:
    """(wins (NV,P+1) i32, vals (NV*8,128) f32, idx (NV*8,128) i16, x2d
    (S,128) f32) -> per-level column sums (NV*8/stride, 128) f32.

    With lam = idx & 127, cell = idx at (i, lam) of the same tile and
    q = (cell >> 7) & 7, slot (i, j) of vreg v gathers x2d[row, lam]:
    row = q ("static"), wins[v,1] + q ("one"), or wins[v,1+c] + q with the
    tag c read at the slot ("cur"), at the cell ("flane") or at (q, lam) of
    the raw tile ("fboth"); a tag outside [0, P) gathers 0.  Each level
    sums its ``stride`` sublanes in sublane order, as the kernel does."""
    nv, P, R = wins.shape[0], wins.shape[1] - 1, SUB // stride
    tile = idx.view(nv, SUB, LANES).long()
    lam = tile & 127
    cell = torch.gather(tile, 2, lam)
    q = (cell >> 7) & 7
    hit = None
    if form == "static":
        row = q
    elif form == "one":
        row = wins[:, 1].long().view(nv, 1, 1) + q
    else:
        if form == "cur":
            c = tile >> 10
        elif form == "flane":
            c = cell >> 10
        else:
            c = torch.gather((tile >> 10).view(nv, SUB * LANES), 1,
                             (q * LANES + lam).view(nv, SUB * LANES))
        c = c.view(nv, SUB * LANES)
        hit = ((c >= 0) & (c < P)).view(nv, SUB, LANES)
        w = torch.gather(wins.long(), 1, 1 + c.clamp(0, P - 1))
        row = w.view(nv, SUB, LANES) + q
    g = x2d.reshape(-1)[row * LANES + lam]
    if hit is not None:
        g = g.masked_fill(~hit, 0.0)
    prod = (vals.view(nv, SUB, LANES) * g).view(nv, R, stride, LANES)
    acc = prod[:, :, 0]
    for s in range(1, stride):
        acc = acc + prod[:, :, s]
    return acc.reshape(nv * R, LANES)


def stream_bytes(nv: int, stride: int) -> int:
    """The tools' bytes of a call (stream_bench2.py:134): 6 B per slot
    streamed (f32 value, int16 idx) plus the output."""
    return nv * SUB * LANES * 6 + nv * (SUB // stride) * LANES * 4


def must_move(wins, vals, idx, form: str, stride: int) -> int:
    """Bytes one call must move: each input it reads once (of the x
    table, the 8-row windows that these wins name; the static form reads
    window 0 and no wins) and its output once."""
    nb = lambda t: t.numel() * t.element_size()
    if form == "static":
        windows, wins_b = 1, 0
    else:
        windows, wins_b = torch.unique(wins[:, 1:]).numel(), nb(wins)
    return (nb(vals) + nb(idx) + wins_b + windows * SUB * LANES * 4
            + wins.shape[0] * (SUB // stride) * LANES * 4)


def check_probe_args(fn: str, wins, vals, idx, x2d,
                     stride: int) -> torch.device:
    """Validate a T2/T3 call (device, dtype, shape, contiguity, stride);
    return the device."""
    nv, P = wins.shape[0], wins.shape[1] - 1
    dev = check_args(fn, (("wins", wins, torch.int32, (nv, P + 1)),
                          ("vals", vals, torch.float32, (nv * SUB, LANES)),
                          ("idx", idx, torch.int16, (nv * SUB, LANES)),
                          ("x2d", x2d, torch.float32, (x2d.shape[0], LANES))))
    if nv < 1 or P < 1 or stride not in (2, 4, SUB) or x2d.shape[0] < SUB:
        raise ValueError(f"{fn}: nv {nv} / P {P} / stride {stride} / "
                         f"{x2d.shape[0]} x rows not supported")
    return dev


def launch(entry: str, wins, vals, idx, x2d, stride: int,
           *ints: int) -> torch.Tensor:
    """Run C entry point ``entry`` (wins, vals, idx, x2d, out, nv, P,
    *ints, stream) on CUDA tensors checked by ``check_probe_args``."""
    nv, P = wins.shape[0], wins.shape[1] - 1
    for name, t in (("vals", vals), ("idx", idx), ("x2d", x2d)):
        if t.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} must be 16-byte aligned (the "
                             "kernel copies 16 bytes a thread)")
    out = torch.empty((nv * (SUB // stride), LANES), dtype=torch.float32,
                      device=x2d.device)
    rc = getattr(_build.library(), entry)(
        wins.data_ptr(), vals.data_ptr(), idx.data_ptr(), x2d.data_ptr(),
        out.data_ptr(), nv, P, *ints,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(rc, entry)
    return out


def kernel_info(entry: str, *ints: int) -> dict:
    """What the build gave the instance that C entry point ``entry``
    (``dasp_roundcost_probe_info`` with P, variant;
    ``dasp_stream_probe_info`` with P, variant, stride) would launch:
    registers and local (stack and spill) bytes a thread, shared bytes a
    block and co-resident blocks a SM.  Builds the library: needs the
    card."""
    out = (ctypes.c_int * len(INFO))()
    _build.check(getattr(_build.library(), entry)(*ints,
                                                 ctypes.addressof(out)),
                 entry)
    return dict(zip(INFO, out))
