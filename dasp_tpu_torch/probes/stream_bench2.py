"""T3 on the H100: which feature of the colsum costs it its rate.

    python -m dasp_tpu_torch.probes.stream_bench2 [NV] [iters]

Replaces ``tools/stream_bench2.py`` (its kernel ``make``, :39-101, and its
ladder, :104-144), which added K1's features one at a time to a bare
stream on the TPU.  The ladder (``LADDER``, the tool's ``run`` calls in
its order), with lam, q read at the cell (i, lam) of the tile:
  A static-win    x[q, lam], window 0 (reads no wins)
  B dyn-win       x[wins[v, 1] + q, lam]
  C stride2       B with stride 2: 4 level sums per vreg
  D P4            x[wins[v, 1 + tag] + q, lam], the tag read at the slot,
                  4 rounds
  E P4 same-win   D with every window 0
  F P2            D with 2 rounds
The kernel (``csrc/colsum_probe.cu``, ``dasp_stream_probe``) reads the tag
and gathers once per slot; ``stream_probe(..., variant, stride)`` takes
the tool's ``make`` arguments ("A" or "B", P from wins, stride).

``stream_probe`` takes a CPU tensor to ``stream_probe_plain`` and a CUDA
tensor to the kernel; ``stream_probe.launches["f32"]`` counts the
kernel's launches.  ``sweep`` times each step as a CUDA-graph replay,
alone and as the tool's chained step (the kernel, then
``x2d += out[0, 0] * 1e-36``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.cuda_backend import TAP
from ..wplan import SUB, LANES
from ._colsum_probe import (check_probe_args, colsum_probe_plain,
                            kernel_info as _kernel_info, launch, must_move,
                            stream_bytes)
from ._common import graph_ms, require_cuda

NV = 4096                          # vregs (:29)
S = 1536                           # x table rows (:31)
# (tag, make variant, P, stride, same_win), as the tool's run calls
# (:139-144) in their order
LADDER = (("A static-win", "A", 1, SUB, False),
          ("B dyn-win", "B", 1, SUB, False),
          ("C stride2", "B", 1, 2, False),
          ("D P4", "B", 4, SUB, False),
          ("E P4 same-win", "B", 4, SUB, True),
          ("F P2", "B", 2, SUB, False))
MAKE_VARIANTS = ("A", "B")


def _form(variant: str, P: int) -> str:
    if variant not in MAKE_VARIANTS:
        raise ValueError(f"stream_probe: variant {variant!r} not in "
                         f"{MAKE_VARIANTS}")
    return "cur" if P > 1 else "static" if variant == "A" else "one"


def stream_probe_plain(wins: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor, x2d: torch.Tensor, variant: str,
                       stride: int = SUB) -> torch.Tensor:
    """(wins (NV,P+1) i32, vals (NV*8,128) f32, idx (NV*8,128) i16, x2d
    (S,128) f32) -> out (NV*8/stride, 128) f32 of the tool's
    ``make(variant, P, stride)`` with P = wins.shape[1] - 1."""
    return colsum_probe_plain(wins, vals, idx, x2d,
                              _form(variant, wins.shape[1] - 1), stride)


def stream_probe(wins: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                 x2d: torch.Tensor, variant: str,
                 stride: int = SUB) -> torch.Tensor:
    """The T3 kernel on CUDA tensors, ``stream_probe_plain`` on CPU
    tensors."""
    _form(variant, wins.shape[1] - 1)
    dev = check_probe_args("stream_probe", wins, vals, idx, x2d, stride)
    if dev.type == "cpu":
        return stream_probe_plain(wins, vals, idx, x2d, variant, stride)
    out = launch("dasp_stream_probe", wins, vals, idx, x2d, stride,
                 MAKE_VARIANTS.index(variant), stride)
    stream_probe.launches["f32"] += 1
    return out


stream_probe.launches = {"f32": 0}


def kernel_info(P: int, variant: str, stride: int = SUB) -> dict:
    """What the build gave the instance that ``stream_probe`` launches at
    these arguments (``_colsum_probe.kernel_info``).  Needs the card."""
    _form(variant, P)
    return _kernel_info("dasp_stream_probe_info", P,
                        MAKE_VARIANTS.index(variant), stride)


def make_inputs(nv: int = NV, device="cpu", seed: int = 0):
    """(vals, x2d, {step letter: (wins, idx)}): the tool's module-level
    draws (:33-36) and each ``run``'s (:105-115), from one generator in
    the ladder's order, on ``device``."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((nv * SUB, LANES)).astype(np.float32)
    idxh = rng.integers(0, 1 << 10, (nv * SUB, LANES)).astype(np.int32)
    x2d = rng.standard_normal((S, LANES)).astype(np.float32)
    steps = {}
    for tag, _, P, _, same_win in LADDER:
        ix = idxh.copy()
        if P > 1:
            ix |= rng.integers(0, P, (nv * SUB, LANES)).astype(np.int32) << 10
        wins = np.zeros((nv, P + 1), dtype=np.int32)
        wins[:, 0] = P
        for p in range(P):
            if same_win:
                wins[:, 1 + p] = 0
            else:
                wins[:, 1 + p] = rng.integers(0, (S - SUB) // SUB, nv) * SUB
        steps[tag[0]] = (torch.from_numpy(wins).to(device),
                         torch.from_numpy(ix.astype(np.int16)).to(device))
    return (torch.from_numpy(vals).to(device),
            torch.from_numpy(x2d).to(device), steps)


def sweep(device, nv: int = NV, iters: int = 20):
    """Per ladder step: dict(step, tag, nv, stride, ms, chained_ms, bytes,
    move_bytes, flops), ms per call of the kernel alone and of the chained
    step, graph replays; move_bytes and flops what one call must move and
    do."""
    vals, x2d, steps = make_inputs(nv, device)
    rows = []
    for tag, variant, P, stride, _ in LADDER:
        wins, idx = steps[tag[0]]
        x = x2d.clone()

        def alone(wins=wins, idx=idx, x=x, variant=variant, stride=stride):
            return stream_probe(wins, vals, idx, x, variant, stride)

        def chained(alone=alone, x=x):
            x.add_(alone()[0, 0] * TAP)

        rows.append(dict(step=tag[0], tag=tag, nv=nv, stride=stride,
                         ms=graph_ms(alone, iters),
                         chained_ms=graph_ms(chained, iters),
                         bytes=stream_bytes(nv, stride),
                         move_bytes=must_move(wins, vals, idx,
                                              _form(variant, P), stride),
                         flops=2 * vals.numel()))
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    nv = int(argv[0]) if len(argv) > 0 else NV
    iters = int(argv[1]) if len(argv) > 1 else 20
    dev = require_cuda("stream_bench2")
    print(f"{torch.cuda.get_device_name(dev)} NV={nv} replays={iters}",
          flush=True)
    for r in sweep(dev, nv, iters=iters):
        print(f"{r['tag']:14s}: {r['ms'] * 1e3:7.1f} us  "
              f"{r['bytes'] / (r['ms'] * 1e6):6.1f} GB/s  (chained "
              f"{r['chained_ms'] * 1e3:7.1f} us)", flush=True)


if __name__ == "__main__":
    main()
