"""T1 on the H100: what a gather costs, against a plain stream.

    python -m dasp_tpu_torch.probes.gather_bench [all|copy|lane|sublane|xla_take] [rows]

Replaces ``tools/gather_bench.py`` (its kernel ``pallas_stream_op``,
:46-65, and ``main``, :68-96), which timed the TPU's in-kernel gathers.
Over a stream of R rows of 128 int32 idx and a (2048, 128) f32 table xw:
  copy      out[r, j] = float(idx[r, j] * 2)          (reads no table)
  lane      out[r, j] = xw[r mod 2048, idx[r, j]]     (from the stream's
                                                       table rows)
  sublane   out[r, j] = xw[idx[r, j], j]              (from a 16-column
                                                       slab of the table)
  xla_take  torch.take of the flat table, the library yardstick (:92-96)
Stream row r meets table row r mod 2048 in the lane gather because the
tool's table block index is constant (:58).  The kernels are
``csrc/gather_probe.cu``, which gathers both bodies from shared memory;
idx must lie in the table (not checked).

``gather_probe`` takes a CPU tensor to ``gather_probe_plain`` and a CUDA
tensor to the kernel; ``gather_probe.launches["f32"]`` counts the
kernel's launches.  ``sweep`` times each body as a CUDA-graph replay,
alone and as the tool's chained step (the body, then
``xw += out[0] * 1e-36``), with the tool's bytes, 2 * 4 B per element.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.cuda_backend import TAP
from ..wplan import LANES
from ._common import check_args, graph_ms, require_cuda

B = 2048                           # table rows, the tool's block (:46)
ROWS = 20480                       # stream rows (:70)
BODIES = ("copy", "lane", "sublane")
WHICH = BODIES + ("xla_take",)


def gather_probe_plain(idx: torch.Tensor, xw: torch.Tensor,
                       body: str) -> torch.Tensor:
    """(idx (R,128) i32, xw (2048,128) f32) -> out (R,128) f32 of the
    tool's ``body``."""
    if body == "copy":
        return (idx * 2).float()
    if body == "lane":
        r = torch.arange(idx.shape[0], device=idx.device) % B
        return xw[r.view(-1, 1), idx.long()]
    if body == "sublane":
        return xw[idx.long(), torch.arange(LANES, device=idx.device)]
    raise ValueError(f"gather_probe: body {body!r} not in {BODIES}")


def gather_probe(idx: torch.Tensor, xw: torch.Tensor,
                 body: str) -> torch.Tensor:
    """The T1 kernel on CUDA tensors, ``gather_probe_plain`` on CPU
    tensors."""
    if body not in BODIES:
        raise ValueError(f"gather_probe: body {body!r} not in {BODIES}")
    rows = idx.shape[0] if idx.dim() else 0
    dev = check_args("gather_probe", (("idx", idx, torch.int32, (rows, LANES)),
                                      ("xw", xw, torch.float32, (B, LANES))))
    if rows < 1 or rows % B:
        raise ValueError(f"gather_probe: {rows} rows, not a positive "
                         f"multiple of the {B}-row block")
    if dev.type == "cpu":
        return gather_probe_plain(idx, xw, body)
    if idx.data_ptr() % 16 or xw.data_ptr() % 16:
        raise ValueError("gather_probe: idx and xw must be 16-byte aligned "
                         "(the kernels move 16 bytes a thread)")
    out = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    rc = _build.library().dasp_gather_probe(
        idx.data_ptr(), xw.data_ptr(), out.data_ptr(), rows,
        BODIES.index(body), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dasp_gather_probe")
    gather_probe.launches["f32"] += 1
    return out


gather_probe.launches = {"f32": 0}


def kernel_info(body: str) -> dict:
    """What the build gave ``body``'s kernel: registers and local (stack
    and spill) bytes a thread, shared bytes a block, co-resident blocks a
    SM, and the table columns a sublane block holds (0 for the streams).
    Builds the library: needs the card."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().dasp_gather_probe_info(
        BODIES.index(body), ctypes.addressof(out)), "dasp_gather_probe_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "slab_columns"), out))


def xla_take(idx: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """The tool's "xla_take" (:92-96), ``take`` of the flat table, as the
    one PyTorch call ``torch.take`` (int64 idx): a yardstick, not a kernel
    of the port."""
    return torch.take(xw.reshape(-1), idx)


def make_inputs(rows: int = ROWS, device="cpu", seed: int = 0):
    """{"xw": table, body: idx for each of WHICH}: the tool's draws for
    ``main("all")`` (:69-94), same calls in the same order, on
    ``device``."""
    rng = np.random.default_rng(seed)
    got = {"xw": rng.standard_normal((B, LANES)).astype(np.float32)}
    for body, hi in (("copy", 128), ("lane", 128), ("sublane", B),
                     ("xla_take", B * LANES)):
        got[body] = rng.integers(0, hi, (rows, LANES)).astype(np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in got.items()}


def sweep(device, rows: int = ROWS, which: str = "all", iters: int = 20):
    """Per body (and xla_take): dict(body, rows, ms, chained_ms, bytes,
    move_bytes, flops, library_ms), ms per call alone and of the chained
    step, graph replays; move_bytes what one call must move (idx in, out
    back, and the whole table where the body reads it: every row of it is
    reached at these sizes), flops 0; library_ms is ``torch.gather`` for
    the sublane body (the one body a single PyTorch call computes), else
    None."""
    inp = make_inputs(rows, device)
    got = []
    for body in WHICH:
        if which not in ("all", body):
            continue
        xw = inp["xw"].clone()
        idx = inp[body]
        if body == "xla_take":
            idx = idx.long()

            def alone(idx=idx, xw=xw):
                return xla_take(idx, xw)
        else:
            def alone(idx=idx, xw=xw, body=body):
                return gather_probe(idx, xw, body)

        def chained(alone=alone, xw=xw):
            xw.add_(alone().view(-1)[0] * TAP)

        lib = None
        if body == "sublane":
            i64 = idx.long()
            lib = graph_ms(lambda: torch.gather(xw, 0, i64), iters)
        table = 0 if body == "copy" else xw.numel() * 4
        got.append(dict(body=body, rows=rows,
                        ms=graph_ms(alone, iters),
                        chained_ms=graph_ms(chained, iters),
                        bytes=2 * rows * LANES * 4,
                        move_bytes=(idx.numel() * idx.element_size()
                                    + rows * LANES * 4 + table),
                        flops=0, library_ms=lib))
    return got


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    rows = int(argv[1]) if len(argv) > 1 else ROWS
    if which not in ("all",) + WHICH:
        raise SystemExit(f"gather_bench: {which!r} not in all, "
                         f"{', '.join(WHICH)}")
    dev = require_cuda("gather_bench")
    print(f"{torch.cuda.get_device_name(dev)} rows={rows}", flush=True)
    m = rows * LANES
    for r in sweep(dev, rows, which):
        sec = r["ms"] / 1e3
        print(f"{r['body']:10s}: {r['ms']:8.4f} ms  {m / sec / 1e9:7.2f} "
              f"Gelem/s  ({r['bytes'] / sec / 1e9:6.1f} GB/s io), chained "
              f"{r['chained_ms']:8.4f} ms", flush=True)


if __name__ == "__main__":
    main()
