"""T4 on the H100: does a chained loop re-read a stream that fits the 50 MB
L2 from L2?

    python -m dasp_tpu_torch.probes.resident_probe

Replaces ``tools/resident_probe.py`` (its kernel ``make``, :27-62, and
``bench``, :65-88), which asked the same of the TPU's VMEM.  The kernel
(``csrc/resident_probe.cu``) sweeps a stream of ``nv`` vregs (f32 values
and int16 idx, 6 B per slot) ``iters`` times in one cooperative launch,
with a grid-wide barrier between sweeps, as K6 runs its steps.  ``sweep``
times it at stream sizes of about 6 to 192 MB and takes µs per sweep from
the difference of two chain lengths, as ``bench`` does: a rate per sweep
above the copy rate below 50 MB, and at it above, says the L2 keeps the
stream between sweeps.

``resident_probe`` takes a CPU tensor to ``resident_probe_plain`` and a
CUDA tensor to the kernel; ``resident_probe.launches["f32"]`` counts the
kernel's launches.
"""

from __future__ import annotations

import statistics

import torch

from ..wplan import SUB, LANES
from ..ops import _build
from ._common import check_args, require_cuda

X_ROWS = 64                        # rows of the fixed x table (:54)
SIZES_MB = (6, 12, 24, 48, 96, 192)
CHAINS = (10, 50)                  # sweeps per launch, differenced
SLOT_BYTES = 6                     # f32 value + int16 idx


def resident_probe_plain(vals: torch.Tensor, idx: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """(vals (nv*8,128) f32, idx (nv*8,128) i16, x (64,128) f32) -> out
    (nv,128): slot (i, j) gathers x[q, lam], lam = idx & 127 and
    q = (cell >> 7) & 7 at the cell (i, lam); sublanes summed in order."""
    nv = vals.shape[0] // SUB
    tile = idx.view(nv, SUB, LANES).long()
    lam = tile & 127
    q = (torch.gather(tile, 2, lam) >> 7) & 7
    prod = vals.view(nv, SUB, LANES) * x.reshape(-1)[q * LANES + lam]
    acc = prod[:, 0]
    for i in range(1, SUB):
        acc = acc + prod[:, i]
    return acc


def resident_probe(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
                   iters: int = 1) -> torch.Tensor:
    """The probe kernel on CUDA tensors (``iters`` sweeps, one launch),
    ``resident_probe_plain`` on CPU tensors (every sweep gives the same
    out)."""
    nv = vals.shape[0] // SUB
    dev = check_args("resident_probe", (
        ("vals", vals, torch.float32, (nv * SUB, LANES)),
        ("idx", idx, torch.int16, (nv * SUB, LANES)),
        ("x", x, torch.float32, (X_ROWS, LANES))))
    if nv < 1 or not isinstance(iters, int) or iters < 1:
        raise ValueError(f"resident_probe: nv {nv} / iters {iters!r}")
    if dev.type == "cpu":
        return resident_probe_plain(vals, idx, x)
    out = torch.empty((nv, LANES), dtype=torch.float32, device=dev)
    rc = _build.library().dasp_resident_probe(
        vals.data_ptr(), idx.data_ptr(), x.data_ptr(), out.data_ptr(), nv,
        iters, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dasp_resident_probe")
    resident_probe.launches["f32"] += 1
    return out


resident_probe.launches = {"f32": 0}


def make_inputs(nv: int, device, seed: int = 0):
    """The probe's stream (as tools/resident_probe.py:66-71): standard
    normal values, idx uniform in [0, 1024), a standard normal x."""
    g = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((nv * SUB, LANES), generator=g, device=device)
    idx = torch.randint(0, 1024, (nv * SUB, LANES), generator=g,
                        device=device, dtype=torch.int16)
    x = torch.randn((X_ROWS, LANES), generator=g, device=device)
    return vals, idx, x


def _launch_ms(fn, trials: int) -> float:
    """Median device time of one call of ``fn`` (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        got.append(a.elapsed_time(b))
    return statistics.median(got)


def sweep(device, sizes_mb=SIZES_MB, chains=CHAINS, trials: int = 5,
          seed: int = 0):
    """Per stream size: dict(mb, nv, us_per_sweep, gbs), µs per sweep
    from the difference of the two chain lengths' launch times."""
    rows = []
    for mb in sizes_mb:
        nv = max(1, round(mb * 1e6 / (SUB * LANES * SLOT_BYTES)))
        vals, idx, x = make_inputs(nv, device, seed)
        ms = [_launch_ms(lambda n=n: resident_probe(vals, idx, x, n), trials)
              for n in chains]
        us = (ms[1] - ms[0]) * 1e3 / (chains[1] - chains[0])
        nbytes = nv * SUB * LANES * SLOT_BYTES
        rows.append(dict(mb=nbytes / 1e6, nv=nv, us_per_sweep=us,
                         gbs=nbytes / (us * 1e3)))
        del vals, idx, x
    return rows


def main():
    dev = require_cuda("resident_probe")
    print(torch.cuda.get_device_name(dev), flush=True)
    for r in sweep(dev):
        print(f"nv={r['nv']:6d} ({r['mb']:6.1f} MB): "
              f"{r['us_per_sweep']:8.2f} us/sweep "
              f"{r['gbs']:7.1f} GB/s", flush=True)


if __name__ == "__main__":
    main()
