"""What each design decision of K5 (``csrc/colsum_multi.cu``) is worth on
the card: one build of ``k5_levers.cu`` per variant, timed beside each
other.

    python -m dasp_tpu_torch.probes.k5_levers [kv,...]   # default 4,8

``k5_levers.cu`` is K5 with its decisions as compile-time switches, every
default the shipped design's: the x tables stacked or interleaved by
vector, the next vreg's idx tile and wins row staged with ``cp.async`` or
not, the values staged too or loaded straight from device memory, 1, 2, 4
or 8 vregs a block, a strided or contiguous share of the vregs per block,
the words of gathers in flight, and the cache policy of the x gathers and
of the value loads.  ``VARIANTS`` turns one decision at a time (and, last,
all of this kernel's first draft at once).

For each suite matrix (cop20k_like, webbase_like), dtype and kv (4 and 8,
or the kv given; kv = 1 is the K1/K3 instance) it
holds every variant's output equal, bit for bit, to ``colsum_multi``'s
(the shipped kernel, which ``chip_smoke.py`` holds against its plain
version), then times one pass over every stream of the plan, 20 launches
captured in one CUDA graph, in two rounds (the variants in order, then in
reverse), and prints one line per variant with its registers and blocks a
SM.  K1/K3 on the same streams is printed beside them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..bench.suite import build_suite
from ..ops import _build
from ..ops.colsum import colsum
from ..ops.colsum_multi import colsum_multi
from ..ops.cuda_backend import TorchSpMV
from ..wplan import SUB, LANES, build_wplan
from ._common import graph_ms, require_cuda

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "k5_levers.cu")
VARIANTS = {
    "shipped": (),
    "x interleaved": ("-DK5_STACKED=0",),
    "unstaged": ("-DK5_STAGED=0",),
    "values staged too": ("-DK5_STAGE_VALS=1",),
    "2 vregs a block": ("-DK5_VPB=2", "-DK5_MINB=4"),
    "4 vregs a block": ("-DK5_VPB=4", "-DK5_MINB=2"),
    "8 vregs a block": ("-DK5_VPB=8", "-DK5_MINB=1"),
    "contiguous share": ("-DK5_CONTIG=1",),
    "16 words in flight": ("-DK5_FLIGHT=16",),
    "values ld.cs": ("-DK5_VLOAD=1",),
    "x gathers ld.cg": ("-DK5_XLOAD=2",),
    "first draft": ("-DK5_STACKED=0", "-DK5_STAGE_VALS=1", "-DK5_VPB=4",
                    "-DK5_MINB=2"),
}
ARMS = ("cop20k_like", "webbase_like")
DTYPES = ("f32", "f64", "bf16")
KVS = (4, 8)
REPS = 20                       # launches per graph
_P, _I = ctypes.c_void_p, ctypes.c_int
# wins, vals, idx, x, out, nv, P, stride, kv, stream, words per x table
_SIG = [_P] * 5 + [_I] * 4 + [_P, ctypes.c_longlong]


def build_variants(out_dir: str) -> dict:
    """{variant: loaded library}: one nvcc per variant, all started
    together.  Raises RuntimeError with nvcc's output on failure."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for n, (name, flags) in enumerate(VARIANTS.items()):
        so = os.path.join(out_dir, f"k5_levers_{n}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               _build.SRC_DIR, *flags, "-o", so, SOURCE]
        procs[name] = (so, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, cmd, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{text}")
        lib = ctypes.CDLL(so)
        for d in DTYPES:
            fn = getattr(lib, f"dasp_colsum_multi_{d}")
            fn.argtypes, fn.restype = _SIG, _I
        lib.dasp_colsum_multi_info.argtypes = [_I, _I, _I, _P]
        libs[name] = lib
    return libs


def run_variant(lib, dtype: str, st: dict, x: torch.Tensor, stride: int,
                kv: int) -> torch.Tensor:
    """One launch of a variant on a stream's tables; x holds the kv tables
    in the variant's layout."""
    nv, P = st["wins"].shape[0], st["wins"].shape[1] - 1
    out = torch.empty((kv, nv * (SUB // stride), LANES), dtype=x.dtype,
                      device=x.device)
    rc = getattr(lib, f"dasp_colsum_multi_{dtype}")(
        st["wins"].data_ptr(), st["vals"].data_ptr(), st["idx"].data_ptr(),
        x.data_ptr(), out.data_ptr(), nv, P, stride, kv,
        torch.cuda.current_stream().cuda_stream, x.numel() // kv)
    _build.check(rc, f"k5_levers {dtype}")
    return out


def main(kvs=KVS) -> None:
    dev = require_cuda("k5_levers")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build_variants(os.path.join(_build.BUILD_DIR, "k5_levers"))
    for arm, csr in build_suite(list(ARMS), seed=0):
        plan = build_wplan(csr)
        for d in DTYPES:
            op = TorchSpMV(plan, device=dev, dtype=d, force_streamed=True)
            streams = list(zip(op._arrays["streams"],
                               (s for _, s, _ in op._meta.streams)))
            rng = np.random.default_rng(5)
            tabs = [op._prep_x(rng.standard_normal(op.n_cols))
                    for _ in range(max(kvs))]
            k1 = graph_ms(lambda: [
                [colsum(st["wins"], st["vals"], st["idx"], tabs[0], s)
                 for st, s in streams] for _ in range(REPS)]) / REPS * 1e3
            print(f"[levers] {arm} {d} streams {list(op._meta.streams)}: "
                  f"K1/K3 {k1:.1f} us [{card}]", flush=True)
            for kv in kvs:
                stacked = torch.cat(tabs[:kv])
                layouts = {True: stacked, False: torch.stack(
                    tabs[:kv], -1).contiguous()}
                want = [colsum_multi(st["wins"], st["vals"], st["idx"],
                                     stacked, s, kv) for st, s in streams]
                us = {name: [] for name in libs}
                for order in (list(libs), list(libs)[::-1]):
                    for name in order:
                        x = layouts["-DK5_STACKED=0" not in VARIANTS[name]]

                        def one_pass(lib=libs[name], x=x):
                            return [run_variant(lib, d, st, x, s, kv)
                                    for st, s in streams]
                        if not all(torch.equal(a, b)
                                   for a, b in zip(one_pass(), want)):
                            raise AssertionError(
                                f"{name} differs from K5 ({arm} {d} kv {kv})")
                        us[name].append(graph_ms(
                            lambda: [one_pass() for _ in range(REPS)])
                            / REPS * 1e3)
                for name, lib in libs.items():
                    info = (ctypes.c_int * 4)()
                    lib.dasp_colsum_multi_info(
                        ("f32", "bf16", "f64").index(d), streams[-1][1], kv,
                        ctypes.addressof(info))
                    print(f"[levers] {arm} {d} kv={kv} {name:20s} "
                          f"{us[name][0]:6.1f} / {us[name][1]:6.1f} us a "
                          f"pass (two rounds); last stream's instance: "
                          f"{info[0]} registers, {info[1]} B local, "
                          f"{info[2]} B shared, {info[3]} blocks a SM "
                          f"[{card}]", flush=True)


if __name__ == "__main__":
    main(tuple(int(k) for k in sys.argv[1].split(",")) if sys.argv[1:]
         else KVS)
