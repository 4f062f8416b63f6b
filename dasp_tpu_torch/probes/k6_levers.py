"""What the launch shape of K6 (``csrc/resident.cu``) is worth on the
card: one build of ``k6_levers.cu`` per shape, timed beside each other.

    python -m dasp_tpu_torch.probes.k6_levers [arm,...] [dtype,...]

``k6_levers.cu`` includes ``csrc/resident.cu`` whole and adds entry
points ``dasp_k6_lever_{f32,bf16,f64}``, which launch the kernel at the
shape its -D flags name: lane columns a thread, blocks a SM the compiler
must leave registers for, item stages in shared memory, and the values'
L2 evict-first policy.  ``VARIANTS`` lists the candidates as (columns,
blocks, stages, evict-first); the kernel's arithmetic is the same in
every one.

    python -m dasp_tpu_torch.probes.k6_levers [arm,...] [dtype,...] kv

The kv arm (``kv`` as the third argument) builds the file once for each
``K6_XI`` of ``KV_VARIANTS`` (1, 2, 4), whose entries
``dasp_k6_lever_{f32,bf16,f64}_kv8`` run an SpMM pass of 8 x tables at
each value type's shipped Shape: phase A folding one table at a time, or
two or four tables with their gathers in flight together.  Each is held
bit for bit to the shipped pass (``spmm_loop``), timed as a pass (graph
replays, two rounds) beside 8 K6 steps and cuSPARSE ``A @ X``, with its
phase clock and its build's registers and spills.  Its figures pick
``XI_F32`` and ``XI_F64`` in ``csrc/resident.cu`` (measured on the three
arms and uniform_medium).

For each suite matrix (cop20k_like, webbase_like, rmat_like, or the arms
given) and value type (f64, or the dtypes given) the shape arm holds the
shipped
instance (``resident_loop``) to ``resident_loop_plain`` and every
variant's y2 and out to the shipped instance's, bit for bit, at 1 and 3
steps; then times a chain of ``CHAIN`` steps (one launch) and one step
(``REPS`` launches a graph), graph replays, in two rounds (the variants
in order, then in reverse), reads the phase clock over one chain, and
prints a line per variant with its registers, local bytes, ptxas's stack
and spill bytes, shared bytes and blocks a SM.  Graphed cuSPARSE on the
same x is printed beside them (not for bf16, which it does not take).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..bench.__main__ import card_line
from ..bench.baselines import cusparse_matrix
from ..bench.suite import build_suite
from ..io.build import ensure_built
from ..ops import _build
from ..ops.cuda_backend import TorchSpMV
from ..ops.resident import INFO_FIELDS, STAMP_WORDS, STAMPS, \
    launch_entry, resident_loop, resident_loop_plain, spmm_loop, \
    spmm_loop_plain
from ..wplan import build_wplan
from ._common import graph_ms, require_cuda

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "k6_levers.cu")
# name -> (lane columns a thread, blocks a SM, item stages, evict-first)
VARIANTS = {
    "(0) 512 threads, 2 blocks/SM, 2 stages": (1, 2, 2, 0),
    "(a) 512 threads, 1 block/SM, 3 stages": (1, 1, 3, 0),
    "(a) 512 threads, 1 block/SM, 2 stages": (1, 1, 2, 0),
    "(b) 2 columns, 256 threads, 2 blocks/SM": (2, 2, 2, 0),
    "(b) 2 columns, 256 threads, 1 block/SM, 3 st": (2, 1, 3, 0),
    "(d) (0) + values evict-first": (1, 2, 2, 1),
    "(a)+(d) 1 block/SM, 3 stages, evict-first": (1, 1, 3, 1),
    "(b)+(d) 2 columns, evict-first": (2, 2, 2, 1),
}
ARMS = ("cop20k_like", "webbase_like", "rmat_like")
DTYPES = ("f32", "bf16", "f64")    # the instances, in dasp_k6_lever_info's
                                   # order
# the mangled name's start of each instance's kernel (ptxas -v)
KERNELS = {"f32": "resident_kernelIff", "bf16":
           "resident_kernelI13__nv_bfloat16f", "f64": "resident_kernelIdd"}
CHAIN = 100                     # steps of the chained launch
REPS = 20                       # single-step launches a graph
_FLAGS = ("K6_COLS", "K6_MINB", "K6_STAGES", "K6_EF")
# the kv arm: x tables of a pass, and the tables phase A gathers together
KV_LEVER = 8
KV_VARIANTS = {"one table at a time": 1, "two tables interleaved": 2,
               "four tables interleaved": 4}
# each value type's shipped Shape (csrc/resident.cu's ShapeF32, ShapeF64)
SHIPPED = {"f32": (1, 2, 2, 1), "bf16": (1, 2, 2, 1), "f64": (2, 2, 2, 1)}


def ptxas_figures(text: str, shape, dtype: str, kv: int = 1,
                  xi: int = 1) -> str:
    """ptxas -v's registers, stack frame and spill bytes of the ``dtype``
    kernel at ``shape`` without the phase clock (the Shape's template
    arguments, then ``false``, in its mangled name): resident_kernel, or
    at kv > 1 x tables spmm_kernel, xi of them gathered together."""
    name = KERNELS[dtype]
    if kv > 1:
        name = name.replace("resident_kernel", "spmm_kernel")
    want = re.compile(re.escape(name) + "NS_5ShapeILi{}ELi{}ELi{}"
                      "ELb{}EE+Lb0E".format(*shape)
                      + (f"Li{kv}ELi{xi}E" if kv > 1 else ""))
    fig, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        if cur and want.search(cur):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                fig["stack"], fig["spill st"], fig["spill ld"] = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                fig["registers"] = m.group(1)
    return ", ".join(f"{k} {v}" for k, v in fig.items()) or "not found"


def build_variants(out_dir: str, kv: bool = False) -> dict:
    """{variant: (loaded library, ptxas -v's output)}: one nvcc per
    variant of ``VARIANTS`` (of ``KV_VARIANTS`` with ``kv``), all started
    together.  Raises RuntimeError with nvcc's output on failure."""
    os.makedirs(out_dir, exist_ok=True)
    flags = ({name: [f"-DK6_XI={xi}"] for name, xi in KV_VARIANTS.items()}
             if kv else
             {name: [f"-D{f}={v}" for f, v in zip(_FLAGS, shape)]
              for name, shape in VARIANTS.items()})
    procs = {}
    for n, (name, defs) in enumerate(flags.items()):
        so = os.path.join(out_dir, f"k6_levers_{'kv' if kv else ''}{n}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas",
               "-v", "-I", _build.SRC_DIR, *defs, "-o", so, SOURCE]
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
            fn = getattr(lib, f"dasp_k6_lever_{d}" + (
                f"_kv{KV_LEVER}" if kv else ""))
            fn.argtypes = list(_build.SIGNATURES[f"dasp_resident_{d}"])
            fn.restype = ctypes.c_int
        fn = getattr(lib, "dasp_k6_lever_kv_info" if kv
                     else "dasp_k6_lever_info")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (lib, text)
    return libs


def info(lib, dtype: str, kv: bool = False) -> dict:
    out = (ctypes.c_int * len(INFO_FIELDS))()
    fn = "dasp_k6_lever_kv_info" if kv else "dasp_k6_lever_info"
    _build.check(getattr(lib, fn)(DTYPES.index(dtype),
                                  ctypes.addressof(out)), fn)
    return dict(zip(INFO_FIELDS, out))


def main(arms=ARMS, dtypes=("f64",), kv: bool = False) -> None:
    dev = require_cuda("k6_levers")
    card = card_line()
    print(card, flush=True)
    if ensure_built(cxx="g++") is None:
        raise RuntimeError("native host library build failed")
    libs = build_variants(os.path.join(_build.BUILD_DIR, "k6_levers"), kv)
    for arm, csr in build_suite(list(arms), seed=0):
        plan = build_wplan(csr)
        for d in dtypes:
            (kv_arm if kv else arm_levers)(arm, csr, plan, d, libs, dev,
                                           card)


def kv_arm(arm, csr, plan, dtype, libs, dev, card) -> None:
    """Every variant of ``KV_VARIANTS`` on one arm and value type: a pass
    of KV_LEVER tables held to the shipped pass bit for bit, then timed
    beside the shipped pass, KV_LEVER one-table steps and cuSPARSE, one
    line each."""
    op = TorchSpMV(plan, device=dev, dtype=dtype)
    meta, arrays = op._meta, op._arrays
    X = np.random.default_rng(5).standard_normal((op.n_cols, KV_LEVER))
    tabs = [op._prep_x(X[:, j]) for j in range(KV_LEVER)]
    x3d = torch.cat(tabs)
    scratch = {}
    y = spmm_loop(meta, arrays, x3d, KV_LEVER, scratch=scratch)
    if not torch.equal(y, spmm_loop_plain(meta, arrays, x3d, KV_LEVER)):
        raise AssertionError(f"shipped K6 pass {dtype} differs from its "
                             f"plain version ({arm})")
    entry = f"dasp_k6_lever_{dtype}_kv{KV_LEVER}"

    def run(lib, stamps=None):
        return launch_entry(getattr(lib, entry), entry, meta, arrays, x3d,
                            1, stamps, KV_LEVER)
    for name, (lib, _) in libs.items():
        if not all(torch.equal(a, b) for a, b in zip(
                run(lib), (scratch["y2"], scratch["out"]))):
            raise AssertionError(f"{name} differs from the shipped K6 pass "
                                 f"({arm} {dtype})")
    per_pass = lambda step: graph_ms(
        lambda: [step() for _ in range(REPS)], 5) / REPS * 1e3
    beside = {"shipped pass": per_pass(
        lambda: spmm_loop(meta, arrays, x3d, KV_LEVER)),
        f"{KV_LEVER} K6 steps": per_pass(
            lambda: [resident_loop(meta, arrays, x, 1) for x in tabs])}
    if dtype != "bf16":
        A, vdt = cusparse_matrix(csr, dtype, dev)
        Xd = torch.from_numpy(X).to(vdt).to(dev)
        beside["cuSPARSE A @ X"] = per_pass(lambda: A @ Xd)
    print(f"[levers] {arm} {dtype} kv {KV_LEVER}, us a pass: " + ", ".join(
        f"{k} {v:.2f} ({v / KV_LEVER:.2f} a column)"
        for k, v in beside.items()) + f" [{card}]", flush=True)
    us = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            us[name].append(per_pass(lambda lib=libs[name][0]: run(lib)))
    for name, (lib, text) in libs.items():
        stamps = torch.zeros(STAMP_WORDS, dtype=torch.int64, device=dev)
        run(lib, stamps)
        torch.cuda.synchronize()
        ph = dict(zip(STAMPS, stamps.tolist()))
        i = info(lib, dtype, kv=True)
        fig = ptxas_figures(text, SHIPPED[dtype], dtype, KV_LEVER,
                            KV_VARIANTS[name])
        print(f"[levers] {arm} {dtype} kv {KV_LEVER} {name:24s} "
              f"{us[name][0]:7.2f} / {us[name][1]:7.2f} us a pass (two "
              f"rounds), {us[name][0] / KV_LEVER:.2f} a column; phases "
              "A / R / C / D " + " / ".join(
                  f"{ph[k] / 1e3:.2f}" for k in ("A", "R", "C", "D"))
              + f" us, grid {ph['grid']}; " + ", ".join(
                  f"{k} {i[k]}" for k in INFO_FIELDS)
              + f"; ptxas: {fig} [{card}]", flush=True)


def arm_levers(arm, csr, plan, dtype, libs, dev, card) -> None:
    """Every variant of ``libs`` on one arm and value type: held to the
    shipped instance, timed, one line each."""
    op = TorchSpMV(plan, device=dev, dtype=dtype)
    meta, arrays = op._meta, op._arrays
    xh = np.random.default_rng(5).standard_normal(op.n_cols)
    x2d = op._prep_x(xh)
    want = {}
    for n in (1, 3):
        scratch = {}
        y = resident_loop(meta, arrays, x2d, n, scratch=scratch)
        if not torch.equal(y, resident_loop_plain(meta, arrays, x2d, n)):
            raise AssertionError(f"shipped K6 {dtype} differs from its "
                                 f"plain version ({arm}, {n} steps)")
        want[n] = (scratch["y2"], scratch["out"])
    entry = f"dasp_k6_lever_{dtype}"

    def run(lib, n, stamps=None):
        return launch_entry(getattr(lib, entry), entry, meta, arrays, x2d,
                            n, stamps)
    for name, (lib, _) in libs.items():
        for n in (1, 3):
            if not all(torch.equal(a, b)
                       for a, b in zip(run(lib, n), want[n])):
                raise AssertionError(f"{name} differs from the shipped K6 "
                                     f"({arm} {dtype}, {n} steps)")
    lib_us = "none (bf16)"
    if dtype != "bf16":
        A, vdt = cusparse_matrix(csr, dtype, dev)
        xv = torch.from_numpy(xh).to(vdt).to(dev)
        us = graph_ms(lambda: [A @ xv for _ in range(REPS)], 5) / REPS
        lib_us = f"{us * 1e3:.2f} us an SpMV"
    print(f"[levers] {arm} {dtype} streams {list(meta.streams)}, "
          f"{arrays['resident']['items'].shape[0]} items: graphed "
          f"cuSPARSE {lib_us} [{card}]", flush=True)
    chain = {name: [] for name in libs}
    one = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            lib = libs[name][0]
            chain[name].append(graph_ms(
                lambda: run(lib, CHAIN), 3) / CHAIN * 1e3)
            one[name].append(graph_ms(
                lambda: [run(lib, 1) for _ in range(REPS)], 5) / REPS * 1e3)
    for name, (lib, text) in libs.items():
        stamps = torch.zeros(STAMP_WORDS, dtype=torch.int64, device=dev)
        run(lib, CHAIN, stamps)
        torch.cuda.synchronize()
        ph = dict(zip(STAMPS, stamps.tolist()))
        i = info(lib, dtype)
        print(f"[levers] {arm} {dtype} {name:45s} chain {CHAIN} "
              f"{chain[name][0]:7.2f} / {chain[name][1]:7.2f} us a step, "
              f"one step {one[name][0]:7.2f} / {one[name][1]:7.2f} us (two "
              f"rounds); phases A / C / D+tap "
              + " / ".join(f"{ph[k] / CHAIN / 1e3:.2f}"
                           for k in ("A", "C", "D"))
              + f" us a step, grid {ph['grid']}; "
              + ", ".join(f"{k} {i[k]}" for k in INFO_FIELDS)
              + f"; ptxas: {ptxas_figures(text, VARIANTS[name], dtype)} "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    main(tuple(sys.argv[1].split(",")) if sys.argv[1:] else ARMS,
         tuple(sys.argv[2].split(",")) if sys.argv[2:] else ("f64",),
         sys.argv[3:] == ["kv"])
