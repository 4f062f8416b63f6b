"""One run of one cell: set-up, the measured window, the traced readings,
the check against the plain reference, and the result line.

Set-up (``setup_s``, from the start of the process) is everything before
the window: importing, building the program's native packer and CUDA
kernels where a checkout has not built them yet, making the matrix and
the vectors from the seed, the pack (``build_wplan``, ``pack_s``), the
operator (lowering, upload and K6's schedule, ``operator_s``) and the
traffic's warm-up, less the seconds of the plain reference's products
that make CG's right-hand sides.  Nothing is cached between runs but the
program's own builds and a generated matrix pattern (``_pattern``).
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import subprocess
import time
import types

import numpy as np

from ..reference.csr import Csr
from . import drive, profile
from .spec import Spec

FOREIGN = ("jax", "jaxlib", "flax", "dasp_tpu")
ALONE_CALLS = 20


def seeds(seed: int):
    """(values' seed, vectors' generator) of a run's seed: any whole
    number, taken modulo 2**64."""
    s = seed % (1 << 64)
    return s, np.random.default_rng([s, 1])


def foreign_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FOREIGN, compared whole: ``dasp_tpu_torch`` is not ``dasp_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FOREIGN))


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _pattern(spec: Spec, config: dict, gen):
    """``gen.pattern(params)``, kept in ``benchmark/.cache/patterns/`` under
    a name made from the generator's source and the params, so that only
    a checkout's first run makes it."""
    with open(gen.__file__, "rb") as f:
        key = hashlib.sha256(f.read() + json.dumps(
            config["params"], sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(spec.dir, ".cache", "patterns",
                        f"{config['generator']}-{key}.npz")
    if not os.path.exists(path):
        n_rows, n_cols, row_ptr, col_idx = gen.pattern(config["params"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path[:-len(".npz")] + ".tmp.npz"
        np.savez(tmp, shape=np.array([n_rows, n_cols]), row_ptr=row_ptr,
                 col_idx=col_idx)
        os.replace(tmp, path)
    with np.load(path) as f:
        n_rows, n_cols = (int(v) for v in f["shape"])
        return n_rows, n_cols, f["row_ptr"], f["col_idx"]


def make_matrix(spec: Spec, config: dict, seed: int) -> Csr:
    """The configuration's matrix, its values as the program is given them
    (float32 for an f32 configuration).  A generator whose pattern is
    dear to make gives ``pattern`` and ``values`` apart, and the pattern
    is cached (``_pattern``)."""
    gen = spec.generator(config["generator"])
    if hasattr(gen, "pattern"):
        n_rows, n_cols, row_ptr, col_idx = _pattern(spec, config, gen)
        values = gen.values(len(col_idx), seed)
    else:
        n_rows, n_cols, row_ptr, col_idx, values = gen.generate(
            config["params"], seed)
    if config.get("nnz") not in (None, len(col_idx)):
        raise RuntimeError(f"{config['name']}: {len(col_idx)} nonzeros, "
                           f"not the configuration's {config['nnz']}")
    dt = np.float64 if config["dtype"] == "f64" else np.float32
    return Csr(n_rows, n_cols, row_ptr, col_idx, values.astype(dt))


def pack(a: Csr, config: dict):
    """(plan, seconds): the program's pack (``build_wplan``)."""
    import dasp_tpu_torch as dt
    csr = dt.CSRMatrix(a.n_rows, a.n_cols, a.row_ptr, a.col_idx, a.values)
    t = time.perf_counter()
    plan = dt.build_wplan(csr, dt.DaspConfig(**config["dasp_config"]))
    return plan, time.perf_counter() - t


def operator(plan, config: dict, traffic: dict, device):
    """(operator, seconds): the program's operator on ``device``, up to a
    synchronize."""
    import torch
    import dasp_tpu_torch as dt
    t = time.perf_counter()
    op = dt.SpMVOperator(plan, config["dtype"], device=device,
                         force_streamed=bool(traffic.get("force_streamed")))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return op, time.perf_counter() - t


def run(spec: Spec, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float = None) -> dict:
    """One run; returns the result (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` ``breakdown``, and ``checks``
    last: each number compared with its limit)."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    from dasp_tpu_torch.io.build import ensure_built
    cell = spec.cell(workload)
    dev = torch.device(device)
    ensure_built(cxx="g++")
    if dev.type == "cuda":
        from dasp_tpu_torch.ops import _build
        _build.library()
    vseed, rng = seeds(seed)
    a = make_matrix(spec, cell.config, vseed)
    plan, pack_s = pack(a, cell.config)
    op, operator_s = operator(plan, cell.config, cell.traffic, dev)
    del plan
    kind = spec.kind(cell.traffic["kind"])(op, a, cell.traffic, rng)
    if trace and dev.type == "cuda":
        profile.warm()
    setup_s = time.perf_counter() - t0 - kind.reference_s

    window_s, units, reading = drive.window(kind, seconds, trace, dev)
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    alone = None
    if trace and cuda:
        fn, count, kv = kind.alone()
        alone = {"device_s": profile.device_seconds(fn, ALONE_CALLS)
                 / (ALONE_CALLS * count), "kv": kv}
    kind.collect()
    rec = types.SimpleNamespace(
        workload=workload, config=cell.config, traffic=cell.traffic,
        dtype=cell.config["dtype"], n_rows=a.n_rows, n_cols=a.n_cols,
        nnz=a.nnz, setup_s=setup_s, pack_s=pack_s, operator_s=operator_s,
        window_s=window_s, units=units,
        spmvs=units * kind.spmvs_per_unit,
        columns=units * kind.columns_per_unit,
        request_s=kind.request_s, iters=kind.iters, failed=kind.failed,
        alone=alone, trace=reading)
    del op
    kind.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = kind.judge(a, cell.limits)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    out = {"correct": bool(correct), "attempted": units,
           "failed": int(kind.failed), "metrics": metrics}
    out["device"] = ({"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev),
                      "count": cell.chips, "memory_peak_bytes": int(peak)}
                     if cuda else {"platform": "cpu", "kind": "cpu",
                                   "count": 1, "memory_peak_bytes": 0})
    if trace and reading is not None:
        out["device"].update(busy_s=reading["busy_s"],
                             window_s=reading["window_s"],
                             power_limit=_power_limit())
        out["breakdown"] = {"device_ops": reading["device_ops"],
                            "idle_gaps": reading["idle_gaps"]}
    out["checks"] = {k: {"value": _number(v), "limit": float(lim)}
                     for k, (v, lim) in checks.items()}
    return out


def _number(v):
    """A float for JSON, which has no inf or nan: those as strings."""
    v = float(v)
    return v if np.isfinite(v) else str(v)
