"""Run one cell of the port's benchmark once, on the CUDA card(s) of this
machine, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (from ``torch.profiler`` and the benchmark's own
clocks).  The run fails, printing no result, without enough CUDA cards,
without the program (``dasp_tpu_torch``) beside this folder, or when a
module of JAX or of the JAX package is loaded once the window has closed.
The numbers compared with the plain reference, each beside its limit,
are the last lines of standard error and the result's last key.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # fixed cache directories inside the checkout, for any JIT a library
    # of the program may use; the program's kernels build into its own
    # dasp_tpu_torch/_build/
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[0] = ROOT
    import torch
    from benchmark.harness import cell
    from benchmark.harness.spec import Spec
    spec = Spec(ROOT)
    chips = spec.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import dasp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not here: {e}", file=sys.stderr)
        return 2
    out = cell.run(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T0)
    foreign = cell.foreign_modules(sys.modules)
    if foreign:
        print(f"benchmark: modules loaded that the port must not use: "
              f"{', '.join(foreign)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
