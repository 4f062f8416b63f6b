"""The readings that the limits of ``limits/<workload>.json`` are set from.

For cells of one configuration, at their own size and load, in one
process that packs each seed's matrix once: the program's compared
numbers over many seeds (each a short window of the cell's own traffic,
judged as a run judges it), and the control's over a few: the plain
reference put in the program's place, computed one precision below the
configuration's (``reference/lower.py``), on the same inputs and judged
by the same comparison.  A limit lies above every reading of the program
and below every reading of the control.

    python3 benchmark/control.py --workload <name>[,<name>...] \
        --seeds 1-12 --control-seeds 1-3 --seconds 2

Prints one JSON line per reading: {"workload", "side": "program" |
"control", "seed", "checks": {name: value}}.  Needs the card as a run does; the
tests drive ``readings`` on the CPU at a small size.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(spec, workloads, seeds, control_seeds, seconds: float,
             device: str = "cuda"):
    """Yield (workload, side, seed, {check: value}) for the program on
    ``seeds`` and the control on ``control_seeds``, in each of
    ``workloads``, cells of one configuration."""
    import torch
    from benchmark.harness import cell, drive
    from benchmark.reference.lower import BELOW
    cells = [spec.cell(w) for w in workloads]
    kinds = {c.name: spec.kind(c.traffic["kind"]) for c in cells}
    config = cells[0].config
    assert all(c.config == config for c in cells), "one configuration"
    dev = torch.device(device)
    seeded = spec.generator(config["generator"]).VALUES_SEEDED
    built = {}

    def judged(c, kind, a):
        return {k: v for k, (v, _) in kind.judge(a, c.limits).items()}

    for seed in sorted(set(seeds) | set(control_seeds)):
        vseed, _ = cell.seeds(seed)
        key = vseed if seeded else None
        if key not in built:
            built.clear()
            a = cell.make_matrix(spec, config, vseed)
            built[key] = (a, cell.pack(a, config)[0])
        a, plan = built[key]
        for c in cells:
            op = cell.operator(plan, config, c.traffic, dev)[0]
            if seed in seeds:
                kind = kinds[c.name](op, a, c.traffic, cell.seeds(seed)[1])
                drive.window(kind, seconds, False, dev)
                kind.collect()
                yield c.name, "program", seed, judged(c, kind, a)
            if seed in control_seeds:
                kind = kinds[c.name](op, a, c.traffic, cell.seeds(seed)[1])
                kind.control(a, BELOW[config["dtype"]], dev)
                yield c.name, "control", seed, judged(c, kind, a)
            del op, kind


def main(argv) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True,
                    help="cells of one configuration, comma-separated")
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    import torch
    from benchmark.harness.spec import Spec
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for workload, side, seed, checks in readings(
            Spec(ROOT), args.workload.split(","), args.seeds,
            args.control_seeds, args.seconds):
        print(json.dumps({"workload": workload, "side": side, "seed": seed,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
