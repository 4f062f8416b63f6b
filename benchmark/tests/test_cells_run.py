"""Whole runs of throwaway cells on the CPU (the program's plain kernel
versions), the check that decides ``correct`` failing each fault planted
in the timed path, and the control failing every cell's limits."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.control import readings
from benchmark.harness import cell
from benchmark.harness.spec import Spec
from conftest import ROOT, TINY_CELLS, problems

import dasp_tpu_torch.examples.cg_solver as cg_solver
import dasp_tpu_torch.ops.cuda_backend as cuda_backend
import dasp_tpu_torch.ops.resident as resident

SECONDS = 0.3
SEED = 2 ** 31 + 12345


def _run(root, workload, trace=False, seed=SEED):
    return cell.run(Spec(root), workload, seed, SECONDS, trace, "cpu")


def test_throwaway_cells_are_files_and_entries_only(tiny_root):
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        assert problems(json.load(f), tiny_root) == []


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_a_throwaway_cell_runs_by_name(tiny_root, workload, trace):
    out = _run(tiny_root, workload, trace)
    c = Spec(tiny_root).cell(workload)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:     # no device trace on the CPU: those metrics stay out
        want = {m for m in want if not m.startswith(("k6_", "device_"))}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out, allow_nan=False)


def test_the_seed_makes_the_inputs(tiny_root):
    a = _run(tiny_root, "tiny_graph.chain_t", seed=7)["checks"]
    b = _run(tiny_root, "tiny_graph.chain_t", seed=7)["checks"]
    c = _run(tiny_root, "tiny_graph.chain_t", seed=8)["checks"]
    assert a == b and a != c


def _alter(fn, how):
    def wrapped(*args, **kwargs):
        return how(fn(*args, **kwargs))
    return wrapped


def _bump(y):
    y = y.clone()
    y.view(-1)[3] += 1.0
    return y


def _half(y):
    y = y.clone()
    y[:, y.shape[1] // 2:] = 0
    return y


FAULTS = {
    # an answer altered where it is produced
    "chain: y altered": ("tiny_graph.chain_t", resident, "resident_loop",
                         lambda f: _alter(f, _bump)),
    "streamed: y altered": ("tiny_graph.streamed_t", cuda_backend,
                            "spmv_fn", lambda f: _alter(f, _bump)),
    "spmm: y altered": ("tiny_hpcg.spmm8_t", resident, "spmm_loop",
                        lambda f: _alter(f, _bump)),
    # half of the batch (of the pass's columns) left out
    "spmm: half the columns": ("tiny_hpcg.spmm8_t", resident, "spmm_loop",
                               lambda f: _alter(f, _half)),
    # a step that returns its state unchanged
    "cg: step unchanged": ("tiny_hpcg.cg_t", cg_solver.CGIteration,
                           "raw_step", lambda f: (lambda self: None)),
    "cg: x altered": ("tiny_hpcg.cg_t", cg_solver, "_to_host",
                      lambda f: _alter(f, lambda x: x + 1e-3)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(tiny_root, fault,
                                                  monkeypatch):
    workload, owner, attr, make = FAULTS[fault]
    assert _run(tiny_root, workload)["correct"]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = _run(tiny_root, workload)
    assert not out["correct"]


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_the_control_fails_and_the_program_passes(tiny_root, workload):
    spec = Spec(tiny_root)
    limits = spec.cell(workload).limits
    got = list(readings(spec, [workload], [1, 2], [1, 2], SECONDS, "cpu"))
    assert len(got) == 4
    for _, side, seed, checks in got:
        over = [k for k, v in checks.items() if not v <= limits[k]]
        assert bool(over) == (side == "control"), (side, seed, checks)


def test_nothing_of_jax_or_the_jax_package_is_loaded(tiny_root):
    """In a fresh interpreter: the reference and the generators load
    neither the program nor JAX; a whole run loads no JAX package."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
from benchmark.harness.spec import Spec
import benchmark.reference.csr, benchmark.reference.lower
spec = Spec({tiny_root!r})
for g in ("hpcg27", "kronecker"):
    spec.generator(g)
top = {{m.split(".")[0] for m in sys.modules}}
assert not top & {{"dasp_tpu_torch", "dasp_tpu", "jax", "jaxlib"}}, top
from benchmark.harness import cell
cell.run(spec, "tiny_hpcg.cg_t", 1, 0.2, False, "cpu")
print(cell.foreign_modules(sys.modules))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_foreign_modules_compare_whole_top_level_names():
    assert cell.foreign_modules(["dasp_tpu_torch", "dasp_tpu_torch.ops",
                                 "jaxtyping", "numpy"]) == []
    assert cell.foreign_modules(["dasp_tpu.spmv", "jax._src", "flax"]) \
        == ["dasp_tpu", "flax", "jax"]


def test_run_py_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                     "run.py"),
                        "--workload", "graph500s20_f32.chain", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_reservoir_keeps_the_seeded_sample(tiny_root):
    out = _run(tiny_root, "tiny_hpcg.cg_t")
    assert out["checks"]["residual"]["value"] < 1e-8 * 1.5
    assert np.isfinite(out["checks"]["residual"]["value"])


def test_setup_leaves_out_the_references_products(tiny_root, monkeypatch):
    """CG's right-hand sides come from the reference's product; its
    seconds are not the program's set-up."""
    from benchmark.harness import drive
    base = _run(tiny_root, "tiny_hpcg.cg_t")["metrics"]["setup_s"]["value"]

    def slow(*args):
        time.sleep(1.0)
        return product(*args)
    product = drive.product
    monkeypatch.setattr(drive, "product", slow)
    out = _run(tiny_root, "tiny_hpcg.cg_t")
    assert out["correct"]
    assert out["metrics"]["setup_s"]["value"] < base + 1.0
