"""On a CUDA card: one short run of a cell through ``run.py``, as the
benchmark's command runs it."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_run_py_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hpcg104_f64.spmm8", "--seed", str(2 ** 31 + 3), "--seconds",
         "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert r.stderr.strip().splitlines()[-1].startswith("check y_err:")
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert {"k6_roofline.spmm", "device_idle.spmm"} <= set(
            out["metrics"])
    else:
        assert {"spmm_gflops", "setup_s"} == set(out["metrics"])
