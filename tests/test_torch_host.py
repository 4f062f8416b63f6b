"""Host side of the PyTorch port (dasp_tpu_torch) against the JAX package:
the copied numpy-only modules, the packer, and the f32 lowering."""

import dataclasses
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dasp_tpu.utils
import dasp_tpu_torch.utils
from dasp_tpu.ops import pallas_backend as pb
from dasp_tpu.wplan import build_wplan as ref_build_wplan
from dasp_tpu_torch import sparse as tsp
from dasp_tpu_torch.ops import cuda_backend as cb
from dasp_tpu_torch.wplan import build_wplan

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# numpy-only modules the port carries as byte-for-byte copies: importing
# any dasp_tpu module runs dasp_tpu/__init__.py, which imports jax
COPIED = ["config.py", "sparse.py", "relabel.py", "wplan.py",
          "io/__init__.py", "io/mmio.py", "io/native.py",
          "bench/suite.py", "bench/fem.py"]
# the one edit a copy carries: bench/fem.py's docstring cites the upstream
# README by an absolute path of the machine it was written on; the copy
# cites it as "reference README.md"
COPY_EDITS = {"bench/fem.py": (rb"``/[\w/]+/README\.md",
                               b"``reference README.md")}


def _split_fixture(rng, n=26 * 64 * 128):
    """A mixed 256-row head over identity rows: the head's output blocks
    use 6 y2 sources and the rest 2, so the outgather range split
    (og_ranges) engages."""
    head = tsp.mixed_categories(256, rng)
    lens = np.concatenate([head.row_lengths, np.ones(n - 256, np.int64)])
    rpt = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=rpt[1:])
    cols = np.concatenate([head.col_idx, np.arange(256, n, dtype=np.int32)])
    vals = np.concatenate([head.values, rng.standard_normal(n - 256)])
    return tsp.CSRMatrix(n, n, rpt, cols, vals)


# the packer fixtures of tests/test_wplan.py:96-118
CASES = {
    "tiny": lambda rng: tsp.random_csr(10, 12, np.array(
        [0, 1, 2, 3, 4, 5, 9, 2, 0, 7]), rng),
    "fem": lambda rng: tsp.fem_like(400, 20, rng),
    "powerlaw": lambda rng: tsp.powerlaw_like(400, 1.8, 3000, rng),
    "circuit": lambda rng: tsp.circuit_like(6000, rng),
    "powerlaw_deg": lambda rng: tsp.powerlaw_like(20_000, 1.7, 20_000, rng,
                                                  col_alpha=1.6),
}
LOWER_CASES = dict(CASES, mixed=lambda rng: tsp.mixed_categories(500, rng),
                   og_split=_split_fixture)


def _assert_same(a, b, path):
    """Structural equality of two plans / table trees built by the two
    packages (class identity aside): arrays equal in dtype, shape, bytes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (
            path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _to_ref(csr):
    from dasp_tpu.sparse import CSRMatrix
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                     csr.values)


def _assert_same_meta(ours, ref, path="meta"):
    for f in cb.WMeta._fields:
        if f == "res":
            assert (ours.res is None) == (ref.res is None), path
            if ours.res is not None:
                _assert_same_meta(ours.res, ref.res, f"{path}.res")
        else:
            assert getattr(ours, f) == getattr(ref, f), (path, f)


@pytest.mark.parametrize("rel", COPIED)
def test_host_module_is_identical_copy(rel):
    with open(os.path.join(REPO, "dasp_tpu", rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "dasp_tpu_torch", rel), "rb") as f:
        ours = f.read()
    if rel in COPY_EDITS:
        ref, n = re.subn(*COPY_EDITS[rel], ref)
        assert n == 1, f"dasp_tpu/{rel}: the edited citation moved"
    assert ours == ref, f"dasp_tpu_torch/{rel} drifted from dasp_tpu/{rel}"


def test_gc_paused_is_identical_copy():
    assert (inspect.getsource(dasp_tpu_torch.utils.gc_paused)
            == inspect.getsource(dasp_tpu.utils.gc_paused))


@pytest.mark.parametrize("name", list(CASES))
def test_build_wplan_identical(name):
    csr = CASES[name](np.random.default_rng(0))
    _assert_same(build_wplan(csr), ref_build_wplan(_to_ref(csr)), "plan")


@pytest.mark.parametrize("name", list(LOWER_CASES))
def test_plan_to_arrays_matches_reference(name):
    csr = LOWER_CASES[name](np.random.default_rng(0))
    meta, arrays = cb.plan_to_arrays(build_wplan(csr), "f32")
    ref_meta, ref_arrays = pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)),
                                             "f32")
    _assert_same_meta(meta, ref_meta)
    _assert_same(arrays, ref_arrays, "arrays")
    if name == "og_split":
        assert len(meta.og_ranges) > 1, "fixture must split the outgather"


def test_plan_to_arrays_residue_subplan_matches_reference(monkeypatch):
    """The residue sub-plan recursion (RES_REPACK_MIN forced to 1, as in
    test_pallas_residue_subplan_matches_golden) lowers identically."""
    monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
    monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    rng = np.random.default_rng(0)
    n = 40_000
    csr = tsp.random_csr(n, n, rng.integers(1, 8, size=n), rng)
    meta, arrays = cb.plan_to_arrays(build_wplan(csr), "f32")
    ref_meta, ref_arrays = pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)),
                                             "f32")
    assert meta.res is not None, "sub-plan path not taken"
    _assert_same_meta(meta, ref_meta)
    _assert_same(arrays, ref_arrays, "arrays")


def test_arrays_from_reference_matches_own_lowering():
    csr = LOWER_CASES["mixed"](np.random.default_rng(0))
    meta, arrays = cb.plan_to_arrays(build_wplan(csr), "f32")
    ours = cb.arrays_to_device(meta, arrays, "cpu")
    ref_meta, ref_arrays = cb.arrays_from_reference(
        *pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)), "f32"), "cpu")
    assert ref_meta == meta
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} if isinstance(
        t, dict) else [to_np(v) for v in t] if isinstance(t, list) else (
        None if t is None else t.numpy())
    _assert_same(to_np(ref_arrays), to_np(ours), "device arrays")


def test_lowering_rejects_unported_dtypes():
    plan = build_wplan(CASES["tiny"](np.random.default_rng(0)))
    for dtype in ("bf16", "f64"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cb.plan_to_arrays(plan, dtype)


_NO_JAX = r"""
import sys
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "dasp_tpu")
for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
torch.set_num_threads(1)
import dasp_tpu_torch
from dasp_tpu_torch.sparse import mixed_categories
from dasp_tpu_torch.ops import colsum, outgather, cuda_backend  # noqa
from dasp_tpu_torch.bench import suite, fem  # noqa
rng = np.random.default_rng(0)
csr = mixed_categories(300, rng)
op = dasp_tpu_torch.SpMVOperator(csr, dtype="f32", device="cpu")
x = rng.standard_normal(csr.n_cols)
golden = csr.spmv(x)
err = np.abs(op(x) - golden) / np.maximum(np.abs(golden), 1.0)
assert err.max() <= 2e-5, err.max()
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("NO_JAX_OK", float(err.max()))
"""


def test_port_runs_without_jax():
    """The GPU machine has no JAX: the port imports, packs and runs with
    every import of jax, ml_dtypes and dasp_tpu refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout
