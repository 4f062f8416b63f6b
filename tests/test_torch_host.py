"""Host side of the PyTorch port (dasp_tpu_torch) against the JAX package:
the copied numpy-only modules, the packer, and the f32 lowering."""

import dataclasses
import inspect
import os
import re
import shutil
import subprocess
import sys
import time

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
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# numpy-only modules the port carries as byte-for-byte copies: importing
# any dasp_tpu module runs dasp_tpu/__init__.py, which imports jax
COPIED = ["config.py", "sparse.py", "relabel.py", "wplan.py", "plan.py",
          "io/__init__.py", "io/mmio.py", "io/native.py",
          "bench/suite.py", "bench/fem.py", "bench/record.py",
          "analyze.py"]
# the edits a copy carries, each (pattern, replacement, times it applies):
# bench/fem.py's docstring cites the upstream README by an absolute path of
# the machine it was written on (the copy cites it as "reference
# README.md"); wplan.py's long-row packer tested `_nat is not None`, but
# _native_router() returns False, not None, without native/libdasp_host.so,
# so the no-library fallback crashed on long rows (the copy tests `_nat`;
# see test_no_native_router_packs_long_rows); wplan.py's pack phases are
# spans of dasp_tpu_torch.trace (`pack` around build_wplan, `pack.order`,
# `pack.rows`, `pack.tables` and `pack.check` where the reference's
# printed marks `sell`, `assembly` and `plan_ctor` sit), and its other 18
# marks and their printer are gone; io/native.py's _find_lib ran
# a bare `make`, which writes the library in place, so a process loading
# it during another's build read a short file (the copy builds through
# io/build.ensure_built, under a lock, to a name of its own, renamed
# whole; see test_concurrent_builds_never_expose_a_short_library)
COPY_EDITS = {"bench/fem.py": [(rb"``/[\w/]+/README\.md",
                                b"``reference README.md", 1)],
              "wplan.py": [
                  (rb"if _nat is not None and scalar_owners",
                   b"if _nat and scalar_owners", 1),
                  (rb"\nfrom \.utils import gc_paused\n",
                   b"\nfrom .trace import phase, span\n"
                   b"from .utils import gc_paused\n", 1),
                  (rb"@gc_paused\ndef build_wplan\(",
                   b"@gc_paused\n@span(\"pack\")\ndef build_wplan(", 1),
                  (rb"    csr\.check\(\)\n    import os as _os, time as _time\n",
                   b"    phase(\"pack.order\")\n    csr.check()\n"
                   b"    import time as _time\n", 1),
                  (rb"    _t = \[_time\.perf_counter\(\)\]\n\n"
                   rb"    def _pt\(tag\):\n(?:        .*\n)+", b"", 1),
                  (rb"_pt\('sell'\)", b"phase(\"pack.rows\")", 1),
                  (rb"_pt\('assembly'\)", b"phase(\"pack.tables\")", 1),
                  (rb"_pt\('plan_ctor'\)", b"phase(\"pack.check\")", 1),
                  (rb"\n *_pt\('\w+'\)(?=\n)", b"", 18)],
              "io/native.py": [(
                  rb"(?s)(new native entry points\.)\n    if os\.path\.exists"
                  rb"\(os\.path\.join\(srcdir, \"Makefile\"\)\):\n.*?"
                  rb"\n    return None\n",
                  rb"\1  The\n    # build runs under a lock and lands whole "
                  rb"(build.ensure_built).\n    from .build import "
                  rb"ensure_built\n    return ensure_built(srcdir=srcdir)\n",
                  1)]}


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
    for pattern, repl, times in COPY_EDITS.get(rel, ()):
        ref, n = re.subn(pattern, repl, ref)
        assert n == times, f"dasp_tpu/{rel}: an edited passage moved"
    assert ours == ref, f"dasp_tpu_torch/{rel} drifted from dasp_tpu/{rel}"



def test_native_library_loaded():
    """Both packages' loaders find the library this module's import built:
    a lost build race shows here, once, and not as the long-row packs of
    every later test falling back to numpy."""
    from dasp_tpu.io import native as ref_native
    from dasp_tpu_torch.io import native
    assert native._load() is not None
    assert ref_native._load() is not None


_BUILD_AND_LOAD = r"""
import ctypes, sys
from dasp_tpu_torch.io.build import ensure_built
path = ensure_built(srcdir=sys.argv[1])
assert path is not None, "the build failed"
lib = ctypes.CDLL(path)
assert lib.dasp_read_mtx and lib.dasp_route_vregs
print("LOADED", path)
"""


def test_concurrent_builds_never_expose_a_short_library(tmp_path):
    """Build processes started together and during the build, against a
    copy of native/ with no library: each loads a whole library, the
    library's path never holds a file of another size than the finished
    one, and no temporary file is left behind."""
    src = tmp_path / "native"
    src.mkdir()
    for f in os.listdir(os.path.join(REPO, "native")):
        if f.endswith(".cpp") or f == "Makefile":
            shutil.copy(os.path.join(REPO, "native", f), src / f)
    lib = src / "libdasp_host.so"
    env = dict(os.environ, PYTHONPATH=REPO)

    def start():
        return subprocess.Popen(
            [sys.executable, "-c", _BUILD_AND_LOAD, str(src)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    procs = [start() for _ in range(4)]
    sizes = set()
    t0 = time.monotonic()
    late = False
    while any(p.poll() is None for p in procs):
        if os.path.exists(lib):
            sizes.add(os.path.getsize(lib))
        if not late and time.monotonic() - t0 > 2.0:
            procs += [start() for _ in range(2)]
            late = True
        assert time.monotonic() - t0 < 240, "the build processes hung"
        time.sleep(0.002)
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "LOADED" in out, out + err
    assert sizes <= {os.path.getsize(lib)}, sizes
    assert not [f for f in os.listdir(src) if f.endswith(".tmp")]

def test_categorize_matches_reference():
    """The row census (analyze.py, exported as in the JAX package) on the
    fixture every row family passes through."""
    import dasp_tpu
    import dasp_tpu_torch
    csr = tsp.mixed_categories(500, np.random.default_rng(0))
    ours = dasp_tpu_torch.categorize(csr)
    ref = dasp_tpu.categorize(_to_ref(csr))
    assert isinstance(ours, dasp_tpu_torch.RowCategories)
    _assert_same(ours, ref, "categories")
    assert ours.census == ref.census


def test_gc_paused_is_identical_copy():
    assert (inspect.getsource(dasp_tpu_torch.utils.gc_paused)
            == inspect.getsource(dasp_tpu.utils.gc_paused))


@pytest.mark.parametrize("name", list(CASES))
def test_build_wplan_identical(name):
    csr = CASES[name](np.random.default_rng(0))
    _assert_same(build_wplan(csr), ref_build_wplan(_to_ref(csr)), "plan")


@pytest.mark.parametrize("name", list(LOWER_CASES))
def test_build_plan_identical(name):
    """The tile plan (plan.py, a copy): built by both packages, and carried
    across by plan_from_reference, field for field the same."""
    from dasp_tpu.plan import build_plan as ref_build_plan
    from dasp_tpu_torch import build_plan
    from dasp_tpu_torch.ops.xla_backend import plan_from_reference
    csr = LOWER_CASES[name](np.random.default_rng(0))
    ref = ref_build_plan(_to_ref(csr))
    ours = build_plan(csr)
    _assert_same(ours, ref, "plan")
    carried = plan_from_reference(ref)
    assert type(carried) is type(ours)
    _assert_same(carried, ours, "carried")


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
    for dtype in ("f16", "fp8", "f32x2"):
        with pytest.raises(ValueError, match="must be one of"):
            cb.plan_to_arrays(plan, dtype)


def _ref_values(ref, dtype):
    """The reference's value table of one entry (stream or residue) as
    float64, and the entry without it."""
    ref = dict(ref)
    if dtype == "f64":
        hi, lo = ref.pop("vals_hi"), ref.pop("vals_lo")
        assert hi.dtype == lo.dtype == np.float32
        return hi.astype(np.float64) + lo.astype(np.float64), ref
    return ref.pop("vals").astype(np.float64), ref


def _assert_same_dtype_tables(ours, ref, dtype, path="arrays"):
    """The port's bf16 / f64 lowering against the reference's.  bf16: the
    stream values are bit-equal (the port's uint16 bits, the reference's
    ml_dtypes.bfloat16) and the residue values equal.  f64: every value is
    within 2^-48 (relative) of the reference's hi + lo, the bound of a
    double-double split of a float64.  Every other table is equal."""
    ours = dict(ours)
    ref = dict(ref)
    entries = [("streams", i) for i in range(len(ours["streams"]))]
    if ours["overflow"] is not None:
        entries.append(("overflow", None))
    for key, i in entries:
        o = ours[key] if i is None else ours[key][i]
        r = ref[key] if i is None else ref[key][i]
        o = dict(o)
        ov = o.pop("vals")
        if dtype == "bf16" and key == "streams":
            assert ov.dtype == np.uint16 and r["vals"].itemsize == 2
            np.testing.assert_array_equal(ov, r["vals"].view(np.uint16),
                                          err_msg=f"{path}.{key}[{i}]")
            r = {k: v for k, v in r.items() if k != "vals"}
        else:
            assert ov.dtype == (np.float64 if dtype == "f64"
                                else np.float32), (path, key, ov.dtype)
            rv, r = _ref_values(r, dtype)
            np.testing.assert_array_less(
                np.abs(ov - rv), 2.0 ** -48 * np.abs(ov) + 1e-300,
                err_msg=f"{path}.{key}[{i}]")
        _assert_same(o, r, f"{path}.{key}[{i}]")
        if i is None:
            ours.pop(key)
            ref.pop(key)
    ours.pop("streams")
    ref.pop("streams")
    if "res" in ours:
        _assert_same_dtype_tables(ours.pop("res"), ref.pop("res"), dtype,
                                  f"{path}.res")
    _assert_same(ours, ref, path)


@pytest.mark.parametrize("name", list(LOWER_CASES))
@pytest.mark.parametrize("dtype", ["bf16", "f64"])
def test_plan_to_arrays_dtype_matches_reference(name, dtype):
    csr = LOWER_CASES[name](np.random.default_rng(0))
    meta, arrays = cb.plan_to_arrays(build_wplan(csr), dtype)
    ref_meta, ref_arrays = pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)),
                                             dtype)
    assert meta.dtype == dtype
    _assert_same_meta(meta, ref_meta)
    _assert_same_dtype_tables(arrays, ref_arrays, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f64"])
def test_plan_to_arrays_dtype_residue_subplan(dtype, monkeypatch):
    """The residue sub-plan lowers per dtype like the main plan."""
    monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
    monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    rng = np.random.default_rng(0)
    n = 40_000
    csr = tsp.random_csr(n, n, rng.integers(1, 8, size=n), rng)
    meta, arrays = cb.plan_to_arrays(build_wplan(csr), dtype)
    ref_meta, ref_arrays = pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)),
                                             dtype)
    assert meta.res is not None and meta.res.dtype == dtype
    _assert_same_meta(meta, ref_meta)
    _assert_same_dtype_tables(arrays, ref_arrays, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f64"])
def test_arrays_from_reference_dtype_matches_own_lowering(dtype):
    """The reference's bf16 / f64 tables carried across equal the port's
    own on the device: bf16 bit for bit, f64 values within 2^-48 (hi + lo
    against the float64 the port lowers), all else equal."""
    csr = LOWER_CASES["mixed"](np.random.default_rng(0))
    meta, arrays = cb.plan_to_arrays(build_wplan(csr), dtype)
    ours = cb.arrays_to_device(meta, arrays, "cpu")
    ref_meta, ref_arrays = cb.arrays_from_reference(
        *pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)), dtype), "cpu")
    assert ref_meta == meta
    want = {"bf16": torch.bfloat16, "f64": torch.float64}[dtype]
    for a, b in zip(ours["streams"], ref_arrays["streams"]):
        assert a["vals"].dtype == b["vals"].dtype == want
        if dtype == "bf16":
            assert torch.equal(a["vals"].view(torch.int16),
                               b["vals"].view(torch.int16))
        else:
            assert bool(((a["vals"] - b["vals"]).abs()
                         <= 2.0 ** -48 * a["vals"].abs()).all())
        for k in ("wins", "idx"):
            assert torch.equal(a[k], b[k])
    for k in ("out_src", "out_perm", "long_gat"):
        assert torch.equal(ours[k], ref_arrays[k])


def test_arrays_from_reference_refuses_bf16_lo_store(monkeypatch):
    """A reference f64 plan past its big-plan gate stores the lo values
    as bf16; carrying that across would lose low bits, so it is refused."""
    monkeypatch.setattr(pb, "DD_LO16_MIN_BYTES", 0)
    csr = CASES["fem"](np.random.default_rng(0))
    ref = pb.plan_to_arrays(ref_build_wplan(_to_ref(csr)), "f64")
    with pytest.raises(ValueError, match="bf16 lo store"):
        cb.arrays_from_reference(*ref, "cpu")


@pytest.mark.parametrize("name", ["random_long", "mixed"])
def test_no_native_router_packs_long_rows(name, monkeypatch):
    """Without native/libdasp_host.so, _native_router() returns False; the
    port's packer must then pack long rows through its numpy fallback
    (the reference's copy tested `is not None` and raised AttributeError:
    'bool' object has no attribute 'has_pack_long')."""
    import dasp_tpu_torch.wplan as twplan
    monkeypatch.setattr(twplan, "_NATIVE_ROUTER", False)
    assert twplan._native_router() is False
    rng = np.random.default_rng(0)
    csr = (tsp.random_csr(6, 4000, np.array([256, 300, 1000, 2048, 257,
                                             4000]), rng)
           if name == "random_long" else tsp.mixed_categories(500, rng))
    plan = build_wplan(csr)
    assert plan.n_long, "fixture must have long rows"
    from dasp_tpu_torch import SpMVOperator
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    scale = np.maximum(np.abs(golden), 1.0)
    y = SpMVOperator(plan, device="cpu")(x)
    np.testing.assert_allclose(y / scale, golden / scale, rtol=2e-5,
                               atol=2e-5)


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
from dasp_tpu_torch.ops import resident  # noqa
from dasp_tpu_torch.probes import resident_probe  # noqa
from dasp_tpu_torch.bench import suite, fem  # noqa
import dasp_tpu_torch.bench as bench
from dasp_tpu_torch.bench import __main__ as bench_cli  # noqa
from dasp_tpu_torch import analyze  # noqa
from dasp_tpu_torch.examples import cg_solver, pagerank  # noqa
from dasp_tpu_torch.parallel import MultiChipSpMV
rng = np.random.default_rng(0)
csr = mixed_categories(300, rng)
op = dasp_tpu_torch.SpMVOperator(csr, dtype="f32", device="cpu")
x = rng.standard_normal(csr.n_cols)
golden = csr.spmv(x)
err = np.abs(op(x) - golden) / np.maximum(np.abs(golden), 1.0)
assert err.max() <= 2e-5, err.max()
y = op.perm_out(op.timing_loop(2)(op._prep_x(x)).numpy())
err = np.abs(y - golden) / np.maximum(np.abs(golden), 1.0)
assert op.resident and err.max() <= 2e-5, err.max()
assert dasp_tpu_torch.categorize(csr).census["row_long"] >= 0
mc = MultiChipSpMV(csr, devices=["cpu"] * 3)
err = np.abs(mc(x) - golden) / np.maximum(np.abs(golden), 1.0)
assert mc.resident and err.max() <= 2e-5, err.max()
res = bench.bench_spmv(op, x, "f32", iters=2, trials=2)
assert res.gflops > 0 and bench.record_from(op.plan, res, "m", "f32")
tile = dasp_tpu_torch.SpMVOperator(csr, backend="xla", device="cpu")
err = np.abs(tile(x) - golden) / np.maximum(np.abs(golden), 1.0)
assert type(tile).__name__ == "TileSpMV" and err.max() <= 2e-5, err.max()
mc = MultiChipSpMV(csr, devices=["cpu"] * 3, dtype="f64", backend="xla")
err = np.abs(mc(x) - golden) / np.maximum(np.abs(golden), 1.0)
assert err.max() <= 1e-10, err.max()
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
