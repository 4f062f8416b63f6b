"""The port's resident executor (K6, ``dasp_tpu_torch/ops/resident.py``) on
the CPU, where ``resident_loop`` runs ``resident_loop_plain``: against the
port's streamed path, against the JAX package's resident loop
(``PallasSpMV.timing_loop`` on a resident operator, in interpret mode, as
tests/test_resident.py runs it) on the same plan, and against the CSR
golden.  The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``.

Tolerances, on the error scaled by max(|golden|, 1) per row:
- f32 1e-5 against the port's streamed path and the reference's resident
  loop (test_resident_matches_spmv): the same products, sums in another
  order (the folds, the vreg totals' lane tree, the long scalars, where
  the reference runs HIGHEST-precision MXU matmuls);
- bf16 0.1 against the golden (test_resident_bf16's bound), 1e-2 against
  the reference's resident y: sums that differ only in order, then one
  rounding to bf16 each, which can land one bf16 step (2^-7 of |y|) apart;
- f64 1e-10 against the golden: native fp64 sums of at most a few
  thousand terms (test_torch_dtypes.py); the reference's double-double
  resident loop is held to its own 2e-6 (test_resident_dd_matches_golden:
  its long scalars pass an f32 incidence matmul).

Not mirrored: test_split_incidence_cascade and test_resident_dd_split_kernel
(the port has no f32 incidence matmul to cascade; their fixture, one
150k-nnz row, runs here in f64 without a cap), and the budget and
compression tests (test_budget_gate, test_resident_compression_when_over_
budget, test_resident_output_not_in_vmem_budget, test_uniform_scatter_
plans_stay_static, test_resident_dd_f32_colsum_tier), which test the
TPU's VMEM budget and tiers the port does not have.
"""

import functools
import inspect
import operator
import os

import numpy as np
import pytest
import torch

from dasp_tpu.ops import dd, pallas_backend as pb
from dasp_tpu.ops import resident as ref_resident
from dasp_tpu.sparse import CSRMatrix as RefCSR
import dasp_tpu_torch as dt
from dasp_tpu_torch import sparse as tsp
from dasp_tpu_torch.config import DaspConfig
from dasp_tpu_torch.ops import _build, cuda_backend as cb
from dasp_tpu_torch.ops import resident
from dasp_tpu_torch.ops.colsum import colsum_plain
from dasp_tpu_torch.ops.cuda_backend import TorchSpMV
from dasp_tpu_torch.wplan import SUB
from dasp_tpu_torch.probes import resident_probe as t4
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = {"f32": 1e-5, "f64": 1e-10}
TOL_BF16_GOLDEN = 0.1
TOL_BF16_VS_REF = 1e-2
TOL_REF_DD = 2e-6

# tests/test_resident.py:21-29 and :84-88
MATCH_CASES = {
    "mixed": (lambda rng: tsp.mixed_categories(500, rng), 0),
    "circuit": (lambda rng: tsp.circuit_like(2000, rng), 1),
    "powerlaw": (lambda rng: tsp.powerlaw_like(1500, 1.8, 700, rng,
                                               col_alpha=1.8), 2),
    "fem_long_segments": (lambda rng: tsp.fem_like(6000, 24, rng), 3),
}
DD_CASES = {
    "mixed": (lambda rng: tsp.mixed_categories(500, rng), 10),
    "circuit": (lambda rng: tsp.circuit_like(2000, rng), 11),
    "powerlaw": (lambda rng: tsp.powerlaw_like(1500, 1.8, 700, rng,
                                               col_alpha=1.8), 12),
}


def _ref(csr):
    return RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  csr.values)


def _long_row_csr():
    """tests/test_resident.py:test_resident_dd_split_kernel's fixture: one
    150k-nnz row over 2000 short ones."""
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 6, 2000)
    lens[0] = 150_000
    return tsp.random_csr(2000, 2000, lens, rng), rng


def _wide_long_csr():
    """256 rows of 220-255 nnz (a w8 = 32 slice folded into a stride-2
    stream: w8 x F = 128 partial rows per y2 row), three rows of 6000 nnz
    (long rows) and short rows: every kind of work item of the schedule."""
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 6, 2000)
    lens[:256] = rng.integers(220, 256, 256)
    lens[300:303] = 6000
    return tsp.random_csr(2000, 2000, lens, rng), rng


def _port_loop(op, x, iters):
    """The port's timing_loop y in original row order, float64."""
    y = op.timing_loop(iters)(op._prep_x(x))
    return op.perm_out(y.double().numpy())


def _ref_loop(csr, x, dtype, iters):
    """The reference's resident timing_loop y in original row order."""
    op = pb.PallasSpMV(_ref(csr), dtype)
    assert op.resident
    out = op.timing_loop(iters)(op._prep_x(x))
    if dtype == "f64":
        return op.perm_out(dd.to_f64(np.asarray(out["hi"]),
                                     np.asarray(out["lo"])))
    return op.perm_out(np.asarray(out).astype(np.float64))


def _err(y, want, golden):
    return float((np.abs(np.asarray(y, np.float64) - want)
                  / np.maximum(np.abs(golden), 1.0)).max(initial=0.0))


@pytest.mark.parametrize("name", list(MATCH_CASES))
def test_resident_matches_spmv(name):
    """The port's resident y against its streamed y and the reference's
    resident y (test_resident_matches_spmv)."""
    make, seed = MATCH_CASES[name]
    rng = np.random.default_rng(seed)
    csr = make(rng)
    op = dt.SpMVOperator(csr, device="cpu")
    assert op.resident, "suite-scale plans must be resident"
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    y_res = _port_loop(op, x, 1)
    assert _err(y_res, op(x), golden) <= TOL["f32"]
    assert _err(y_res, _ref_loop(csr, x, "f32", 1), golden) <= TOL["f32"]
    assert _err(y_res, golden, golden) <= 2e-5


def test_resident_chained_iters_stay_close():
    """The 1e-36 tap does not visibly move y over three steps, here and
    in the reference (test_resident_chained_iters_stay_close)."""
    rng = np.random.default_rng(3)
    csr = tsp.mixed_categories(400, rng)
    op = dt.SpMVOperator(csr, device="cpu")
    x = rng.standard_normal(csr.n_cols)
    y1 = _port_loop(op, x, 1)
    y3 = _port_loop(op, x, 3)
    assert _err(y3, y1, y1) <= TOL["f32"]
    assert _err(y3, _ref_loop(csr, x, "f32", 3), y1) <= TOL["f32"]


def test_resident_bf16():
    """test_resident_bf16: bf16 values, f32 sums, y rounded once."""
    rng = np.random.default_rng(4)
    csr = tsp.circuit_like(1500, rng)
    op = dt.SpMVOperator(csr, dtype="bf16", device="cpu")
    assert op.resident
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    y = op.timing_loop(2)(op._prep_x(x))
    assert y.dtype == torch.bfloat16
    y = op.perm_out(y.double().numpy())
    assert _err(y, golden, golden) < TOL_BF16_GOLDEN
    assert _err(y, _ref_loop(csr, x, "bf16", 2), golden) <= TOL_BF16_VS_REF


@pytest.mark.parametrize("name", list(DD_CASES))
def test_resident_f64_matches_golden(name):
    """test_resident_dd_matches_golden: the port's native fp64 resident y
    at 1e-10, the reference's double-double one at its own 2e-6."""
    make, seed = DD_CASES[name]
    rng = np.random.default_rng(seed)
    csr = make(rng)
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu")
    assert op.resident
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    y = op.timing_loop(1)(op._prep_x(x))
    assert y.dtype == torch.float64
    assert _err(op.perm_out(y.numpy()), golden, golden) <= TOL["f64"]
    assert _err(_ref_loop(csr, x, "f64", 1), golden, golden) <= TOL_REF_DD


def test_resident_f64_long_row():
    """One 150k-nnz row over 2000 columns (the fixture of
    test_resident_dd_split_kernel, whose scalar the reference splits into
    a cascade once its fan-in cap is lowered to 2): here its scalar sums
    its vreg totals in fp64, with no cap and no cascade."""
    csr, rng = _long_row_csr()
    op = dt.SpMVOperator(csr, dtype="f64", device="cpu")
    assert op.resident and op._meta.n_long
    counts = np.diff(op._arrays["resident"]["inc_ptr"].numpy())
    assert counts.max() > 2, "the scalar must exceed the lowered cap of 2"
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    assert _err(_port_loop(op, x, 1), golden, golden) <= TOL["f64"]


@pytest.mark.parametrize("name", ["mixed", "powerlaw", "long_row"])
def test_incidence_matches_reference_bigs(name):
    """The port's per-scalar (total, multiplicity) lists, expanded to
    dense (n_long, NV) matrices per stream, equal the reference's
    ``resident.prepare`` incidence matrices ``bigs`` with the band trim
    ``big_c0`` undone."""
    if name == "long_row":
        csr, _ = _long_row_csr()
    else:
        make, seed = MATCH_CASES[name]
        csr = make(np.random.default_rng(seed))
    ref_meta, ref_arrays = pb.plan_to_arrays(pb.build_wplan(_ref(csr)))
    ref_resident.prepare(ref_meta, ref_arrays)
    ref = ref_arrays["resident"]
    meta, arrays = cb.plan_to_arrays(dt.build_wplan(csr))
    resident.prepare(meta, arrays)
    res = arrays["resident"]
    assert meta.n_long and set(ref["bigs"]) == set(res["long_streams"])
    for s, big in ref["bigs"].items():
        nv = meta.streams[s][2]
        want = np.zeros((meta.n_long, nv))
        c0 = ref["big_c0"].get(s, 0)
        want[:, c0:c0 + big.shape[1]] = big[:meta.n_long]
        got = np.zeros((meta.n_long, nv))
        t0 = res["tot_off"][s]
        counts = np.diff(res["inc_ptr"])
        rows = np.repeat(np.arange(meta.n_long), counts)
        mine = (res["inc_tot"] >= t0) & (res["inc_tot"] < t0 + nv)
        got[rows[mine], res["inc_tot"][mine] - t0] = res["inc_mult"][mine]
        np.testing.assert_array_equal(got, want)


def _residue_case(tier, monkeypatch):
    rng = np.random.default_rng(0)
    if tier == "scatter":
        csr = tsp.random_csr(300, 5000, rng.integers(1, 60, 300), rng)
    elif tier == "route":
        csr = tsp.random_csr(200, 400_000, np.where(
            np.arange(200) % 50 == 0, 2000, 3), rng)
    else:                   # the residue sub-plan (RES_REPACK_MIN = 1)
        monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
        n = 40_000
        csr = tsp.random_csr(n, n, rng.integers(1, 8, size=n), rng)
    return csr, rng


@pytest.mark.parametrize("tier", ["scatter", "route", "subplan"])
def test_residue_post_loop_correction(tier, monkeypatch):
    """Every residue row goes through the post-loop correction, whatever
    tier the streamed path routes it by (sorted scatter, y2 lane-table
    route, or sub-plan): the resident y matches the golden, and without
    the correction it would not."""
    csr, rng = _residue_case(tier, monkeypatch)
    op = dt.SpMVOperator(csr, dtype="f32", config=DaspConfig(relabel="off"),
                         device="cpu")
    meta = op._meta
    assert op.resident and op._arrays["overflow"] is not None
    assert (meta.res is not None) == (tier == "subplan")
    if tier != "subplan":
        assert meta.overflow_meta == (tier,)
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    x2d = op._prep_x(x)
    y = op.timing_loop(1)(x2d)
    assert _err(op.perm_out(y.numpy()), golden, golden) <= 2e-5
    assert _err(op.perm_out(y.numpy()), op(x), golden) <= TOL["f32"]
    o = op._arrays["overflow"]
    corr = torch.zeros_like(y).index_add(
        0, o["tree_rows"], cb.residue_sums(o, x2d)[o["sort_back"]])
    assert float(corr.abs().max()) > 0.1
    assert _err(op.perm_out((y - corr).numpy()), golden, golden) > 1e-3


def test_resident_tap_and_residue_from_caller_x(monkeypatch):
    """With TAP raised so that it shows: each step adds row 0 of its y2,
    times TAP, into every row of x; y is the last step's outgather plus
    the residue of the caller's x (not the tapped one); x2d is never
    written.  Rebuilt here from the streamed path's own pieces."""
    monkeypatch.setattr(cb, "TAP", 0.25)
    rng = np.random.default_rng(0)
    csr = tsp.random_csr(300, 5000, rng.integers(1, 60, 300), rng)
    op = dt.SpMVOperator(csr, config=DaspConfig(relabel="off"), device="cpu")
    meta, arrays = op._meta, op._arrays
    assert arrays["overflow"] is not None
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    keep = x2d.clone()
    got = op.timing_loop(3)(x2d)
    assert torch.equal(x2d, keep), "timing_loop must not write its input"
    no_res = dict(arrays, overflow=None)
    x = x2d.clone()
    for _ in range(3):
        parts = [cb.colsum_plain(st["wins"], st["vals"], st["idx"], x, s)
                 for (_, s, _), st in zip(meta.streams, arrays["streams"])]
        y2, _ = cb.stack_y2(meta, no_res, parts, x)
        out = cb.outgather_plain(arrays["out_src"], arrays["out_perm"], y2)
        x = x + y2[0] * 0.25
    want = out.reshape(-1)[:meta.n_rows]
    o = arrays["overflow"]
    want = want.index_add(0, o["tree_rows"],
                          cb.residue_sums(o, x2d)[o["sort_back"]])
    scale = want.abs().clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) <= TOL["f32"]
    assert float(((op.timing_loop(1)(x2d) - got).abs() / scale).max()) > 1e-2


def test_force_streamed_and_empty():
    """force_streamed=True keeps the operator's timing loop off the
    resident chain, though it carries the schedule (each of its SpMVs is
    one K6 step); the empty matrix has no schedule, is never resident
    (the reference fails there) and its timing loop returns zeros."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    assert dt.SpMVOperator(csr, device="cpu").resident
    op = dt.SpMVOperator(csr, device="cpu", force_streamed=True)
    assert not op.resident and op._arrays["resident"] is not None
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    assert torch.equal(op.timing_loop(0)(x2d), op.device_call(x2d))
    empty = tsp.random_csr(50, 50, np.zeros(50, np.int64), rng)
    for dtype in ("f32", "bf16", "f64"):
        op = dt.SpMVOperator(empty, dtype=dtype, device="cpu")
        assert not op.resident
        y = op.timing_loop(2)(op._prep_x(np.ones(50)))
        assert y.shape == (50,) and not y.any()
    with pytest.raises(ValueError, match="no resident tables"):
        resident.resident_loop(op._meta, op._arrays, op._prep_x(np.ones(50)),
                               1)


def test_resident_loop_refuses_bad_calls():
    """Wrong device, dtype, shape or iteration count raises; a CPU tensor
    runs the plain version (and counts no launch)."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    op = dt.SpMVOperator(csr, device="cpu")
    meta, arrays = op._meta, op._arrays
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    before = dict(resident.resident_loop.launches)
    assert torch.equal(resident.resident_loop(meta, arrays, x2d, 2),
                       resident.resident_loop_plain(meta, arrays, x2d, 2))
    assert resident.resident_loop.launches == before
    for bad, iters, what in ((x2d.double(), 1, "x must be"),
                             (x2d[:-1], 1, "x must be"),
                             (x2d, 0, "iters"),
                             (x2d.to("meta"), 1, "unsupported device")):
        with pytest.raises(ValueError, match=what):
            resident.resident_loop(meta, arrays, bad, iters)


def test_kernel_info_refuses_without_cuda(monkeypatch):
    """resident.kernel_info reads K6's figures from the CUDA build: with
    no card it raises a RuntimeError that says so before the library is
    built or loaded (no nvcc search, no ctypes call); an instance that
    does not exist raises ValueError."""
    def no_library():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "library", no_library)
    for name in resident.resident_loop.launches:
        with pytest.raises(RuntimeError, match="need a CUDA card"):
            resident.kernel_info(name)
    with pytest.raises(ValueError, match="no K6 instance 'f16'"):
        resident.kernel_info("f16")
    assert "dasp_resident_info" in _build.SIGNATURES


def test_k6_levers_shapes_are_launchable():
    """probes/k6_levers.py builds k6_levers.cu once per shape: each sets
    every shape switch the source reads; each gives a thread row more threads
    than a vreg has windows (it copies the wins row a word a thread) and
    fits its item stages and static arrays in a block's 227 KB of shared
    memory; shape (0), one column a thread, comes first and the shapes
    resident.cu ships are among them; ptxas's figures are read for the
    kernel of the variant's shape and value type alone."""
    import re
    from dasp_tpu_torch.probes import k6_levers
    src = open(k6_levers.SOURCE).read()
    # the shape switches; the kv arm's (K6_XI64, K6_XIL) follow #ifdef
    # K6_XI and are tested with that arm
    shape_src = src.split("#ifdef K6_XI")[0]
    assert re.findall(r"#ifndef (K6_\w+)\n", shape_src) == \
        list(k6_levers._FLAGS)
    stage = -(-(resident.VPB * SUB * 128 * (2 + 8)
                + resident.VPB * (resident.MAX_P + 1) * 4
                + len(resident.ITEM_FIELDS) * 4) // 16) * 16
    static = resident.VPB * (4 + 1) * 128 * 8     # red and lsum, f64
    for name, (cols, minb, stages, ef) in k6_levers.VARIANTS.items():
        assert 128 % cols == 0 and 128 // cols > resident.MAX_P, name
        assert minb >= 1 and stages >= 2 and ef in (0, 1), name
        assert stages * stage + static <= 232_448, name
    assert list(k6_levers.VARIANTS.values())[0] == (1, 2, 2, 0)
    with open(os.path.join(_build.SRC_DIR, "resident.cu")) as fh:
        shipped = re.findall(r"using ShapeF(?:32|64) = Shape<(\d), (\d), "
                             r"(\d), (true|false)>", fh.read())
    assert len(shipped) == 2
    for *shape, ef in shipped:
        assert (*map(int, shape), int(ef == "true")) in \
            k6_levers.VARIANTS.values()
    kernel = ("_ZN12_GLOBAL__N_115resident_kernelI{}NS_5ShapeILi{}ELi2ELi2"
              "ELb0EEELb{}EEvNS_6ParamsIT0_EE")
    text = "\n".join(
        f"ptxas info    : Compiling entry function "
        f"'{kernel.format(v, c, k)}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {kernel.format(v, c, k)}\n"
        f"    {s} bytes stack frame, {s} bytes spill stores, {s} bytes "
        f"spill loads\nptxas info    : Used {r} registers, used 1 barriers"
        for v, c, s, r in (("ff", 1, 8, 64), ("13__nv_bfloat16f", 1, 16, 64),
                           ("dd", 1, 184, 64), ("dd", 2, 0, 126))
        for k, s, r in ((1, s + 8, r), (0, s, r)))   # clocked twin first
    assert k6_levers.ptxas_figures(text, (2, 2, 2, 0), "f64") == \
        "stack 0, spill st 0, spill ld 0, registers 126"
    assert k6_levers.ptxas_figures(text, (1, 2, 2, 0), "f64") == \
        "stack 184, spill st 184, spill ld 184, registers 64"
    assert k6_levers.ptxas_figures(text, (1, 2, 2, 0), "f32") == \
        "stack 8, spill st 8, spill ld 8, registers 64"
    assert k6_levers.ptxas_figures(text, (1, 2, 2, 0), "bf16") == \
        "stack 16, spill st 16, spill ld 16, registers 64"
    assert k6_levers.ptxas_figures(text, (1, 1, 3, 0), "f64") == \
        "not found"


def test_entry_points_default_to_cuda():
    """SpMVOperator, spmv and TorchSpMV run on the card unless the caller
    asks for the CPU (read from the signatures, no card needed)."""
    for fn in (dt.SpMVOperator.__init__, dt.spmv, TorchSpMV.__init__):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn


def test_probe_plain_matches_numpy():
    """T4's plain version against a numpy reading of the body of
    tools/resident_probe.py:make (:28-44); sums of 8 products in another
    order, so 1e-6 of max(|ref|, 1)."""
    nv = 48
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((nv * 8, 128)).astype(np.float32)
    idx = rng.integers(0, 1024, (nv * 8, 128)).astype(np.int16)
    x2d = rng.standard_normal((64, 128)).astype(np.float32)
    want = []
    for v in range(nv):
        val = vals[v * 8:(v + 1) * 8]
        ix = idx[v * 8:(v + 1) * 8].astype(np.int32)
        lam = ix & 127
        q = (ix >> 7) & 7
        g = np.take_along_axis(x2d[0:8], q, axis=0)
        g = np.take_along_axis(g, lam, axis=1)
        want.append((val * g).sum(axis=0))
    want = np.stack(want)
    got = t4.resident_probe(torch.from_numpy(vals), torch.from_numpy(idx),
                            torch.from_numpy(x2d), iters=3)
    assert got.shape == (nv, 128) and got.dtype == torch.float32
    assert _err(got.numpy(), want, want) <= 1e-6
    with pytest.raises(ValueError, match="x must be"):
        t4.resident_probe(torch.from_numpy(vals), torch.from_numpy(idx),
                          torch.from_numpy(x2d[:8]))


def _sum(terms):
    """Left-to-right rounded sum in the terms' own dtype."""
    return functools.reduce(operator.add, terms)


def _emulate_schedule(meta, arrays, x2d):
    """csrc/resident.cu's phases A and C for one step, restated in numpy
    item by item from the schedule the kernel runs (the items, the wide
    rows, the incidence lists), in the written order of every sum: the
    sell and long rows of y2, unwritten rows left NaN."""
    res = arrays["resident"]
    items, wide = res["items"].numpy(), res["wide"].numpy()
    parts = [colsum_plain(st["wins"], st["vals"], st["idx"], x2d, s).numpy()
             for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    dt = parts[0].dtype
    Z = meta.n_y2_rows
    y2 = np.full((Z + 1, 128), np.nan, dt)
    y2[Z] = 0
    cbuf = np.full((res["chunk_rows"], 128), np.nan, dt)
    tot = np.full(max(res["n_tot"], 1), np.nan, dt)
    for s, v0, n, w, F, R, dst, out, t0, mask in items:
        r_st = SUB // meta.streams[s][1]
        lv = []
        for t in range(n):
            acc = parts[s][(v0 + t) * r_st:(v0 + t + 1) * r_st]
            lv.append([_sum(acc[r * F:(r + 1) * F]) for r in range(R)])
            if mask >> t & 1:
                c = _sum(acc)
                for s_ in resident.TREE:
                    c = c[:s_] + c[s_:2 * s_]
                tot[t0 + t] = c[0]
        if dst == resident.DST_NONE:
            continue
        o = y2 if dst == resident.DST_Y2 else cbuf
        for t in range(0, n, w):
            for r in range(R):
                o[out + t // w * R + r] = _sum([lv[t + u][r]
                                                for u in range(w)])
    for row, first, n, step in wide:
        y2[row] = _sum([cbuf[first + c * step] for c in range(n)])
    base = Z - meta.n_long_rows
    y2[base:Z] = 0
    ptr, ti, m = (res[k].numpy() for k in ("inc_ptr", "inc_tot", "inc_mult"))
    for p in range(meta.n_long):
        k0, k1 = ptr[p], ptr[p + 1]
        if k0 < k1:
            y2[base + p // 127, p % 127] = _sum(
                [dt.type(m[k]) * tot[ti[k]] for k in range(k0, k1)])
    return y2


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_schedule_matches_plain_fold_order(dtype):
    """On a plan with a wide slice and long rows, the kernel's schedule
    restated in numpy (``_emulate_schedule``) gives the y2 of
    ``y2_plain`` bit for bit: the schedule writes every row once, in the
    order of arithmetic that the plain version follows."""
    csr, rng = _wide_long_csr()
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    meta, arrays = op._meta, op._arrays
    res = arrays["resident"]
    w8f = max(w8 * (SUB // meta.streams[s][1]) // (SUB // st)
              for s, _, _, w8, st in meta.sell_segs)
    dsts = set(res["items"][:, 6].tolist())
    assert w8f >= 64 and meta.n_long and res["wide"].shape[0]
    assert dsts == {resident.DST_Y2, resident.DST_CHUNK, resident.DST_NONE}
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    want = resident.y2_plain(meta, arrays, x2d).numpy()
    np.testing.assert_array_equal(_emulate_schedule(meta, arrays, x2d), want)


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_wide_long_plain_matches_reference(dtype):
    """The plain resident loop on the wide-slice, long-row plan against
    the JAX package: f32 against PallasSpMV (interpret mode) and the
    golden at 2e-5, f64 against the golden at 1e-10, bf16 against the
    golden of the bf16-rounded A and x at 0.05 (all scaled by
    max(|golden|, 1))."""
    csr, rng = _wide_long_csr()
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    x = rng.standard_normal(csr.n_cols)
    y = _port_loop(op, x, 1)
    if dtype == "bf16":
        r16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).double().numpy()
        golden = tsp.CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr,
                               csr.col_idx, r16(csr.values)).spmv(r16(x))
        assert _err(y, golden, golden) <= 0.05
        return
    golden = csr.spmv(x)
    assert _err(y, golden, golden) <= {"f32": 2e-5, "f64": 1e-10}[dtype]
    if dtype == "f32":
        ref = pb.PallasSpMV(_ref(csr), "f32")
        assert _err(y, ref(x), golden) <= 2e-5


def _corrupt(name, res, meta):
    items, wide = res["items"], res["wide"]
    y2_items = np.flatnonzero(items[:, 6] == resident.DST_Y2)
    if name == "stream":
        items[0, 0] = len(meta.streams)
    elif name == "past_stream":
        items[0, 1] = meta.streams[items[0, 0]][2]
    elif name == "levels":
        items[y2_items[0], 4] *= 2
    elif name == "too_many_vregs":
        items[0, 2] = resident.VPB + 1
    elif name == "row_twice":
        items[y2_items[1]] = items[y2_items[0]]
    elif name == "row_missing":
        res["items"] = np.delete(items, y2_items[0], axis=0)
    elif name == "wide_chunk":
        wide[0, 1] = res["chunk_rows"]
    elif name == "total_missing":
        items[:, 9] = 0


@pytest.mark.parametrize("name", ["stream", "past_stream", "levels",
                                  "too_many_vregs", "row_twice",
                                  "row_missing", "wide_chunk",
                                  "total_missing"])
def test_to_device_refuses_bad_schedule(name):
    """A schedule or wide-row table that reads outside the plan, writes a
    y2 row twice or never, or leaves a total a long scalar reads
    uncomputed is refused before upload, as the fold table was."""
    csr, _ = _wide_long_csr()
    meta, arrays = cb.plan_to_arrays(dt.build_wplan(csr))
    resident.prepare(meta, arrays)
    res = arrays.pop("resident")
    streams = cb.arrays_to_device(meta, arrays, "cpu")["streams"]
    resident.to_device(meta, res, streams, "cpu")      # as prepared: fine
    bad = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in res.items()}
    _corrupt(name, bad, meta)
    with pytest.raises(ValueError):
        resident.to_device(meta, bad, streams, "cpu")


def test_resident_loop_refuses_cpu_stamps():
    """The phase clock exists only in the kernel: stamps with a CPU x, or
    on the CPU, raise; the plain version takes none."""
    rng = np.random.default_rng(0)
    csr = tsp.mixed_categories(300, rng)
    op = dt.SpMVOperator(csr, device="cpu")
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    stamps = torch.zeros(resident.STAMP_WORDS, dtype=torch.int64)
    with pytest.raises(ValueError, match="stamps"):
        resident.resident_loop(op._meta, op._arrays, x2d, 1, stamps=stamps)
    with pytest.raises(TypeError):
        resident.resident_loop_plain(op._meta, op._arrays, x2d, 1,
                                     stamps=stamps)
