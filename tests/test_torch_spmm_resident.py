"""The SpMM pass on tables with a K6 schedule: one launch of K6's
kv-table instance at one step (``resident.spmm_loop``, which
``cuda_backend.spmm_fn`` and ``matmat`` run for kv = 2, 4, 8), here its
plain version ``spmm_loop_plain`` on the CPU, over the glue's fixtures
(tests/test_torch_spmm_glue.py's ``GLUE_CASES``: F > 1, w8 > VPB, long
rows, a relabel, the residue's scatter and lane-table tiers, a sub-plan)
in f32, bf16 and f64.

Tolerances, on the error scaled by max(|ref|, 1):
- column j of a pass against one K6 step (``device_call``) on table j:
  equal, bit for bit (the pass folds each table in the step's order, and
  the plain version batches only elementwise ops and gathers);
- column j when its neighbours change (other vectors, zero padding):
  equal, bit for bit;
- against ``PallasSpMV.matmat`` (interpret mode, ``force_streamed=True``)
  and the CSR golden: the glue test's REF_TOL and TOL (f32 2e-5; bf16
  1e-2, the golden of the bf16-rounded A and X scaled by the row's mass;
  f64 1e-10 against the golden, 2e-6 against the reference's dd tier).
"""

import numpy as np
import pytest
import torch

from dasp_tpu_torch.io.build import ensure_built
from dasp_tpu_torch.ops import _build, cuda_backend as cb, resident
from test_torch_spmm_glue import GLUE_CASES, REF_TOL, _check_golden, \
    _close, _operator, _reference

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
DTYPES = ("f32", "bf16", "f64")
KVS = (2, 4, 8)
COLS = 8
_CASES = {}


def _case(name, dtype, monkeypatch):
    """(csr, operator, X (n_cols, 8), the reference's matmat of X), made
    once per fixture and dtype: the reference's interpret-mode operator
    takes 15-40 s to build and compile here."""
    if (name, dtype) not in _CASES:
        rng = np.random.default_rng(0)
        csr, op = _operator(name, dtype, monkeypatch, rng)
        X = rng.standard_normal((csr.n_cols, COLS))
        Yr = np.asarray(_reference(name, csr, dtype).matmat(X), np.float64)
        _CASES[name, dtype] = csr, op, X, Yr
    return _CASES[name, dtype]


def _tables(op, X):
    return torch.cat([op._prep_x(X[:, j]) for j in range(X.shape[1])])


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(GLUE_CASES))
def test_pass_columns_are_one_k6_step(name, dtype, kv, monkeypatch):
    """spmm_fn on scheduled tables: column j equals device_call (one K6
    step) on table j bit for bit, in the plan's output dtype, and does not
    change when its neighbours become other vectors or zero padding."""
    csr, op, X, _ = _case(name, dtype, monkeypatch)
    meta, arrays = op._meta, op._arrays
    x3d = _tables(op, X[:, :kv])
    Y = cb.spmm_fn(meta, arrays, x3d, kv)
    assert Y.shape == (kv, csr.n_rows)
    assert Y.dtype == (torch.bfloat16 if dtype == "bf16" else x3d.dtype)
    assert torch.equal(Y, resident.spmm_loop_plain(meta, arrays, x3d, kv))
    xs = x3d.view(kv, meta.s_rows, -1)
    for j in range(kv):
        assert torch.equal(Y[j], op.device_call(xs[j].contiguous())), j
    rng = np.random.default_rng(kv)
    for j in (0, kv - 1):
        for fill in ("random", "zero"):
            xb = torch.zeros_like(xs)
            if fill == "random":
                xb.copy_(torch.from_numpy(rng.standard_normal(xb.shape)))
            xb[j] = xs[j]
            y = cb.spmm_fn(meta, arrays, xb.view(-1, xs.shape[-1]), kv)[j]
            assert torch.equal(y, Y[j]), (j, fill)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(GLUE_CASES))
def test_plain_pass_matches_pallas_and_golden(name, dtype, kv,
                                              monkeypatch):
    """spmm_loop_plain's columns against PallasSpMV.matmat on the same X
    (REF_TOL) and the CSR golden (TOL; bf16 on the bf16-rounded A and X,
    scaled by the row's mass)."""
    csr, op, X, Yr = _case(name, dtype, monkeypatch)
    Y = resident.spmm_loop_plain(op._meta, op._arrays,
                                 _tables(op, X[:, :kv]), kv)
    Yh = op.perm_out(cb._to_host(Y).T).astype(np.float64)
    _close(Yh, Yr[:, :kv], REF_TOL[dtype])
    _check_golden(csr, X[:, :kv], Yh, dtype)


def test_spmm_loop_refuses_bad_calls(monkeypatch):
    """kv outside (1, 2, 4, 8), x3d rows other than kv * s_rows, iters
    other than 1 at kv > 1 and the phase clock on the CPU raise the same
    ValueError on the CPU as on the card, before anything is launched; a
    CPU pass counts no launch; kv = 1 is one step, (1, n_rows)."""
    _, op, X, _ = _case("mixed", "f32", monkeypatch)
    meta, arrays = op._meta, op._arrays
    x3d = _tables(op, X[:, :4])
    before = dict(resident.spmm_loop.launches)
    for fn in (resident.spmm_loop, resident.spmm_loop_plain):
        for kv in (3, 16, 0):
            with pytest.raises(ValueError, match="kv"):
                fn(meta, arrays, x3d, kv)
        with pytest.raises(ValueError, match="x must be"):
            fn(meta, arrays, x3d, 2)
        with pytest.raises(ValueError, match="x must be"):
            fn(meta, arrays, x3d[:-1], 4)
    with pytest.raises(ValueError, match="stamps"):
        resident.spmm_loop(meta, arrays, x3d, 4, stamps=torch.zeros(
            resident.STAMP_WORDS, dtype=torch.int64))
    for iters in (2, 0):
        with pytest.raises(ValueError, match="iters"):
            resident._check("spmm_loop", meta, arrays, x3d, iters, 4)
    with pytest.raises(ValueError, match="kv"):
        cb.spmm_fn(meta, arrays, x3d, 2)
    assert resident.spmm_loop.launches == before
    y1 = resident.spmm_loop(meta, arrays, x3d[:meta.s_rows], 1)
    assert y1.shape == (1, meta.n_rows)
    assert torch.equal(y1[0], op.device_call(x3d[:meta.s_rows]))
    assert torch.equal(cb.spmm_fn(meta, arrays, x3d[:meta.s_rows], 1), y1)


def test_spmm_entries_are_bound():
    """The nine kv-table entries of csrc/resident.cu are bound with K6's
    arguments, their launches counted per instance and kv under the
    kernel names the smoke reads, and dasp_resident_info takes a kv."""
    from dasp_tpu_torch.ops import kernel_launches
    names = [f"dasp_resident_{d}_kv{kv}" for d in DTYPES for kv in KVS]
    for n in names:
        assert _build.SIGNATURES[n] == _build.SIGNATURES["dasp_resident_f32"]
    assert len(_build.SIGNATURES["dasp_resident_info"]) == 3
    assert set(resident.spmm_loop.launches) == {
        f"{d}_kv{kv}" for d in DTYPES for kv in KVS}
    counts = kernel_launches()
    for d in DTYPES:
        for kv in KVS:
            assert ("resident" + ("" if d == "f32" else f"_{d}")
                    + f"_kv{kv}") in counts
    with pytest.raises(ValueError, match="no K6 instance 'f32' at kv 3"):
        resident.kernel_info("f32", 3)


def test_k6_levers_kv_arm_reads_its_kernels():
    """probes/k6_levers.py's kv arm builds k6_levers.cu with K6_XI = 1, 2
    and 4 (a switch the source reads) and reads ptxas's figures for the pass
    of KV_LEVER tables (spmm_kernel) at the value type's shipped Shape and
    its XI alone; the shape arm still reads the one-table kernel."""
    import re
    from dasp_tpu_torch.probes import k6_levers
    src = open(k6_levers.SOURCE).read()
    assert "#ifdef K6_XI" in src
    assert sorted(k6_levers.KV_VARIANTS.values()) == [1, 2, 4]
    assert k6_levers.KV_LEVER == max(KVS)
    with open(f"{_build.SRC_DIR}/resident.cu") as fh:
        shipped = re.findall(r"using ShapeF(32|64) = Shape<(\d), (\d), (\d), "
                             r"(true|false)>", fh.read())
    for kind, *shape, ef in shipped:
        for d in (("f32", "bf16") if kind == "32" else ("f64",)):
            assert k6_levers.SHIPPED[d] == (*map(int, shape),
                                            int(ef == "true"))
    step = ("_ZN12_GLOBAL__N_115resident_kernelI{}NS_5ShapeILi{}ELi2ELi2"
            "ELb1EEELb{}EEvNS_6ParamsIT0_EE")
    kvk = ("_ZN12_GLOBAL__N_111spmm_kernelI{}NS_5ShapeILi{}ELi2ELi2"
           "ELb1EEELb{}ELi{}ELi{}EEvNS_10PassParamsIT0_EE")
    name = lambda v, c, k, kv, xi: (step.format(v, c, k) if kv == 1
                                    else kvk.format(v, c, k, kv, xi))
    cases = (("dd", 2, 1, 1, 0, 128), ("dd", 2, 8, 1, 8, 128),
             ("dd", 2, 8, 2, 96, 128), ("ff", 1, 8, 2, 16, 64))
    text = "\n".join(
        f"ptxas info    : Compiling entry function "
        f"'{name(v, c, k, kv, xi)}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for "
        f"{name(v, c, k, kv, xi)}\n"
        f"    {s + 8 * k} bytes stack frame, {s} bytes spill stores, {s} "
        f"bytes spill loads\nptxas info    : Used {r} registers"
        for v, c, kv, xi, s, r in cases for k in (1, 0))
    fig = lambda s, r: (f"stack {s}, spill st {s}, spill ld {s}, "
                        f"registers {r}")
    assert k6_levers.ptxas_figures(text, (2, 2, 2, 1), "f64") == fig(0, 128)
    assert k6_levers.ptxas_figures(text, (2, 2, 2, 1), "f64", 8, 1) == \
        fig(8, 128)
    assert k6_levers.ptxas_figures(text, (2, 2, 2, 1), "f64", 8, 2) == \
        fig(96, 128)
    assert k6_levers.ptxas_figures(text, (1, 2, 2, 1), "f32", 8, 2) == \
        fig(16, 64)
    assert k6_levers.ptxas_figures(text, (1, 2, 2, 1), "f32") == "not found"
