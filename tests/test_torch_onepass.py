"""The port's single-vector SpMV as ONE resident-executor step
(``cuda_backend.spmv_fn`` on a table set with a schedule runs
``resident_loop(meta, arrays, x2d, 1)``: K6 at one step, the COO residue
summed and added inside it), on the CPU, where the wrappers run
``resident_loop_plain``.  Held against the JAX package's ``spmv_fn``
(``PallasSpMV(force_streamed=True)``, in interpret mode) and the CSR
golden; the card holds the kernel to the plain version (chip_smoke.py).

Tolerances, on the error scaled by max(|golden|, 1) per row (ROADMAP.md,
"What held against the reference means"):
- f32 2e-5: the same products, sums in another order (K6's folds, lane
  trees and residue trees against the reference's glue);
- f64 1e-10: native fp64 sums against the reference's double-double ones
  (~2^-44 a step), both far inside it;
- bf16 0.05 against the golden of the bf16-rounded A and x, and against
  the reference: x stays f32 and y is rounded to bf16 once (2^-8 of |y|).
Everything else is bit for bit: the one-step y against
``resident_loop_plain(..., 1)``, a chain against the chain that still
tapped after its last step, and the plain residue against the kernel's
order restated in numpy.
"""

import functools
import operator

import ml_dtypes
import numpy as np
import pytest
import torch

from dasp_tpu.config import DaspConfig as RefConfig
from dasp_tpu.ops import pallas_backend as pb
from dasp_tpu.sparse import CSRMatrix as RefCSR
import dasp_tpu_torch as dt
from dasp_tpu_torch import sparse as tsp
from dasp_tpu_torch.config import DaspConfig
from dasp_tpu_torch.ops import cuda_backend as cb
from dasp_tpu_torch.ops import resident
from dasp_tpu_torch.ops.outgather import outgather_plain
from dasp_tpu_torch.wplan import LANES
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = {"f32": 2e-5, "f64": 1e-10, "bf16": 5e-2}
DTYPES = ("f32", "bf16", "f64")


def _hub(rng):
    """Short rows and three of 200, 120 and 40 nnz; packed with
    ``fill_dump=0.1``, the slices that hold the long ones go to the COO
    residue, whose trees then reach 256 and 128 slots (a warp each)."""
    lens = rng.integers(1, 6, 600)
    lens[[5, 300, 500]] = [200, 120, 40]
    return tsp.random_csr(600, 600, lens, rng)


def _wide_long(rng):
    """A slice of w8 = 32 vregs (wider than a work item's VPB = 4), two
    long rows and short rows (tests/test_torch_resident.py's fixture, cut
    to half its rows)."""
    lens = rng.integers(1, 6, 1000)
    lens[:128] = rng.integers(220, 256, 128)
    lens[300:302] = 3000
    return tsp.random_csr(1000, 1000, lens, rng)


# name -> (matrix, packing options, RES_REPACK_MIN forced to 1, what the
# fixture must reach)
CASES = {
    # one stream of short rows: whole sell slices per work item
    "sell": (lambda rng: tsp.random_csr(3000, 3000, np.full(3000, 4), rng),
             {}, False, dict()),
    "wide_long": (_wide_long, {}, False, dict(wide=True, long=True)),
    # a small residue: trees of 1 to 32 slots (a row a lane) and of 64
    # slots and more (a warp each)
    "hub": (_hub, dict(relabel="off", fill_dump=0.1), False,
            dict(residue=True, warp=True)),
    # the same residue past RES_REPACK_MIN (forced to 1): the glue runs it
    # as a sub-plan, K6 by its trees
    "subplan": (_hub, dict(relabel="off", fill_dump=0.1), True,
                dict(residue=True, warp=True, subplan=True)),
    "empty": (lambda rng: tsp.random_csr(50, 50, np.zeros(50, np.int64),
                                         rng), {}, False, dict(empty=True)),
}


def _operator(name, dtype, monkeypatch, rng, **kw):
    make, opts, repack, _ = CASES[name]
    if repack:
        monkeypatch.setattr(cb, "RES_REPACK_MIN", 1)
        monkeypatch.setattr(pb, "RES_REPACK_MIN", 1)
    csr = make(rng)
    op = dt.SpMVOperator(csr, dtype=dtype, config=DaspConfig(**opts),
                         device="cpu", **kw)
    return csr, op


def _golden(csr, x, dtype):
    """The CSR golden; for bf16 that of the bf16-rounded A and x."""
    if dtype != "bf16":
        return csr.spmv(x)
    r = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)
    return tsp.CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                         r(csr.values)).spmv(r(x))


def _close(y, want, golden, tol):
    scale = np.maximum(np.abs(golden), 1.0)
    np.testing.assert_allclose(np.asarray(y, np.float64) / scale,
                               np.asarray(want, np.float64) / scale,
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_one_step_matches_reference_and_golden(name, dtype, monkeypatch):
    """``op(x)`` (``device_call`` -> ``spmv_fn``) against the golden and
    the reference's streamed SpMV on every fixture; each fixture reaches
    what it is listed for (a sub-plan only where it is listed), and only
    the empty plan has no schedule."""
    rng = np.random.default_rng(0)
    csr, op = _operator(name, dtype, monkeypatch, rng)
    meta, arrays, want = op._meta, op._arrays, CASES[name][3]
    res = arrays["resident"]
    assert (res is None) == want.get("empty", False)
    if res is not None:
        widths = res["res_ent"][:, 2]
        assert bool(widths.numel()) >= want.get("residue", False)
        assert bool((widths >= resident.RES_WARP_MIN).any()) >= \
            want.get("warp", False)
        assert (res["wide"].shape[0] > 0) >= want.get("wide", False)
    assert bool(meta.n_long) >= want.get("long", False)
    assert (meta.res is not None) == want.get("subplan", False)
    x = rng.standard_normal(csr.n_cols)
    y = op(x)
    assert y.shape == (csr.n_rows,)
    assert y.dtype == (np.float64 if dtype == "f64" else np.float32)
    golden = _golden(csr, x, dtype)
    _close(y, golden, golden, TOL[dtype])
    if want.get("empty"):
        assert not y.any()
    ref_cfg = RefConfig(**CASES[name][1])
    ref = pb.PallasSpMV(RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr,
                               csr.col_idx, csr.values), dtype=dtype,
                        config=ref_cfg, force_streamed=True)
    _close(y, np.asarray(ref(x)).astype(np.float64), golden, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["wide_long", "hub", "subplan", "empty"])
def test_one_step_is_resident_loop_plain(name, dtype, monkeypatch):
    """With a schedule, ``spmv_fn`` (and its ``plain`` form) is
    ``resident_loop_plain(..., 1)`` bit for bit; without one (the empty
    plan), the reference-order glue.  No residue sub-plan is run."""
    rng = np.random.default_rng(1)
    csr, op = _operator(name, dtype, monkeypatch, rng)
    meta, arrays = op._meta, op._arrays
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    y = op.device_call(x2d)
    assert torch.equal(y, cb.spmv_fn(meta, arrays, x2d, plain=True))
    if arrays["resident"] is None:
        glue = cb._narrow(meta, cb._wide(meta, arrays, x2d[None], True,
                                         False)[0])
        assert torch.equal(y, glue)
        return
    assert torch.equal(y, resident.resident_loop_plain(meta, arrays, x2d, 1))
    monkeypatch.setattr(cb, "_wide", None)      # the glue is never reached
    assert torch.equal(op.device_call(x2d), y)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_unchanged_by_dropped_last_tap(dtype, monkeypatch):
    """A chain of 5 on a plan without a residue gives, bit for bit, the y
    of the chain that still tapped after its last step (restated here
    from the plain pieces), with TAP raised to 0.25 so that every tap
    shows; and x2d is never written."""
    monkeypatch.setattr(cb, "TAP", 0.25)
    rng = np.random.default_rng(2)
    csr, op = _operator("wide_long", dtype, monkeypatch, rng)
    meta, arrays = op._meta, op._arrays
    assert arrays["overflow"] is None
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    keep = x2d.clone()
    got = resident.resident_loop_plain(meta, arrays, x2d, 5)
    assert torch.equal(x2d, keep)
    x = x2d.clone()
    for _ in range(5):
        y2 = resident.y2_plain(meta, arrays, x)
        out = outgather_plain(arrays["resident"]["src"], arrays["out_perm"],
                              y2)
        x = x + y2[0] * 0.25
    want = cb._narrow(meta, out.reshape(-1)[:meta.n_rows])
    assert torch.equal(got, want)
    assert not torch.equal(got, op.device_call(x2d))


def _sum(terms):
    """Left-to-right rounded sum in the terms' own dtype."""
    return functools.reduce(operator.add, terms)


def _residue_by_tables(res, x, n_out):
    """csrc/resident.cu's residue, restated in numpy from the tables the
    kernel reads (the tasks, the rows, the block table): the row sums of
    phase A and what phase D adds at each word of out."""
    ent, task = res["res_ent"].numpy(), res["res_task"].numpy()
    cols, vals = res["res_cols"].numpy(), res["res_vals"].numpy()
    prod = lambda s: vals[s] * x[cols[s]]
    zero = vals.dtype.type(0)
    rsum = np.full(ent.shape[0], np.nan, vals.dtype)
    for first, n in task:
        for e in range(first, first + n):
            s0, length, w = ent[e]
            if w >= resident.RES_WARP_MIN:
                assert n == 1
                lanes = [_sum([prod(s0 + k) if k < length else zero
                               for k in range(i, w, resident.RES_LANES)])
                         for i in range(resident.RES_LANES)]
                for s_ in resident.RES_TREE:
                    lanes = [lanes[i] + lanes[i + s_] for i in range(s_)]
                rsum[e] = lanes[0]
            else:
                acc = _sum([prod(s0 + k) for k in range(length)])
                rsum[e] = acc + zero if w > length else acc
    add = {}
    bptr, bent = res["res_bptr"].numpy(), res["res_bent"].numpy()
    for b in range(bptr.size - 1):
        for e in bent[bptr[b]:bptr[b + 1]]:
            row = b * LANES + (e & 127)
            assert row < n_out and row not in add
            add[row] = rsum[e >> 7]
    return add


@pytest.mark.parametrize("dtype", DTYPES)
def test_residue_order_with_hub_rows(dtype, monkeypatch):
    """On the fixture whose residue holds trees of 256 and 128 slots: the
    kernel's tables put those rows first, a warp (a task) each, and add
    every residue row exactly once; the plain residue equals, bit for bit,
    the kernel's order restated in numpy from those tables; and the plain
    one-step y is the outgather's y plus those sums, one add a row."""
    rng = np.random.default_rng(3)
    csr, op = _operator("hub", dtype, monkeypatch, rng)
    meta, arrays = op._meta, op._arrays
    res, o = arrays["resident"], arrays["overflow"]
    ent, task = res["res_ent"].numpy(), res["res_task"].numpy()
    n_warp = int((ent[:, 2] >= resident.RES_WARP_MIN).sum())
    assert n_warp >= 2 and ent[:, 2].max() >= 256
    assert np.all(ent[:n_warp, 2] >= resident.RES_WARP_MIN)
    assert np.all(task[:n_warp, 1] == 1)
    assert np.array_equal(task[:n_warp, 0], np.arange(n_warp))
    assert task[n_warp:, 1].max() == resident.RES_LANES
    x2d = op._prep_x(rng.standard_normal(csr.n_cols))
    add = _residue_by_tables(res, x2d.reshape(-1).numpy(),
                             meta.B_pad * LANES)
    plain = resident.residue_plain(o, x2d)[o["sort_back"]].numpy()
    rows = o["tree_rows"].numpy()
    assert sorted(add) == sorted(rows.tolist())
    np.testing.assert_array_equal(plain, [add[r] for r in rows])
    y = resident.resident_loop_plain(meta, arrays, x2d, 1)
    y2 = resident.y2_plain(meta, arrays, x2d)
    out = outgather_plain(res["src"], arrays["out_perm"], y2).reshape(-1)
    out[rows] = out[rows] + torch.from_numpy(plain)
    assert torch.equal(y, cb._narrow(meta, out[:meta.n_rows]))


def test_residue_plain_sums_in_sequence():
    """The plain residue's order on hand-made trees: a row of 5 slots in
    a tree of 8 adds its products left to right and then the padding's
    zero; a row of 40 in a tree of 64 adds by lanes, then a lane tree.
    Values chosen so that another order gives another float32 sum."""
    vals = np.array([1e8, 1.0, -1e8, 1.0, 3.0] + [1.0] * 40, np.float32)
    vals[5] = 1e8
    x2d = torch.ones((1, LANES), dtype=torch.float32)
    cols = torch.zeros(vals.size, dtype=torch.int64)
    nnz = vals.size
    t8 = np.array([[0, 1, 2, 3, 4, nnz, nnz, nnz]])
    t64 = np.full((1, 64), nnz)
    t64[0, :40] = np.arange(5, 45)
    o = dict(vals=torch.from_numpy(vals), cols=cols,
             trees=[torch.from_numpy(t8), torch.from_numpy(t64)])
    got = resident.residue_plain(o, x2d).numpy()
    f = np.float32
    seq = f(f(f(f(f(1e8) + f(1)) + f(-1e8)) + f(1)) + f(3))
    lanes = [vals[5 + i] + (vals[5 + i + 32] if i < 8 else f(0))
             for i in range(32)]
    for s_ in resident.RES_TREE:
        lanes = [f(lanes[i] + lanes[i + s_]) for i in range(s_)]
    np.testing.assert_array_equal(got, np.array([seq, lanes[0]], f))
    assert got[0] != f(sum(vals[:5].astype(np.float64)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_force_streamed_carries_a_schedule(dtype, monkeypatch):
    """A force_streamed operator has the schedule but is not resident:
    its timing loop runs one K6 step a SpMV (iters + 1 calls of
    resident_loop at one step), a resident one the chain in one call,
    and the two y's agree within the dtype's tolerance."""
    rng = np.random.default_rng(4)
    csr, sop = _operator("hub", dtype, monkeypatch, rng,
                         force_streamed=True)
    rop = dt.SpMVOperator(sop.plan, dtype=dtype, device="cpu")
    assert sop._arrays["resident"] is not None and not sop.resident
    assert rop.resident
    calls = []
    loop_fn = resident.resident_loop

    def counted(meta, arrays, x2d, iters, stamps=None):
        calls.append(iters)
        return loop_fn(meta, arrays, x2d, iters, stamps)
    monkeypatch.setattr(resident, "resident_loop", counted)
    x = rng.standard_normal(csr.n_cols)
    x2d = sop._prep_x(x)
    y_s = sop.timing_loop(3)(x2d)
    assert calls == [1] * 4
    y_r = rop.timing_loop(3)(x2d)
    assert calls == [1] * 4 + [3]
    golden = _golden(csr, x, dtype)
    _close(sop.perm_out(y_s.double().numpy()),
           rop.perm_out(y_r.double().numpy()), golden, TOL[dtype])


@pytest.mark.parametrize("what", ["slot", "task", "wide_task", "block"])
def test_to_device_refuses_bad_residue(what):
    """Residue tables that read past the residue, leave a row out of the
    tasks, put a warp-wide row in a task of several, or add a row in two
    blocks are refused before upload."""
    rng = np.random.default_rng(3)
    csr = _hub(rng)
    meta, arrays = cb.plan_to_arrays(
        dt.build_wplan(csr, DaspConfig(relabel="off", fill_dump=0.1)))
    resident.prepare(meta, arrays)
    res = arrays.pop("resident")
    streams = cb.arrays_to_device(meta, arrays, "cpu")["streams"]
    resident.to_device(meta, res, streams, "cpu")      # as prepared: fine
    bad = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in res.items()}
    if what == "slot":
        bad["res_ent"][-1, 0] = bad["res_vals"].shape[0]
    elif what == "task":
        bad["res_task"] = bad["res_task"][:-1]
    elif what == "wide_task":
        bad["res_task"][0, 1] = 2
    else:
        bad["res_bent"][1] = bad["res_bent"][0]
    with pytest.raises(ValueError):
        resident.to_device(meta, bad, streams, "cpu")
