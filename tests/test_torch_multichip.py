"""The port's multi-device SpMV (dasp_tpu_torch.parallel) on the CPU: its
partition functions against dasp_tpu.parallel's, MultiChipSpMV on eight
chips that share the CPU against the JAX package's MultiChipSpMV on the
eight simulated host devices of tests/conftest.py (interpret-mode Pallas),
and the mirrors of every test of tests/test_multichip.py."""

import jax
import numpy as np
import pytest
import torch

import dasp_tpu.parallel as ref
from dasp_tpu.config import DaspConfig as RefConfig
from dasp_tpu.sparse import CSRMatrix as RefCSR
import dasp_tpu_torch
from dasp_tpu_torch import parallel as par
from dasp_tpu_torch.bench import check
from dasp_tpu_torch.config import DaspConfig
from dasp_tpu_torch.ops import resident
from dasp_tpu_torch.sparse import mixed_categories, powerlaw_like
from dasp_tpu_torch.spmv import SpMVOperator
from dasp_tpu_torch.wplan import build_wplan

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
TOL = {"f32": 2e-5, "f64": 1e-10}


def _ref(csr):
    return RefCSR(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                  csr.values)


def _scaled(y, golden):
    return float((np.abs(y - golden) / np.maximum(np.abs(golden),
                                                  1.0)).max())


def _same_csr(a, b):
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    for f in ("row_ptr", "col_idx", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


PARTITION_INPUTS = {
    "powerlaw_1000": lambda rng: powerlaw_like(1000, 1.9, 3000, rng),
    "mixed_300": lambda rng: mixed_categories(300, rng),
    "powerlaw_120k": lambda rng: powerlaw_like(120_000, 1.8, 600_000, rng,
                                               col_alpha=1.6),
}


@pytest.mark.parametrize("name", PARTITION_INPUTS)
def test_partitions_match_reference(rng, name):
    csr = PARTITION_INPUTS[name](rng)
    rc = _ref(csr)
    for n in (1, 3, 8):
        assert par.partition_rows(csr, n) == ref.partition_rows(rc, n)
        for align, per in ((128, 8), (64, 3)):
            ours = par.partition_strips(csr, n, align, per)
            assert ours == ref.partition_strips(rc, n, align, per)
            for strips in ours[0]:
                _same_csr(par.strips_csr(csr, strips),
                          ref.strips_csr(rc, strips))
    _same_csr(par.strips_csr(csr, []), ref.strips_csr(rc, []))
    s, e = csr.n_rows // 5, csr.n_rows // 2
    _same_csr(par.slab_csr(csr, s, e), ref.slab_csr(rc, s, e))


def test_partition_balanced(rng):
    csr = powerlaw_like(1000, 1.9, 3000, rng)
    slabs = par.partition_rows(csr, 8)
    assert slabs[0][0] == 0 and slabs[-1][1] == csr.n_rows
    for (a, b), (c, d) in zip(slabs, slabs[1:]):
        assert b == c
    nnzs = [int(csr.row_ptr[e] - csr.row_ptr[s]) for s, e in slabs]
    assert sum(nnzs) == csr.nnz
    assert max(nnzs) <= 2.5 * csr.nnz / 8 + max(csr.row_lengths)


def test_slab_extraction(rng):
    csr = mixed_categories(300, rng)
    sub = par.slab_csr(csr, 50, 120)
    sub.check()
    np.testing.assert_array_equal(sub.to_dense(), csr.to_dense()[50:120])


JAX_CASES = {
    "mixed_1200_f32": ("mixed", "f32", {}),
    "mixed_1200_f64": ("mixed", "f64", {}),
    "powerlaw_2000_f32": ("powerlaw", "f32", {}),
    "powerlaw_2000_first_touch": ("powerlaw", "f32",
                                  {"relabel": "first_touch"}),
}


@pytest.mark.parametrize("case", JAX_CASES)
def test_matches_jax_multichip(rng, case):
    """The same seeded x through the JAX package's MultiChipSpMV (windowed
    Pallas kernels under shard_map, harmonized plans) and the port's (one
    operator per chip): the same strips and relabel, and y within the
    tolerance of each other and of the golden."""
    kind, dtype, cfg = JAX_CASES[case]
    csr = (mixed_categories(1200, rng) if kind == "mixed"
           else powerlaw_like(2000, 1.8, 4000, rng, col_alpha=1.6))
    x = rng.standard_normal(csr.n_cols)
    assert len(jax.devices()) == 8, "conftest must provide 8 host devices"
    theirs = ref.MultiChipSpMV(_ref(csr), dtype=dtype, config=RefConfig(**cfg))
    ours = par.MultiChipSpMV(csr, devices=CPU8, dtype=dtype,
                             config=DaspConfig(**cfg))
    assert ours.n_devices == theirs.n_devices == 8
    assert ours.strips == theirs.strips
    assert ours.stats["slab_nnz"] == theirs.stats["slab_nnz"]
    assert ours.stats["balance"] == theirs.stats["balance"]
    if cfg:
        assert ours.col_perm is not None
    if theirs.col_perm is None:
        assert ours.col_perm is None
    else:
        np.testing.assert_array_equal(ours.col_perm, theirs.col_perm)
    golden = csr.spmv(x)
    y, y_ref = ours(x), theirs(x)
    assert y.dtype == y_ref.dtype == np.float64 and y.shape == golden.shape
    tol = TOL[dtype]
    assert _scaled(y_ref, golden) <= tol
    assert _scaled(y, golden) <= tol
    assert _scaled(y, y_ref) <= tol


# the reference's two tests of its scatter executor (backend="xla"): their
# fixtures and tolerances, through the port's only executor
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_multichip_matches_golden(rng, dtype):
    csr = mixed_categories(900, rng)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype=dtype)
    assert op.n_devices == 8
    x = rng.standard_normal(csr.n_cols)
    assert _scaled(op(x), csr.spmv(x)) <= (1e-5 if dtype == "f32"
                                           else 1e-10)


def test_multichip_powerlaw(rng):
    csr = powerlaw_like(800, 1.8, 4000, rng)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype="f32")
    x = rng.standard_normal(csr.n_cols)
    assert _scaled(op(x), csr.spmv(x)) <= 2e-5


def test_multichip_scale_balance(rng):
    """120,000 rows with a power-law tail: every nonzero on a chip, the
    nnz balance within 1.5x of the mean, no chip padded, and y within
    2e-6 of the golden scaled by the mass |A||x| (a hub row's dot product
    cancels to ~1e-1 from ~1e5 of mass)."""
    csr = powerlaw_like(120_000, 1.8, 600_000, rng, col_alpha=1.6)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype="f32")
    assert sum(op.stats["slab_nnz"]) == csr.nnz
    assert op.stats["balance"] <= 1.5, op.stats
    assert op.stats["pad_vregs"] == [0] * 8
    assert all(r > 0 for r in op.stats["real_vregs"])
    x = rng.standard_normal(csr.n_cols)
    golden, scale = check.golden_mass(csr, x, "f32")
    assert check.scaled_error(op(x), golden, scale) <= 2e-6


@pytest.mark.parametrize("force_streamed", [False, True])
def test_multichip_timing_loop(rng, monkeypatch, force_streamed):
    """The bench's chained loop agrees with one step (the 1e-36 taps are
    below f32 resolution).  A step is one K6 call at one step per chip;
    a loop, resident: one K6 call of 3 steps per chip, streamed: four
    steps; the pieces of x are never written."""
    csr = mixed_categories(900, rng)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype="f32",
                           force_streamed=force_streamed)
    assert op.resident is op.stats["resident"] is (not force_streamed)
    calls = []
    loop_fn = resident.resident_loop

    def counted(meta, arrays, x2d, iters, stamps=None):
        calls.append(iters)
        return loop_fn(meta, arrays, x2d, iters, stamps)
    monkeypatch.setattr(resident, "resident_loop", counted)
    x = rng.standard_normal(csr.n_cols)
    pieces = op._prep_x(x)
    kept = [p.clone() for p in pieces]
    y_step = op.stitch(op.step(pieces))
    y_loop = op.stitch(op.timing_loop(3)(pieces))
    chips = sum(c is not None for c in op.chips)
    assert calls == [1] * chips + ([1] * (4 * chips) if force_streamed
                                   else [3] * chips)
    assert all(torch.equal(a, b) for a, b in zip(pieces, kept))
    np.testing.assert_allclose(y_loop, y_step, rtol=2e-5, atol=2e-4)
    assert _scaled(y_loop, csr.spmv(x)) <= 2e-5


def test_multichip_f64_runs_resident(rng):
    """f64 chips run resident (K6 in fp64), where the reference keeps them
    streamed (its test_multichip_resident_f64_streams): each chip is its
    own program, so nothing forces one shape on all of them."""
    csr = mixed_categories(900, rng)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype="f64")
    assert op.stats["resident"] is True
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    assert _scaled(op(x), golden) <= 1e-10
    y_loop = op.stitch(op.timing_loop(2)(op._prep_x(x)))
    assert _scaled(y_loop, golden) <= 1e-10


def test_multichip_bf16(rng):
    csr = powerlaw_like(2000, 1.8, 4000, rng, col_alpha=1.6)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype="bf16")
    x = rng.standard_normal(csr.n_cols)
    golden, scale = check.golden_mass(csr, x, "bf16")
    assert check.scaled_error(op(x), golden, scale) <= check.E2E_TOL["bf16"]


@pytest.mark.parametrize("force_streamed", [False, True])
def test_multichip_empty_chips(rng, force_streamed):
    """300 rows make three 128-row blocks for eight chips: five chips get
    no strip, no operator and an empty y, and the step, the stitch and
    both timing loops pass them by."""
    csr = mixed_categories(300, rng)
    op = par.MultiChipSpMV(csr, devices=CPU8, dtype="f32",
                           force_streamed=force_streamed)
    empty = [i for i, c in enumerate(op.chips) if c is None]
    assert len(empty) == 5
    for i in empty:
        assert op.strips[i] == [] and op.stats["slab_nnz"][i] == 0
        assert op.stats["real_vregs"][i] == 0 and op.overflows[i] is None
    assert op.resident is not force_streamed
    x = rng.standard_normal(csr.n_cols)
    golden = csr.spmv(x)
    ys = op.step(op._prep_x(x))
    assert all(ys[i].numel() == 0 for i in empty)
    assert _scaled(op.stitch(ys), golden) <= 2e-5
    y_loop = op.stitch(op.timing_loop(2)(op._prep_x(x)))
    assert _scaled(y_loop, golden) <= 2e-5


def test_one_chip_is_the_single_device_operator(rng):
    """One chip holds the whole matrix in row order: the single-device
    operator on the same plan, bit for bit."""
    csr = mixed_categories(700, rng)
    cfg = DaspConfig(relabel="off", row_sort="off")
    op = par.MultiChipSpMV(csr, devices=["cpu"], config=cfg)
    x = rng.standard_normal(csr.n_cols)
    one = SpMVOperator(build_wplan(csr, cfg), device="cpu")
    np.testing.assert_array_equal(op(x), one(x).astype(np.float64))


def test_default_devices_are_the_cards_never_the_cpu(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        par.MultiChipSpMV(mixed_categories(100, rng))


def test_exports():
    assert par.WMultiChipSpMV is par.MultiChipSpMV
    assert not hasattr(dasp_tpu_torch, "MultiChipSpMV")
    assert "MultiChipSpMV" not in dasp_tpu_torch.__all__
