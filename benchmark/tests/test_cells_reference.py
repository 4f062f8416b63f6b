"""The generators, the plain reference, the control's arithmetic and the
model-1 byte count, at sizes worked by hand."""

import os

import numpy as np
import pytest

from benchmark.harness.roofline import PEAK_HBM_BYTES_S, model1_bytes
from benchmark.harness.spec import Spec
from benchmark.reference import csr as ref
from benchmark.reference.lower import cg_below, product_below, tf32
from conftest import ROOT


def _gen(name):
    return Spec(ROOT).generator(name)


def _dense(a):
    d = np.zeros((a.n_rows, a.n_cols))
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.row_ptr))
    np.add.at(d, (rows, a.col_idx), a.values)
    return d


@pytest.mark.parametrize("n", [2, 3, 5])
def test_hpcg_stencil_counts(n):
    rows, cols, rp, ci, v = _gen("hpcg27").generate(
        {"nx": n, "ny": n, "nz": n}, 0)
    assert rows == cols == n ** 3
    assert rp[-1] == (3 * n - 2) ** 3
    lens = np.diff(rp)
    expect = {8: 8, 12: 12 * (n - 2), 18: 6 * (n - 2) ** 2,
              27: (n - 2) ** 3}
    got = dict(zip(*np.unique(lens, return_counts=True)))
    assert got == {k: c for k, c in expect.items() if c}
    a = ref.Csr(rows, cols, rp, ci, v)
    d = _dense(a)
    assert np.array_equal(d, d.T)
    assert np.all(np.diag(d) == 26) and set(np.unique(v)) == {-1.0, 26.0}
    for r in range(rows):                    # ascending columns
        assert np.all(np.diff(ci[rp[r]:rp[r + 1]]) > 0)


def test_hpcg_grid_order_and_neighbours():
    nx, ny, nz = 4, 3, 2
    _, _, rp, ci, _ = _gen("hpcg27").generate(
        {"nx": nx, "ny": ny, "nz": nz}, 0)
    r = 1 + nx * (1 + ny * 0)                # (ix, iy, iz) = (1, 1, 0)
    expect = sorted(x + nx * (y + ny * z) for z in (0, 1)
                    for y in (0, 1, 2) for x in (0, 1, 2))
    assert list(ci[rp[r]:rp[r + 1]]) == expect


def test_kronecker_pattern_is_fixed_and_values_follow_the_seed():
    p = {"scale": 9, "edgefactor": 16, "pattern_seed": 3}
    g = _gen("kronecker")
    n, m, rp, ci, v = g.generate(p, 1)
    _, _, rp2, ci2, v2 = g.generate(p, 2)
    assert n == m == 512 and g.VALUES_SEEDED
    assert np.array_equal(rp, rp2) and np.array_equal(ci, ci2)
    assert not np.array_equal(v, v2)
    assert v.min() >= 0 and v.max() < 1


def test_kronecker_matrix_is_kernel_1s_undirected_graph():
    """Every generated edge in both directions, once; no self-loops."""
    p = {"scale": 8, "edgefactor": 16, "pattern_seed": 4}
    g = _gen("kronecker")
    start, end = g.edges(8, 16, np.random.default_rng(4))
    assert start.size == 16 * 256
    want = {(int(i), int(j)) for i, j in zip(start, end) if i != j}
    want |= {(j, i) for i, j in want}
    n, _, rp, ci, v = g.generate(p, 0)
    rows = np.repeat(np.arange(n), np.diff(rp))
    got = list(zip(rows.tolist(), ci.tolist()))
    assert len(got) == len(set(got)) and set(got) == want
    for r in range(n):                       # ascending columns
        assert np.all(np.diff(ci[rp[r]:rp[r + 1]]) > 0)


def test_kronecker_quadrants_follow_the_initiator():
    """At scale 1 each edge is one draw of the initiator: the diagonal
    quadrants take A and D, the others B and C, whatever the permutation
    of the two labels."""
    start, end = _gen("kronecker").edges(1, 200_000,
                                         np.random.default_rng(5))
    m = start.size
    same = start == end
    diag = sorted([np.mean(same & (start == 0)), np.mean(same & (start == 1))])
    off = [np.mean(~same & (start == 0)), np.mean(~same & (start == 1))]
    assert np.allclose(diag, [0.05, 0.57], atol=4e-3)
    assert np.allclose(off, [0.19, 0.19], atol=4e-3) and m == 400_000


def test_model1_bytes_by_hand():
    # 5 entries of 8 + 4 bytes, 3 + 4 words of x and y at 8 bytes
    assert model1_bytes(3, 4, 5, "f64") == 5 * 12 + 7 * 8 == 116
    assert model1_bytes(3, 4, 5, "f64", kv=8) == 60 + 8 * 56 == 508
    assert model1_bytes(3, 4, 5, "f32") == 5 * 8 + 7 * 4 == 68
    # hpcg104's f64 SpMV: 357.5 MB of A, 18.0 MB of x and y: 112.1 us
    b = model1_bytes(104 ** 3, 104 ** 3, 310 ** 3, "f64")
    assert b == 310 ** 3 * 12 + 2 * 104 ** 3 * 8
    assert abs(b / PEAK_HBM_BYTES_S - 112.1e-6) < 0.1e-6


@pytest.fixture
def small():
    # empty rows, a duplicate entry, a long row
    rp = np.array([0, 3, 3, 5, 5, 11])
    ci = np.array([0, 2, 2, 1, 3, 0, 1, 2, 3, 4, 4], np.int32)
    v = np.arange(1, 12, dtype=np.float64) / 3
    return ref.Csr(5, 5, rp, ci, v)


@pytest.mark.parametrize("block", [1, 2, 3, 1 << 22])
def test_product_against_dense(small, block, monkeypatch):
    monkeypatch.setattr(ref, "BLOCK_NNZ", block)
    rng = np.random.default_rng(0)
    x, X = rng.standard_normal(5), rng.standard_normal((5, 3))
    d = _dense(small)
    assert np.allclose(ref.product(small, x), d @ x, rtol=0, atol=1e-14)
    assert np.allclose(ref.product(small, X), d @ X, rtol=0, atol=1e-14)


def test_judges(small):
    x = np.linspace(-1, 1, 5)
    y = _dense(small) @ x
    assert ref.scaled_error(small, x, y) < 1e-15
    bad = y.copy()
    bad[3] += 1.0
    assert ref.scaled_error(small, x, bad) > 0.01
    assert ref.scaled_error(small, x, y[:4]) == float("inf")
    assert ref.scaled_error(small, x, np.where(y == y, np.nan, y)) \
        == float("inf")
    a = ref.Csr(3, 3, np.array([0, 1, 2, 3]), np.arange(3, dtype=np.int32),
                np.array([2.0, 4.0, 5.0]))
    b = np.array([2.0, 4.0, 5.0])
    assert ref.relative_residual(a, b, np.ones(3)) == 0.0
    assert abs(ref.relative_residual(a, b, np.zeros(3)) - 1.0) < 1e-15


def test_tf32_rounds_to_ten_mantissa_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -10,
                  -(1 + 2.0 ** -12)], np.float32)
    assert list(tf32(x)) == [one, one + 2 * ulp, one + ulp, -one]


def test_control_product_is_float32_of_rounded_operands(small):
    x = np.linspace(-1, 1, 5)
    for below, rnd in (("f32", lambda a: np.float32(a)), ("tf32", tf32)):
        vals = np.asarray(rnd(np.asarray(small.values, np.float32)),
                          np.float64)
        xx = np.asarray(rnd(np.asarray(x, np.float32)), np.float64)
        d = _dense(ref.Csr(5, 5, small.row_ptr, small.col_idx, vals))
        got = product_below(small, x, below)
        assert got.dtype == np.float32
        assert np.allclose(got, d @ xx, rtol=1e-6, atol=1e-6)


def test_cg_below_reaches_float32s_floor():
    rows, cols, rp, ci, v = _gen("hpcg27").generate(
        {"nx": 10, "ny": 10, "nz": 10}, 0)
    a = ref.Csr(rows, cols, rp, ci, v)
    b = ref.product(a, 1 + np.random.default_rng(0).random(cols))
    x, it = cg_below(a, b, 1e-8, 1000, "f32")
    res = ref.relative_residual(a, b, x)
    assert 0 < it < 1000 and 1e-9 < res < 1e-4


def test_a_costly_pattern_is_made_once_and_kept(tiny_root):
    from benchmark.harness import cell
    spec = Spec(tiny_root)
    config = spec.cell("tiny_graph.chain_t").config
    cache = os.path.join(spec.dir, ".cache", "patterns")
    a = cell.make_matrix(spec, config, 1)
    kept = os.listdir(cache)
    b = cell.make_matrix(spec, config, 2)
    assert os.listdir(cache) == kept and len(kept) == 1
    assert np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col_idx, b.col_idx)
    assert not np.array_equal(a.values, b.values)
    n, _, rp, ci, _ = spec.generator("kronecker").generate(config["params"],
                                                           1)
    assert np.array_equal(a.row_ptr, rp) and np.array_equal(a.col_idx, ci)
    other = dict(config, params=dict(config["params"], pattern_seed=6))
    cell.make_matrix(spec, other, 1)
    assert len(os.listdir(cache)) == 2
