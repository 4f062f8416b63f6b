"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions
(``colsum_plain``, ``outgather_plain``); the Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  Both sides read
the very same tables (``arrays_from_reference``).  The CUDA kernels
themselves are checked against the plain versions on the card by
``chip_smoke.py`` (this file imports JAX, which that machine lacks).

Tolerances, on the error scaled by max(|ref|, 1):
- 1e-6 for f32 and bf16 values: both sides multiply the same f32 words
  (bf16 values upcast exactly), and their sums of at most 8 (colsum) or 7
  (outgather) terms differ only in order;
- 1e-10 for f64: the port runs native fp64 on hi + lo of the reference's
  double-double tables (within 2^-48 of the split values), the reference
  double-double arithmetic (~2^-44 per operation), so the two differ by a
  few units of 2^-44 of the row's mass.
"""

import numpy as np
import pytest
import torch

from dasp_tpu.ops import dd, pallas_backend as pb
from dasp_tpu.sparse import (CSRMatrix, circuit_like, mixed_categories,
                             powerlaw_like, random_csr)
from dasp_tpu.wplan import build_wplan
from dasp_tpu_torch.ops import cuda_backend as cb
from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
from dasp_tpu_torch.ops.outgather import outgather, outgather_plain
from dasp_tpu_torch.wplan import K_SOURCES

torch.set_num_threads(1)
TOL = 1e-6
TOL_F64 = 1e-10


def _split_fixture(rng, n=26 * 64 * 128):
    """Mixed head over identity rows: engages the range-split outgather
    (same fixture as test_torch_host.py)."""
    head = mixed_categories(256, rng)
    lens = np.concatenate([head.row_lengths, np.ones(n - 256, np.int64)])
    rpt = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=rpt[1:])
    cols = np.concatenate([head.col_idx, np.arange(256, n, dtype=np.int32)])
    vals = np.concatenate([head.values, rng.standard_normal(n - 256)])
    return CSRMatrix(n, n, rpt, cols, vals)


# circuit: P=6 at stride 2; powerlaw_deg: P=1 and P=4 at stride 8, P=6
# at stride 2; short4: rows of 4 nnz only, one P=3 stream at stride 4
COLSUM_CASES = {
    "circuit": lambda rng: circuit_like(6000, rng),
    "powerlaw_deg": lambda rng: powerlaw_like(20_000, 1.7, 20_000, rng,
                                              col_alpha=1.6),
    "short4": lambda rng: random_csr(3000, 3000, np.full(3000, 4), rng),
}
OUTGATHER_CASES = {
    "mixed": lambda rng: mixed_categories(500, rng),
    "og_split": _split_fixture,
}


def _lowered(csr, dtype="f32"):
    """Reference lowering -> (port meta, CPU tensors), plus the reference's
    numpy tables."""
    ref_meta, ref_arrays = pb.plan_to_arrays(build_wplan(csr), dtype)
    meta, arrays = cb.arrays_from_reference(ref_meta, ref_arrays, "cpu")
    return ref_meta, ref_arrays, meta, arrays


def _scaled_err(ours, ref):
    ref = np.asarray(ref, dtype=np.float64)
    ours = np.asarray(ours, dtype=np.float64)
    return float((np.abs(ours - ref) / np.maximum(np.abs(ref), 1.0)).max(
        initial=0.0))


@pytest.mark.parametrize("name", list(COLSUM_CASES))
def test_colsum_plain_matches_pallas(name):
    rng = np.random.default_rng(0)
    csr = COLSUM_CASES[name](rng)
    ref_meta, ref_arrays, meta, arrays = _lowered(csr)
    x2d = rng.standard_normal((meta.s_rows, 128)).astype(np.float32)
    xt = torch.from_numpy(x2d)
    seen = set()
    for (P, stride, nv), st, ref_st in zip(meta.streams, arrays["streams"],
                                           ref_arrays["streams"]):
        ref = pb._make_colsum(P, meta.s_rows, nv, True, stride)(
            ref_st["wins"], ref_st["vals"], ref_st["idx"], x2d)
        ours = colsum(st["wins"], st["vals"], st["idx"], xt, stride)
        assert ours.shape == (nv * 8 // stride, 128)
        assert _scaled_err(ours.numpy(), ref) <= TOL, (P, stride)
        seen.add((P > 1, stride))
    want = {"circuit": {(True, 2)}, "powerlaw_deg": {(False, 8), (True, 8),
                                                     (True, 2)},
            "short4": {(True, 4)}}[name]
    assert want <= seen, f"fixture no longer covers {want - seen}"


@pytest.mark.parametrize("name", list(OUTGATHER_CASES))
def test_outgather_plain_matches_pallas(name):
    rng = np.random.default_rng(0)
    csr = OUTGATHER_CASES[name](rng)
    ref_meta, ref_arrays, meta, arrays = _lowered(csr)
    x2d = torch.from_numpy(
        rng.standard_normal((meta.s_rows, 128)).astype(np.float32))
    partials = [colsum_plain(st["wins"], st["vals"], st["idx"], x2d, s)
                for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    y2, _ = cb.stack_y2(meta, arrays, partials, x2d)
    y2n = y2.numpy()
    assert not y2n[meta.n_y2_rows].any(), "zero row must be zero"
    R2 = y2n.shape[0]
    if len(ref_meta.og_ranges) > 1:
        ref = np.concatenate([
            np.asarray(pb._make_outgather(b1 - b0, R2, k, True)(s, p, y2n))
            for (b0, b1, k), s, p in zip(ref_meta.og_ranges,
                                         ref_arrays["og_src"],
                                         ref_arrays["og_perm"])])
    else:
        ref = pb._make_outgather(meta.B_pad, R2, meta.k_used, True)(
            ref_arrays["out_src"], ref_arrays["out_perm"], y2n)
    ours = outgather(arrays["out_src"], arrays["out_perm"], y2,
                     meta.n_y2_rows)
    assert ours.shape == (meta.B_pad, 128)
    assert _scaled_err(ours.numpy(), ref) <= TOL
    if name == "og_split":
        assert len(meta.og_ranges) > 1, "fixture must split the outgather"


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never sent to a plain version."""
    meta = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        colsum(meta, meta, meta, meta, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        outgather(meta, meta, meta, 0)


@pytest.mark.parametrize("name", list(COLSUM_CASES))
def test_colsum_plain_bf16_matches_pallas(name):
    """K1 with bf16 values: the port's colsum on the reference's bf16
    tables (carried bit for bit) against _make_colsum on the same tables,
    f32 x."""
    rng = np.random.default_rng(0)
    csr = COLSUM_CASES[name](rng)
    ref_meta, ref_arrays, meta, arrays = _lowered(csr, "bf16")
    x2d = rng.standard_normal((meta.s_rows, 128)).astype(np.float32)
    xt = torch.from_numpy(x2d)
    for (P, stride, nv), st, ref_st in zip(meta.streams, arrays["streams"],
                                           ref_arrays["streams"]):
        assert st["vals"].dtype == torch.bfloat16
        ref = pb._make_colsum(P, meta.s_rows, nv, True, stride)(
            ref_st["wins"], ref_st["vals"], ref_st["idx"], x2d)
        ours = colsum(st["wins"], st["vals"], st["idx"], xt, stride)
        assert ours.dtype == torch.float32
        assert _scaled_err(ours.numpy(), ref) <= TOL, (P, stride)


@pytest.mark.parametrize("name", list(COLSUM_CASES))
def test_colsum_plain_f64_matches_pallas_dd(name):
    """K3: the port's fp64 colsum against _make_colsum_dd's hi + lo, on
    the same tables (the port's values are the reference's hi + lo) and
    the same x (split into hi/lo for the reference)."""
    rng = np.random.default_rng(0)
    csr = COLSUM_CASES[name](rng)
    ref_meta, ref_arrays, meta, arrays = _lowered(csr, "f64")
    x2d = rng.standard_normal((meta.s_rows, 128))
    xh, xl = dd.from_f64(x2d)
    xt = torch.from_numpy(x2d)
    for (P, stride, nv), st, ref_st in zip(meta.streams, arrays["streams"],
                                           ref_arrays["streams"]):
        oh, ol = pb._make_colsum_dd(P, meta.s_rows, nv, True, stride)(
            ref_st["wins"], ref_st["vals_hi"], ref_st["vals_lo"],
            ref_st["idx"], xh, xl)
        ours = colsum(st["wins"], st["vals"], st["idx"], xt, stride)
        assert ours.dtype == torch.float64
        assert ours.shape == (nv * 8 // stride, 128)
        assert _scaled_err(ours.numpy(), dd.to_f64(np.asarray(oh),
                                                  np.asarray(ol))) <= TOL_F64


@pytest.mark.parametrize("name", list(OUTGATHER_CASES))
def test_outgather_plain_f64_matches_pallas_dd(name):
    """K4: the port's fp64 outgather against _make_outgather_dd on the
    same y2, split into hi/lo pairs for the reference."""
    rng = np.random.default_rng(0)
    csr = OUTGATHER_CASES[name](rng)
    ref_meta, ref_arrays, meta, arrays = _lowered(csr, "f64")
    x2d = torch.from_numpy(rng.standard_normal((meta.s_rows, 128)))
    partials = [colsum_plain(st["wins"], st["vals"], st["idx"], x2d, s)
                for (_, s, _), st in zip(meta.streams, arrays["streams"])]
    y2, _ = cb.stack_y2(meta, arrays, partials, x2d)
    assert y2.dtype == torch.float64
    yh, yl = dd.from_f64(y2.numpy())
    R2 = yh.shape[0]
    if len(ref_meta.og_ranges) > 1:
        pairs = [pb._make_outgather_dd(b1 - b0, R2, k, True)(s, p, yh, yl)
                 for (b0, b1, k), s, p in zip(ref_meta.og_ranges,
                                              ref_arrays["og_src"],
                                              ref_arrays["og_perm"])]
        ref = np.concatenate([dd.to_f64(np.asarray(h), np.asarray(lo))
                              for h, lo in pairs])
    else:
        h, lo = pb._make_outgather_dd(meta.B_pad, R2, meta.k_used, True)(
            ref_arrays["out_src"], ref_arrays["out_perm"], yh, yl)
        ref = dd.to_f64(np.asarray(h), np.asarray(lo))
    ours = outgather(arrays["out_src"], arrays["out_perm"], y2,
                     meta.n_y2_rows)
    assert ours.dtype == torch.float64 and ours.shape == (meta.B_pad, 128)
    assert _scaled_err(ours.numpy(), ref) <= TOL_F64


def test_wrappers_refuse_other_dtypes():
    """A value or y2 dtype that no kernel instance takes, or an x table
    of another dtype than the values', raises on either device."""
    wins = torch.zeros((1, 2), dtype=torch.int32)
    idx = torch.zeros((8, 128), dtype=torch.int16)
    x32 = torch.zeros((8, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported value dtype"):
        colsum(wins, torch.zeros((8, 128), dtype=torch.float16), idx, x32, 8)
    with pytest.raises(ValueError, match="x must be"):
        colsum(wins, torch.zeros((8, 128), dtype=torch.float64), idx, x32, 8)
    with pytest.raises(ValueError, match="x must be"):
        colsum(wins, torch.zeros((8, 128), dtype=torch.bfloat16), idx,
               x32.double(), 8)
    src = torch.zeros((1, 1), dtype=torch.int32)
    perm = torch.zeros((1, 1, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported y2 dtype"):
        outgather(src, perm, torch.zeros((2, 128), dtype=torch.bfloat16), 1)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_outgather_plain_empty_and_full_blocks(dtype):
    """Blocks whose K_SOURCES slots all name the zero row give zeros;
    blocks with every slot used give their slots' gathers summed in slot
    order from zero (a numpy restatement of the kernel's adds, bit for
    bit), and both agree with _make_outgather (_make_outgather_dd for
    f64) in interpret mode."""
    rng = np.random.default_rng(11)
    B, R2 = pb.OB, 40
    zero = R2 - 1
    src = rng.integers(0, zero, (B, K_SOURCES)).astype(np.int32)
    src[::2] = zero
    perm = rng.integers(0, 128, (K_SOURCES, B, 128)).astype(np.int8)
    y2 = rng.standard_normal((R2, 128))
    y2[zero] = 0
    y2 = y2.astype(np.float32 if dtype == "f32" else np.float64)
    want = np.zeros((B, 128), y2.dtype)
    lanes = perm.astype(np.int64)
    for b in range(B):
        for k in range(K_SOURCES):
            if src[b, k] != zero:
                want[b] = want[b] + y2[src[b, k], lanes[k, b]]
    ours = outgather(torch.from_numpy(src), torch.from_numpy(perm),
                     torch.from_numpy(y2), zero).numpy()
    np.testing.assert_array_equal(ours, want)
    assert not ours[::2].any() and ours[1::2].all()
    if dtype == "f32":
        ref = pb._make_outgather(B, R2, K_SOURCES, True)(src, perm, y2)
        assert _scaled_err(ours, np.asarray(ref)) <= TOL
    else:
        yh, yl = dd.from_f64(y2)
        h, lo = pb._make_outgather_dd(B, R2, K_SOURCES, True)(src, perm, yh,
                                                              yl)
        assert _scaled_err(ours, dd.to_f64(np.asarray(h),
                                           np.asarray(lo))) <= TOL_F64
