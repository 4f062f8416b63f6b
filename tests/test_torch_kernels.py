"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions
(``colsum_plain``, ``outgather_plain``); the Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  Both sides read
the very same tables (``arrays_from_reference``).  The CUDA kernels
themselves are checked against the plain versions on the card by
``chip_smoke.py`` (this file imports JAX, which that machine lacks).

Tolerance 1e-6 on the error scaled by max(|ref|, 1): both sides multiply
the same f32 words, and their sums of at most 8 (colsum) or 7
(outgather) terms differ only in order.
"""

import numpy as np
import pytest
import torch

from dasp_tpu.ops import pallas_backend as pb
from dasp_tpu.sparse import (CSRMatrix, circuit_like, mixed_categories,
                             powerlaw_like, random_csr)
from dasp_tpu.wplan import build_wplan
from dasp_tpu_torch.ops import cuda_backend as cb
from dasp_tpu_torch.ops.colsum import colsum, colsum_plain
from dasp_tpu_torch.ops.outgather import outgather, outgather_plain

torch.set_num_threads(1)
TOL = 1e-6


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


def _lowered(csr):
    """Reference lowering -> (port meta, CPU tensors), plus the reference's
    numpy tables."""
    ref_meta, ref_arrays = pb.plan_to_arrays(build_wplan(csr), "f32")
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
