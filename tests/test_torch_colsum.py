"""K1/K3, the single-vector colsum, as the kv = 1 instance of K5's kernel.

On the card ``colsum`` launches the kv = 1 instance of
``csrc/colsum_multi.cu`` and is held to ``colsum_plain`` bit for bit by
``chip_smoke.py``; that rests on the identity held here on the CPU:
``colsum_plain`` is ``colsum_multi_plain`` at kv = 1, and both equal a
numpy emulation of the slot semantics (the cell lookup, the round tag
clamped to P-1, each level's sublanes summed in order) exactly, in f32,
bf16 and f64 values, at strides 2, 4 and 8, on the packer's streams and
on synthetic ones with P = 1 (nonzero round tags), P = 32, pad vregs and
no vregs.  The wrappers' refusals (P over the packer's cap, a stride the
kernel has no instance for) are the same on the CPU as on the card, and
the C entry points that ``ops/_build.py`` binds are read from the sources,
since a missing or doubled one would fail only where nvcc runs.

Exact equality throughout: every side multiplies the same words once and
adds the same products in the same order, so no tolerance applies.
"""

import os
import re

import numpy as np
import pytest
import torch

import dasp_tpu_torch as dt
from dasp_tpu_torch import sparse as tsp
from dasp_tpu_torch.ops import _build
from dasp_tpu_torch.ops.colsum import MAX_P, colsum, colsum_plain
from dasp_tpu_torch.ops.colsum_multi import colsum_multi, colsum_multi_plain
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
VALUES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
STRIDES = (2, 4, 8)

# powerlaw_deg: P=1 and P=4 streams at stride 8, P=6 at stride 2; short4:
# one P=3 stream at stride 4 (as tests/test_torch_kernels.py)
PACKED = {
    "powerlaw_deg": lambda rng: tsp.powerlaw_like(20_000, 1.7, 20_000, rng,
                                                  col_alpha=1.6),
    "short4": lambda rng: tsp.random_csr(3000, 3000, np.full(3000, 4), rng),
}


def _packed_streams(name, dtype):
    """[(wins, vals, idx)] of every stream of a packed fixture, on the CPU,
    and the x table's rows."""
    csr = PACKED[name](np.random.default_rng(0))
    op = dt.SpMVOperator(dt.build_wplan(csr), dtype=dtype, device="cpu",
                         force_streamed=True)
    return ([(st["wins"], st["vals"], st["idx"])
             for st in op._arrays["streams"]], op._meta.s_rows)


def _synthetic(P, nv, n_pad, S, dtype, rng):
    """A stream of nv random vregs with P windows (round tags up to P+3,
    so that the clamp to P-1 matters, within the 5 bits idx gives them),
    then n_pad all-zero pad vregs."""
    lam = rng.integers(0, 128, size=(nv, 8, 128))
    q = rng.integers(0, 8, size=(nv, 8, 128))
    c = rng.integers(0, min(P + 4, 32), size=(nv, 8, 128))
    idx = np.concatenate([(c << 10 | q << 7 | lam).reshape(nv * 8, 128),
                          np.zeros((n_pad * 8, 128), np.int64)])
    wins = np.concatenate([rng.integers(0, S - 8, size=(nv, P + 1)),
                           np.zeros((n_pad, P + 1), np.int64)])
    vals = np.concatenate([rng.standard_normal((nv * 8, 128)),
                           np.zeros((n_pad * 8, 128))])
    return (torch.from_numpy(wins.astype(np.int32)),
            torch.from_numpy(vals).to(VALUES[dtype]),
            torch.from_numpy(idx.astype(np.int16)))


def _emulate(wins, vals, idx, x, stride):
    """numpy: slot (i, j) of vreg v multiplies vals[v,i,j] by
    x[wins[v, 1 + c] + q, lam], lam = idx & 127, with q = (cell>>7)&7 and
    c = min(cell>>10, P-1) read at the cell (i, lam); level L sums the
    products of sublanes L*stride .. L*stride+stride-1 in order."""
    wins, idx = wins.numpy().astype(np.int64), idx.numpy().astype(np.int64)
    vals = vals.to(x.dtype).numpy()         # bf16 -> f32 is exact
    x = x.numpy()
    nv, P = wins.shape[0], wins.shape[1] - 1
    out = np.empty((nv, 8 // stride, 128), x.dtype)
    for v in range(nv):
        tile = idx[v * 8:(v + 1) * 8]
        lam = tile & 127
        cell = np.take_along_axis(tile, lam, axis=1)
        row = wins[v, 1 + np.minimum(cell >> 10, P - 1)] + ((cell >> 7) & 7)
        prod = vals[v * 8:(v + 1) * 8] * x[row, lam]
        for L in range(8 // stride):
            acc = prod[L * stride]
            for s in range(1, stride):
                acc = acc + prod[L * stride + s]
            out[v, L] = acc
    return torch.from_numpy(out.reshape(nv * 8 // stride, 128))


def _x(S, dtype, seed):
    xdt = torch.float64 if dtype == "f64" else torch.float32
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((S, 128))).to(xdt)


def _hold(wins, vals, idx, x, stride):
    """colsum_plain == colsum_multi_plain(kv=1)[0] == the emulation ==
    colsum on the CPU, exactly; returns the emulation's rows."""
    got = colsum_plain(wins, vals, idx, x, stride)
    multi = colsum_multi_plain(wins, vals, idx, x, stride, 1)
    assert multi.shape == (1, *got.shape)
    want = _emulate(wins, vals, idx, x, stride)
    assert got.dtype == want.dtype == x.dtype
    assert torch.equal(got, multi[0]), "colsum_plain != K5 plain at kv = 1"
    assert torch.equal(got, want), "colsum_plain != the slot emulation"
    assert torch.equal(colsum(wins, vals, idx, x, stride), got)
    return want


@pytest.mark.parametrize("dtype", list(VALUES))
@pytest.mark.parametrize("name", list(PACKED))
def test_colsum_is_k5_at_kv1_on_packed_streams(name, dtype):
    """Every stream of the packer's fixtures, summed at every stride."""
    streams, S = _packed_streams(name, dtype)
    x = _x(S, dtype, 1)
    Ps = set()
    for wins, vals, idx in streams:
        Ps.add(wins.shape[1] - 1)
        # a prefix of each stream: the emulation walks vregs in Python
        nv = min(wins.shape[0], 48)
        for stride in STRIDES:
            _hold(wins[:nv], vals[:nv * 8], idx[:nv * 8], x, stride)
    want = {"powerlaw_deg": {1, 4, 6}, "short4": {3}}[name]
    assert want <= Ps, f"fixture no longer covers P {want - Ps}"


@pytest.mark.parametrize("dtype", list(VALUES))
@pytest.mark.parametrize("P", [1, 5, MAX_P])
def test_colsum_is_k5_at_kv1_on_synthetic_streams(P, dtype):
    """P = 1 with round tags past it (the clamp), an odd P and the cap;
    pad vregs give zero rows; a stream of no vregs gives no rows."""
    rng = np.random.default_rng(P)
    S = 300
    wins, vals, idx = _synthetic(P, 37, 3, S, dtype, rng)
    x = _x(S, dtype, 2)
    for stride in STRIDES:
        R = 8 // stride
        out = _hold(wins, vals, idx, x, stride)
        assert out.shape == (40 * R, 128)
        assert not out[37 * R:].any(), "pad vregs must give zero rows"
        assert out[:37 * R].abs().sum() > 0
        empty = _hold(wins[:0], vals[:0], idx[:0], x, stride)
        assert empty.shape == (0, 128)


def test_colsum_refuses_what_the_kernel_refuses():
    """P over the packer's cap and a stride without an instance raise on
    the CPU too, before the device is looked at, for K1/K3 and K5 alike."""
    rng = np.random.default_rng(0)
    x = _x(300, "f32", 3)
    wins, vals, idx = _synthetic(MAX_P + 1, 2, 0, 300, "f32", rng)
    with pytest.raises(ValueError, match="P 33"):
        colsum(wins, vals, idx, x, 8)
    with pytest.raises(ValueError, match="P 33"):
        colsum_multi(wins, vals, idx, x, 8, 1)
    wins, vals, idx = _synthetic(4, 2, 0, 300, "f32", rng)
    for stride in (1, 3, 16):
        with pytest.raises(ValueError, match=f"stride {stride}"):
            colsum(wins, vals, idx, x, stride)
    with pytest.raises(ValueError, match="P 0"):
        colsum(wins[:, :1].contiguous(), vals, idx, x, 8)
    assert colsum.launches == dict.fromkeys(colsum.launches, 0)


def test_every_bound_entry_point_is_defined_once():
    """Each C name ops/_build.py binds (SIGNATURES and the error-name
    helper) is defined by exactly one extern "C" in csrc/*.cu, no other is
    defined, and K1/K3's old entries are gone: the kv = 1 instance of
    dasp_colsum_multi_* is their kernel."""
    defined = []
    for f in sorted(os.listdir(_build.SRC_DIR)):
        if not f.endswith(".cu"):
            continue
        with open(os.path.join(_build.SRC_DIR, f)) as fh:
            text = fh.read()
        defined += re.findall(r'extern\s+"C"[^(;{]*?\b(dasp_\w+)\s*\(', text)
        # entries a macro defines: #define M(NAME, ...) ... extern "C" ...
        # NAME(, instantiated as M(dasp_..., ...)
        for macro in re.findall(r'#define\s+(\w+)\(NAME\b[^\n]*\\\n'
                                r'(?:[^\n]*\\\n)*?[^\n]*extern\s+"C"[^(]*'
                                r'\bNAME\s*\(', text):
            defined += re.findall(rf'^{macro}\((dasp_\w+)', text, re.M)
    bound = set(_build.SIGNATURES) | {"dasp_cuda_error_name"}
    assert sorted(defined) == sorted(bound), (
        f"defined {sorted(defined)}, bound {sorted(bound)}")
    for d in VALUES:
        assert f"dasp_colsum_{d}" not in defined
        assert f"dasp_colsum_multi_{d}" in defined
    assert not os.path.exists(os.path.join(_build.SRC_DIR, "colsum.cu"))
