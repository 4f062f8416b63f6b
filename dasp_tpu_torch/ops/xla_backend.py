"""Tile-plan executor on PyTorch tensors: runs a ``DaspPlan``'s packed
structures as gathers, products, sums and scatter-adds.

The port of ``dasp_tpu/ops/xla_backend.py``, the JAX package's portable
executor (its default off a TPU, ``dasp_tpu/spmv.py:60-66``); the name is
kept so that a reader finds the counterpart, but the executor is PyTorch
ops on whatever device its tensors live on, and reaches none of the
kernels of ``csrc/``.  Structure to ops, as the reference's (:8-21):

* ``ShortStream`` (stride s): products reshaped (T, 8/s, s, 128), summed
  over the stride axis;
* ``Pair13Stream``: slot element 0 -> y1, elements 1..3 summed -> y3;
* ``SellGroup``: summed over the width axis, 128 rows per slice;
* remainder ``SellGroup``: the same sums, scatter-added into y_perm from a
  zero buffer of their own, which is then added once (:255-264);
* ``LongStream``: one partial sum per chunk, reduced through the plan's
  power-of-two gather tree.

Where it differs from the reference:

* one algebra.  f64 is native fp64 throughout (values, x, products,
  sums), where the reference carries double-double f32 pairs (``_DDAlg``,
  ``ops/dd.py``; neither is ported).  bf16 rounds the values and x to
  bf16, multiplies and sums in f32 and rounds y to bf16 (:159-162);
  ``__call__`` returns y's bf16 values as float32, numpy having no
  bfloat16.  The reference's ``_Alg.mul`` (:131-133) rounds each product
  to bf16 as written, but its operator runs jitted, and XLA keeps the
  product in f32 there (excess precision: the round trip through bf16 is
  elided).  The port computes what the jitted reference computes: on the
  CPU it equals it bit for bit on tests/test_spmv.py's mixed fixture,
  where rounding each product would put y 0.08 (scaled by
  max(|golden|, 1)) from both it and the golden of the bf16-rounded A and
  x, past the 0.05 that tests/test_spmv.py:44 holds the reference to.
* indices out of range.  The reference drops scatter positions at
  INT32_MAX (``mode="drop"``) and clips the final take onto a trailing
  zero slot (``mode="clip"``); ``index_add_`` and ``index_select`` raise
  on such an index instead.  The lowerings therefore map every one, once,
  onto two slots past y_perm: ``n_perm`` (ZERO, never written, read by the
  rows that have no slot) and ``n_perm + 1`` (DUMP, written by padding
  slots, never read), so no padding slot adds into a real row.
* on a CUDA card ``index_add_`` adds colliding positions atomically, in
  no fixed order, so the card's y is held to the golden within a
  tolerance, not bit for bit.  (Each medium row spills one tail at most,
  so only DUMP receives more than one add of a scatter.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import plan as plan_module
from ..config import DEFAULT_CONFIG, LANES, SUBLANES
from ..plan import DaspPlan, build_plan
from .cuda_backend import DTYPES, TAP, _to_host

F32, BF16, F64 = DTYPES
_VALUES = {F32: torch.float32, BF16: torch.bfloat16, F64: torch.float64}


class PlanMeta(NamedTuple):
    """Static structure of a lowered plan."""
    dtype: str
    strides: Tuple[int, ...]   # one per ShortStream, in array order
    n_perm: int                # y_perm's slots; ZERO = n_perm, DUMP = + 1


def _acc(dtype: str) -> torch.dtype:
    """The products' and sums' dtype: fp64 for f64, else f32."""
    return torch.float64 if dtype == F64 else torch.float32


def _values(a: np.ndarray, dtype: str, dev) -> torch.Tensor:
    """float64 values -> the plan dtype on ``dev``; bf16 rounds through
    float32, as the reference's ``astype``."""
    host = np.float64 if dtype == F64 else np.float32
    return torch.from_numpy(np.ascontiguousarray(a, dtype=host)).to(
        _VALUES[dtype]).to(dev)


def _index(a: np.ndarray, dev) -> torch.Tensor:
    """An index table as the int32 tensor that index_select and
    index_add_ take, uploaded once."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def plan_to_arrays(plan: DaspPlan, dtype: str, device
                   ) -> Tuple[PlanMeta, Dict]:
    """Lower a host plan to (static meta, dict of tensors on ``device``),
    as the reference's ``plan_to_arrays`` (:52-74).  Remainder positions
    at the dummy slot (padding rows of a remainder slice) become DUMP."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} must be one of {DTYPES}")
    dev = torch.device(device)
    dummy, dump = plan.n_perm - 1, plan.n_perm + 1

    def tiles(s) -> Dict:
        return dict(vals=_values(s.vals, dtype, dev),
                    cols=_index(s.cols, dev))

    t: Dict = {
        "shorts": [tiles(s) for s in plan.shorts],
        "pair13": tiles(plan.pair13) if plan.pair13 else None,
        "sell": [tiles(g) for g in plan.sell],
        "remainder": [dict(tiles(g), pos=_index(np.where(
            g.out_pos == dummy, dump, g.out_pos).reshape(-1), dev))
            for g in plan.remainder],
        "long": (dict(tiles(plan.long),
                      buckets=[_index(b, dev) for b in plan.long.buckets])
                 if plan.long else None),
        "inv_perm": _index(plan.inv_perm, dev),
    }
    meta = PlanMeta(dtype=dtype,
                    strides=tuple(s.stride for s in plan.shorts),
                    n_perm=plan.n_perm)
    return meta, t


def plan_to_scatter_arrays(plan: DaspPlan, dtype: str, device
                           ) -> Tuple[PlanMeta, Dict]:
    """Lower a plan for the scatter executor (``spmv_scatter_fn``), as the
    reference's ``plan_to_scatter_arrays`` (:79-117): ``seg_pos`` holds one
    position table per segment output, in ``_segment_outputs``' order, its
    padding slots at DUMP (the reference's INT32_MAX); ``inv_perm``'s
    entries at the dummy slot (rows without nonzeros) point at ZERO."""
    meta, t = plan_to_arrays(plan, dtype, device)
    dev = torch.device(device)
    order, n_perm = plan.order_rid, plan.n_perm
    pos = 0

    def seg(capacity: int) -> torch.Tensor:
        nonlocal pos
        p = np.arange(pos, pos + capacity, dtype=np.int64)
        p = np.where(order[pos:pos + capacity] >= 0, p, n_perm + 1)
        pos += capacity
        return _index(p, dev)

    seg_pos: List[torch.Tensor] = []
    if plan.long is not None:
        seg_pos += [seg(b.shape[0]) for b in plan.long.buckets]
    seg_pos += [seg(g.vals.shape[0] * g.vals.shape[2]) for g in plan.sell]
    if plan.pair13 is not None:
        seg_pos += [seg(plan.pair13.pairs_capacity) for _ in range(2)]
    seg_pos += [seg(s.rows_capacity) for s in plan.shorts]
    t["seg_pos"] = seg_pos
    inv = plan.inv_perm.astype(np.int64)
    t["inv_perm"] = _index(np.where(inv == n_perm - 1, n_perm, inv), dev)
    return meta, t


def plan_from_reference(ref) -> DaspPlan:
    """A ``dasp_tpu.plan.DaspPlan`` -> this package's ``DaspPlan`` with the
    same numpy arrays (the analog of ``cuda_backend.arrays_from_reference``),
    so that tests run both packages on the very same plan."""
    def convert(o):
        if dataclasses.is_dataclass(o):
            cls = getattr(plan_module, type(o).__name__)
            return cls(**{f.name: convert(getattr(o, f.name))
                          for f in dataclasses.fields(o)})
        if isinstance(o, list):
            return [convert(v) for v in o]
        return o
    return convert(ref)


# ---------------------------------------------------------------------------
# The executors
# ---------------------------------------------------------------------------


def _products(tiles: Dict, x: torch.Tensor) -> torch.Tensor:
    """vals * x[cols], x in the accumulate dtype (a bf16 value times an f32
    x is an exact f32 product of two bf16 numbers)."""
    cols = tiles["cols"]
    return tiles["vals"] * x.index_select(0, cols.reshape(-1)).view(
        cols.shape)


def _segment_outputs(meta: PlanMeta, arrays: Dict, x: torch.Tensor
                     ) -> Iterator[torch.Tensor]:
    """The flat output of every packed structure, in y_perm layout order:
    [long buckets... | sell groups... | pair13 y1 | pair13 y3 | shorts...]
    (the reference's :190-252); x in the accumulate dtype."""
    long = arrays["long"]
    if long is not None:
        partial = _products(long, x).sum(1)                  # (C,)
        padded = torch.cat([partial, partial.new_zeros(1)])  # (C+1,)
        for idx in long["buckets"]:                          # (R_b, 2^k)
            yield padded.index_select(0, idx.reshape(-1)).view(
                idx.shape).sum(1)
    for g in arrays["sell"]:
        yield _products(g, x).sum(1).reshape(-1)             # (S*128,)
    p13 = arrays["pair13"]
    if p13 is not None:
        prod = _products(p13, x).view(-1, 2, 4, LANES)
        yield prod[:, :, 0].reshape(-1)
        yield prod[:, :, 1:4].sum(2).reshape(-1)
    for s, st in zip(arrays["shorts"], meta.strides):
        prod = _products(s, x).view(-1, SUBLANES // st, st, LANES)
        yield prod.sum(2).reshape(-1)


def _remainder_into(arrays: Dict, x: torch.Tensor, y_perm: torch.Tensor
                    ) -> torch.Tensor:
    """The spilled tails' sums, scatter-added into a zero buffer of their
    own and then added to y_perm once (the reference's ``_remainder_into``
    and ``_remainder_scatter``, which keep this order); x in the
    accumulate dtype."""
    if not arrays["remainder"]:
        return y_perm
    scattered = torch.zeros_like(y_perm)
    for g in arrays["remainder"]:
        r = _products(g, x).sum(1).reshape(-1)
        scattered.index_add_(0, g["pos"], r)
    return y_perm + scattered


def _finish(meta: PlanMeta, arrays: Dict, y_perm: torch.Tensor
            ) -> torch.Tensor:
    """y_perm -> y in original row order; bf16 rounds once, here."""
    y = y_perm.index_select(0, arrays["inv_perm"])
    return y.to(torch.bfloat16) if meta.dtype == BF16 else y


def spmv_fn(meta: PlanMeta, arrays: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (n_cols,) of the plan dtype (fp64 for f64, bf16 for bf16) -> y
    (n_rows,) in original row order: f32, bf16 or fp64.  The segment
    outputs are concatenated in y_perm order, then the dummy slot, ZERO
    and DUMP."""
    x = x.to(_acc(meta.dtype))
    parts = list(_segment_outputs(meta, arrays, x))
    parts.append(x.new_zeros(3))
    y_perm = _remainder_into(arrays, x, torch.cat(parts))
    return _finish(meta, arrays, y_perm)


def spmv_scatter_fn(meta: PlanMeta, arrays: Dict, x: torch.Tensor
                    ) -> torch.Tensor:
    """The scatter variant (``plan_to_scatter_arrays``' tables), which the
    multi-device operator runs: every structure scatter-adds its flat
    output at its own positions into a zero y_perm of n_perm + 2 slots.
    Real positions are disjoint and land on zero slots, so each sum is
    exact; padding lands on DUMP."""
    x = x.to(_acc(meta.dtype))
    y_perm = x.new_zeros(meta.n_perm + 2)
    for out, pos in zip(_segment_outputs(meta, arrays, x),
                        arrays["seg_pos"]):
        y_perm.index_add_(0, pos, out)
    y_perm = _remainder_into(arrays, x, y_perm)
    return _finish(meta, arrays, y_perm)


def perturb_x(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y[0] * TAP: a timing loop's steps form a true data-dependence
    chain, and x stays numerically unchanged (the reference's :332-340;
    the tap in fp64 for an fp64 x, else in f32)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x + (y.reshape(-1)[0].to(acc) * TAP).to(x.dtype)


def prep_x(dtype: str, x, n_cols: int, n: int, col_perm=None
           ) -> torch.Tensor:
    """Host x -> the executor's (n,) x on the host: fp64 for f64, else f32
    rounded to bf16 for bf16 (the reference's ``_prep_x``), zero past
    n_cols; ``col_perm`` (old -> new) scatters x into relabeled order."""
    x = np.asarray(x)
    xp = np.zeros(n, dtype=np.float64 if dtype == F64 else np.float32)
    xp[slice(0, n_cols) if col_perm is None else col_perm] = x[:n_cols]
    return torch.from_numpy(xp).to(_VALUES[dtype])


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


class TileSpMV:
    """SpMV on the tile plan for one matrix on one device: the JAX
    package's ``SpMVOperator`` on its XLA executor (``dasp_tpu/spmv.py``,
    :76-170), which ``SpMVOperator(..., backend="xla")`` and a prebuilt
    ``DaspPlan`` give.

    Built from a CSRMatrix (packed here with ``config``) or a DaspPlan.
    The tensors live on ``device`` (the CUDA card unless the caller asks
    for the CPU; on a machine without a card that raises, it never falls
    back) for the operator's lifetime.  ``__call__`` and ``matmat`` take
    and return host arrays (bf16's y as float32); ``device_call`` maps the
    device x of ``_prep_x`` to the device y.  The plan never relabels, so
    ``perm_in`` and ``perm_out`` are the identity."""

    backend = "xla"

    def __init__(self, csr, dtype: str = F32, config=None, *,
                 device="cuda"):
        t0 = time.perf_counter()
        self.plan = (csr if isinstance(csr, DaspPlan)
                     else build_plan(csr, config or DEFAULT_CONFIG))
        self.dtype = dtype
        self.device = torch.device(device)
        self._meta, self._arrays = plan_to_arrays(self.plan, dtype,
                                                  self.device)
        self.preprocess_seconds = time.perf_counter() - t0

    n_rows = property(lambda self: self.plan.n_rows)
    n_cols = property(lambda self: self.plan.n_cols)
    nnz = property(lambda self: self.plan.nnz)

    def _prep_x(self, x) -> torch.Tensor:
        return prep_x(self.dtype, x, self.n_cols, self.n_cols).to(
            self.device)

    def device_call(self, x_dev: torch.Tensor) -> torch.Tensor:
        return spmv_fn(self._meta, self._arrays, x_dev)

    def timing_loop(self, iters: int):
        """A callable x_dev -> y_dev running ``iters`` chained SpMVs on the
        device, each folding ``perturb_x`` of its y into x, then one more
        whose y it returns (the reference's :117-142); x_dev is never
        written."""
        meta, arrays = self._meta, self._arrays

        def run(x: torch.Tensor) -> torch.Tensor:
            for _ in range(iters):
                x = perturb_x(x, spmv_fn(meta, arrays, x))
            return spmv_fn(meta, arrays, x)
        return run

    def perm_in(self, v):
        return np.asarray(v)

    perm_out = perm_in

    def matmat(self, X) -> np.ndarray:
        """Y = A @ X for X (n_cols, k), one SpMV a column (the reference's
        :152-157)."""
        X = np.asarray(X)
        return np.stack([self(X[:, j]) for j in range(X.shape[1])],
                        axis=1)

    def __call__(self, x) -> np.ndarray:
        return _to_host(self.device_call(self._prep_x(x)))
