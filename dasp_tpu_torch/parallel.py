"""Multi-device SpMV: rows dealt to devices in block-aligned strips, x
all-gathered, y stitched back by row.

The port of ``dasp_tpu/parallel.py``.  The reference drives a JAX
``Mesh`` from one controller through ``shard_map``; here ONE process
drives a list of torch devices, each "chip" an ordinary single-device
operator (``TorchSpMV``) on its own device:

* ``partition_rows``, ``slab_csr``, ``partition_strips`` and
  ``strips_csr`` (:44-131) are numpy only and give the reference's outputs
  on the same inputs; they are copied here because ``dasp_tpu/parallel.py``
  imports ``jax`` and ``ml_dtypes`` (:30-34).
* x arrives split by rows, one piece per chip on its device (the
  reference's ``P("x")``); each chip's step gathers every piece into its
  own (s_rows, 128) x table (the reference's ``jax.lax.all_gather``, the
  only communication) and runs its plan.  Rows are disjoint, so y needs
  none.

A device may appear more than once: the chips then share that device and
run one after another on its current stream, as the reference's simulated
host devices share one CPU.  Tests pass ``["cpu"] * 8``; one H100 runs
``["cuda:0"] * 4``.  ``torch.distributed`` is not used: NCCL refuses two
ranks on one GPU, so a one-card machine could only run a world of one.

Two per-chip executors, as in the reference (``backend=``): "pallas" (the
default) runs each chip's windowed plan on the port's kernels; "xla" runs
each chip's tile plan (``build_plan``) through the scatter executor
(``ops/xla_backend.spmv_scatter_fn``, PyTorch ops), on an x of
ceil(n_cols / chips) * chips entries where the windowed chips take the
(s_rows, 128) x table.  The relabel, strips, all-gather and stitch are
shared.

Each chip runs its own program, so none of the reference's SPMD
machinery is needed: no ``harmonize_wplans`` (padding every chip's
streams to one shape signature), no ``_harmonize`` of the xla chips'
arrays, no global class pin, no shared outgather trim, no ``long_gat``
padding, no ``resident.prepare(uniform=True)``.
``stats["pad_vregs"]`` is therefore all zeros.  The COO residue runs on
the device inside each chip's operator, as on one device (the reference
adds it on the host, :537-546).  f64 chips run resident (K6 in fp64),
where the reference keeps them streamed because its double-double cascade
split is per-chip data-dependent under ``shard_map``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch

from .config import DaspConfig, DEFAULT_CONFIG
from .ops import xla_backend
from .ops.cuda_backend import TAP, TorchSpMV, _to_host, prep_x
from .plan import build_plan
from .sparse import CSRMatrix
from .wplan import LANES, build_wplan


def partition_rows(csr: CSRMatrix, n_parts: int) -> List[Tuple[int, int]]:
    """Contiguous row ranges with approximately equal nnz per part."""
    targets = np.linspace(0, csr.nnz, n_parts + 1)
    bounds = np.searchsorted(csr.row_ptr, targets, side="left")
    bounds[0], bounds[-1] = 0, csr.n_rows
    bounds = np.maximum.accumulate(bounds)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_parts)]


def slab_csr(csr: CSRMatrix, start: int, end: int) -> CSRMatrix:
    """Extract rows [start, end) as a standalone CSR (full column space)."""
    lo, hi = int(csr.row_ptr[start]), int(csr.row_ptr[end])
    return CSRMatrix(end - start, csr.n_cols,
                     (csr.row_ptr[start:end + 1] - lo).copy(),
                     csr.col_idx[lo:hi].copy(), csr.values[lo:hi].copy())


def partition_strips(csr: CSRMatrix, n_parts: int, align: int,
                     strips_per_part: int = 8
                     ) -> Tuple[List[List[Tuple[int, int]]], List[int]]:
    """Strip-interleaved row partition: ``n_parts * strips_per_part``
    block-aligned nnz-balanced contiguous strips, dealt to chips by
    greedy longest-processing-time assignment that balances both the nnz
    and the mass of long rows (length >= 1024) of each chip.  Strips
    sample the whole row space, so each chip sees a similar mix of rows.

    Returns (per-chip sorted strip lists, per-chip nnz loads).  Strips
    stay whole multiples of ``align`` rows."""
    raw = partition_rows(csr, n_parts * strips_per_part)
    bounds = [0]
    for _, e in raw[:-1]:
        bounds.append(min(-(-e // align) * align, csr.n_rows))
    bounds.append(csr.n_rows)
    bounds = sorted(set(bounds))
    ranges = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    nnz_of = [int(csr.row_ptr[e] - csr.row_ptr[s]) for s, e in ranges]
    lens = csr.row_lengths.astype(np.int64)
    LONG_LEN = 1024
    lmass = np.where(lens >= LONG_LEN, lens, 0)
    lcum = np.concatenate([[0], np.cumsum(lmass)])
    long_of = [int(lcum[e] - lcum[s]) for s, e in ranges]
    avg_n = max(sum(nnz_of) / n_parts, 1.0)
    avg_l = max(sum(long_of) / n_parts, 1.0)
    order = sorted(range(len(ranges)),
                   key=lambda i: (long_of[i], nnz_of[i]), reverse=True)
    loads = [0] * n_parts
    lloads = [0] * n_parts
    assign: List[List[Tuple[int, int]]] = [[] for _ in range(n_parts)]
    for i in order:
        c = min(range(n_parts),
                key=lambda c: max((loads[c] + nnz_of[i]) / avg_n,
                                  (lloads[c] + long_of[i]) / avg_l))
        assign[c].append(ranges[i])
        loads[c] += nnz_of[i]
        lloads[c] += long_of[i]
    for strips in assign:
        strips.sort()
    return assign, loads


def strips_csr(csr: CSRMatrix, strips: List[Tuple[int, int]]) -> CSRMatrix:
    """Concatenate the given row ranges into one standalone CSR (rows in
    strip order; full column space).  An empty strip list yields an
    empty 0-row matrix."""
    if not strips:
        return CSRMatrix(0, csr.n_cols, np.zeros(1, csr.row_ptr.dtype),
                         csr.col_idx[:0].copy(), csr.values[:0].copy())
    lens = np.concatenate([csr.row_lengths[s:e] for s, e in strips])
    cols = np.concatenate([csr.col_idx[csr.row_ptr[s]:csr.row_ptr[e]]
                           for s, e in strips])
    vals = np.concatenate([csr.values[csr.row_ptr[s]:csr.row_ptr[e]]
                           for s, e in strips])
    rpt = np.zeros(lens.size + 1, dtype=csr.row_ptr.dtype)
    np.cumsum(lens, out=rpt[1:])
    return CSRMatrix(int(lens.size), csr.n_cols, rpt, cols, vals)


def default_devices() -> List[torch.device]:
    """Every visible CUDA card, one chip each; never the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("MultiChipSpMV: no CUDA card is visible "
                           "(torch.cuda.is_available() is False); pass "
                           "devices=[...] to run on others")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(dev: torch.device):
    """The context a chip's kernels launch in: its CUDA device made
    current (the wrappers refuse a tensor on another), else nothing."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


class _TileChip:
    """One chip of the xla backend: its strips' tile plan, lowered for the
    scatter executor on its device (never resident)."""

    resident = False

    def __init__(self, csr: CSRMatrix, config: DaspConfig, dtype: str,
                 dev: torch.device):
        t0 = time.perf_counter()
        self.plan = build_plan(csr, config)
        self._meta, self._arrays = xla_backend.plan_to_scatter_arrays(
            self.plan, dtype, dev)
        self.preprocess_seconds = time.perf_counter() - t0

    def device_call(self, x: torch.Tensor) -> torch.Tensor:
        return xla_backend.spmv_scatter_fn(self._meta, self._arrays, x)


class MultiChipSpMV:
    """Row-partitioned SpMV over a list of devices: each chip computes
    y_chip = A_chip @ allgather(x) for its strips of rows.

    Args:
      csr: the full matrix.
      devices: torch devices, one chip each, repeats allowed (default:
        every visible CUDA card; without one it raises).
      dtype: "f32" / "bf16" / "f64".
      config: packing tunables.  The relabel is applied GLOBALLY before
        partitioning (all chips gather one x, so they share one column
        space), and every chip packs with relabel and row_sort off, so
        its y keeps the strips' row order.
      backend: "pallas" (each chip a windowed ``TorchSpMV``) or "xla" (each
        chip's tile plan through the scatter executor; never resident).
      force_streamed: every chip's windowed operator built streamed
        (``resident`` is then False), as ``SpMVOperator(force_streamed=
        True)``.

    ``stats``: ``slab_nnz`` (nnz per chip), ``balance`` (max / mean of
    it), ``resident``; windowed, also ``real_vregs`` (value-tile vregs per
    chip) and ``pad_vregs`` (all zeros: no chip is padded to another's
    shapes).
    """

    def __init__(self, csr: CSRMatrix, devices=None, dtype: str = "f32",
                 config: DaspConfig = DEFAULT_CONFIG,
                 backend: str = "pallas", *, force_streamed: bool = False):
        if backend not in ("pallas", "xla"):
            raise ValueError("backend must be 'pallas' or 'xla'")
        devices = default_devices() if devices is None else devices
        self.devices = [_device(d) for d in devices]
        self.n_devices = len(self.devices)
        if not self.n_devices:
            raise ValueError("MultiChipSpMV: no devices given")
        self.dtype = dtype
        self.backend = backend
        self.n_rows, self.n_cols = csr.n_rows, csr.n_cols
        self.nnz = csr.nnz
        self.stats = {}

        self.col_perm = None
        self.row_perm = None
        if config.relabel != "off" and csr.nnz:
            from .relabel import (apply_col_perm, apply_sym_perm,
                                  choose_relabel, first_touch_perm)
            sym = csr.n_rows == csr.n_cols
            if config.relabel == "auto":
                self.col_perm = choose_relabel(csr, config.relabel_hub_deg,
                                               symmetric=sym)
            else:
                self.col_perm = first_touch_perm(csr,
                                                 config.relabel_hub_deg)
            if self.col_perm is not None:
                if sym:
                    csr = apply_sym_perm(csr, self.col_perm)
                    self.row_perm = self.col_perm
                else:
                    csr = apply_col_perm(csr, self.col_perm)
        config = dataclasses.replace(config, relabel="off", row_sort="off")

        self.strips, slab_nnz = partition_strips(csr, self.n_devices, LANES)
        self.stats["slab_nnz"] = slab_nnz
        self.stats["balance"] = (max(slab_nnz)
                                 / max(sum(slab_nnz) / len(slab_nnz), 1.0))
        # rows of the (relabeled) matrix that each chip's y holds, in order
        self._rows = [np.concatenate([np.arange(s, e) for s, e in strips])
                      if strips else np.zeros(0, dtype=np.int64)
                      for strips in self.strips]
        # a chip without rows gets no operator, and an empty y
        self.chips = []
        for strips, dev in zip(self.strips, self.devices):
            sub = strips_csr(csr, strips)
            if not sub.n_rows:
                self.chips.append(None)
            elif backend == "xla":
                self.chips.append(_TileChip(sub, config, dtype, dev))
            else:
                self.chips.append(TorchSpMV(build_wplan(sub, config), dev,
                                            None, dtype, force_streamed))
        live = [c for c in self.chips if c is not None]
        if not live:
            raise ValueError("MultiChipSpMV: the matrix has no rows")
        self.stats["resident"] = self.resident
        self.preprocess_seconds = sum(c.preprocess_seconds for c in live)
        if backend == "xla":
            # the reference's x: n_cols padded to a multiple of the chips
            self._x_shape = (-(-self.n_cols // self.n_devices)
                             * self.n_devices,)
            self.overflows = [None] * self.n_devices
        else:
            self._meta = live[0]._meta
            if any(c._meta.s_rows != self._meta.s_rows for c in live):
                raise ValueError("chips disagree on the x table's rows")
            self._x_shape = (self._meta.s_rows, LANES)
            self.overflows = [c.plan.overflow if c is not None else None
                              for c in self.chips]
            self.stats["real_vregs"] = [
                sum(s.n_vregs for s in c.plan.streams) if c is not None
                else 0 for c in self.chips]
            self.stats["pad_vregs"] = [0] * self.n_devices

    @property
    def resident(self) -> bool:
        """True when ``timing_loop`` runs every chip's resident executor
        (K6): each chip with rows is resident."""
        return all(c.resident for c in self.chips if c is not None)

    @property
    def device(self):
        """The one device all chips share, else the tuple of distinct
        devices (the bench's harness times each case its own way)."""
        devs = tuple(dict.fromkeys(self.devices))
        return devs[0] if len(devs) == 1 else devs

    # ---- x in, y out ------------------------------------------------------
    def _prep_x(self, x) -> List[torch.Tensor]:
        """Host x -> its padded (and relabeled) x table split by rows into
        one piece per chip, each on its chip's device: float64 for f64,
        float32 otherwise (windowed bf16 chips take an f32 x; xla bf16
        chips x rounded to bf16, as the reference's)."""
        if self.backend == "xla":
            flat = xla_backend.prep_x(self.dtype, x, self.n_cols,
                                      self._x_shape[0], self.col_perm)
        else:
            flat = torch.from_numpy(prep_x(self._meta, x, self.col_perm)
                                    ).reshape(-1)
        return [p.to(dev) for p, dev in
                zip(torch.tensor_split(flat, self.n_devices), self.devices)]

    def gather(self, pieces: List[torch.Tensor]) -> List[torch.Tensor]:
        """The all-gather: each chip's x ((s_rows, 128) table windowed,
        flat xla), assembled on its device from every piece (None for a
        chip without rows)."""
        out = []
        for chip, dev in zip(self.chips, self.devices):
            if chip is None:
                out.append(None)
                continue
            with on_device(dev):
                out.append(torch.cat([p.to(dev, non_blocking=True)
                                      for p in pieces]).view(self._x_shape))
        return out

    def step(self, pieces: List[torch.Tensor]) -> List[torch.Tensor]:
        """One SpMV on the device: the all-gather, then each chip's plan
        in turn on its device's current stream.  Returns each chip's y in
        its strips' row order (empty for a chip without rows)."""
        return self._run(self.gather(pieces),
                         lambda chip, x2d: chip.device_call(x2d))

    def _run(self, tables, fn) -> List[torch.Tensor]:
        ys = []
        for chip, dev, x2d in zip(self.chips, self.devices, tables):
            if chip is None:
                ys.append(torch.zeros(0, device=dev))
                continue
            with on_device(dev):
                ys.append(fn(chip, x2d))
        return ys

    def stitch(self, ys: List[torch.Tensor]) -> np.ndarray:
        """Each chip's y -> y (n_rows,) float64 in original row order."""
        out = np.zeros(self.n_rows, dtype=np.float64)
        for rows, y in zip(self._rows, ys):
            out[rows] = _to_host(y)
        if self.row_perm is not None:
            out = out[self.row_perm]
        return out

    def __call__(self, x) -> np.ndarray:
        return self.stitch(self.step(self._prep_x(x)))

    def timing_loop(self, iters: int):
        """A callable pieces -> chips' y's running chained SpMVs, as
        ``MultiChipSpMV.timing_loop`` (parallel.py:551-613).  Resident: one
        all-gather, then ``iters`` SpMVs per chip in one K6 launch each
        (each chip's chained tap stays on the chip).  Streamed: ``iters``
        steps, each all-gathering x and adding the first chip's y[0] * TAP
        into every piece, then one more step whose y's it returns.  The
        pieces are never written."""
        if self.resident:
            return lambda pieces: self._run(
                self.gather(pieces),
                lambda chip, x2d: chip.timing_loop(iters)(x2d))
        lead = next(i for i, c in enumerate(self.chips) if c is not None)

        def run(pieces):
            xs = [p.clone() for p in pieces]
            for _ in range(iters):
                y0 = self.step(xs)[lead][0]
                for p in xs:
                    p.add_(y0.to(p.device, p.dtype) * TAP)
            return self.step(xs)
        return run


# The reference's back-compat alias, kept so both packages offer one name.
WMultiChipSpMV = MultiChipSpMV
