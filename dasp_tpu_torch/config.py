"""Configuration for the DASP-TPU SpMV engine.

The reference (DASP, SC'23) exposes its tunables as compile-time macros and
hard-coded locals (``block_longest=256``, ``threshold=0.75`` in
``main_f64.cu:121-125``; ``BlockSize 8`` / MMA tile shape in ``common.h:28-33``).
Here they are a real runtime config, re-parameterized for TPU tile geometry:
the MXU/VPU native tile is (8 sublanes x 128 lanes) for fp32, so the packing
unit is 128-wide in the lane dimension instead of the GPU's 8-row x K=4 MMA
fragment.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


# TPU vector-register geometry (fp32): 8 sublanes x 128 lanes.
SUBLANES = 8
LANES = 128
TILE_ELEMS = SUBLANES * LANES  # 1024


@dataclasses.dataclass(frozen=True)
class DaspConfig:
    """Tunables for analysis + packing + kernels.

    Attributes:
      block_longest: rows with ``nnz >= block_longest`` take the long-row
        (chunk + segmented reduction) strategy.  Mirrors the reference default
        (``main_f64.cu:124``).
      threshold: target occupancy of the regular (dense) region of a medium
        SELL slice; the packer picks the widest bucket whose regular region
        stays at least this full, and spills row tails beyond that width.
        Mirrors ``threshold=0.75`` (``main_f64.cu:125``).
      slice_rows: rows per medium SELL slice (the lane dimension).  128 matches
        the TPU lane count; the reference's analog is BlockSize=8 rows per
        row-block (``common.h:29``), re-shaped for 128-wide vregs.
      width_buckets: allowed regular widths of a medium slice, ascending.
        Quantizing widths keeps the number of distinct XLA/Pallas launch shapes
        small.  Must be multiples of 8 (fp32 sublane granularity).
      long_chunk: elements per long-row chunk (one 128-lane vreg row).  The
        reference chops long rows into 64-nnz warp chunks (``dasp_f64.h:1005``).
      pair_13: enable DASP's trick of pairing 1-nnz with 3-nnz rows into full
        K=4 slots (``dasp_f64.h:597-607``).
      pair_13_min_slots: minimum number of (1,3) pairs, in units of packed
        slots, before pairing is worthwhile.  The reference requires 16 blocks
        of 8 slots (``dasp_f64.h:598``): 128 slots.
      relabel: "auto", "off" or "first_touch" — relabel columns at pack
        time for window locality (hubs front in degree order, tail in
        first-touch order; dasp_tpu/relabel.py).  "auto" relabels only
        when it reduces the measured window spread (helps power-law
        graphs +10-16%, would badly hurt banded/FEM).  The plan then
        carries ``col_perm`` and x is permuted host-side in ``prep_x``.
        Windowed (Pallas) backend only; the XLA executor ignores it.
      relabel_hub_deg: minimum column degree to count as a hub.
      row_sort: "auto", "off" or "on" — group rows into 128-row SELL
        blocks by length class (stable descending-length order), the TPU
        analog of the reference's ``order_rid`` row regrouping
        (``dasp_f64.h:959-976``).  Mixed-length blocks pad every row to
        the block width and push tails into 3x-filled spill slices;
        length grouping collapses both.  Free at run time: the
        block-aligned outgather already indirects, the plan just carries
        ``row_perm`` and y is un-permuted in ``perm_out``.  "auto"
        applies it only when columns are scattered anyway (window spread
        already high — banded matrices would lose their locality) and
        the quantized-width model predicts a real fill saving, and never
        on top of a symmetric relabel (which needs row order == column
        order for on-device iteration).
      fill_dump: realized-fill floor for SELL/pool slices — slices whose
        post-routing fill lands below it dump their elements into the
        COO residue.  Default 0 = OFF, a MEASURED negative result
        (round 5): even a 1%-fill slice streams its elements at
        ~3-4 ns each (1024 slots x 6 B / ~10 elements at the ~190 GB/s
        realized stream rate), while a residue element pays the
        terminal per-element correction (~9 ns/row XLA scatter or
        another sub-plan level) — rmat_like at fill_dump=0.12 moved
        290k elements residue-ward and measured 6.6 vs ~6.2 ms/iter.
        Kept as a knob because the trade flips if the terminal path
        ever gets a Pallas scatter.
      strict_f64: keep the FULL double-double pipeline on f64 operators
        regardless of plan size.  By default, production-size streamed dd
        plans (past a ~16 MB floor) run their column-sum products in
        plain f32 and store the lo value stream as bf16 — measured +18-45%
        on graph arms at ~1e-7/1e-9 relative error, far inside the
        reference's 1e-5 verification contract (main_f64.cu:8) but above
        the ~1e-13 a full dd pipeline delivers.  Set True when f64 results
        must carry full dd accuracy (e.g. cg_solve_dd residual floors);
        costs the measured speedup on large plans, no effect on small
        ones or on f32/bf16.
    """

    block_longest: int = 256
    threshold: float = 0.75
    slice_rows: int = LANES
    width_buckets: Tuple[int, ...] = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)
    long_chunk: int = LANES
    pair_13: bool = True
    pair_13_min_slots: int = 128
    relabel: str = "auto"
    # 4 won the pack-cost sweep on wikitalk-like/square power-law
    # (P-weighted vreg cost ratios 0.709-0.773 vs 0.746-0.788 at 8)
    relabel_hub_deg: int = 4
    row_sort: str = "auto"
    fill_dump: float = 0.0
    strict_f64: bool = False

    def __post_init__(self):
        if self.block_longest < 5:
            raise ValueError("block_longest must be >= 5 (rows with 1..4 nnz "
                             "are handled by the short strategies)")
        if not (0.0 < self.threshold <= 1.0):
            raise ValueError("threshold must be in (0, 1]")
        for w in self.width_buckets:
            if w % SUBLANES != 0:
                raise ValueError(f"width bucket {w} not a multiple of {SUBLANES}")
        if tuple(sorted(self.width_buckets)) != tuple(self.width_buckets):
            raise ValueError("width_buckets must be ascending")
        if self.width_buckets[-1] < self.block_longest:
            raise ValueError(
                "largest width bucket must cover block_longest-1 so any "
                "medium row fits a slice")
        if self.long_chunk % LANES != 0:
            raise ValueError(f"long_chunk must be a multiple of {LANES}")
        if self.relabel not in ("auto", "off", "first_touch"):
            raise ValueError(
                "relabel must be 'auto', 'off' or 'first_touch'")
        if self.row_sort not in ("auto", "off", "on"):
            raise ValueError("row_sort must be 'auto', 'off' or 'on'")
        if not (0.0 <= self.fill_dump < 1.0):
            raise ValueError("fill_dump must be in [0, 1)")


DEFAULT_CONFIG = DaspConfig()
