"""Pack plans: reshaping CSR into TPU-tile-shaped dense fragments.

This is the TPU-native re-design of the reference's packers
(``dasp_f64.h:595-1157``).  The GPU reference packs rows into 8x4 ``m8n8k4``
MMA fragments; a TPU's native vector tile is (8 sublanes x 128 lanes) and its
MXU is 128x128, so every structure here is built from (8,128)-style tiles:

* **Short rows (1..4 nnz)** -> ``ShortStream``: rows are laid out one per
  *lane column segment* of an (8,128) tile with a sublane *stride* s:
  stride 1 holds 1-nnz rows (1024 rows/tile), stride 2 holds 2-nnz rows
  (512 rows/tile), stride 4 holds 3- and 4-nnz rows (256 rows/tile).  The
  strategy generalizes the reference's short1 / 22 / 34 kernels
  (``dasp_f64.h:283-483``); reduction is a strided sublane sum.
* **1+3 pairing** -> ``Pair13Stream``: a 1-nnz row and a 3-nnz row share one
  stride-4 slot, exactly the reference's ``common_13`` trick
  (``dasp_f64.h:597-607``), producing two y values per slot.
* **Medium rows (5..block_longest-1)** -> ``SellGroup``s: SELL-C-sigma-style
  *transposed* slices — rows sorted descending by length (the reference's
  ``radix_sort`` at ``dasp_f64.h:914``), 128 consecutive rows form a slice
  (lane dim), the slice's regular width is the widest bucket keeping the
  dense region >= ``threshold`` occupied (the reference's adaptive-width loop,
  ``dasp_f64.h:1052-1083``), and each row's tail beyond that width spills to
  the remainder structure (the reference's irregular CSR tail,
  ``dasp_f64.h:1077-1106``).  Value layout is (slice, k, lane) so the runtime
  reduction is a sublane-axis sum feeding 128 output rows at once.
* **Remainder** -> more ``SellGroup``s packing the spilled tails, scattered
  (added) into the permuted y at ``out_pos``.
* **Long rows (>= block_longest)** -> ``LongStream``: each row chopped into
  fixed 128-element chunks (the reference uses 64-nnz warp chunks,
  ``dasp_f64.h:1005-1010``); the runtime computes one partial sum per chunk
  and reduces a row's partials through a *static* power-of-two gather tree
  (``LongStream.buckets``) — the fused, on-chip replacement for the
  reference's second ``longPart_sum`` kernel (``dasp_f64.h:53-75``).

The permuted output vector ``y_perm`` is laid out as::

    [ long | medium (bucket-major) | pair13 y1 | pair13 y3
      | short4(3&4) | short2 | short1 | dummy ]

``order_rid[pos] -> original row`` mirrors the reference's permutation record
(``dasp_f64.h:959-976``); ``inv_perm[row] -> pos`` turns the final
un-permutation into a single gather.  Zero rows point at the trailing dummy
slot, which always holds 0 (y preset semantics of ``dasp_f64.h:1242``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .analyze import RowCategories, categorize
from .config import DaspConfig, DEFAULT_CONFIG, LANES, SUBLANES
from .sparse import CSRMatrix


# ---------------------------------------------------------------------------
# Plan dataclasses (all-numpy; device transfer happens in the ops backend).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShortStream:
    stride: int                  # 1, 2 or 4 elements per row
    vals: np.ndarray             # (T, 8, 128) float64
    cols: np.ndarray             # (T, 8, 128) int32
    n_rows: int                  # real rows before padding

    @property
    def rows_capacity(self) -> int:
        return self.vals.shape[0] * (SUBLANES // self.stride) * LANES


@dataclasses.dataclass
class Pair13Stream:
    vals: np.ndarray             # (T, 8, 128) float64; slot = [v1, v3a, v3b, v3c]
    cols: np.ndarray             # (T, 8, 128) int32
    n_pairs: int

    @property
    def pairs_capacity(self) -> int:
        return self.vals.shape[0] * 2 * LANES


@dataclasses.dataclass
class SellGroup:
    width: int
    vals: np.ndarray             # (S, width, 128) float64, transposed slices
    cols: np.ndarray             # (S, width, 128) int32
    # Remainder groups scatter-add into y_perm at these positions:
    out_pos: Optional[np.ndarray] = None   # (S, 128) int32 or None for primary


@dataclasses.dataclass
class LongStream:
    vals: np.ndarray             # (C, chunk) float64
    cols: np.ndarray             # (C, chunk) int32
    # Power-of-two reduction tree over chunk partials: per log2-bucket,
    # (R_b, 2^k) int32 indices into the (C+1,)-long partials array
    # (index C = zero dummy).
    buckets: List[np.ndarray]
    n_rows: int


@dataclasses.dataclass
class DaspPlan:
    n_rows: int
    n_cols: int
    nnz: int
    config: DaspConfig
    shorts: List[ShortStream]            # stride 4, 2, 1 (present ones only)
    pair13: Optional[Pair13Stream]
    sell: List[SellGroup]                # primary medium, ascending width
    remainder: List[SellGroup]           # spilled tails, ascending width
    long: Optional[LongStream]
    order_rid: np.ndarray                # (n_perm,) int64, -1 on padding
    inv_perm: np.ndarray                 # (n_rows,) int32 into y_perm
    n_perm: int
    census: Dict[str, int]
    stats: Dict[str, float]

    def save(self, path) -> None:
        """Serialize the pack plan (.npz).  The reference repacks on every
        run (``dasp_f64.h:486-1157``); persisting the plan makes
        preprocessing a one-time cost per matrix."""
        arrays = {}
        meta = dict(n_rows=self.n_rows, n_cols=self.n_cols, nnz=self.nnz,
                    n_perm=self.n_perm,
                    config=dataclasses.asdict(self.config),
                    census=self.census, stats=self.stats,
                    shorts=[s.stride for s in self.shorts],
                    short_rows=[s.n_rows for s in self.shorts],
                    pair13=self.pair13.n_pairs if self.pair13 else -1,
                    sell=[g.width for g in self.sell],
                    remainder=[g.width for g in self.remainder],
                    long_rows=self.long.n_rows if self.long else -1,
                    long_buckets=len(self.long.buckets) if self.long else 0)
        for i, s in enumerate(self.shorts):
            arrays[f"short{i}_vals"] = s.vals
            arrays[f"short{i}_cols"] = s.cols
        if self.pair13:
            arrays["p13_vals"] = self.pair13.vals
            arrays["p13_cols"] = self.pair13.cols
        for i, g in enumerate(self.sell):
            arrays[f"sell{i}_vals"] = g.vals
            arrays[f"sell{i}_cols"] = g.cols
        for i, g in enumerate(self.remainder):
            arrays[f"rem{i}_vals"] = g.vals
            arrays[f"rem{i}_cols"] = g.cols
            arrays[f"rem{i}_pos"] = g.out_pos
        if self.long:
            arrays["long_vals"] = self.long.vals
            arrays["long_cols"] = self.long.cols
            for i, b in enumerate(self.long.buckets):
                arrays[f"long_bucket{i}"] = b
        arrays["order_rid"] = self.order_rid
        arrays["inv_perm"] = self.inv_perm
        import json
        np.savez_compressed(path, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    @staticmethod
    def load(path) -> "DaspPlan":
        import json
        z = np.load(path)
        meta = json.loads(bytes(z["__meta__"]).decode())
        shorts = [ShortStream(stride=s, vals=z[f"short{i}_vals"],
                              cols=z[f"short{i}_cols"],
                              n_rows=meta["short_rows"][i])
                  for i, s in enumerate(meta["shorts"])]
        pair13 = None
        if meta["pair13"] >= 0:
            pair13 = Pair13Stream(z["p13_vals"], z["p13_cols"], meta["pair13"])
        sell = [SellGroup(w, z[f"sell{i}_vals"], z[f"sell{i}_cols"])
                for i, w in enumerate(meta["sell"])]
        rem = [SellGroup(w, z[f"rem{i}_vals"], z[f"rem{i}_cols"],
                         z[f"rem{i}_pos"])
               for i, w in enumerate(meta["remainder"])]
        long = None
        if meta["long_rows"] >= 0:
            long = LongStream(z["long_vals"], z["long_cols"],
                              [z[f"long_bucket{i}"]
                               for i in range(meta["long_buckets"])],
                              meta["long_rows"])
        return DaspPlan(
            n_rows=meta["n_rows"], n_cols=meta["n_cols"], nnz=meta["nnz"],
            config=DaspConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in meta["config"].items()}),
            shorts=shorts, pair13=pair13, sell=sell, remainder=rem, long=long,
            order_rid=z["order_rid"], inv_perm=z["inv_perm"],
            n_perm=meta["n_perm"], census=meta["census"], stats=meta["stats"])


# ---------------------------------------------------------------------------
# Vectorized packing helpers.
# ---------------------------------------------------------------------------


def _gather_window(csr: CSRMatrix, base: np.ndarray, lens: np.ndarray,
                   width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gather up to ``width`` consecutive CSR elements starting at ``base``
    per row; zero-pad values and point padded columns at 0."""
    k = np.arange(width, dtype=np.int64)
    take = np.minimum(lens, width)
    idx = base[:, None] + k[None, :]
    valid = k[None, :] < take[:, None]
    idx = np.where(valid, idx, 0)
    vals = np.where(valid, csr.values[idx], 0.0).astype(np.float64)
    cols = np.where(valid, csr.col_idx[idx], 0).astype(np.int32)
    return vals, cols


def _pack_strided(vals_m: np.ndarray, cols_m: np.ndarray,
                  stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Place per-row (R, stride) element matrices into (T, 8, 128) tiles.

    Row j lands at tile ``j // spt``, sublane group ``(j % spt) // 128``,
    lane ``j % 128`` with its elements on ``stride`` consecutive sublanes,
    matching the runtime reshape-(8/s,s,128)-sum reduction.
    """
    R = vals_m.shape[0]
    spt = (SUBLANES // stride) * LANES
    T = max(1, -(-R // spt)) if R else 0
    vals = np.zeros((T, SUBLANES, LANES), dtype=np.float64)
    cols = np.zeros((T, SUBLANES, LANES), dtype=np.int32)
    if R:
        j = np.arange(R)
        t, g, l = j // spt, (j % spt) // LANES, j % LANES
        for e in range(stride):
            vals[t, g * stride + e, l] = vals_m[:, e]
            cols[t, g * stride + e, l] = cols_m[:, e]
    return vals, cols


def _choose_widths(lmat: np.ndarray, buckets: Tuple[int, ...],
                   threshold: float) -> np.ndarray:
    """Per-slice regular width: the widest bucket whose dense region stays
    >= threshold occupied (occupancy is non-increasing in width, so the
    feasible buckets form a prefix).  Mirrors ``dasp_f64.h:1052-1083``."""
    S = lmat.shape[0]
    occ = np.stack([np.minimum(lmat, w).sum(axis=1) / (lmat.shape[1] * w)
                    for w in buckets])                      # (B, S)
    ok = occ >= threshold                                   # prefix per slice
    n_ok = ok.sum(axis=0)
    choice = np.maximum(n_ok - 1, 0)
    return np.asarray(buckets, dtype=np.int64)[choice]


# ---------------------------------------------------------------------------
# Plan builder.
# ---------------------------------------------------------------------------


def build_plan(csr: CSRMatrix, config: DaspConfig = DEFAULT_CONFIG,
               cats: Optional[RowCategories] = None) -> DaspPlan:
    csr.check()
    if cats is None:
        cats = categorize(csr, config)
    lens = cats.row_lengths.astype(np.int64)
    rpt = csr.row_ptr.astype(np.int64)

    # --- 1+3 pairing (dasp_f64.h:597-607) -------------------------------
    r1, r3 = cats.short1, cats.short3
    common_13 = min(r1.size, r3.size)
    if not (config.pair_13 and common_13 >= config.pair_13_min_slots):
        common_13 = 0
    pair_r1, rest_r1 = r1[:common_13], r1[common_13:]
    pair_r3, rest_r3 = r3[:common_13], r3[common_13:]

    pair13 = None
    if common_13:
        v1, c1 = _gather_window(csr, rpt[pair_r1], lens[pair_r1], 1)
        v3, c3 = _gather_window(csr, rpt[pair_r3], lens[pair_r3], 3)
        vm = np.concatenate([v1, v3], axis=1)
        cm = np.concatenate([c1, c3], axis=1)
        pv, pc = _pack_strided(vm, cm, 4)
        pair13 = Pair13Stream(pv, pc, common_13)

    # --- short streams ---------------------------------------------------
    shorts: List[ShortStream] = []
    r34 = np.concatenate([rest_r3, cats.short4])
    for stride, rids in ((4, r34), (2, cats.short2), (1, rest_r1)):
        if rids.size == 0:
            continue
        vm, cm = _gather_window(csr, rpt[rids], lens[rids], stride)
        sv, sc = _pack_strided(vm, cm, stride)
        shorts.append(ShortStream(stride, sv, sc, rids.size))
    short_rids = {4: r34, 2: cats.short2, 1: rest_r1}

    # --- medium SELL slices ---------------------------------------------
    C = config.slice_rows
    med = cats.medium
    sell_groups: List[SellGroup] = []
    sell_group_rids: List[np.ndarray] = []   # (S_g*128,) with -1 pads
    spill_base: List[np.ndarray] = []
    spill_len: List[np.ndarray] = []
    spill_local: List[np.ndarray] = []       # index into medium segment
    if med.size:
        order = np.argsort(-lens[med], kind="stable")
        rids_sorted = med[order]
        n_pad = -(-rids_sorted.size // C) * C
        rmat = np.full(n_pad, -1, dtype=np.int64)
        rmat[:rids_sorted.size] = rids_sorted
        rmat = rmat.reshape(-1, C)
        lmat = np.where(rmat >= 0, lens[np.maximum(rmat, 0)], 0)
        widths = _choose_widths(lmat, config.width_buckets, config.threshold)

        # Group slices by chosen width (ascending); the medium segment of
        # y_perm is laid out in this (bucket, slice, lane) order.
        group_offset = 0
        for w in sorted(set(widths.tolist())):
            sel = np.flatnonzero(widths == w)
            rs = rmat[sel].reshape(-1)                       # (Sg*128,)
            ls = lmat[sel].reshape(-1)
            base = np.where(rs >= 0, rpt[np.maximum(rs, 0)], 0)
            vm, cm = _gather_window(csr, base, ls, w)        # (Sg*128, w)
            Sg = sel.size
            vals = vm.reshape(Sg, C, w).transpose(0, 2, 1)   # (Sg, w, 128)
            colsa = cm.reshape(Sg, C, w).transpose(0, 2, 1)
            sell_groups.append(SellGroup(int(w), np.ascontiguousarray(vals),
                                         np.ascontiguousarray(colsa)))
            sell_group_rids.append(rs)
            over = ls > w
            if over.any():
                oi = np.flatnonzero(over)
                spill_base.append(base[oi] + w)
                spill_len.append(ls[oi] - w)
                spill_local.append(group_offset + oi)
            group_offset += Sg * C

    # --- long stream -----------------------------------------------------
    long_stream = None
    long_rid_order = np.empty(0, dtype=np.int64)
    chunk = config.long_chunk
    rl = cats.long
    if rl.size:
        llens = lens[rl]
        n_chunks = -(-llens // chunk)
        Ctot = int(n_chunks.sum())
        starts = np.zeros(rl.size + 1, dtype=np.int64)
        np.cumsum(n_chunks, out=starts[1:])
        chunk_row = np.repeat(np.arange(rl.size), n_chunks)
        local = np.arange(Ctot) - starts[chunk_row]
        base = rpt[rl][chunk_row] + local * chunk
        rem = llens[chunk_row] - local * chunk
        lv, lc = _gather_window(csr, base, rem, chunk)       # (C, chunk)

        # Power-of-two partial-reduction tree, grouped by ceil(log2(chunks)).
        k_row = np.ceil(np.log2(np.maximum(n_chunks, 1))).astype(np.int64)
        buckets: List[np.ndarray] = []
        order_parts: List[np.ndarray] = []
        for k in sorted(set(k_row.tolist())):
            sel = np.flatnonzero(k_row == k)
            width = 1 << int(k)
            idx = np.full((sel.size, width), Ctot, dtype=np.int64)
            for j, ri in enumerate(sel):                    # rows only, cheap
                idx[j, :n_chunks[ri]] = np.arange(starts[ri], starts[ri + 1])
            buckets.append(idx.astype(np.int32))
            order_parts.append(rl[sel])
        long_rid_order = np.concatenate(order_parts)
        long_stream = LongStream(lv, lc, buckets, rl.size)

    # --- y_perm layout & permutation records ----------------------------
    seg_order: List[np.ndarray] = []

    def seg(ids: np.ndarray, capacity: int) -> int:
        block = np.full(capacity, -1, dtype=np.int64)
        block[:ids.size] = ids
        seg_order.append(block)
        return capacity

    pos = 0
    offsets: Dict[str, int] = {}
    offsets["long"] = pos
    if long_stream:
        pos += seg(long_rid_order, long_rid_order.size)
    offsets["medium"] = pos
    for rs in sell_group_rids:
        pos += seg(rs, rs.size)
    offsets["pair13_y1"] = pos
    if pair13:
        pos += seg(pair_r1, pair13.pairs_capacity)
    offsets["pair13_y3"] = pos
    if pair13:
        pos += seg(pair_r3, pair13.pairs_capacity)
    for s in shorts:
        offsets[f"short{s.stride}"] = pos
        pos += seg(short_rids[s.stride], s.rows_capacity)
    dummy = pos
    pos += seg(np.empty(0, dtype=np.int64), 1)
    n_perm = pos

    order_rid = np.concatenate(seg_order) if seg_order else np.full(
        1, -1, dtype=np.int64)
    inv_perm = np.full(csr.n_rows, dummy, dtype=np.int32)
    real = order_rid >= 0
    inv_perm[order_rid[real]] = np.flatnonzero(real).astype(np.int32)

    # --- remainder structure from medium spills -------------------------
    remainder: List[SellGroup] = []
    fill0_rem = 0
    if spill_len:
        sb = np.concatenate(spill_base)
        sl = np.concatenate(spill_len)
        sp = np.concatenate(spill_local) + offsets["medium"]
        order = np.argsort(-sl, kind="stable")
        sb, sl, sp = sb[order], sl[order], sp[order]
        n_pad = -(-sb.size // C) * C
        pb = np.zeros(n_pad, dtype=np.int64)
        pl = np.zeros(n_pad, dtype=np.int64)
        pp = np.full(n_pad, dummy, dtype=np.int64)
        pb[:sb.size], pl[:sb.size], pp[:sb.size] = sb, sl, sp
        pb, pl, pp = (a.reshape(-1, C) for a in (pb, pl, pp))
        max_len = pl.max(axis=1)
        bkt = np.searchsorted(config.width_buckets, max_len)
        widths = np.asarray(config.width_buckets, dtype=np.int64)[bkt]
        for w in sorted(set(widths.tolist())):
            sel = np.flatnonzero(widths == w)
            vm, cm = _gather_window(csr, pb[sel].reshape(-1),
                                    pl[sel].reshape(-1), int(w))
            Sg = sel.size
            vals = vm.reshape(Sg, C, w).transpose(0, 2, 1)
            colsa = cm.reshape(Sg, C, w).transpose(0, 2, 1)
            remainder.append(SellGroup(int(w), np.ascontiguousarray(vals),
                                       np.ascontiguousarray(colsa),
                                       pp[sel].astype(np.int32)))
            fill0_rem += Sg * C * int(w) - int(pl[sel].sum())

    # --- census & fill statistics (CSV schema, dasp_f64.h:1159-1172) ----
    census = cats.census
    census["common_13"] = common_13
    nnz = csr.nnz
    padded = sum(s.vals.size for s in shorts)
    padded += pair13.vals.size if pair13 else 0
    padded += sum(g.vals.size for g in sell_groups)
    padded += sum(g.vals.size for g in remainder)
    padded += long_stream.vals.size if long_stream else 0
    stats = {
        "fill0_nnz_total": float(padded),
        "rate_fill0": float((padded - nnz) / nnz) if nnz else 0.0,
        "nnz_irreg": float(sum(g.vals.size for g in remainder) - fill0_rem),
        "fill0_nnz_irreg": float(fill0_rem),
    }
    return DaspPlan(
        n_rows=csr.n_rows, n_cols=csr.n_cols, nnz=nnz, config=config,
        shorts=shorts, pair13=pair13, sell=sell_groups, remainder=remainder,
        long=long_stream, order_rid=order_rid, inv_perm=inv_perm,
        n_perm=n_perm, census=census, stats=stats)
