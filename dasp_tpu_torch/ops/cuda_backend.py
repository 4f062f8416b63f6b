"""f32 windowed-gather SpMV executor on PyTorch tensors.

The counterpart of ``dasp_tpu/ops/pallas_backend.py`` for the single-device
f32 path:

* ``plan_to_arrays`` lowers a ``WPlan`` into the kernels' tables (numpy),
  table for table equal to the reference's f32 lowering (:594-886) off
  the TPU; ``arrays_to_device`` moves them onto a device, and
  ``arrays_from_reference`` does the same for tables the JAX package
  lowered, so both packages can run the very same tables.
* ``spmv_fn`` runs one colsum launch per stream (K1, ``ops/colsum.py``),
  the tensor glue of ``_assemble_y``, and one outgather launch (K2,
  ``ops/outgather.py``).
* ``TorchSpMV`` is the operator (``PallasSpMV``, :1230-1364) on an
  explicit device.

The kernels run on CUDA tensors; on CPU tensors the wrappers run their
plain PyTorch versions, so the whole path runs on either device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..sparse import CSRMatrix
from ..utils import gc_paused
from ..wplan import WPlan, SUB, LANES, LONG_PACK, K_SOURCES, build_wplan
from .colsum import colsum, colsum_plain
from .outgather import outgather, outgather_plain

# Streams are padded to a multiple of this many vregs: the reference's
# off-TPU block (BV_INTERPRET, pallas_backend.py:46), so the port's tables
# equal the reference's as lowered on the CPU.  The CUDA kernel masks its
# own tail and needs no padding.
NV_ALIGN = 8
OB = 64          # outgather block alignment of B_pad (pallas_backend.py:48)

# Residue element count above which the COO correction is repacked as a
# sub-plan and run as a second windowed SpMV (pallas_backend.py:581-590).
RES_REPACK_MIN = 16384
RES_MAX_DEPTH = 3


class WMeta(NamedTuple):
    """Static description of a lowered plan (the f32 fields of the
    reference's ``WMeta``, pallas_backend.py:542-578)."""
    dtype: str
    s_rows: int
    n_rows: int
    n_cols: int
    streams: Tuple[Tuple[int, int, int], ...]   # (P, stride, NV_padded)
    sell_segs: Tuple[Tuple[int, int, int, int, int], ...]
    # (stream, vreg_offset, n_slices, w8, stride), ordered by out_row
    long_groups: Tuple[Tuple[int, int], ...]    # (stream, long_idx index)
    n_long: int
    n_long_rows: int
    n_y2_rows: int
    B_pad: int
    overflow_meta: Optional[object]
    k_used: int = K_SOURCES
    # OB-aligned block ranges (b0, b1, K) of the reference's range-split
    # outgather; kept for table equality, while the CUDA kernel covers
    # B_pad in one launch (see csrc/outgather.cu)
    og_ranges: Tuple[Tuple[int, int, int], ...] = ()
    res: Optional["WMeta"] = None               # residue sub-plan


def _og_split(gmax: np.ndarray, k_used: int
              ) -> Tuple[Tuple[int, int, int], ...]:
    """Partition the OB groups into <= 3 contiguous ranges, each at its
    own K (pallas_backend.py:488-534, same cost model and tie-breaks)."""
    G = int(gmax.size)
    best_cost = float(G * k_used)
    best = ((0, G, k_used),)
    if G < 2:
        return ((0, G * OB, k_used),)
    LAUNCH_PEN = 96.0
    pre = np.maximum.accumulate(gmax)
    suf = np.maximum.accumulate(gmax[::-1])[::-1]
    cs = np.arange(1, G)
    cost2 = cs * pre[cs - 1] + (G - cs) * suf[cs] + LAUNCH_PEN
    i = int(np.argmin(cost2))
    if cost2[i] < best_cost:
        c = int(cs[i])
        best_cost = float(cost2[i])
        best = ((0, c, int(pre[c - 1])), (c, G, int(suf[c])))
    drops = (np.flatnonzero(np.diff(suf) != 0) + 1)[:8]
    for c1 in drops:
        c1 = int(c1)
        cs2 = np.arange(c1 + 1, G)
        if not cs2.size:
            continue
        mid = np.maximum.accumulate(gmax[c1:])
        cost3 = (c1 * pre[c1 - 1] + (cs2 - c1) * mid[cs2 - c1 - 1]
                 + (G - cs2) * suf[cs2] + 2 * LAUNCH_PEN)
        j = int(np.argmin(cost3))
        if cost3[j] < best_cost:
            c2 = int(cs2[j])
            best_cost = float(cost3[j])
            best = ((0, c1, int(pre[c1 - 1])),
                    (c1, c2, int(mid[c2 - c1 - 1])),
                    (c2, G, int(suf[c2])))
    return tuple((b0 * OB, b1 * OB, k) for b0, b1, k in best)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


def _lower_streams(plan: WPlan, arrays: Dict):
    shapes = []
    for s in plan.streams:
        nv = s.n_vregs
        # the packer caps every vreg's window list at 32, so a P>32 stream
        # can only come from a stale cached plan (the reference meant to
        # raise this too, but reaches an undefined name first,
        # pallas_backend.py:617)
        if s.P > 32:
            raise ValueError(
                f"stream P={s.P} > 32: dynamic-round streams are no "
                "longer produced (or executed); repack the plan")
        if int(s.idx.max(initial=0)) > np.iinfo(np.int16).max:
            raise ValueError("slot metadata must fit int16 (p_cap <= 32)")
        nv_pad = -(-max(nv, 1) // NV_ALIGN) * NV_ALIGN
        # round<<10|q<<7|lam with <=32 rounds fits int16
        idx = np.zeros((nv_pad * SUB, LANES), dtype=np.int16)
        # wins[:, 0] = per-vreg round count (diagnostic, not read by the
        # kernel); wins[:, 1:] = window row offsets
        wins = np.zeros((nv_pad, s.P + 1), dtype=np.int32)
        idx[:nv * SUB] = s.idx
        wins[:nv, 1:] = s.wins
        wins[:nv, 0] = np.maximum(s.win_counts, 1) if s.P > 1 else 1
        vals = np.zeros((nv_pad * SUB, LANES), dtype=np.float32)
        vals[:nv * SUB] = s.vals.astype(np.float32)
        arrays["streams"].append(dict(idx=idx, wins=wins, vals=vals))
        shapes.append((s.P, s.stride, nv_pad))
    return tuple(shapes)


def _long_gather(plan: WPlan):
    """long_gat[p, :] lists the concatenated long-group outputs that sum to
    long scalar p (a long row may span several round-class streams); pad
    entries point one past the end, at the appended zero."""
    spos_all = [lg.scalar_pos for lg in plan.longs]
    if not spos_all:
        return np.zeros((0, 1), dtype=np.int32)
    concat_pos = np.concatenate(spos_all)
    order = np.argsort(concat_pos, kind="stable")
    sp = concat_pos[order]
    rank = np.arange(sp.size) - np.searchsorted(sp, sp, side="left")
    mult = int(rank.max()) + 1 if sp.size else 1
    gat = np.full((plan.n_long, mult), concat_pos.size, dtype=np.int32)
    gat[sp, rank] = order
    return gat


@gc_paused
def plan_to_arrays(plan, dtype: str = "f32", _res_depth: int = 0):
    """Lower a WPlan (or CSRMatrix) to (WMeta, numpy table dict): the f32
    branch of pallas_backend.plan_to_arrays (:594-886) as it lowers off
    the TPU.  _res_depth guards the residue sub-plan recursion."""
    if isinstance(plan, CSRMatrix):
        plan = build_wplan(plan)
    if dtype != "f32":
        raise NotImplementedError(
            f"dtype {dtype!r}: only f32 is ported (bf16 and f64 are "
            "ROADMAP.md queue 1, modules 4 and 5)")

    arrays: Dict = {"streams": [],
                    "long_idx": [lg.idx for lg in plan.longs]}
    stream_shapes = _lower_streams(plan, arrays)
    sell_segs = tuple((g.stream, g.vreg_offset, g.n_slices, g.w8, g.stride)
                      for g in plan.sell)
    long_groups = tuple((lg.stream, li) for li, lg in enumerate(plan.longs))
    arrays["long_gat"] = _long_gather(plan)

    B = plan.out_src.shape[0]
    B_pad = max(OB, -(-B // OB) * OB)
    Z_final = plan.n_y2_rows                     # zero row index in y2
    src = np.full((B_pad, K_SOURCES), Z_final, dtype=np.int32)
    src[:B] = plan.out_src
    # k-major (K, B_pad, 128) int8 lane ids: contiguous per-slot reads
    perm = np.zeros((K_SOURCES, B_pad, LANES), dtype=np.int8)
    perm[:, :B] = plan.out_perm.reshape(B, K_SOURCES, LANES).transpose(
        1, 0, 2)
    used = src != Z_final
    last = (used * (np.arange(K_SOURCES, dtype=np.int32) + 1)).max(axis=1)

    # COO residue (pallas_backend.py:734-852): three tiers.  Large residues
    # are repacked as a sub-plan (res); the rest are octave-grouped
    # gather-sum trees whose per-row sums are routed into y2 as one extra
    # 128-lane row per residue block (lane_table), through a free out_src
    # slot, or, where the block has no free slot or the scatter is
    # cheaper, added to y by a sorted scatter (fb_rows / fb_pos).
    overflow_meta = None
    arrays["overflow"] = None
    res_meta = None
    if plan.overflow is not None and plan.overflow.nnz:
        o = plan.overflow
        if o.nnz >= RES_REPACK_MIN and _res_depth < RES_MAX_DEPTH:
            sub_plan = getattr(plan, "_res_plan", None)
            if sub_plan is None:
                subcfg = dataclasses.replace(plan.config, relabel="off",
                                             row_sort="off", fill_dump=0.0)
                sub_plan = build_wplan(o, subcfg, sym_ok=False)
                plan._res_plan = sub_plan
            sub_meta, sub_arrays = plan_to_arrays(
                sub_plan, dtype, _res_depth=_res_depth + 1)
            if (sub_meta.s_rows == plan.s_rows
                    and sub_meta.n_rows == plan.n_rows):
                res_meta = sub_meta
                arrays["res"] = sub_arrays
        entry = dict(cols=o.col_idx.astype(np.int32))
        lens_o = o.row_lengths
        urows = np.flatnonzero(lens_o > 0)
        L = lens_o[urows].astype(np.int64)
        widths = np.maximum(
            1 << np.ceil(np.log2(np.maximum(L, 1))).astype(np.int64), 1)
        trees = []
        concat_idx = []                # urows-local index, concat order
        for w in np.unique(widths):
            sel = np.flatnonzero(widths == w)
            rw = urows[sel]
            tree = (o.row_ptr[rw][:, None]
                    + np.arange(w)[None, :]).astype(np.int32)
            tree[np.arange(w)[None, :] >= L[sel][:, None]] = o.nnz
            trees.append(tree)
            concat_idx.append(sel)
        concat_idx = np.concatenate(concat_idx)
        pos_of = np.empty(urows.size, dtype=np.int64)
        pos_of[concat_idx] = np.arange(urows.size)
        entry["trees"] = trees
        entry["sort_back"] = pos_of.astype(np.int32)
        entry["tree_rows"] = urows.astype(np.int32)
        # terminal dispatch by the reference's cost model (its per-element
        # constants are kept so both packages pick the same tier)
        blk_o = urows // LANES
        res_blocks = np.unique(blk_o)
        tree_slots = int(sum(t.size for t in trees))
        route_cost = 2.6 * (res_blocks.size * LANES + o.nnz + tree_slots)
        scatter_cost = 9.0 * urows.size + 2.6 * (o.nnz + tree_slots
                                                 + urows.size)
        use_scatter = res_meta is None and scatter_cost < route_cost
        overflow_meta = ("scatter" if use_scatter else "route",)
        kslot = last[res_blocks]
        ok_b = (kslot < K_SOURCES
                if res_meta is None and not use_scatter
                else np.zeros(res_blocks.size, dtype=bool))
        keep_blocks = res_blocks[ok_b]
        row_ok = ok_b[np.searchsorted(res_blocks, blk_o)]
        if keep_blocks.size:
            bpos = np.searchsorted(keep_blocks, blk_o[row_ok])
            table = np.full(keep_blocks.size * LANES, urows.size,
                            dtype=np.int32)
            table[bpos * LANES + urows[row_ok] % LANES] = pos_of[row_ok]
            entry["lane_table"] = table
            src[keep_blocks, kslot[ok_b]] = (
                Z_final + 1 + np.arange(keep_blocks.size))
            perm[kslot[ok_b], keep_blocks] = np.arange(
                LANES, dtype=np.int8)[None, :]
            used = src != Z_final
            last = (used * (np.arange(K_SOURCES, dtype=np.int32)
                            + 1)).max(axis=1)
        else:
            entry["lane_table"] = np.zeros(0, dtype=np.int32)
        fb = ~row_ok                   # rows whose block had no free slot
        entry["fb_pos"] = pos_of[fb].astype(np.int32)
        entry["fb_rows"] = urows[fb].astype(np.int32)
        entry["vals"] = o.values.astype(np.float32)
        arrays["overflow"] = entry

    # trim the source table to the plan-wide max of used slots
    k_used = max(1, int(last.max()))
    arrays["out_src"] = src[:, :k_used].copy()
    arrays["out_perm"] = perm[:k_used].copy()
    og_ranges = ((0, B_pad, k_used),)
    if k_used > 1:
        gmax = np.maximum(
            last.reshape(-1, OB).max(axis=1), 1).astype(np.int64)
        og_ranges = _og_split(gmax, k_used)
    if len(og_ranges) > 1:
        arrays["og_src"] = [src[b0:b1, :k].copy()
                            for b0, b1, k in og_ranges]
        arrays["og_perm"] = [perm[:k, b0:b1].copy()
                             for b0, b1, k in og_ranges]

    n_long_rows = -(-plan.n_long // LONG_PACK) if plan.n_long else 0
    meta = WMeta(dtype=dtype, s_rows=plan.s_rows, n_rows=plan.n_rows,
                 n_cols=plan.n_cols, streams=stream_shapes,
                 sell_segs=sell_segs, long_groups=long_groups,
                 n_long=plan.n_long, n_long_rows=n_long_rows,
                 n_y2_rows=plan.n_y2_rows, B_pad=B_pad,
                 overflow_meta=overflow_meta, k_used=k_used,
                 og_ranges=og_ranges, res=res_meta)
    return meta, arrays


def prep_x(meta: WMeta, x, col_perm=None) -> np.ndarray:
    """Host-side: pad x to the (s_rows,128) f32 table; ``col_perm``
    (plan.col_perm, old->new) scatters x into relabeled column order."""
    xp = np.zeros(meta.s_rows * LANES, dtype=np.float32)
    if col_perm is not None:
        xp[col_perm] = np.asarray(x, dtype=np.float32)[:meta.n_cols]
    else:
        xp[:meta.n_cols] = np.asarray(x, dtype=np.float32)[:meta.n_cols]
    return xp.reshape(meta.s_rows, LANES)


# ---------------------------------------------------------------------------
# Tables on the device
# ---------------------------------------------------------------------------


def _index(a, hi: int, device) -> torch.Tensor:
    """int64 index tensor clamped to [0, hi]: jnp.take(..., mode="clip")
    as a precomputed clamp plus a plain gather."""
    return torch.from_numpy(np.clip(np.asarray(a, dtype=np.int64), 0, hi)
                            ).to(device)


def arrays_to_device(meta: WMeta, arrays: Dict, device) -> Dict:
    """numpy tables (plan_to_arrays layout) -> tensors on ``device``: the
    kernels' tables in their own dtypes (wins i32, vals f32, idx i16,
    out_src i32, out_perm i8), the glue's indices as clamped int64."""
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out: Dict = {
        "streams": [dict(wins=t(st["wins"]), vals=t(st["vals"]),
                         idx=t(st["idx"])) for st in arrays["streams"]],
        "out_src": t(arrays["out_src"]),
        "out_perm": t(arrays["out_perm"]),
        # vreg_totals of a stream has NV_padded entries + one zero
        "long_idx": [_index(arrays["long_idx"][li],
                            meta.streams[stream][2], dev)
                     for stream, li in meta.long_groups],
        "long_gat": _index(arrays["long_gat"],
                           sum(a.shape[0] for a in arrays["long_idx"]), dev),
        "overflow": None,
    }
    n_y2 = meta.n_y2_rows + 1
    o = arrays["overflow"]
    if o is not None:
        n_sums = o["sort_back"].shape[0]        # rsums = sums + one zero
        keep = o["fb_rows"] < meta.n_rows        # .at[].add(mode="drop")
        out["overflow"] = dict(
            cols=_index(o["cols"], meta.s_rows * LANES - 1, dev),
            vals=t(o["vals"]),
            trees=[_index(tr, o["vals"].shape[0], dev) for tr in o["trees"]],
            lane_table=_index(o["lane_table"], n_sums, dev),
            fb_rows=_index(o["fb_rows"][keep], meta.n_rows, dev),
            fb_pos=_index(o["fb_pos"][keep], n_sums, dev))
        n_y2 += o["lane_table"].shape[0] // LANES
    # the kernels index without bounds checks: reject tables that would
    # read outside x2d or y2
    if int(arrays["out_src"].max(initial=0)) >= n_y2:
        raise ValueError("out_src names a row outside y2")
    if any(int(st["wins"][:, 1:].max(initial=0)) + SUB > meta.s_rows
           for st in arrays["streams"]):
        raise ValueError("a window runs past the end of x2d")
    if meta.res is not None:
        out["res"] = arrays_to_device(meta.res, arrays["res"], dev)
    return out


def arrays_from_reference(meta, arrays: Dict, device):
    """The JAX package's f32 lowering (the WMeta and numpy dict that
    ``dasp_tpu.ops.pallas_backend.plan_to_arrays`` returns) -> this
    package's (WMeta, device tensors): the reference's tables carried
    across, so both packages run the very same tables."""
    if meta.dtype != "f32":
        raise NotImplementedError("only f32 tables are carried across")

    def convert(m):
        return WMeta(**{f: getattr(m, f) for f in WMeta._fields
                        if f != "res"},
                     res=None if m.res is None else convert(m.res))

    ours = convert(meta)
    return ours, arrays_to_device(ours, arrays, device)


# ---------------------------------------------------------------------------
# The SpMV
# ---------------------------------------------------------------------------


def spmv_fn(meta: WMeta, arrays: Dict, x2d: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """x2d (s_rows,128) f32 -> y (n_rows,) f32 in the plan's row order.
    ``plain`` runs the kernels' plain PyTorch versions on any device (the
    smoke's comparison path); otherwise the wrappers pick by device."""
    cs = colsum_plain if plain else colsum
    partials = [cs(st["wins"], st["vals"], st["idx"], x2d, stride)
                for (_, stride, _), st in zip(meta.streams,
                                              arrays["streams"])]
    return _assemble_y(meta, arrays, partials, x2d, plain)


def stack_y2(meta: WMeta, arrays: Dict, partials, x2d: torch.Tensor):
    """Tensor glue from per-stream partials to the outgather's input
    (pallas_backend.py:938-990): segment level sums, long-row scalar rows,
    the zero row (index n_y2_rows), then the residue lane-table rows.
    Returns (y2 (R2,128), per-row residue sums or None)."""
    f32, dev = torch.float32, x2d.device
    zero = torch.zeros(1, dtype=f32, device=dev)
    y2_parts = []
    for stream, off, n_slices, w8, stride in meta.sell_segs:
        # the stream may run at a finer stride than the segment's own
        # (cross-stride merge): F consecutive partial rows form one level
        R_st = SUB // meta.streams[stream][1]
        R = SUB // stride
        F = R_st // R
        p = partials[stream][off * R_st:(off + n_slices * w8) * R_st]
        y2_parts.append(p.reshape(n_slices, w8, R, F, LANES).sum((1, 3))
                        .reshape(n_slices * R, LANES))

    if meta.n_long:
        vreg_totals = {}
        souts = []
        for (stream, _), idxm in zip(meta.long_groups, arrays["long_idx"]):
            if stream not in vreg_totals:
                R_st = SUB // meta.streams[stream][1]
                vreg_totals[stream] = torch.cat(
                    [partials[stream].reshape(-1, R_st * LANES).sum(1), zero])
            souts.append(vreg_totals[stream][idxm].sum(1))
        cat = torch.cat(souts + [zero])
        scalars = cat[arrays["long_gat"]].sum(1)
        pad = meta.n_long_rows * LONG_PACK - meta.n_long
        srows = torch.nn.functional.pad(scalars, (0, pad)).reshape(
            meta.n_long_rows, LONG_PACK)
        y2_parts.append(torch.nn.functional.pad(srows, (0, 1)))

    y2_parts.append(torch.zeros((1, LANES), dtype=f32, device=dev))

    rsums = None
    o = arrays["overflow"]
    if o is not None and meta.res is None:
        xg = x2d.reshape(-1)[o["cols"]]
        pc = torch.cat([o["vals"] * xg, zero])
        parts = [pc[t].sum(1) if t.shape[1] > 1 else pc[t[:, 0]]
                 for t in o["trees"]]
        rsums = torch.cat(parts + [zero])
        if o["lane_table"].shape[0]:
            y2_parts.append(rsums[o["lane_table"]].reshape(-1, LANES))
    return torch.cat(y2_parts, 0), rsums


def _assemble_y(meta: WMeta, arrays: Dict, partials, x2d: torch.Tensor,
                plain: bool) -> torch.Tensor:
    """Partials -> y (pallas_backend.py:935-1014): y2 stack, outgather,
    then the residue's scatter fallback and sub-plan."""
    y2, rsums = stack_y2(meta, arrays, partials, x2d)
    o = arrays["overflow"]
    if plain:
        out = outgather_plain(arrays["out_src"], arrays["out_perm"], y2)
    else:
        out = outgather(arrays["out_src"], arrays["out_perm"], y2,
                        meta.n_y2_rows)
    y = out.reshape(-1)[:meta.n_rows]

    if rsums is not None and o["fb_rows"].shape[0]:
        y = y.index_add(0, o["fb_rows"], rsums[o["fb_pos"]])
    if meta.res is not None:
        y = y + spmv_fn(meta.res, arrays["res"], x2d, plain)
    return y


class TorchSpMV:
    """Packed f32 SpMV for one matrix on one device: ``y = op(x)``.

    Built from a CSRMatrix (packed here, with ``config``) or a prebuilt
    WPlan.  The tables live on ``device`` for the operator's lifetime;
    ``__call__`` takes and returns host vectors in original order, and
    ``device_call`` maps a device x table to a device y in the plan's
    (possibly relabeled) row order."""

    def __init__(self, csr, device, config=None):
        from ..config import DEFAULT_CONFIG
        t0 = time.perf_counter()
        self.plan = (csr if isinstance(csr, WPlan)
                     else build_wplan(csr, config or DEFAULT_CONFIG))
        self.dtype = "f32"
        self.device = torch.device(device)
        self._meta, arrays = plan_to_arrays(self.plan, "f32")
        self._arrays = arrays_to_device(self._meta, arrays, self.device)
        self.preprocess_seconds = time.perf_counter() - t0

    n_rows = property(lambda self: self.plan.n_rows)
    n_cols = property(lambda self: self.plan.n_cols)
    nnz = property(lambda self: self.plan.nnz)

    def _prep_x(self, x) -> torch.Tensor:
        return torch.from_numpy(prep_x(self._meta, x, self.plan.col_perm)
                                ).to(self.device)

    def device_call(self, x2d: torch.Tensor) -> torch.Tensor:
        return spmv_fn(self._meta, self._arrays, x2d)

    def perm_in(self, v):
        """Host: original-order vector -> the operator's internal
        (possibly relabeled) index space.  Identity without a relabel."""
        if self.plan.col_perm is None:
            return np.asarray(v)
        out = np.empty_like(np.asarray(v))
        out[self.plan.col_perm] = np.asarray(v)
        return out

    def perm_out(self, y):
        """Host: internal-order y -> original row order."""
        if self.plan.row_perm is None:
            return np.asarray(y)
        return np.asarray(y)[self.plan.row_perm]

    def __call__(self, x) -> np.ndarray:
        y = self.device_call(self._prep_x(x))
        return self.perm_out(y.cpu().numpy())
