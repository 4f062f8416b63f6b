"""Windowed-gather SpMV and SpMM executor on PyTorch tensors, in f32, bf16
and f64.

The counterpart of ``dasp_tpu/ops/pallas_backend.py`` for one device:

* ``plan_to_arrays`` lowers a ``WPlan`` into the kernels' tables (numpy),
  table for table equal to the reference's lowering (:594-886) off the
  TPU; ``arrays_to_device`` moves them onto a device, and
  ``arrays_from_reference`` does the same for tables the JAX package
  lowered, so both packages can run the very same tables.
* ``spmv_fn`` runs one single-vector SpMV as ONE launch of the resident
  executor at one step (K6, ``ops/resident.py``, the COO residue added
  inside it) on every table set with a schedule, which is every plan
  with a stream.  Table sets without one (the empty plan, and the
  reference's tables carried across by ``arrays_from_reference``) take
  the reference-order glue: one colsum launch per stream (K1, or K3 in
  f64, ``ops/colsum.py``), the tensor glue of ``_assemble_y``, and one
  outgather launch (K2, or K4 in f64, ``ops/outgather.py``).
* ``spmm_fn`` runs a pass of kv = 2, 4 or 8 vectors, x (s_rows*128, kv)
  interleaved by column in and Y (n_rows, kv) out, as ONE launch of the
  resident executor's kv-table instance at one step (``resident.spmm_loop``)
  on every table set with a schedule, and kv = 1 as ``spmv_fn``.  Table
  sets without one take the glue: one multi-vector colsum launch per
  stream (K5, ``ops/colsum_multi.py``) for the kv vectors, stacked, then
  the glue once, the vector as a batch dimension, and one outgather
  launch.
* ``TorchSpMV`` is the operator (``PallasSpMV``, :1230-1474), on the
  CUDA card unless the caller names another device: ``__call__``,
  ``matmat``, and ``timing_loop``, which runs the whole chain in one K6
  launch on a resident operator and one K6 step a SpMV with
  ``force_streamed``.

Dtypes: f32 runs f32 throughout.  bf16 stores the stream values as bf16
and runs x, the sums and the glue in f32, rounding y to bf16 at the end
(:930-931).  f64 is native fp64 throughout (values, x, sums, glue), where
the reference carries double-double f32 pairs because the TPU has no fp64
datapath; the reference's bf16 lo store (:663-677) and f32-colsum tier
(:678-692) are not ported.

The kernels run on CUDA tensors; on CPU tensors the wrappers run their
plain PyTorch versions, so the whole path runs on either device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..sparse import CSRMatrix
from ..utils import gc_paused
from ..wplan import WPlan, SUB, LANES, LONG_PACK, K_SOURCES, build_wplan
from .colsum import colsum, colsum_plain
from .colsum_multi import KV_SIZES, colsum_multi, colsum_multi_plain
from .outgather import outgather, outgather_plain

DTYPES = ("f32", "bf16", "f64")
# host (numpy) type of the stream values per dtype; numpy has no bfloat16,
# so bf16 values are carried as their uint16 bit patterns until upload
VALUE_NP = {"f32": np.float32, "bf16": np.uint16, "f64": np.float64}

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

# Most x vectors per SpMM pass (one K6 launch, or on tables without a
# schedule one K5 launch per stream and the glue), for every dtype.  The
# reference runs 4 (pallas_backend.py:163) and halves kv until the stacked
# x tables fit VMEM (SPMM_X_VMEM_BYTES); here they live in device memory.
# A pass reads A once and pays its fixed costs (the glue's kernels, or
# K6's grid barriers) once whatever its kv: on the glue path 8 columns in
# one pass of 8 cost 0.60-0.70 of two passes of 4 per column in f32, f64
# and bf16 on both suite arms of chip_smoke.py (an NVIDIA H100 80GB HBM3,
# PERF.md); ``matmat`` takes a smaller kv for a short last pass.
KV_SPMM = 8

# timing_loop's feedback: each chained step adds y[0] * TAP into x, so no
# step can be skipped or hoisted and x stays numerically unchanged
TAP = 1e-36


class WMeta(NamedTuple):
    """Static description of a lowered plan (the reference's ``WMeta``,
    pallas_backend.py:542-578, without its TPU-only fields ``interpret``
    and ``dd_f32``)."""
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


def bf16_bits(a) -> np.ndarray:
    """float32 round-to-nearest-even to bfloat16, as uint16 bit patterns:
    the bits of the reference's ``astype(ml_dtypes.bfloat16)``, which also
    rounds through float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _host_values(v: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bf16":
        return bf16_bits(v)
    return v.astype(VALUE_NP[dtype])


def _lower_streams(plan: WPlan, arrays: Dict, dtype: str):
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
        vals = np.zeros((nv_pad * SUB, LANES), dtype=VALUE_NP[dtype])
        vals[:nv * SUB] = _host_values(s.vals, dtype)
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
    """Lower a WPlan (or CSRMatrix) to (WMeta, numpy table dict):
    pallas_backend.plan_to_arrays (:594-886) as it lowers off the TPU.

    Only the stream values and the residue values depend on ``dtype``:
    f32 as float32; bf16 streams as bf16 bit patterns (uint16, see
    ``bf16_bits``) with float32 residue values, as the reference stores
    them; f64 as one float64 array each, where the reference stores
    double-double (vals_hi, vals_lo) pairs.  Every other table equals the
    reference's for every dtype.  _res_depth guards the residue sub-plan
    recursion."""
    if isinstance(plan, CSRMatrix):
        plan = build_wplan(plan)
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} must be one of {DTYPES}")

    arrays: Dict = {"streams": [],
                    "long_idx": [lg.idx for lg in plan.longs]}
    stream_shapes = _lower_streams(plan, arrays, dtype)
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
        entry["vals"] = o.values.astype(
            np.float64 if dtype == "f64" else np.float32)
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


def table_counts(plan: WPlan, meta: WMeta, arrays: Dict) -> Dict[str, int]:
    """What the lowered tables hold, counted once at set-up: ``slots``,
    the value slots that one K6 step or pass reads (every vreg of a sell
    segment and every vreg whose total a long row reads, SUB * LANES
    slots each with their padding, and one slot a residue entry, which K6
    sums by its trees; a residue sub-plan's tables only the glue reads);
    ``nnz``; ``residue_nnz``, the entries of ``plan.overflow``; and
    ``long_nnz``, the entries of long rows."""
    read = [np.zeros(nv, dtype=bool) for _, _, nv in meta.streams]
    for stream, off, n_slices, w8, _ in meta.sell_segs:
        read[stream][off:off + n_slices * w8] = True
    for (stream, _), idx in zip(meta.long_groups, arrays["long_idx"]):
        idx = np.asarray(idx)
        read[stream][idx[idx < read[stream].size]] = True
    residue = 0 if plan.overflow is None else int(plan.overflow.nnz)
    vregs = sum(int(r.sum()) for r in read)
    return dict(slots=vregs * SUB * LANES + residue, nnz=int(plan.nnz),
                residue_nnz=residue,
                long_nnz=int(plan.census["nnz_long"]))


def prep_x(meta: WMeta, x, col_perm=None) -> np.ndarray:
    """Host-side: pad x to the (s_rows,128) table, float64 for f64 plans
    and float32 otherwise (bf16 plans take an f32 x, as the reference's);
    ``col_perm`` (plan.col_perm, old->new) scatters x into relabeled
    column order."""
    return prep_x_multi(meta, np.asarray(x)[:, None], 1,
                        col_perm).reshape(meta.s_rows, LANES)


def prep_x_multi(meta: WMeta, X, kv: int, col_perm=None) -> np.ndarray:
    """Host-side: the columns of X (n_cols, <= kv) as an SpMM pass's x
    tables, interleaved by column: (s_rows*128, kv), column j the padded
    (and, with ``col_perm``, relabeled) column j of X, so that row i holds
    word i of every table; columns past X's are zero.  At kv = 1 it is
    ``prep_x``'s table, byte for byte."""
    dt = np.float64 if meta.dtype == "f64" else np.float32
    X = np.asarray(X)
    xp = np.zeros((meta.s_rows * LANES, kv), dtype=dt)
    cols = slice(0, meta.n_cols) if col_perm is None else col_perm
    xp[cols, :X.shape[1]] = X[:meta.n_cols]
    return xp


# ---------------------------------------------------------------------------
# Tables on the device
# ---------------------------------------------------------------------------


def _index(a, hi: int, device) -> torch.Tensor:
    """int64 index tensor clamped to [0, hi]: jnp.take(..., mode="clip")
    as a precomputed clamp plus a plain gather."""
    return torch.from_numpy(np.clip(np.asarray(a, dtype=np.int64), 0, hi)
                            ).to(device)


def _values_to_device(a: np.ndarray, dev) -> torch.Tensor:
    """Value table -> tensor; uint16 bf16 bit patterns become bfloat16
    (``torch.from_numpy`` takes no bfloat16 array)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(
            dev).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def arrays_to_device(meta: WMeta, arrays: Dict, device) -> Dict:
    """numpy tables (plan_to_arrays layout) -> tensors on ``device``: the
    kernels' tables in their own dtypes (wins i32, vals f32 / bf16 / f64,
    idx i16, out_src i32, out_perm i8), the glue's indices as clamped
    int64."""
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    # the kernels index and type-pun without checks: reject value tables
    # of another dtype or shape than the plan's
    for st in arrays["streams"]:
        if (st["vals"].dtype != VALUE_NP[meta.dtype]
                or st["vals"].shape != st["idx"].shape
                or st["idx"].shape[0] != st["wins"].shape[0] * SUB):
            raise ValueError(
                f"stream tables do not fit a {meta.dtype} plan: vals "
                f"{st['vals'].dtype} {st['vals'].shape}, idx "
                f"{st['idx'].shape}, wins {st['wins'].shape}")
    out: Dict = {
        "streams": [dict(wins=t(st["wins"]),
                         vals=_values_to_device(st["vals"], dev),
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
        # every residue row's sum at its row, for K6's plain version (the
        # kernel reads ops/resident.py's residue tables; the reference-
        # order glue routes the sums through y2 and fb_rows instead)
        keep_t = o["tree_rows"] < meta.n_rows
        out["overflow"] = dict(
            cols=_index(o["cols"], meta.s_rows * LANES - 1, dev),
            vals=t(o["vals"]),
            trees=[_index(tr, o["vals"].shape[0], dev) for tr in o["trees"]],
            lane_table=_index(o["lane_table"], n_sums, dev),
            fb_rows=_index(o["fb_rows"][keep], meta.n_rows, dev),
            fb_pos=_index(o["fb_pos"][keep], n_sums, dev),
            sort_back=_index(o["sort_back"][keep_t], n_sums, dev),
            tree_rows=_index(o["tree_rows"][keep_t], meta.n_rows, dev))
        n_y2 += o["lane_table"].shape[0] // LANES
    # the kernels index without bounds checks: reject tables that would
    # read outside x2d or y2.  A window must stay inside the S = s_rows
    # rows of one x table: K1/K3 read x2d (S rows), and K5 reads table j
    # of its stacked (kv*S, 128) x3d at rows j*S + window + q, q < 8.
    if int(arrays["out_src"].max(initial=0)) >= n_y2:
        raise ValueError("out_src names a row outside y2")
    if any(int(st["wins"][:, 1:].max(initial=0)) + SUB > meta.s_rows
           or int(st["wins"][:, 1:].min(initial=0)) < 0
           for st in arrays["streams"]):
        raise ValueError("a window runs outside the x table")
    if meta.res is not None:
        out["res"] = arrays_to_device(meta.res, arrays["res"], dev)
    out["resident"] = None
    if arrays.get("resident") is not None:
        from . import resident
        out["resident"] = resident.to_device(meta, arrays["resident"],
                                             out["streams"], dev)
    return out


def _ref_f64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """A reference double-double value pair -> float64 (hi + lo: within
    2^-48 of the value it was split from)."""
    if hi.dtype != np.float32 or lo.dtype != np.float32:
        raise ValueError(
            f"reference f64 values stored as {hi.dtype}/{lo.dtype}: only "
            "float32 (hi, lo) pairs are carried across (a bf16 lo store, "
            "the reference's big-plan gate, loses the low bits)")
    return hi.astype(np.float64) + lo.astype(np.float64)


def _tables_from_reference(dtype: str, arrays: Dict) -> Dict:
    """The reference's numpy tables in this package's layout: bf16 values
    as their uint16 bits, f64 (hi, lo) pairs as one float64 array."""
    def values(entry):
        entry = dict(entry)
        if dtype == "f64":
            entry["vals"] = _ref_f64(entry.pop("vals_hi"),
                                     entry.pop("vals_lo"))
        elif dtype == "bf16" and entry["vals"].itemsize == 2:
            entry["vals"] = entry["vals"].view(np.uint16)
        return entry

    out = dict(arrays, streams=[values(st) for st in arrays["streams"]])
    out.pop("resident", None)         # the reference's own resident layout
    if arrays["overflow"] is not None:
        out["overflow"] = values(arrays["overflow"])
    if "res" in arrays:
        out["res"] = _tables_from_reference(dtype, arrays["res"])
    return out


def arrays_from_reference(meta, arrays: Dict, device):
    """The JAX package's lowering (the WMeta and numpy dict that
    ``dasp_tpu.ops.pallas_backend.plan_to_arrays`` returns, for any
    dtype) -> this package's (WMeta, device tensors): the reference's
    tables carried across, so both packages run the very same tables.
    f64 values become hi + lo in fp64; bf16 values keep their bits."""
    if meta.dtype not in DTYPES:
        raise ValueError(f"reference dtype {meta.dtype!r} not in {DTYPES}")

    def convert(m):
        return WMeta(**{f: getattr(m, f) for f in WMeta._fields
                        if f != "res"},
                     res=None if m.res is None else convert(m.res))

    ours = convert(meta)
    return ours, arrays_to_device(
        ours, _tables_from_reference(meta.dtype, arrays), device)


# ---------------------------------------------------------------------------
# The SpMV
# ---------------------------------------------------------------------------


def spmv_fn(meta: WMeta, arrays: Dict, x2d: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """x2d (s_rows,128) (f64 for f64 plans, f32 otherwise) -> y (n_rows,)
    in the plan's row order: f32, bf16 or f64 by the plan's dtype.
    ``plain`` runs the kernels' plain PyTorch versions on any device (the
    smoke's comparison path); otherwise the wrappers pick by device: a
    CUDA tensor launches the kernels or raises.

    Tables with a schedule (``arrays["resident"]``): one K6 step,
    ``resident_loop(meta, arrays, x2d, 1)``, one launch with the residue
    inside.  Without one (the empty plan; ``arrays_from_reference``'s
    tables): the reference-order glue, the one-vector case of what
    ``spmm_fn`` runs on such tables, on K1/K3 (one colsum per stream),
    ``_assemble_y`` and K2/K4.  The two differ in the order of their sums
    only."""
    if arrays.get("resident") is not None:
        from . import resident
        loop = (resident.resident_loop_plain if plain
                else resident.resident_loop)
        return loop(meta, arrays, x2d, 1)
    return _narrow(meta, _wide(meta, arrays, x2d.unsqueeze(0), plain,
                               multi=False)[0])


def _narrow(meta: WMeta, y: torch.Tensor) -> torch.Tensor:
    """The glue's y -> the plan's output dtype: bf16 plans round once, at
    the end (pallas_backend.py:930-931); f32 and f64 are unchanged."""
    return y.to(torch.bfloat16) if meta.dtype == "bf16" else y


def _wide(meta: WMeta, arrays: Dict, xb: torch.Tensor, plain: bool,
          multi: bool) -> torch.Tensor:
    """xb (kv,s_rows,128), the x tables of kv vectors -> y (kv, n_rows) in
    the glue's dtype (f32 for f32 and bf16, f64 for f64): one colsum
    launch per stream for all kv vectors, then the glue and the outgather
    once.  ``multi`` picks the colsum: K5 (any kv), or K1/K3 on the one
    table of a kv = 1 call."""
    kv = xb.shape[0]
    if multi:
        cm = colsum_multi_plain if plain else colsum_multi
        x3d = xb.view(-1, LANES)
        partials = [cm(st["wins"], st["vals"], st["idx"], x3d, stride, kv)
                    for (_, stride, _), st in zip(meta.streams,
                                                  arrays["streams"])]
    else:
        cs = colsum_plain if plain else colsum
        partials = [cs(st["wins"], st["vals"], st["idx"], xb[0],
                       stride).unsqueeze(0)
                    for (_, stride, _), st in zip(meta.streams,
                                                  arrays["streams"])]
    return _assemble_y(meta, arrays, partials, xb, plain, multi)


def spmm_fn(meta: WMeta, arrays: Dict, x: torch.Tensor,
            kv: int = KV_SPMM, plain: bool = False) -> torch.Tensor:
    """Multi-vector SpMV (SpMM, pallas_backend.py:1017-1040): x
    (s_rows*128, kv), kv x tables interleaved by column (``prep_x_multi``;
    f64 for f64 plans, f32 otherwise) -> Y (n_rows, kv) in the plan's row
    order and output dtype.  Column j depends on table j alone.

    Tables with a schedule (``arrays["resident"]``): one launch of K6's
    kv-table instance at one step (``resident.spmm_loop``), which reads
    each A tile once for the kv tables, gathers a slot's x words of a
    group of tables with one load, sums the residue by its trees and
    writes Y itself; kv = 1 is one K6 step.  Column j equals, bit for
    bit, the scheduled ``spmv_fn`` (one K6 step) on table j.  ``plain``
    runs the plain version (``resident.spmm_loop_plain``).

    Without one (the empty plan; ``arrays_from_reference``'s tables): the
    tables are transposed to K5's stacked (kv, s_rows, 128) here; one K5
    launch per stream reads the A stream once for all kv vectors; then the
    glue runs ONCE on the (kv, rows, 128) partials, with the vector as a
    batch dimension, one outgather launch covers the kv vectors, and a
    residue sub-plan recurses as an SpMM (its streams run through K5 too).
    Column j then equals, bit for bit, the reference-order ``spmv_fn`` on
    it.  For f64 both are one fp64 pass, where the reference runs two f32
    cross-product passes (spmm_fn_dd, :1043)."""
    if tuple(x.shape) != (meta.s_rows * LANES, kv):
        raise ValueError(f"spmm_fn: x is {tuple(x.shape)}, kv {kv} tables "
                         f"of {meta.s_rows} rows interleaved by column are "
                         f"({meta.s_rows * LANES}, {kv})")
    if arrays.get("resident") is not None:
        from . import resident
        loop = resident.spmm_loop_plain if plain else resident.spmm_loop
        return loop(meta, arrays, x, kv)
    xb = x.t().contiguous().view(kv, meta.s_rows, LANES)
    return _narrow(meta, _wide(meta, arrays, xb, plain, multi=True)).t()


def stack_y2(meta: WMeta, arrays: Dict, partials, xb: torch.Tensor):
    """Tensor glue from per-stream partials (kv, rows, 128) to the
    outgather's input (pallas_backend.py:938-990, and :1111-1197 for
    f64), the kv vectors of a pass as a leading batch dimension: segment
    level sums, long-row scalar rows, the zero row (index n_y2_rows), then
    the residue lane-table rows.  It runs in the partials' dtype, which
    the x tables xb (kv,s_rows,128) share: f32 for f32 and bf16 plans, f64
    for f64 (plain fp64 sums in place of the reference's compensated
    double-double ones).
    Returns (y2 (kv,R2,128), per-row residue sums (kv, n+1) or None).
    One vector may come without the batch dimension (partials (rows,128),
    one (s_rows,128) table) and gets y2 (R2,128) and sums (n+1,) back."""
    if xb.dim() == 2:
        y2, rsums = stack_y2(meta, arrays,
                             [p.unsqueeze(0) for p in partials],
                             xb.unsqueeze(0))
        return y2[0], None if rsums is None else rsums[0]
    dt, dev, kv = xb.dtype, xb.device, xb.shape[0]
    zero = torch.zeros((kv, 1), dtype=dt, device=dev)
    y2_parts = []
    for stream, off, n_slices, w8, stride in meta.sell_segs:
        # the stream may run at a finer stride than the segment's own
        # (cross-stride merge): F consecutive partial rows form one level
        R_st = SUB // meta.streams[stream][1]
        R = SUB // stride
        F = R_st // R
        p = partials[stream][:, off * R_st:(off + n_slices * w8) * R_st]
        y2_parts.append(p.reshape(kv, n_slices, w8, R, F, LANES).sum((2, 4))
                        .reshape(kv, n_slices * R, LANES))

    if meta.n_long:
        vreg_totals = {}
        souts = []
        for (stream, _), idxm in zip(meta.long_groups, arrays["long_idx"]):
            if stream not in vreg_totals:
                R_st = SUB // meta.streams[stream][1]
                vreg_totals[stream] = torch.cat(
                    [partials[stream].reshape(kv, -1, R_st * LANES).sum(2),
                     zero], 1)
            souts.append(vreg_totals[stream][:, idxm].sum(2))
        cat = torch.cat(souts + [zero], 1)
        scalars = cat[:, arrays["long_gat"]].sum(2)
        pad = meta.n_long_rows * LONG_PACK - meta.n_long
        srows = torch.nn.functional.pad(scalars, (0, pad)).reshape(
            kv, meta.n_long_rows, LONG_PACK)
        y2_parts.append(torch.nn.functional.pad(srows, (0, 1)))

    y2_parts.append(torch.zeros((kv, 1, LANES), dtype=dt, device=dev))

    rsums = None
    o = arrays["overflow"]
    if o is not None and meta.res is None:
        rsums = residue_sums(o, xb)
        if o["lane_table"].shape[0]:
            y2_parts.append(rsums[:, o["lane_table"]].reshape(kv, -1, LANES))
    return torch.cat(y2_parts, 1), rsums


def residue_sums(o: Dict, xb: torch.Tensor) -> torch.Tensor:
    """The COO residue's per-row sums (the octave trees, concatenated in
    tree order) and one zero appended, for each of the kv vectors of the
    x tables xb (kv,s_rows,128): (kv, n+1) in xb's dtype; for one
    (s_rows,128) table, (n+1,)."""
    if xb.dim() == 2:
        return residue_sums(o, xb.unsqueeze(0))[0]
    kv = xb.shape[0]
    zero = xb.new_zeros((kv, 1))
    pc = torch.cat([o["vals"] * xb.reshape(kv, -1)[:, o["cols"]], zero], 1)
    parts = [pc[:, t].sum(2) if t.shape[1] > 1 else pc[:, t[:, 0]]
             for t in o["trees"]]
    return torch.cat(parts + [zero], 1)


def _assemble_y(meta: WMeta, arrays: Dict, partials, xb: torch.Tensor,
                plain: bool, multi: bool) -> torch.Tensor:
    """Partials (kv, rows, 128) per stream -> y (kv, n_rows) in the glue's
    dtype (pallas_backend.py:935-1014, and :1107-1227 for f64): y2 stack,
    outgather (K2, or K4 for f64; one launch for the kv vectors), then the
    residue's scatter fallback and sub-plan."""
    y2, rsums = stack_y2(meta, arrays, partials, xb)
    o = arrays["overflow"]
    if plain:
        out = outgather_plain(arrays["out_src"], arrays["out_perm"], y2)
    else:
        out = outgather(arrays["out_src"], arrays["out_perm"], y2,
                        meta.n_y2_rows)
    y = out.reshape(y2.shape[0], -1)[:, :meta.n_rows]

    if rsums is not None and o["fb_rows"].shape[0]:
        y = y.index_add(1, o["fb_rows"], rsums[:, o["fb_pos"]])
    if meta.res is not None:
        # the sub-plan's y joins in the glue's dtype, before a bf16 plan's
        # one rounding; the reference rounds it to bf16 first (:1012)
        y = y + _wide(meta.res, arrays["res"], xb, plain, multi)
    return y


class TorchSpMV:
    """Packed SpMV for one matrix on one device, in f32, bf16 or f64:
    ``y = op(x)`` and ``Y = op.matmat(X)``.

    Built from a CSRMatrix (packed here, with ``config``) or a prebuilt
    WPlan, which serves every dtype (the plan is dtype-independent).  The
    tables live on ``device`` (the CUDA card unless the caller names
    another) for the operator's lifetime; ``__call__`` and ``matmat`` take
    and return host arrays in original order, and ``device_call`` maps a
    device x table to a device y in the plan's (possibly relabeled) row
    order.  Every plan with a stream gets the resident executor's
    schedule (K6, ``ops/resident.py``), so ``__call__`` and
    ``device_call`` are one K6 step each, and each pass of ``matmat`` one
    K6 launch over its kv columns; ``timing_loop`` runs the whole
    chain in one K6 launch when ``resident`` is true, which is every plan
    with a stream unless ``force_streamed``, and one K6 step a SpMV
    otherwise.  ``config.strict_f64`` changes nothing: the f64 path is
    native fp64, always strict."""

    def __init__(self, csr, device="cuda", config=None, dtype: str = "f32",
                 force_streamed: bool = False):
        from ..config import DEFAULT_CONFIG
        from . import resident
        with trace.span("op.setup") as setup:
            if dtype not in DTYPES:
                raise ValueError(f"dtype {dtype!r} must be one of {DTYPES}")
            self.plan = (csr if isinstance(csr, WPlan)
                         else build_wplan(csr, config or DEFAULT_CONFIG))
            self.dtype = dtype
            self.device = torch.device(device)
            with trace.span("op.lower"):
                self._meta, arrays = plan_to_arrays(self.plan, dtype)
                for k, n in table_counts(self.plan, self._meta,
                                         arrays).items():
                    trace.count(k, n)
            with trace.span("op.schedule"):
                resident.prepare(self._meta, arrays)
            self.force_streamed = force_streamed
            with trace.span("op.upload"):
                self._arrays = arrays_to_device(self._meta, arrays,
                                                self.device)
                if self.device.type == "cuda":   # the copies' tail
                    torch.cuda.synchronize(self.device)
        self.preprocess_seconds = setup.seconds

    n_rows = property(lambda self: self.plan.n_rows)
    n_cols = property(lambda self: self.plan.n_cols)
    nnz = property(lambda self: self.plan.nnz)

    def _prep_x(self, x) -> torch.Tensor:
        return torch.from_numpy(prep_x(self._meta, x, self.plan.col_perm)
                                ).to(self.device)

    def device_call(self, x2d: torch.Tensor) -> torch.Tensor:
        return spmv_fn(self._meta, self._arrays, x2d)

    @property
    def resident(self) -> bool:
        """True when ``timing_loop`` runs the whole chain in one launch of
        the resident executor (K6)."""
        return (not self.force_streamed
                and self._arrays["resident"] is not None)

    def timing_loop(self, iters: int, plain: bool = False):
        """A callable x2d -> y running chained SpMVs on the device, as
        PallasSpMV.timing_loop (:1302-1338) does.  Resident: ``iters``
        SpMVs in one K6 launch (``resident.resident_loop``), each adding
        row 0 of its y2 times TAP into every row of x.  Streamed:
        ``iters`` SpMVs (``spmv_fn``, one K6 step each), each adding
        y[0] * TAP into x (in x's dtype: fp64 for f64), then one more
        SpMV whose y it returns.  x2d is
        never written.  ``plain`` runs the kernels' plain versions (the
        smoke's comparison)."""
        meta, arrays = self._meta, self._arrays
        if self.resident:
            from . import resident
            loop = (resident.resident_loop_plain if plain
                    else resident.resident_loop)
            return lambda x2d: loop(meta, arrays, x2d, iters)

        def run(x2d: torch.Tensor) -> torch.Tensor:
            x = x2d.clone()
            for _ in range(iters):
                y = spmv_fn(meta, arrays, x, plain)
                x.add_(y[0].to(x.dtype) * TAP)
            return spmv_fn(meta, arrays, x, plain)
        return run

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
        """y in original row order: float32 for f32, float64 for f64, and
        for bf16 the bf16 values as float32 (numpy has no bfloat16)."""
        return self.perm_out(_to_host(self.device_call(self._prep_x(x))))

    def _spmm_passes(self, X: np.ndarray):
        """(x on the device, kv) of each pass of ``matmat(X)``, made as it
        is asked for: full passes of KV_SPMM columns, then one pass of the
        smallest kv the kernel has (1, 2, 4, 8) that holds the rest,
        padded with zero tables; x (s_rows*128, kv), interleaved by column
        on the host (``prep_x_multi``) and uploaded once."""
        k = X.shape[1]
        for c0 in range(0, k, KV_SPMM):
            kv = min(s for s in KV_SIZES if s >= min(k - c0, KV_SPMM))
            yield torch.from_numpy(prep_x_multi(
                self._meta, X[:, c0:c0 + kv], kv, self.plan.col_perm)
            ).to(self.device), kv

    def spmm_loop(self, X):
        """A callable running the device half of ``matmat(X)`` once, on x
        tables uploaded here: the (n_rows, kv) Y of each pass, in the
        plan's row order (the bench times it)."""
        meta, arrays = self._meta, self._arrays
        passes = list(self._spmm_passes(np.asarray(X)))
        return lambda: [spmm_fn(meta, arrays, x, kv) for x, kv in passes]

    def matmat(self, X) -> np.ndarray:
        """Multi-vector SpMV (SpMM): Y = A @ X for X of shape (n_cols, k),
        in original order (PallasSpMV.matmat, :1411-1474).  The k columns
        run up to KV_SPMM at a time through ``spmm_fn``
        (``_spmm_passes``); the columns of a short last pass's zero
        tables are dropped.  Y is float64 for f64 operators and for a
        float64 X, else X's dtype."""
        X = np.asarray(X)
        k = X.shape[1]
        cols = [_to_host(spmm_fn(self._meta, self._arrays, x, kv))
                for x, kv in self._spmm_passes(X)]
        out = np.concatenate(cols, axis=1)[:, :k]
        dt = (np.float64 if self.dtype == "f64" or X.dtype == np.float64
              else X.dtype)
        return self.perm_out(out.astype(dt))


def _to_host(y: torch.Tensor) -> np.ndarray:
    """Device y -> numpy; bf16 as float32 (exact), since numpy has no
    bfloat16."""
    return (y.float() if y.dtype == torch.bfloat16 else y).cpu().numpy()
