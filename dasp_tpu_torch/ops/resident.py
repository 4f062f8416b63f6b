"""The resident executor (K6): ``iters`` chained SpMVs in one persistent
cooperative CUDA launch, and its plain version.

Replaces ``dasp_tpu/ops/resident.py:make_resident_loop`` (:452; kernel
``kernel_factory`` :508-1036, ``pallas_call`` :1137, wrapper ``fn``
:1151-1230); the CUDA source is ``dasp_tpu_torch/csrc/resident.cu``.  It
is the path of ``TorchSpMV.timing_loop`` on a resident operator, as the
reference's is the path of ``PallasSpMV.timing_loop`` (pallas_backend.py:
1302-1315).  One call runs ``iters`` SpMVs; step t reads x_t and sets

    x_{t+1}[r, l] = x_t[r, l] + y2_t[0, l] * TAP     for every row r

(row 0 of the step's y2 broadcast over the x table, the reference's tap at
:1026-1034, not the streamed loop's y[0] scalar), for every step but the
last, whose tap nothing would read.  The y returned is the last step's
output plus the whole COO residue, summed once from the caller's x
(:1212-1230) and added inside the kernel; bf16 plans round y once, at the
end.  At ``iters = 1`` this is one single-vector SpMV in one launch, which
is what ``cuda_backend.spmv_fn`` runs for every table set with a
schedule.

Host half (``prepare``, numpy, before upload): the outgather source table
stripped to the zero row (the streamed path's residue rows of y2 do not
exist here, :245); the long-row incidence as compact per-scalar lists of
(total index, multiplicity), composed from ``long_idx`` and ``long_gat`` as
the reference composes its dense incidence matrices (:246-280); and the
kernel's schedule.  A work item is up to ``VPB`` consecutive vregs of one
stream, one per thread row of a CUDA block: whole slices of a sell segment
(``VPB // w8`` of them when w8 <= VPB), one chunk of ``VPB`` vregs of a
wide slice (w8 > VPB), or vregs whose totals a long scalar reads and no
slice holds.  The items are sorted by cost, dearest first (``_cost``).  A
wide slice's y2 row sums the rows its chunks leave in ``cbuf``: one
``wide`` row each.  The residue's schedule: every residue row (the
octave trees of ``plan_to_arrays``) as its first slot, its slots and its
tree's width, the rows of trees at least ``RES_WARP_MIN`` wide first, one
task (a warp) each, then the others in row order, ``RES_LANES`` rows a
task; and, per outgather block, the rows whose sums its threads add.
Every plan with a stream has these tables; the empty plan has none and
runs the reference-order glue (the reference fails there, ``ROADMAP.md``
§3).

Not ported, because they exist for the TPU's 128 MiB VMEM or for Mosaic's
static specialisation: ``RESIDENT_BUDGET``, ``resident_bytes``,
``smem_bytes``, ``_staging_rows`` and the compression tiers (``perm_c``,
``lo16``, ``vals32``, int8 ``bigs``, the band trim ``big_c0``);
``_og_program``; ``split_incidence`` and ``DD_LONG_FANIN_MAX``, since the
long scalars accumulate in the sum type (fp64 for f64), so there is no f32
fan-in to cap; the RowSel/LaneSel and all-ones matmuls, which place and
lane-fold the scalars on the MXU.

Order of every sum, in the kernel and in ``resident_loop_plain`` alike
(each add and product rounded, never contracted), for sum type A (f32 for
f32 and bf16 values, f64 for f64):
- colsum: K1's, sublane order within each level (``colsum_plain``);
- a vreg's folded level r, for a slice whose R levels take F of the
  stream's levels each: the vreg's levels rF, ..., rF + F - 1 in order;
- a chunk (the vregs w = cVPB, ..., cVPB + VPB - 1 of a slice, fewer at
  its end): their folded levels in order of w;
- a sell row of y2: its slice's chunks in order from the first (one chunk
  when w8 <= VPB, so the row is that chunk);
- vreg total: per lane, the vreg's levels in order; then a tree over the
  128 lanes, ``c[l] += c[l + s]`` for s = 64, 32, ..., 1;
- long scalar p: its (total, multiplicity) list in ascending total index,
  ``m * total`` rounded and added left to right;
- outgather: K2's, the k_used slots in order from zero (a zero-row slot
  adds the zero row's zero);
- residue row (from the caller's x, once per call): each product
  ``vals[k] * x[cols[k]]`` rounded; a tree of w < RES_WARP_MIN slots from
  its slot 0, adding slots 1, ..., w - 1 in order (a padding slot adds
  the zero); a wider tree by lanes, lane i adding the slots i, i + 32,
  ..., in order, then a tree over the 32 lanes, ``c[l] += c[l + s]`` for
  s = 16, 8, ..., 1; the row's sum added to the outgather's last;
- tap: ``x + y2[0] * TAP``, product then sum, at every step but the
  last.
The longest serial fold is a chunk's: F <= 4 levels in a thread's
registers, then VPB = 4 vregs' folded levels from shared memory, so no
fold waits on device memory in phase A.  A wide row's chunks (at most
w8 / VPB = 8 on the packer's widest class, w8 = 32) are loaded eight at a
time before the first add, one round trip for the whole fold.

An SpMM pass of kv = 2, 4 or 8 columns (``spmm_loop``, what
``cuda_backend.spmm_fn`` runs on a table set with a schedule) is one
launch of the kernel's kv-table instance at one step: kv x tables stacked
as (kv*s_rows, 128), each item's A tile read once for them all, and table
j's y2 and out word for word those of one step on table j alone, so
column j equals ``resident_loop(meta, arrays, x_j, 1)`` (``device_call``)
bit for bit.
``spmm_loop_plain`` is ``resident_loop_plain`` at one step with the kv
tables as a leading batch dimension.

``resident_loop`` and ``spmm_loop`` take a CPU tensor to their plain
versions and a CUDA tensor to the kernel; there is no fallback from one to
the other.  ``resident_loop.launches`` counts kernel launches per instance
("f32", "bf16", "f64"), ``spmm_loop.launches`` per instance and kv
("f32_kv2", ..., "f64_kv8").
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np
import torch

from ..wplan import SUB, LANES, LONG_PACK
from . import _build
from . import cuda_backend as cb
from .colsum import colsum_multi_plain
from .colsum_multi import KV_SIZES
from .outgather import outgather_plain

# int64 fields of one stream's row of the kernel's descriptor table, in
# the order of csrc/resident.cu's enum: table pointers, windows, stride
DESC_FIELDS = ("wins", "vals", "idx", "P", "stride")
VPB = 4             # thread rows (vregs) per CUDA block: the chunk of a fold
MAX_P = 32          # windows a vreg may reach (the kernel's shared wins row)
# int32 fields of a work item (csrc/resident.cu's enum): stream, first
# vreg, vregs, vregs per slice, F, R, destination (DST_*), first output
# row, total index of the first vreg (-1: none), mask of the thread rows
# whose totals a long scalar reads
ITEM_FIELDS = ("stream", "v0", "nv", "w", "F", "R", "dst", "out", "tot",
               "mask")
DST_Y2, DST_CHUNK, DST_NONE = 0, 1, 2
# int32 fields of a wide row: its y2 row, its first chunk row in cbuf, its
# chunks, the cbuf rows from one chunk to the next
WIDE_FIELDS = ("y2", "first", "n", "step")
TREE = (64, 32, 16, 8, 4, 2, 1)     # lane-tree steps of a vreg total
# int32 fields of a residue row (csrc/resident.cu's enum): first slot,
# slots, its tree's width; of a residue task: first row, rows
RES_FIELDS = ("slot", "len", "w")
RES_TASK_FIELDS = ("first", "n")
RES_LANES = 32      # rows of a task; lanes of a wide row's warp
RES_WARP_MIN = 64   # tree width from which a residue row takes a warp
RES_TREE = (16, 8, 4, 2, 1)     # lane-tree steps of a wide residue row
# words of the phase clock (csrc/resident.cu's enum): ns per phase summed
# over the steps (A colsum and folds, R the residue's sums in step 0, C
# wide rows and long scalars, D outgather, the residue's adds and the
# tap), the grid and blocks per SM
STAMPS = ("A", "R", "C", "D", "grid", "per_sm")
STAMP_WORDS = len(STAMPS)


def eligible(meta) -> bool:
    """A plan runs resident when its dtype is ported and it has a stream
    (the empty matrix has none, and runs streamed)."""
    return meta.dtype in cb.DTYPES and len(meta.streams) > 0


def prepare(meta, arrays: Dict) -> None:
    """Attach the resident tables to the numpy ``arrays`` (before upload)
    as ``arrays["resident"]``, or None for an ineligible plan."""
    arrays["resident"] = None
    if not eligible(meta):
        return
    nv = [NV for _, _, NV in meta.streams]
    long_streams = sorted({s for s, _ in meta.long_groups})
    tot_off = np.full(len(nv), -1, dtype=np.int64)
    n_tot = 0
    for s in long_streams:
        tot_off[s] = n_tot
        n_tot += nv[s]
    inc_ptr, inc_tot, inc_mult = _incidence(meta, arrays, tot_off, n_tot)
    need = np.zeros(n_tot, dtype=bool)          # totals a scalar reads
    need[inc_tot] = True
    items, wide, chunk_rows = _schedule(meta, tot_off, need)
    arrays["resident"] = dict(
        src=np.minimum(arrays["out_src"], meta.n_y2_rows).astype(np.int32),
        items=items, wide=wide, chunk_rows=chunk_rows, tot_off=tot_off,
        long_streams=long_streams, n_tot=n_tot, inc_ptr=inc_ptr,
        inc_tot=inc_tot, inc_mult=inc_mult,
        **_residue_schedule(meta, arrays["overflow"]))


def _residue_schedule(meta, o) -> Dict:
    """The kernel's residue tables from the octave trees of
    ``plan_to_arrays`` (rows past n_rows dropped, as ``arrays_to_device``
    drops them): ``res_ent`` (RES_FIELDS per row, wide trees first, dearest
    first, then the rest in row order), ``res_task`` (RES_TASK_FIELDS),
    ``res_bptr`` (B_pad + 1) and ``res_bent`` (row index * 128 + lane, by
    outgather block), ``res_cols`` (int32 x words) and ``res_vals``."""
    if o is None or not o["tree_rows"].size:
        return dict(res_ent=np.zeros((0, len(RES_FIELDS)), np.int32),
                    res_task=np.zeros((0, len(RES_TASK_FIELDS)), np.int32),
                    res_bptr=np.zeros(meta.B_pad + 1, np.int32),
                    res_bent=np.zeros(0, np.int32),
                    res_cols=np.zeros(0, np.int32),
                    res_vals=np.zeros(0, np.float64 if meta.dtype == "f64"
                                      else np.float32))
    nnz = o["vals"].shape[0]
    first = np.concatenate([t[:, 0] for t in o["trees"]])
    slots = np.concatenate([(t < nnz).sum(1) for t in o["trees"]])
    width = np.concatenate([np.full(t.shape[0], t.shape[1])
                            for t in o["trees"]])
    at = o["sort_back"].astype(np.int64)          # tree_rows order
    rows = o["tree_rows"].astype(np.int64)
    keep = rows < meta.n_rows
    rows, at = rows[keep], at[keep]
    ent = np.stack([first[at], slots[at], width[at]], 1).astype(np.int64)
    wide = ent[:, 2] >= RES_WARP_MIN
    order = np.lexsort((rows, -np.where(wide, ent[:, 2], 0)))
    ent, rows, n_wide = ent[order], rows[order], int(wide.sum())
    narrow = np.arange(n_wide, rows.size, RES_LANES)
    task = np.concatenate([
        np.stack([np.arange(n_wide), np.ones(n_wide, np.int64)], 1),
        np.stack([narrow, np.minimum(RES_LANES, rows.size - narrow)], 1)])
    blk = np.argsort(rows // LANES, kind="stable")
    bent = blk * LANES + rows[blk] % LANES
    bptr = np.searchsorted(rows[blk] // LANES, np.arange(meta.B_pad + 1))
    return dict(res_ent=ent.astype(np.int32),
                res_task=task.astype(np.int32),
                res_bptr=bptr.astype(np.int32), res_bent=bent.astype(np.int32),
                res_cols=np.clip(o["cols"], 0, meta.s_rows * LANES - 1
                                 ).astype(np.int32),
                res_vals=o["vals"])


def _schedule(meta, tot_off: np.ndarray, need: np.ndarray):
    """The kernel's work items (ITEM_FIELDS, sorted by ``_cost``, dearest
    first), its wide rows (WIDE_FIELDS) and the number of chunk rows:
    the sell segments' slices in y2 row order, then the vregs whose
    totals a long scalar reads (``need``, over the total index) and no
    slice holds, in runs of at most VPB."""
    r_st = [SUB // stride for _, stride, _ in meta.streams]
    items, wide = [], []
    row = chunk_row = 0
    covered = [np.zeros(NV, dtype=bool) for _, _, NV in meta.streams]
    for stream, off, n_slices, w8, stride in meta.sell_segs:
        R = SUB // stride
        F = r_st[stream] // R
        covered[stream][off:off + n_slices * w8] = True
        if w8 <= VPB:
            k = VPB // w8
            for i in range(0, n_slices, k):
                n = min(k, n_slices - i)
                items.append([stream, off + i * w8, n * w8, w8, F, R,
                              DST_Y2, row + i * R])
        else:
            n_ch = -(-w8 // VPB)
            for i in range(n_slices):
                for c in range(n_ch):
                    n = min(VPB, w8 - c * VPB)
                    items.append([stream, off + i * w8 + c * VPB, n, n, F, R,
                                  DST_CHUNK, chunk_row + c * R])
                wide += [[row + i * R + r, chunk_row + r, n_ch, R]
                         for r in range(R)]
                chunk_row += n_ch * R
        row += n_slices * R
    if row != meta.n_y2_rows - meta.n_long_rows:
        raise ValueError(f"sell segments give {row} y2 rows, the plan has "
                         f"{meta.n_y2_rows - meta.n_long_rows}")
    for s in np.flatnonzero(tot_off >= 0):        # totals no slice computes
        v = np.flatnonzero(need[tot_off[s]:tot_off[s] + covered[s].size]
                           & ~covered[s])
        i = 0
        while i < v.size:
            n = 1
            while n < VPB and i + n < v.size and v[i + n] == v[i] + n:
                n += 1
            items.append([int(s), int(v[i]), n, 1, 1, 0, DST_NONE, 0])
            i += n
    items = np.array(items, dtype=np.int64).reshape(-1, 8)
    tot = np.where(tot_off[items[:, 0]] >= 0,
                   tot_off[items[:, 0]] + items[:, 1], -1)
    mask = np.zeros(len(items), dtype=np.int64)
    for t in range(VPB):
        hit = (tot >= 0) & (t < items[:, 2])
        hit[hit] = need[tot[hit] + t]
        mask |= hit.astype(np.int64) << t
    items = np.concatenate([items, np.where(mask > 0, tot, -1)[:, None],
                            mask[:, None]], axis=1)
    P = np.array([P for P, _, _ in meta.streams])
    items = items[np.argsort(-_cost(P[items[:, 0]], items[:, 2]),
                             kind="stable")]
    return (items.astype(np.int32),
            np.array(wide, dtype=np.int32).reshape(-1, len(WIDE_FIELDS)),
            chunk_row)


def _cost(P: np.ndarray, n: np.ndarray) -> np.ndarray:
    """An item's cost for the schedule's order: its vregs, each dearer by
    a quarter per doubling of its stream's windows P (a vreg whose slots
    reach 32 windows costs 2.2x a one-window vreg: T2 flane, PERF.md)."""
    return n * (1.0 + 0.25 * np.log2(P))


def _incidence(meta, arrays, tot_off: np.ndarray, n_tot: int):
    """Long scalar p = sum of multiplicity x vreg total, over the vregs
    that the long groups' gather rows named by long_gat[p] list (pad
    entries dropped): the reference's ``bigs`` (resident.py:246-280) as
    CSR lists over the concatenated total index.  Returns (inc_ptr
    (n_long+1,) i64, inc_tot i64, inc_mult i32), sorted by (p, total)."""
    if not meta.n_long:
        return (np.zeros(meta.n_long + 1, dtype=np.int64),
                np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32))
    ent_c, ent_t = [], []        # (concat gather row, total index) pairs
    base = 0
    for stream, li in meta.long_groups:
        idxm = np.asarray(arrays["long_idx"][li])
        c, k = np.nonzero(idxm < meta.streams[stream][2])
        ent_c.append(base + c)
        ent_t.append(tot_off[stream] + idxm[c, k].astype(np.int64))
        base += idxm.shape[0]
    ent_c = np.concatenate(ent_c)
    ent_t = np.concatenate(ent_t)
    cnt = np.bincount(ent_c, minlength=base)
    ptr = np.concatenate([[0], np.cumsum(cnt)])
    gat = np.asarray(arrays["long_gat"])
    ps, ms = np.nonzero(gat < base)
    cs = gat[ps, ms]
    n_e = cnt[cs]
    first = np.repeat(ptr[cs] - (np.cumsum(n_e) - n_e), n_e)
    t_rep = ent_t[first + np.arange(first.size)]
    key = np.repeat(ps.astype(np.int64), n_e) * max(n_tot, 1) + t_rep
    uk, mult = np.unique(key, return_counts=True)
    p_u = uk // max(n_tot, 1)
    inc_ptr = np.searchsorted(p_u, np.arange(meta.n_long + 1)).astype(
        np.int64)
    return inc_ptr, uk % max(n_tot, 1), mult.astype(np.int32)


def _runs(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """The concatenated ranges first[i] .. first[i] + count[i] - 1."""
    count = count.astype(np.int64)
    return (np.repeat(first.astype(np.int64) - np.cumsum(count) + count,
                      count) + np.arange(int(count.sum())))


def _check_schedule(meta, res: Dict) -> None:
    """Raise ValueError unless the schedule fits the plan: every item's
    vregs inside its stream and its F x R the stream's levels, every sell
    row of y2 and every chunk row written exactly once, every wide row's
    chunks inside cbuf, and every total that a long scalar reads
    computed.  The kernel checks none of it."""
    it, wide = res["items"].astype(np.int64), res["wide"].astype(np.int64)
    if it.ndim != 2 or it.shape[1] != len(ITEM_FIELDS) or (
            wide.ndim != 2 or wide.shape[1] != len(WIDE_FIELDS)):
        raise ValueError("the schedule or the wide-row table has the wrong "
                         "shape")
    s, v0, n, w, F, R, dst, out, tot, mask = it.T
    if it.size and not (0 <= s.min() and s.max() < len(meta.streams)):
        raise ValueError("a work item names a stream that does not exist")
    if max(P for P, _, _ in meta.streams) > MAX_P:
        raise ValueError(f"a stream reaches more than {MAX_P} windows")
    s = np.clip(s, 0, len(meta.streams) - 1)
    NV = np.array([NV for _, _, NV in meta.streams])[s]
    r_st = SUB // np.array([st for _, st, _ in meta.streams])[s]
    emits = dst != DST_NONE
    if not (np.all((1 <= n) & (n <= VPB) & (0 <= v0) & (v0 + n <= NV)
                   & (w >= 1) & (n % np.maximum(w, 1) == 0)
                   & (0 <= dst) & (dst <= DST_NONE))
            and np.all(~emits | ((F >= 1) & (R >= 1) & (F * R == r_st)))):
        raise ValueError("a work item reads outside its stream or folds "
                         "other levels than its stream has")
    n_sell = meta.n_y2_rows - meta.n_long_rows
    y2_rows, chunk_rows = [wide[:, 0]], []
    for d, rows in ((DST_Y2, y2_rows), (DST_CHUNK, chunk_rows)):
        k = dst == d
        rows.append(_runs(out[k], n[k] // w[k] * R[k]))
    y2_rows, chunk_rows = np.concatenate(y2_rows), np.concatenate(chunk_rows)
    if not (np.array_equal(np.bincount(y2_rows[(0 <= y2_rows)
                                               & (y2_rows < n_sell)],
                                       minlength=n_sell),
                           np.ones(n_sell, dtype=np.int64))
            and y2_rows.size == n_sell
            and np.array_equal(np.sort(chunk_rows),
                               np.arange(res["chunk_rows"]))):
        raise ValueError("the schedule does not write every sell row of y2 "
                         "and every chunk row exactly once")
    if wide.size and not np.all(
            (wide[:, 1] >= 0) & (wide[:, 2] >= 1) & (wide[:, 3] >= 1)
            & (wide[:, 1] + (wide[:, 2] - 1) * wide[:, 3]
               < res["chunk_rows"])):
        raise ValueError("a wide row reads outside the chunk rows")
    m = mask > 0
    bit = (((mask[m, None] >> np.arange(VPB)) & 1) > 0)
    done = (tot[m, None] + np.arange(VPB))[bit]
    if not (np.all(tot[m] >= 0) and np.all(mask < (1 << n))
            and np.all((0 <= done) & (done < res["n_tot"]))
            and np.isin(res["inc_tot"], done).all()):
        raise ValueError("a long scalar reads a vreg total that the "
                         "schedule does not compute")


def to_device(meta, res: Dict, streams: List[Dict], dev) -> Dict:
    """The numpy tables of ``prepare`` -> tensors on ``dev``, checked
    against the bounds the kernel does not check (``_check_schedule``),
    with the kernel's stream descriptor table (pointers of the uploaded
    ``streams``) and the plain version's padded incidence lists."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n_tot = res["n_tot"]
    _check_schedule(meta, res)
    if res["inc_tot"].size and not (0 <= res["inc_tot"].min()
                                    and res["inc_tot"].max() < n_tot):
        raise ValueError("a long scalar names a vreg total that does not "
                         "exist")
    if (res["inc_ptr"].shape != (meta.n_long + 1,)
            or res["inc_ptr"][-1] != res["inc_tot"].size):
        raise ValueError("the incidence lists do not fit the plan")
    if int(res["src"].max(initial=0)) > meta.n_y2_rows:
        raise ValueError("the resident source table names a row past the "
                         "zero row")
    _check_residue(meta, res)
    desc = np.zeros((len(streams), len(DESC_FIELDS)), dtype=np.int64)
    desc[:, 0] = [st["wins"].data_ptr() for st in streams]
    desc[:, 1] = [st["vals"].data_ptr() for st in streams]
    desc[:, 2] = [st["idx"].data_ptr() for st in streams]
    desc[:, 3:] = [[P, stride] for P, stride, _ in meta.streams]
    # plain version: the lists padded to one length (pad: the zero
    # appended to the totals, x 0)
    counts = np.diff(res["inc_ptr"])
    width = int(counts.max(initial=1))
    pad_t = np.full((meta.n_long, width), n_tot, dtype=np.int64)
    pad_m = np.zeros((meta.n_long, width), dtype=np.int32)
    col = np.arange(res["inc_tot"].size) - np.repeat(res["inc_ptr"][:-1],
                                                     counts)
    row = np.repeat(np.arange(meta.n_long), counts)
    pad_t[row, col] = res["inc_tot"]
    pad_m[row, col] = res["inc_mult"]
    return dict(
        src=t(res["src"]), desc=t(desc), items=t(res["items"]),
        wide=t(res["wide"]), chunk_rows=res["chunk_rows"],
        inc_ptr=t(res["inc_ptr"]), inc_tot=t(res["inc_tot"]),
        inc_mult=t(res["inc_mult"]), inc_pad_t=t(pad_t), inc_pad_m=t(pad_m),
        tot_off=res["tot_off"], long_streams=list(res["long_streams"]),
        n_tot=n_tot, **{k: t(res[k]) for k in (
            "res_ent", "res_task", "res_bptr", "res_bent", "res_cols",
            "res_vals")})


def _check_residue(meta, res: Dict) -> None:
    """Raise ValueError unless the residue tables fit: every row's slots
    inside the residue's values, 1 <= slots <= width, a width a power of
    two, every task inside the rows (a wide row alone), every block's
    range inside the rows and every row added in exactly one block.  The
    kernel checks none of it."""
    ent = res["res_ent"].astype(np.int64)
    task = res["res_task"].astype(np.int64)
    bptr = res["res_bptr"].astype(np.int64)
    bent = res["res_bent"].astype(np.int64)
    n, nnz = ent.shape[0], res["res_vals"].shape[0]
    if not (ent.ndim == 2 and ent.shape[1] == len(RES_FIELDS)
            and task.ndim == 2 and task.shape[1] == len(RES_TASK_FIELDS)
            and bptr.shape == (meta.B_pad + 1,)
            and res["res_cols"].shape == (nnz,) and n * LANES < 2 ** 31
            and res["res_vals"].dtype == (np.float64 if meta.dtype == "f64"
                                          else np.float32)):
        raise ValueError("the residue tables have the wrong shape or type")
    slot, length, w = ent.T
    if n and not np.all((slot >= 0) & (length >= 1) & (length <= w)
                        & (slot + length <= nnz) & ((w & (w - 1)) == 0)):
        raise ValueError("a residue row reads outside the residue")
    if res["res_cols"].size and not (
            0 <= res["res_cols"].min()
            and res["res_cols"].max() < meta.s_rows * LANES):
        raise ValueError("a residue slot names a word outside x")
    f, k = task.T
    if not (np.all((f >= 0) & (k >= 1) & (k <= RES_LANES) & (f + k <= n))
            and np.all(w[_runs(f[k > 1], k[k > 1])] < RES_WARP_MIN)
            and np.array_equal(np.sort(_runs(f, k)), np.arange(n))):
        raise ValueError("the residue tasks do not cover every row once")
    if not (bptr[0] == 0 and bptr[-1] == n and np.all(np.diff(bptr) >= 0)
            and np.array_equal(np.sort(bent >> 7), np.arange(n))):
        raise ValueError("the residue's block table does not add every row "
                         "once")


def _check(fn: str, meta, arrays: Dict, x: torch.Tensor, iters,
           kv: int = 1, stamps: torch.Tensor = None) -> str:
    """Validate a resident call on ``kv`` x tables stacked as (kv*s_rows,
    128) (kv > 1: one step); return the kernel instance's value type."""
    res = arrays.get("resident")
    if res is None:
        raise ValueError(f"{fn}: the plan has no resident tables (the "
                         "empty plan, or tables carried from the reference)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if kv not in KV_SIZES:
        raise ValueError(f"{fn}: kv {kv!r} must be one of {KV_SIZES}")
    xdt = torch.float64 if meta.dtype == "f64" else torch.float32
    if (x.dtype != xdt or tuple(x.shape) != (kv * meta.s_rows, LANES)
            or not x.is_contiguous()):
        raise ValueError(
            f"{fn}: x must be a contiguous {xdt} ({kv * meta.s_rows}, "
            f"{LANES}) tensor ({kv} x table(s) of {meta.s_rows} rows), got "
            f"{x.dtype} {tuple(x.shape)}")
    if res["src"].device != x.device:
        raise ValueError(f"{fn}: x is on {x.device}, the tables on "
                         f"{res['src'].device}")
    if not isinstance(iters, int) or iters < 1:
        raise ValueError(f"{fn}: iters must be an int >= 1, got {iters!r}")
    if kv > 1 and iters != 1:
        raise ValueError(f"{fn}: iters must be 1 at kv = {kv} (an SpMM "
                         f"pass is one step), got {iters}")
    if (x.device.type == "cuda"
            and x.device.index != torch.cuda.current_device()):
        # the kernel library launches on the current device's context
        raise ValueError(f"{fn}: {x.device} is not the current CUDA "
                         "device (use torch.cuda.device(...))")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be 16-byte aligned (the tap reads "
                         "it in 16-byte vectors)")
    if stamps is not None and (
            stamps.device != x.device or x.device.type != "cuda"
            or stamps.dtype != torch.int64
            or tuple(stamps.shape) != (STAMP_WORDS,)):
        raise ValueError(f"{fn}: stamps must be an int64 ({STAMP_WORDS},) "
                         f"tensor on x's CUDA device, got {stamps.dtype} "
                         f"{tuple(stamps.shape)} on {stamps.device} (x on "
                         f"{x.device})")
    return meta.dtype


def resident_loop(meta, arrays: Dict, x2d: torch.Tensor, iters: int,
                  stamps: torch.Tensor = None,
                  scratch: Dict = None) -> torch.Tensor:
    """K6 on CUDA tensors (one cooperative launch for all ``iters``
    steps), ``resident_loop_plain`` on CPU tensors.  x2d (s_rows, 128),
    f64 for f64 plans and f32 otherwise, is never written.  Returns y
    (n_rows,) in the plan's row order and output dtype.

    ``stamps``, an int64 CUDA tensor of ``STAMP_WORDS`` on x2d's device,
    turns on the kernel's phase clock (``STAMPS`` names its words): the
    nanoseconds of each phase summed over the steps, each up to the
    ``grid.sync()`` that ends it, and the grid it ran on.  The plain
    version has no clock.  ``scratch``, a dict, receives the kernel's
    last y2 and out (the smoke holds them to the plain version's)."""
    name = _check("resident_loop", meta, arrays, x2d, iters, 1, stamps)
    if x2d.device.type == "cpu":
        return resident_loop_plain(meta, arrays, x2d, iters)
    entry = f"dasp_resident_{name}"
    y2, out = launch_entry(getattr(_build.library(), entry), entry, meta,
                           arrays, x2d, iters, stamps)
    resident_loop.launches[name] += 1
    if scratch is not None:
        scratch.update(y2=y2, out=out)
    return _finish(meta, out)


resident_loop.launches = {"f32": 0, "bf16": 0, "f64": 0}


def spmm_loop(meta, arrays: Dict, x3d: torch.Tensor, kv: int,
              stamps: torch.Tensor = None,
              scratch: Dict = None) -> torch.Tensor:
    """An SpMM pass: K6's kv-table instance at one step (one cooperative
    launch) on CUDA tensors, ``spmm_loop_plain`` on CPU tensors.  x3d
    (kv*s_rows, 128), kv in (1, 2, 4, 8), the stacked x tables, is never
    written.  Returns y (kv, n_rows) in the plan's row order and output
    dtype; row j equals ``resident_loop`` at one step on table j, bit for
    bit.  kv = 1 is that step.  ``stamps`` (at kv = 1 or 8) and
    ``scratch`` (y2 and out, (kv, ...)) as for ``resident_loop``."""
    name = _check("spmm_loop", meta, arrays, x3d, 1, kv, stamps)
    if kv == 1:
        return resident_loop(meta, arrays, x3d, 1, stamps,
                             scratch).unsqueeze(0)
    if x3d.device.type == "cpu":
        return spmm_loop_plain(meta, arrays, x3d, kv)
    entry = f"dasp_resident_{name}_kv{kv}"
    y2, out = launch_entry(getattr(_build.library(), entry), entry, meta,
                           arrays, x3d, 1, stamps, kv)
    spmm_loop.launches[f"{name}_kv{kv}"] += 1
    if scratch is not None:
        scratch.update(y2=y2, out=out)
    return _finish(meta, out)


spmm_loop.launches = {f"{d}_kv{kv}": 0 for d in ("f32", "bf16", "f64")
                      for kv in KV_SIZES[1:]}


def launch_entry(fn, entry: str, meta, arrays: Dict, x: torch.Tensor,
                 iters: int, stamps: torch.Tensor = None, kv: int = 1):
    """Allocate K6's buffers on x's device, one set per x table, and
    launch the C entry point ``fn`` (named ``entry``, with
    ``_build.SIGNATURES["dasp_resident_f32"]``'s arguments) for the kv
    tables of x, on a call that ``_check`` has passed; return the last
    step's y2 and out ((kv, ...) at kv > 1).  Raises if the launch is
    refused (the launcher refuses kv, iters and x_scr that do not fit the
    entry, and ``stamps`` where the entry has no clock: kv other than 1
    and 8).  It counts no launch: ``resident_loop`` and ``spmm_loop`` do,
    and probes/k6_levers.py launches its own builds of the kernel through
    it."""
    res = arrays["resident"]
    dev, dt = x.device, x.dtype
    lead = (kv,) if kv > 1 else ()
    x_scr = torch.empty_like(x) if iters > 1 else None   # the taps' x
    n_res = max(res["res_ent"].shape[0], 1)
    n_cbuf = max(res["chunk_rows"], 1) * LANES
    n_tot = max(res["n_tot"], 1)
    rsum = torch.empty(lead + (n_res,), dtype=dt, device=dev)
    y2 = torch.empty(lead + (meta.n_y2_rows + 1, LANES), dtype=dt,
                     device=dev)
    cbuf = torch.empty(lead + (n_cbuf,), dtype=dt, device=dev)
    tot = torch.empty(lead + (n_tot,), dtype=dt, device=dev)
    out = torch.empty(lead + (meta.B_pad, LANES), dtype=dt, device=dev)
    rc = fn(
        res["desc"].data_ptr(), res["items"].data_ptr(),
        res["items"].shape[0], res["wide"].data_ptr(), res["wide"].shape[0],
        cbuf.data_ptr(), res["inc_ptr"].data_ptr(),
        res["inc_tot"].data_ptr(), res["inc_mult"].data_ptr(), meta.n_long,
        meta.n_long_rows, res["src"].data_ptr(),
        arrays["out_perm"].data_ptr(), meta.B_pad, meta.k_used,
        meta.n_y2_rows, x.data_ptr(),
        None if x_scr is None else x_scr.data_ptr(), x.numel() // kv,
        y2.data_ptr(), tot.data_ptr(), out.data_ptr(),
        res["res_ent"].data_ptr(), res["res_task"].data_ptr(),
        res["res_task"].shape[0], res["res_cols"].data_ptr(),
        res["res_vals"].data_ptr(), rsum.data_ptr(),
        res["res_bptr"].data_ptr(), res["res_bent"].data_ptr(), iters,
        float(cb.TAP), None if stamps is None else stamps.data_ptr(), kv,
        n_cbuf, n_tot, n_res, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry)
    return y2, out


# what csrc/resident.cu's dasp_resident_info reports of an instance
INFO_FIELDS = ("registers", "local_bytes", "static_shared_bytes",
               "dynamic_shared_bytes", "blocks_per_sm", "threads")


def kernel_info(name: str, kv: int = 1) -> dict:
    """What the build gave K6's instance ``name`` ("f32", "bf16", "f64")
    at ``kv`` x tables (1: the chained loop; 2, 4, 8: the SpMM pass):
    registers and local (stack and spill) bytes a thread, static shared
    bytes a block, the dynamic shared bytes its launch asks for,
    co-resident blocks a SM at that size, and threads a block
    (``INFO_FIELDS``).  Builds the library: needs the card."""
    if name not in resident_loop.launches or kv not in KV_SIZES:
        raise ValueError(f"kernel_info: no K6 instance {name!r} at kv "
                         f"{kv!r} (one of {tuple(resident_loop.launches)} "
                         f"at {KV_SIZES})")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_info: K6's build figures need a CUDA "
                           "card (torch.cuda.is_available() is False)")
    out = (ctypes.c_int * len(INFO_FIELDS))()
    _build.check(_build.library().dasp_resident_info(
        tuple(resident_loop.launches).index(name), kv,
        ctypes.addressof(out)), "dasp_resident_info")
    return dict(zip(INFO_FIELDS, out))


def resident_loop_plain(meta, arrays: Dict, x2d: torch.Tensor,
                        iters: int) -> torch.Tensor:
    """The computation of ``resident_loop`` in plain PyTorch on any
    device, in the kernel's order of arithmetic (module docstring)."""
    _check("resident_loop_plain", meta, arrays, x2d, iters)
    return _plain(meta, arrays, x2d, iters)


def spmm_loop_plain(meta, arrays: Dict, x3d: torch.Tensor,
                    kv: int) -> torch.Tensor:
    """The computation of ``spmm_loop`` in plain PyTorch on any device:
    ``resident_loop_plain`` at one step with the kv x tables as a leading
    batch dimension (every op elementwise or a gather, so row j is that
    of table j alone, bit for bit)."""
    _check("spmm_loop_plain", meta, arrays, x3d, 1, kv)
    return _plain(meta, arrays, x3d.view(kv, meta.s_rows, LANES), 1)


def _plain(meta, arrays: Dict, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` steps from the x table x (s_rows, 128), or one step from
    the kv tables x (kv, s_rows, 128): y (n_rows,) or (kv, n_rows)."""
    x0 = x
    for it in range(iters):
        y2 = y2_plain(meta, arrays, x)
        out = outgather_plain(arrays["resident"]["src"], arrays["out_perm"],
                              y2)
        if it + 1 < iters:
            x = x + y2[..., 0, :] * cb.TAP
    o = arrays["overflow"]
    if o is not None and o["tree_rows"].shape[0]:
        flat = out.view(*out.shape[:-2], -1)
        flat[..., o["tree_rows"]] = (
            flat[..., o["tree_rows"]]
            + residue_plain(o, x0)[..., o["sort_back"]])
    return _finish(meta, out)


def residue_plain(o: Dict, x: torch.Tensor) -> torch.Tensor:
    """The COO residue's row sums from the x table x (s_rows, 128), or
    each of the tables x (kv, s_rows, 128), concatenated in tree order
    (``sort_back`` gives a row's place), in the kernel's order: a tree
    narrower than RES_WARP_MIN from its slot 0 over its slots in order, a
    wider one per lane (lane i: slots i, i + 32, ...) and then over the
    lanes by a tree; a padding slot adds the zero.  Explicit loops, since
    a reduction's order on the CPU is not sequential."""
    lead = tuple(x.shape[:-2])
    ax = len(lead) + 1                       # the slot axis of a tree
    pc = torch.cat([o["vals"] * x.reshape(*lead, -1)[..., o["cols"]],
                    x.new_zeros(lead + (1,))], -1)
    sums = []
    for t in o["trees"]:
        p = pc[..., t]
        if t.shape[1] >= RES_WARP_MIN:
            p = p.view(*lead, t.shape[0], -1, RES_LANES)
        acc = p.select(ax, 0)
        for k in range(1, p.shape[ax]):
            acc = acc + p.select(ax, k)
        if t.shape[1] >= RES_WARP_MIN:
            for s_ in RES_TREE:
                acc = acc[..., :s_] + acc[..., s_:2 * s_]
            acc = acc[..., 0]
        sums.append(acc)
    return torch.cat(sums, -1)


def y2_plain(meta, arrays: Dict, x: torch.Tensor) -> torch.Tensor:
    """One step's y2 from the x table x (s_rows, 128), or from each of the
    tables x (kv, s_rows, 128): the sell rows, the long rows and the zero
    row, (n_y2_rows + 1, 128) (or (kv, ...)) in x's dtype."""
    lead = tuple(x.shape[:-2])
    kv = lead[0] if lead else 1
    parts = [colsum_multi_plain(st["wins"], st["vals"], st["idx"],
                                x.reshape(-1, LANES), stride, kv
                                ).view(*lead, -1, LANES)
             for (_, stride, _), st in zip(meta.streams, arrays["streams"])]
    rows = [_folds_plain(meta, parts, lead)]
    if meta.n_long:
        rows.append(_long_rows_plain(meta, arrays["resident"], parts, lead))
    return torch.cat(rows + [x.new_zeros(lead + (1, LANES))], -2)


def _folds_plain(meta, parts: List[torch.Tensor], lead) -> torch.Tensor:
    """The sell rows of y2 from the streams' partials (lead + (rows,
    128)): per vreg its F levels in order, per chunk of VPB vregs their
    sums in order, per slice its chunks in order."""
    rows = [parts[0].new_zeros(lead + (0, LANES))]
    for stream, off, n_slices, w8, stride in meta.sell_segs:
        R_st = SUB // meta.streams[stream][1]
        R = SUB // stride
        F = R_st // R
        p = parts[stream][..., off * R_st:(off + n_slices * w8) * R_st,
                          :].view(*lead, n_slices, w8, R, F, LANES)
        lv = p[..., 0, :]                    # (..., n_slices, w8, R, 128)
        for f in range(1, F):
            lv = lv + p[..., f, :]
        y = None
        for c0 in range(0, w8, VPB):
            c = lv[..., c0, :, :]
            for w in range(c0 + 1, min(w8, c0 + VPB)):
                c = c + lv[..., w, :, :]
            y = c if y is None else y + c
        rows.append(y.reshape(*lead, n_slices * R, LANES))
    return torch.cat(rows, -2)


def _long_rows_plain(meta, res: Dict, parts: List[torch.Tensor],
                     lead) -> torch.Tensor:
    """The long rows of y2: per-vreg totals of the long streams, the
    scalars as multiplicity-weighted sums of totals, packed LONG_PACK to a
    row with lane 127 zero (lead + (n_long_rows, 128))."""
    tots = []
    for s in res["long_streams"]:
        _, stride, nv = meta.streams[s]
        c = parts[s].view(*lead, nv, SUB // stride, LANES)
        acc = c[..., 0, :]
        for r in range(1, c.shape[-2]):
            acc = acc + c[..., r, :]
        for s_ in TREE:
            acc = acc[..., :s_] + acc[..., s_:2 * s_]
        tots.append(acc[..., 0])
    T = torch.cat(tots + [parts[0].new_zeros(lead + (1,))], -1)
    ti, m = res["inc_pad_t"], res["inc_pad_m"].to(T.dtype)
    acc = m[:, 0] * T[..., ti[:, 0]]
    for c in range(1, ti.shape[1]):
        acc = acc + m[:, c] * T[..., ti[:, c]]
    rows = T.new_zeros(lead + (meta.n_long_rows * LONG_PACK,))
    rows[..., :meta.n_long] = acc
    return torch.nn.functional.pad(
        rows.view(*lead, meta.n_long_rows, LONG_PACK), (0, LANES - LONG_PACK))


def _finish(meta, out: torch.Tensor) -> torch.Tensor:
    """The last step's out (B_pad, 128), or the (kv, B_pad, 128) of a pass
    (its residue added) -> y: the first n_rows words of each; bf16 plans
    round y once (one torch op on the card)."""
    return cb._narrow(meta, out.reshape(*out.shape[:-2], -1)[
        ..., :meta.n_rows])
