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
:1026-1034, not the streamed loop's y[0] scalar).  The y returned is the
last step's output plus the whole COO residue, added once, after the loop,
from the caller's x (:1212-1230); bf16 plans round y once, at the end.

Host half (``prepare``, numpy, before upload): the outgather source table
stripped to the zero row (the streamed path's residue rows of y2 do not
exist here, :245), one fold descriptor per sell row of y2, and the long-row
incidence as compact per-scalar lists of (total index, multiplicity),
composed from ``long_idx`` and ``long_gat`` as the reference composes its
dense incidence matrices (:246-280).  Every plan with a stream is resident;
the empty plan is not (the reference fails there, ``ROADMAP.md`` §3).

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
- sell fold of y2 row r: the w8 x F partial rows in (w, f) row-major
  order, starting from the (0, 0) row;
- vreg total: per lane, the R partial rows in order; then a tree over the
  128 lanes, ``c[l] += c[l + s]`` for s = 64, 32, ..., 1;
- long scalar p: its (total, multiplicity) list in ascending total index,
  ``m * total`` rounded and added left to right;
- outgather: K2's, the k_used slots in order (zero-row slots skipped);
- tap: ``x + y2[0] * TAP``, product then sum.

``resident_loop`` takes a CPU tensor to ``resident_loop_plain`` and a CUDA
tensor to the kernel; there is no fallback from one to the other.
``resident_loop.launches`` counts kernel launches per instance ("f32",
"bf16", "f64").
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..wplan import SUB, LANES, LONG_PACK
from . import _build
from . import cuda_backend as cb
from .colsum import colsum_plain
from .outgather import outgather_plain

# int64 fields of one stream's row of the kernel's descriptor table, in
# the order of csrc/resident.cu's enum: table pointers, shape, and the
# stream's first vreg, partial row and vreg total in the concatenated
# spaces (-1: the stream has no long rows and no totals)
DESC_FIELDS = ("wins", "vals", "idx", "P", "stride", "NV", "vreg_off",
               "part_off", "tot_off")
TREE = (64, 32, 16, 8, 4, 2, 1)     # lane-tree steps of a vreg total


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
    Z = meta.n_y2_rows
    r_st = [SUB // stride for _, stride, _ in meta.streams]
    nv = [NV for _, _, NV in meta.streams]
    vreg_off = np.concatenate([[0], np.cumsum(nv)]).astype(np.int64)
    part_off = np.concatenate(
        [[0], np.cumsum([n * r for n, r in zip(nv, r_st)])]).astype(np.int64)
    long_streams = sorted({s for s, _ in meta.long_groups})
    tot_off = np.full(len(nv), -1, dtype=np.int64)
    n_tot = 0
    for s in long_streams:
        tot_off[s] = n_tot
        n_tot += nv[s]

    # y2 row r of a sell segment sums partial rows start + w * R_st + f,
    # w < w8, f < F (the streamed glue's reshape(n, w8, R, F).sum((1, 3)))
    fold = [np.zeros((0, 4), dtype=np.int64)]
    for stream, off, n_slices, w8, stride in meta.sell_segs:
        R = SUB // stride
        F = r_st[stream] // R
        start = (part_off[stream]
                 + (off + np.arange(n_slices)[:, None] * w8) * r_st[stream]
                 + np.arange(R)[None, :] * F).reshape(-1)
        fold.append(np.stack([start, np.full_like(start, w8),
                              np.full_like(start, F),
                              np.full_like(start, r_st[stream])], axis=1))
    fold = np.concatenate(fold)
    if fold.shape[0] != Z - meta.n_long_rows:
        raise ValueError(f"sell segments give {fold.shape[0]} y2 rows, the "
                         f"plan has {Z - meta.n_long_rows}")

    layout = np.stack([np.array([P for P, _, _ in meta.streams]),
                       np.array([st for _, st, _ in meta.streams]),
                       np.array(nv), vreg_off[:-1], part_off[:-1],
                       tot_off], axis=1).astype(np.int64)
    inc_ptr, inc_tot, inc_mult = _incidence(meta, arrays, tot_off, n_tot)
    arrays["resident"] = dict(
        src=np.minimum(arrays["out_src"], Z).astype(np.int32),
        fold=fold, layout=layout, long_streams=long_streams,
        part_rows=int(part_off[-1]), n_tot=n_tot,
        inc_ptr=inc_ptr, inc_tot=inc_tot, inc_mult=inc_mult)


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


def to_device(meta, res: Dict, streams: List[Dict], dev) -> Dict:
    """The numpy tables of ``prepare`` -> tensors on ``dev``, checked
    against the bounds the kernel does not check, with the kernel's
    stream descriptor table (pointers of the uploaded ``streams``) and the
    plain version's grouped views of the same tables."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    fold, n_tot = res["fold"], res["n_tot"]
    last = fold[:, 0] + (fold[:, 1] - 1) * fold[:, 3] + fold[:, 2] - 1
    if fold.size and (fold[:, 0].min() < 0
                      or last.max() >= res["part_rows"]):
        raise ValueError("a sell fold reads outside the partials")
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
    desc = np.zeros((len(streams), len(DESC_FIELDS)), dtype=np.int64)
    desc[:, 0] = [st["wins"].data_ptr() for st in streams]
    desc[:, 1] = [st["vals"].data_ptr() for st in streams]
    desc[:, 2] = [st["idx"].data_ptr() for st in streams]
    desc[:, 3:] = res["layout"]
    # plain version: fold rows grouped by (w8, F, R_st), and the lists
    # padded to one length (pad: the zero appended to the totals, x 0)
    classes = np.unique(fold[:, 1:], axis=0) if fold.size else []
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
        src=t(res["src"]), fold=t(fold), desc=t(desc),
        inc_ptr=t(res["inc_ptr"]), inc_tot=t(res["inc_tot"]),
        inc_mult=t(res["inc_mult"]), inc_pad_t=t(pad_t), inc_pad_m=t(pad_m),
        fold_classes=[(int(w8), int(F), int(rs), t(np.flatnonzero(
            (fold[:, 1] == w8) & (fold[:, 2] == F) & (fold[:, 3] == rs))))
            for w8, F, rs in classes],
        layout=res["layout"], long_streams=list(res["long_streams"]),
        part_rows=res["part_rows"], n_tot=n_tot,
        nv_total=int(res["layout"][:, 2].sum()))


def _check(fn: str, meta, arrays: Dict, x2d: torch.Tensor, iters) -> str:
    """Validate a resident call; return the kernel instance's name."""
    res = arrays.get("resident")
    if res is None:
        raise ValueError(f"{fn}: the plan has no resident tables (empty "
                         "plan, or built with force_streamed=True)")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x2d.device}")
    xdt = torch.float64 if meta.dtype == "f64" else torch.float32
    if (x2d.dtype != xdt or tuple(x2d.shape) != (meta.s_rows, LANES)
            or not x2d.is_contiguous()):
        raise ValueError(
            f"{fn}: x must be a contiguous {xdt} ({meta.s_rows}, {LANES}) "
            f"tensor, got {x2d.dtype} {tuple(x2d.shape)}")
    if res["src"].device != x2d.device:
        raise ValueError(f"{fn}: x is on {x2d.device}, the tables on "
                         f"{res['src'].device}")
    if not isinstance(iters, int) or iters < 1:
        raise ValueError(f"{fn}: iters must be an int >= 1, got {iters!r}")
    if (x2d.device.type == "cuda"
            and x2d.device.index != torch.cuda.current_device()):
        # the kernel library launches on the current device's context
        raise ValueError(f"{fn}: {x2d.device} is not the current CUDA "
                         "device (use torch.cuda.device(...))")
    return meta.dtype


def resident_loop(meta, arrays: Dict, x2d: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """K6 on CUDA tensors (one cooperative launch for all ``iters``
    steps), ``resident_loop_plain`` on CPU tensors.  x2d (s_rows, 128),
    f64 for f64 plans and f32 otherwise, is never written.  Returns y
    (n_rows,) in the plan's row order and output dtype."""
    name = _check("resident_loop", meta, arrays, x2d, iters)
    if x2d.device.type == "cpu":
        return resident_loop_plain(meta, arrays, x2d, iters)
    res = arrays["resident"]
    dev, dt = x2d.device, x2d.dtype
    x_scr = torch.empty_like(x2d)
    part = torch.empty((res["part_rows"], LANES), dtype=dt, device=dev)
    y2 = torch.empty((meta.n_y2_rows + 1, LANES), dtype=dt, device=dev)
    tot = torch.empty(max(res["n_tot"], 1), dtype=dt, device=dev)
    out = torch.empty((meta.B_pad, LANES), dtype=dt, device=dev)
    entry = f"dasp_resident_{name}"
    rc = getattr(_build.library(), entry)(
        res["desc"].data_ptr(), len(meta.streams), res["nv_total"],
        res["n_tot"], res["fold"].data_ptr(), res["fold"].shape[0],
        res["inc_ptr"].data_ptr(), res["inc_tot"].data_ptr(),
        res["inc_mult"].data_ptr(), meta.n_long, meta.n_long_rows,
        res["src"].data_ptr(), arrays["out_perm"].data_ptr(), meta.B_pad,
        meta.k_used, meta.n_y2_rows, x2d.data_ptr(), x_scr.data_ptr(),
        x2d.numel(), part.data_ptr(), y2.data_ptr(), tot.data_ptr(),
        out.data_ptr(), iters, float(cb.TAP),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, entry)
    resident_loop.launches[name] += 1
    return _finish(meta, arrays, x2d, out)


resident_loop.launches = {"f32": 0, "bf16": 0, "f64": 0}


def resident_loop_plain(meta, arrays: Dict, x2d: torch.Tensor,
                        iters: int) -> torch.Tensor:
    """The computation of ``resident_loop`` in plain PyTorch on any
    device, in the kernel's order of arithmetic (module docstring)."""
    _check("resident_loop_plain", meta, arrays, x2d, iters)
    res = arrays["resident"]
    x = x2d.clone()
    zero = x.new_zeros((1, LANES))
    for _ in range(iters):
        part = torch.cat([colsum_plain(st["wins"], st["vals"], st["idx"], x,
                                       stride)
                          for (_, stride, _), st in zip(meta.streams,
                                                        arrays["streams"])])
        rows = [_folds_plain(res, part)]
        if meta.n_long:
            rows.append(_long_rows_plain(meta, res, part))
        y2 = torch.cat(rows + [zero])
        out = outgather_plain(res["src"], arrays["out_perm"], y2)
        x = x + y2[0] * cb.TAP
    return _finish(meta, arrays, x2d, out)


def _folds_plain(res: Dict, part: torch.Tensor) -> torch.Tensor:
    """The sell rows of y2, each the sum of its w8 x F partial rows."""
    y = part.new_empty((res["fold"].shape[0], LANES))
    for w8, F, r_st, rows in res["fold_classes"]:
        start = res["fold"][rows, 0]
        acc = part[start]
        for w in range(w8):
            for f in range(F):
                if w or f:
                    acc = acc + part[start + (w * r_st + f)]
        y[rows] = acc
    return y


def _long_rows_plain(meta, res: Dict, part: torch.Tensor) -> torch.Tensor:
    """The long rows of y2: per-vreg totals of the long streams, the
    scalars as multiplicity-weighted sums of totals, packed LONG_PACK to a
    row with lane 127 zero."""
    tots = []
    for s in res["long_streams"]:
        _, stride, nv = meta.streams[s]
        R = SUB // stride
        p0 = int(res["layout"][s, 4])
        c = part[p0:p0 + nv * R].view(nv, R, LANES)
        acc = c[:, 0]
        for r in range(1, R):
            acc = acc + c[:, r]
        for s_ in TREE:
            acc = acc[:, :s_] + acc[:, s_:2 * s_]
        tots.append(acc[:, 0])
    T = torch.cat(tots + [part.new_zeros(1)])
    ti, m = res["inc_pad_t"], res["inc_pad_m"].to(part.dtype)
    acc = m[:, 0] * T[ti[:, 0]]
    for c in range(1, ti.shape[1]):
        acc = acc + m[:, c] * T[ti[:, c]]
    rows = part.new_zeros(meta.n_long_rows * LONG_PACK)
    rows[:meta.n_long] = acc
    return torch.nn.functional.pad(
        rows.view(meta.n_long_rows, LONG_PACK), (0, LANES - LONG_PACK))


def _finish(meta, arrays: Dict, x2d: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """The last step's out -> y: every residue row's sum, from the
    caller's x, added once at its row; bf16 plans round y once."""
    y = out.reshape(-1)[:meta.n_rows]
    o = arrays["overflow"]
    if o is not None and o["tree_rows"].shape[0]:
        y = y.index_add(0, o["tree_rows"],
                        cb.residue_sums(o, x2d)[o["sort_back"]])
    return cb._narrow(meta, y)
