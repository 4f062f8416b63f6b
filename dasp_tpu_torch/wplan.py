"""Windowed pack plan (WPlan): the Pallas-native matrix format.

This is the TPU-native analog of the reference's packed-fragment formats
(``dasp_f64.h:595-1157``), redesigned around what the TPU vector unit does
fast (measured, tools/gather_bench.py):

  * lane-gather (``take_along_axis(.., axis=1)``) runs at copy speed;
  * sublane-gather is vreg-local (8 rows max);
  * an (8,128) window of x loads from VMEM with one dynamic slice.

Every nonzero is packed into a slot of an (8,128) **vreg tile** whose values
are fetched from x by a two-stage vreg-local shuffle.  With ``idx`` the
tile's int32 metadata and ``xw_p = x2d[w_p : w_p+8]`` one of the vreg's P
1024-aligned *windows*::

    r    = (idx >> 7) & 7       # routing table, indexed (sublane, lam)
    lam  = idx & 127            # per-slot lane-gather index
    crnd = idx >> 10            # per-CELL window (round) id, at (i, lam)
    xsel[i,j] = sum_p where(crnd[i,j] == p, xw_p[i,j], 0)
    g1[i,j]   = xsel[r[i,j], j]
    g2[i,j]   = g1[i, lam[i,j]]  # slot (i,j) reads xw_crnd[r[i,lam], lam]

The packer *routes* each element: it picks a slot (i, j) and claims the
shared routing cell ``r[i, lam]``; two elements may share a cell only if
they read the same x word (a free broadcast).  Windows are 1024-aligned so
a source's sublane coordinate ``q_rel = (col//128) % 8`` is
window-independent and the routing table is shared across rounds.  Because
a cell maps to exactly one x word it also maps to exactly one window, so
the round tag is CELL data (bits >= 10 at (i, lam)): the kernel pays one
compare+select per round and runs the two gathers once per vreg — measured
1.82 -> 0.89 ns/vreg/round on v5e (tools/roundcost_ab.py).

**Block-aligned output layout.**  Slice b holds exactly the original rows
[128b, 128b+128) (length-sorted *within* the block — the reference sorts
rows globally, ``dasp_f64.h:914``; here the sort must stay block-local so
both the window gather and the un-permutation stay cheap).  Per-block
output assembly is then a tiny gather kernel: block b of y is the sum of up
to K lane-gathered source rows of the stacked partial-output matrix y2
(primary slice row, remainder-tail row, and the long-scalar rows), which
replaces the reference's order_rid un-permutation (``dasp_f64.h:959-976``)
without any element scatter.

Row families (same taxonomy as the reference's analyzer,
``dasp_f64.h:499-531``, unified):
  * rows < block_longest nnz  -> SELL slice of their block, adaptive
    quantized width W8 (the adaptive row-block width of
    ``dasp_f64.h:1052-1083``); tails spill to a per-block remainder slice
    (the irregular tail of ``dasp_f64.h:1077-1106``) summed in via the
    output kernel.  Narrow slices subsume the short-row strategies.
  * rows >= block_longest nnz -> long rows: column-sorted elements dealt so
    a sublane row holds 128 consecutive nonzeros; reduction sums every slot
    of the row's vregs (fusing away ``longPart_sum``, ``dasp_f64.h:53-75``).

Unroutable elements (window budget or routing-cell conflicts) overflow to a
COO list executed by the XLA backend and added into y.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import DaspConfig, DEFAULT_CONFIG
from .sparse import CSRMatrix, from_coo
from .trace import phase, span
from .utils import gc_paused

LANES = 128
SUB = 8
VREG = 1024
LONG_PACK = 127          # long scalars per y2 row (lane 127 stays zero)

# SELL slice widths in vregs.  Power-of-two classes match the reference's
# K=4-step width growth (dasp_f64.h:1052-1083); the intermediate classes
# (3, 6, 12, 24) exist because mesh/FEM blocks with ~width*1.05 row
# lengths otherwise quantize UP a full power of two — measured on the
# assembled poisson3d operator: 16.5-nnz rows forced w8=4 (32 slots/row,
# 2.3 slots/nnz plan-wide); with w8=3 the same blocks pack at ~1.5.
# Streams key on (P, stride) only, so extra width classes add no kernel
# streams — only segment bookkeeping.
W8_CLASSES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
P_CLASSES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
# Every vreg's window list is capped at P_CLASSES[-1]=32 by construction
# (sequential chunking, window bin-packing and reject-retry re-chunking all
# break at 32 windows), so stream classes are always statically unrolled.
# Dynamic (P>32) round classes existed through round 3; round 4 measured
# static splitting to win up to ~200x padding (the structural worst case is
# 32x: 32 windows x 1 element per 1024-slot vreg) and round 5 removed the
# serialized dynamic-round kernels outright.
# LONG_P_CAP bounds the native router's window table; with the 32-window
# caps above it is never the binding constraint (kept > 32 so the router
# reports, rather than rejects, an over-cap vreg if an invariant breaks).
LONG_P_CAP = 512
# output-gather sources per block:
# [0] primary slice, [1..4] length-bucketed shared slices, [5]/[6]
# re-routed tails/conflicts (two shared rem levels) and long-scalar rows,
# allocated dynamically per block (a block rarely uses more than a few).
# The short buckets carry the reference's short-row strategies
# (``dasp_f64.h:595-713``) as strided shared slices: 8/stride row levels
# per lane so 1-4 nnz rows fill the vreg instead of leaving 7/8 sublanes
# as padding; the medium buckets catch 5-16 nnz rows of blocks whose own
# SELL slice would be mostly padding.
K_SOURCES = 7
SHORT_MAX = 4
# (max_len, stride, w8); the first two apply to ALL rows <= 4 nnz, the
# med classes only to rows of blocks that dumped their primary slice.
# The 32/64 classes are a round-4 addition (R-MAT finding): dumped rows
# of 17-64 nnz previously fell straight to the overflow pool and came
# back as ~10%-fill rem slices / COO residue on clustered graphs.
SHORT_BUCKETS = ((2, 2, 1), (4, 4, 1))
MED_BUCKETS = ((8, SUB, 1), (16, SUB, 2), (32, SUB, 4), (64, SUB, 8))


@dataclasses.dataclass
class WStream:
    """One Pallas launch: all vregs sharing a round-class P and sublane
    stride (the kernel sums groups of ``stride`` sublanes, emitting
    8/stride output rows per vreg — strided slices hold 8/stride row
    LEVELS per lane, subsuming the reference's short-row strategies)."""
    P: int
    vals: np.ndarray          # (NV*8, 128) float64 (cast at lowering)
    idx: np.ndarray           # (NV*8, 128) int32
    wins: np.ndarray          # (NV, P) int32 row offsets into x2d (mult 8)
    win_counts: np.ndarray    # (NV,) int32 rounds actually used per vreg
    stride: int = SUB

    @property
    def n_vregs(self) -> int:
        return self.wins.shape[0]


@dataclasses.dataclass
class SellSegment:
    """Contiguous run of equal-width slices inside one stream's partials."""
    stream: int
    vreg_offset: int
    n_slices: int
    w8: int
    out_row: int              # first y2 row produced by this segment
    stride: int = SUB         # each slice yields 8/stride y2 rows


@dataclasses.dataclass
class LongGroup:
    """Long rows in one stream sharing a padded vreg-count class; reduced by
    gathering per-vreg totals through a static index matrix."""
    stream: int
    idx: np.ndarray           # (R, nv_c) int32 vreg ids (pad = NV of stream)
    scalar_pos: np.ndarray    # (R,) positions in the row-ordered scalar list


@dataclasses.dataclass
class WPlan:
    n_rows: int
    n_cols: int
    nnz: int
    config: DaspConfig
    s_rows: int               # x2d rows (multiple of 8)
    streams: List[WStream]
    sell: List[SellSegment]
    longs: List[LongGroup]
    n_long: int
    # Output assembly (see pallas_backend.unperm kernel):
    out_src: np.ndarray       # (B, K) int32 y2 source rows (Z = zero row)
    out_perm: np.ndarray      # (B*K, 128) int8 lane indices (0..127; the
                              # device copy upcasts — int8 quarters the
                              # pack-time write traffic and the .npz size)
    n_y2_rows: int            # rows of y2 incl. long rows, excl. zero row
    overflow: Optional[CSRMatrix]
    census: Dict[str, int]
    stats: Dict[str, float]
    # When columns were relabeled at pack time (config.relabel), the old->new
    # column map; x must be scattered through it before entering the kernels
    # (ops.pallas_backend.prep_x).  None = identity.
    col_perm: Optional[np.ndarray] = None
    # Square matrices are permuted SYMMETRICALLY, and an independent row
    # length-grouping may compose on top (row_perm = rs[col_perm]): the
    # kernels emit y in the permuted row order and callers decode with
    # y_original = y[row_perm] (one host gather, same contract as the
    # reference's order_rid, dasp_f64.h:959-976).  None = original order.
    # row_perm == col_perm iff x and y share one index space (on-device
    # iteration; consumers that need it pass config.row_sort="off").
    row_perm: Optional[np.ndarray] = None

    def check(self) -> None:
        """Structural invariants: segments tile their streams exactly, long
        gather ids stay in range, out tables reference valid y2 rows, and
        no element is packed twice."""
        used = [0] * len(self.streams)
        for seg in self.sell:
            end = seg.vreg_offset + seg.n_slices * seg.w8
            assert seg.vreg_offset == used[seg.stream], (
                f"segment gap in stream {seg.stream}: offset "
                f"{seg.vreg_offset} != cursor {used[seg.stream]}")
            assert end <= self.streams[seg.stream].n_vregs
            used[seg.stream] = end
        for lg in self.longs:
            nv = self.streams[lg.stream].n_vregs
            assert int(lg.idx.max(initial=0)) <= nv
            assert int(lg.scalar_pos.max(initial=0)) < max(self.n_long, 1)
        assert int(self.out_src.max(initial=0)) <= self.n_y2_rows
        packed = sum(int(np.count_nonzero(s.vals)) for s in self.streams)
        over = self.overflow.nnz if self.overflow is not None else 0
        # explicit zeros in the input never occupy nonzero slots
        assert packed + over <= self.nnz, "elements double-packed"
        def _is_perm(p, m):
            # O(m) bincount instead of an O(m log m) sort (multi-M rows)
            cnt = np.bincount(p, minlength=m)
            return cnt.size == m and bool((cnt == 1).all())

        if self.col_perm is not None:
            assert self.col_perm.shape == (self.n_cols,)
            assert _is_perm(self.col_perm, self.n_cols), \
                "col_perm must be a permutation"
        if self.row_perm is not None:
            # Producers: the symmetric relabel (row_perm == col_perm,
            # shared x/y space), the independent row length-grouping
            # (order_rid analog), or their composition rs[col_perm].
            assert self.row_perm.shape == (self.n_rows,)
            if self.row_perm is not self.col_perm:
                assert _is_perm(self.row_perm, self.n_rows), \
                    "row_perm must be a permutation"


# ---------------------------------------------------------------------------
# Vreg routing
# ---------------------------------------------------------------------------


_NATIVE_ROUTER = None


def _native_router():
    global _NATIVE_ROUTER
    if _NATIVE_ROUTER is None:
        try:
            from .io import native
            _NATIVE_ROUTER = native if native.has_router() else False
        except Exception:
            _NATIVE_ROUTER = False
    return _NATIVE_ROUTER


def _route_concat(offsets, lane, ipref, col, val, p_cap: int,
                  strides=None):
    """Route vregs given CONCATENATED element arrays (vreg v owns elements
    [offsets[v], offsets[v+1])).  Returns a list of (vals_tile, idx_tile,
    win_list, overflow_mask) per vreg.  The fast path for bulk callers —
    no per-vreg array slicing or re-concatenation."""
    nat = _native_router()
    nv = offsets.size - 1
    if nat:
        vt, it, wins, wc, ovf = nat.route_vregs(
            offsets, lane, ipref, col, val, p_cap,
            np.asarray(strides, dtype=np.int32)
            if strides is not None else None)
        return [(vt[v], it[v], wins[v, :wc[v]],
                 ovf[offsets[v]:offsets[v + 1]])
                for v in range(nv)]
    return [_route_vreg(lane[offsets[v]:offsets[v + 1]],
                        ipref[offsets[v]:offsets[v + 1]],
                        col[offsets[v]:offsets[v + 1]],
                        val[offsets[v]:offsets[v + 1]], p_cap,
                        stride=SUB if strides is None else strides[v])
            for v in range(nv)]


def _route_vregs_batch(parts, p_cap: int, strides=None):
    """Route a batch of vregs: ``parts`` is a list of (lane, ipref, col,
    val) tuples, one per vreg.  Returns a list of (vals_tile, idx_tile,
    win_list, overflow_mask) in the same order.  ``strides``: optional
    per-vreg sublane stride list (None = all 8).  Uses the native C++
    router in ONE call when built."""
    nat = _native_router()
    if nat and parts:
        sizes = np.array([p[0].size for p in parts], dtype=np.int64)
        offsets = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        lane = np.concatenate([p[0] for p in parts])
        ipref = np.concatenate([p[1] for p in parts])
        col = np.concatenate([p[2] for p in parts])
        val = np.concatenate([p[3] for p in parts])
        return _route_concat(offsets, lane, ipref, col, val, p_cap,
                             strides)
    if strides is None:
        return [_route_vreg(*p, p_cap) for p in parts]
    return [_route_vreg(*p, p_cap, stride=s)
            for p, s in zip(parts, strides)]


def _route_vreg(lane: np.ndarray, ipref: np.ndarray, col: np.ndarray,
                val: np.ndarray, p_cap: int, stride: int = SUB):
    """Route one vreg's elements into slots.  Returns (vals_tile, idx_tile,
    win_list, overflow_mask).  ``stride``: sublane attempts stay within the
    element's stride-group (strided slices, see build_wplan).  Uses the
    native C++ router (native/router.cpp) when built; the numpy
    implementation below is the semantics oracle."""
    nat = _native_router()
    if nat:
        return _route_vregs_batch([(lane, ipref, col, val)], p_cap,
                                  [stride])[0]
    n = lane.size
    w = (col // VREG) * SUB
    q_rel = (col // LANES) % SUB
    lam = col % LANES
    src_row = col // LANES

    uw, counts = np.unique(w, return_counts=True)
    overflow = np.zeros(n, dtype=bool)
    if uw.size > p_cap:
        keep = uw[np.argsort(-counts, kind="stable")[:p_cap]]
        overflow = ~np.isin(w, keep)
    win_list = np.unique(w[~overflow]) if (~overflow).any() else \
        np.empty(0, dtype=np.int64)
    win_of = {int(ww): p for p, ww in enumerate(win_list)}

    slot_i = np.full(n, -1, dtype=np.int64)
    cell_owner = np.full((SUB, LANES), -1, dtype=np.int64)
    lane_used = np.zeros((SUB, LANES), dtype=bool)

    todo = np.flatnonzero(~overflow)
    attempt = ipref.astype(np.int64).copy()
    base = (ipref.astype(np.int64) // stride) * stride
    for _ in range(stride):
        if todo.size == 0:
            break
        i_t = base[todo] + attempt[todo] % stride
        cell = cell_owner[i_t, lam[todo]]
        ok = (~lane_used[i_t, lane[todo]]) & \
             ((cell == -1) | (cell == src_row[todo]))
        if ok.any():
            cand = todo[ok]
            ci, cl, cm, ck = i_t[ok], lane[cand], lam[cand], src_row[cand]
            sk1 = ci * LANES + cl
            _, fidx = np.unique(sk1, return_index=True)
            first1 = np.zeros(cand.size, dtype=bool)
            first1[fidx] = True
            sk2 = ci * LANES + cm
            o2 = np.argsort(sk2, kind="stable")
            sk2s, ks = sk2[o2], ck[o2]
            grp_start = np.r_[True, sk2s[1:] != sk2s[:-1]]
            head_idx = np.maximum.accumulate(
                np.where(grp_start, np.arange(ks.size), 0))
            ok2 = np.zeros(cand.size, dtype=bool)
            ok2[o2] = ks == ks[head_idx]
            acc = first1 & ok2
            acc_idx = cand[acc]
            ai, al, am = ci[acc], cl[acc], cm[acc]
            slot_i[acc_idx] = ai
            lane_used[ai, al] = True
            cell_owner[ai, am] = ck[acc]
            keepmask = np.ones(todo.size, dtype=bool)
            keepmask[np.flatnonzero(ok)[acc]] = False
            todo = todo[keepmask]
        attempt[todo] += 1
    overflow[todo] = True

    placed = slot_i >= 0
    vals_tile = np.zeros((SUB, LANES))
    idx_tile = np.zeros((SUB, LANES), dtype=np.int64)
    if placed.any():
        rounds = np.array([win_of[int(ww)] for ww in w[placed]],
                          dtype=np.int64)
        si, sj = slot_i[placed], lane[placed]
        vals_tile[si, sj] = val[placed]
        # slot bits at (i, lane): lam only.  CELL bits at (i, lam):
        # q_rel<<7 | round<<10 — a cell maps to one x word, hence one
        # round, so the round tag is cell data: the kernel selects raw
        # windows per cell and gathers once per vreg (see router.cpp).
        idx_tile[si, sj] = lam[placed]
        cell = np.zeros((SUB, LANES), dtype=np.int64)
        cell[si, lam[placed]] = (rounds << 10) | (q_rel[placed] << 7)
        idx_tile |= cell
    return vals_tile, idx_tile, win_list, overflow


def _deal_windows(sid, col, row, vl0, w8, n_sids):
    """Window-aligned element dealing for stride-8 SELL slices.

    Position dealing (``k // c``) mixes x windows across a slice's
    vregs: chunk j of row A and chunk j of row B hold different
    1024-aligned windows, so every vreg's window union — and with it
    the gather round count P — approaches the *whole block's* window
    footprint (measured 7.6 rounds/vreg on the assembled poisson3d
    operator, whose footprint of 10.4 windows/block divided by the
    width is 3.5).  Round count is what the colsum kernel pays per
    vreg: the P-round cost is VPU compute, not DMA (DESIGN.md §2), so
    fewer rounds is directly runtime.

    Here each slice instead assigns WHOLE windows to chunks (vregs) by
    a block-shared mass-midpoint map, so chunk j holds a contiguous
    mass-balanced run of the block's windows and every row's chunk-j
    elements come from the same few windows.  Windows too heavy for
    one chunk — more mass than a balanced share, or more than SUB
    elements of one row (a lane has SUB sublane slots per vreg) —
    split elementwise at the same cuts.  Rows the shared map would
    still overfill (their own mass distribution deviates too far from
    the block's) fall back to position dealing for that row only:
    measured on poisson3d, cascading their excess forward instead
    costs +1.4 distinct windows per vreg, and letting them reject
    costs a doubled-width retry (+36% vregs).

    Returns ``(vreg_local, ipref, take)``: per-element chunk and
    sublane preference (parallel to the inputs; only meaningful for
    elements of taken slices), and ``take[sid]`` True where this
    dealing strictly reduces the slice's total round count vs the
    position dealing described by ``vl0``.  The caller merges with its
    defaults via ``take[sid]`` per element.

    The reference has no analog: its per-thread loads gather x at any
    address (``dasp_f64.h:112``); window locality is a TPU-only cost.
    """
    n = sid.size
    take = np.zeros(n_sids, dtype=bool)
    ipref0 = np.zeros(n, dtype=np.int64)
    if n < 2:
        return vl0, ipref0, take
    win = (col // VREG).astype(np.int64)
    sid = sid.astype(np.int64)
    # bit budget for the fused radix keys
    sb = max(int(sid.max()), 1).bit_length()
    wb = max(int(win.max()), 1).bit_length()
    if sb + wb + 15 > 62 or int(w8.max()) > 64:
        return vl0, ipref0, take
    idx = np.arange(n)
    w8 = w8.astype(np.int64)
    # (row, window) groups are contiguous runs in the original order
    # (row-major elements, columns ascending within a row)
    newr = np.empty(n, dtype=bool)
    newr[0] = True
    newr[1:] = row[1:] != row[:-1]
    newg = newr.copy()
    newg[1:] |= win[1:] != win[:-1]
    k_rw = idx - np.maximum.accumulate(np.where(newg, idx, 0))
    if int(k_rw.max()) > 255:
        return vl0, ipref0, take
    k_row = idx - np.maximum.accumulate(np.where(newr, idx, 0))
    rend_idx = np.flatnonzero(np.append(newr[1:], True))
    row_len = (k_row[rend_idx] + 1)[np.searchsorted(rend_idx, idx)]
    rid = np.cumsum(newr) - 1
    # ---- block-shared map: sort by (sid, win, rank-in-(row,win), lane)
    # so (sid, win) groups are contiguous and round-robin across rows
    lane = (row % LANES).astype(np.int64)
    key = ((((sid << wb) | win) << 8) | k_rw) << 7 | lane
    o = np.argsort(key, kind="stable")
    sid_s, win_s, w8_s = sid[o], win[o], w8[o]
    gch = np.empty(n, dtype=bool)
    gch[0] = True
    gch[1:] = (sid_s[1:] != sid_s[:-1]) | (win_s[1:] != win_s[:-1])
    gi = np.cumsum(gch) - 1
    ng = int(gi[-1]) + 1
    mass = np.bincount(gi, minlength=ng).astype(np.int64)
    gsid = sid_s[gch]
    gw8 = w8_s[gch]
    tot_sid = np.bincount(gsid, weights=mass,
                          minlength=n_sids).astype(np.int64)
    cum = np.cumsum(mass) - mass
    sch = np.empty(ng, dtype=bool)
    sch[0] = True
    sch[1:] = gsid[1:] != gsid[:-1]
    sid_start = np.maximum.accumulate(np.where(sch, cum, 0))
    cumb = cum - sid_start                    # mass before group, in-sid
    tot_g = np.maximum(tot_sid[gsid], 1)
    wchunk = (2 * cumb + mass) * gw8 // (2 * tot_g)   # midpoint cut
    # a group sorted by k_rw ends at its max per-row count
    gend = np.append(gch[1:], True)
    maxk = k_rw[o][gend][gi]                  # broadcast group max
    heavy = (mass[gi] * gw8[gi] > tot_g[gi]) | (maxk >= SUB)
    rank_g = idx - np.maximum.accumulate(np.where(gch, idx, 0))
    ce_s = wchunk[gi]
    if heavy.any():
        ce_s = ce_s.copy()
        ce_s[heavy] = ((cumb[gi][heavy] + rank_g[heavy]) * w8_s[heavy]
                       // tot_g[gi][heavy])
    ce_s = np.minimum(np.maximum(ce_s, 0), w8_s - 1)
    ce = np.empty(n, dtype=np.int64)
    ce[o] = ce_s
    # ---- per-row feasibility: a lane has SUB sublane slots per vreg,
    # so a chunk holding > SUB of one row's elements must shed the
    # excess.  ce is nondecreasing within a row — windows ascend with
    # columns and both cuts are monotone — so (row, chunk) runs are
    # contiguous and ranks come from scans.  Excess cascades FORWARD
    # (the run's tail is the chunk's boundary window, and every row
    # sheds the same window into the same next chunk, so the receiving
    # vreg gains ~one distinct window), then BACKWARD for rows whose
    # last chunk is overfull (mass-midpoint skew).  Cascading instead
    # of rejecting matters: rejects beyond a slice's 5% budget retry
    # it at doubled width (+36% vregs measured on poisson3d).
    # forward wave to fixpoint (run tails — the chunk's boundary
    # window — climb), then a pure downward wave for runs stuck at the
    # cap (their heads — the run's lowest windows — descend).  Mixing
    # the directions ping-pongs the same elements and smears windows
    # across chunks: measured 6.8 rounds/vreg interleaved vs 5.3
    # forward-only on poisson3d.
    from .io import native as _nat
    _nd = _nat.deal_cascade(newr, w8, ce)
    if _nd is not None:
        # native cascade: same waves, parallel over rows (each wave in
        # numpy is a full-array pass and livejournal runs ~dozens)
        ce, pos = _nd
    else:
        pos = ipref0
        for _ in range(36):
            nrc = newr.copy()
            nrc[1:] |= ce[1:] != ce[:-1]
            pos = idx - np.maximum.accumulate(np.where(nrc, idx, 0))
            over_f = (pos >= SUB) & (ce < w8 - 1)
            if not over_f.any():
                break
            ce[over_f] += 1
        for _ in range(36):
            cend_idx = np.flatnonzero(np.append(nrc[1:], True))
            rpos = (pos[cend_idx])[np.searchsorted(cend_idx, idx)] - pos
            over_b = (rpos >= SUB) & (ce > 0)
            if not over_b.any():
                break
            ce[over_b] -= 1
            nrc = newr.copy()
            nrc[1:] |= ce[1:] != ce[:-1]
            pos = idx - np.maximum.accumulate(np.where(nrc, idx, 0))
    # ---- gate per sid: total rounds (distinct (chunk, window) pairs)
    # must strictly drop vs position dealing
    key1 = (((sid << 6) | ce) << wb) | win
    k1s = np.sort(key1)
    b1 = np.empty(n, dtype=bool)
    b1[0] = True
    b1[1:] = k1s[1:] != k1s[:-1]
    new_rounds = np.bincount(k1s[b1] >> (wb + 6), minlength=n_sids)
    key0 = (((sid << 6) | vl0.astype(np.int64)) << wb) | win
    k0s = np.sort(key0)
    b0 = np.empty(n, dtype=bool)
    b0[0] = True
    b0[1:] = k0s[1:] != k0s[:-1]
    cur_rounds = np.bincount(k0s[b0] >> (wb + 6), minlength=n_sids)
    take = new_rounds < cur_rounds
    # pos >= SUB cannot fit the lane; keep a valid preference and let
    # the router reject to the rem slices (rare by construction).
    return ce, pos % SUB, take


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


class _Packet:
    __slots__ = ("kind", "w8", "cls", "tiles", "block", "stride")

    def __init__(self, kind, w8, cls, tiles, block, stride=SUB):
        self.kind = kind      # 'sell' | 'rem' | 'long'
        self.w8 = w8
        self.cls = cls
        self.tiles = tiles
        self.block = block    # slice id for sell, rem-slice id, row (long)
        self.stride = stride  # sublanes per row level (sell slices)


def _p_class(p_used: int, p_cap: int) -> int:
    for c in P_CLASSES:
        if p_used <= c:
            return min(c, p_cap)
    raise AssertionError(
        f"vreg uses {p_used} windows > {P_CLASSES[-1]}: the packer's "
        "32-window caps (chunking/bin-pack/retry) were violated")


def merge_class_keys(key_mass: Dict[Tuple[int, int], int],
                     s_rows: int = 0
                     ) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """Merge small (P-class, stride) stream keys into bigger ones.

    Each stream is one kernel launch whose fixed cost (pipeline ramp on a
    2-3-step grid) measures ~6 us = the streaming time of ~320 vregs.  A
    small class therefore rides along with a bigger one when the merge
    tax -- extra masked rounds for the lower-P side (measured 1.8
    cycles/vreg/round ~ 0.17 vreg-equivalents) and extra per-level output
    rows when strides mix (the stream runs at the MINIMUM stride; coarser
    segments' level sums are rebuilt in XLA glue by pairwise row adds,
    ~0.083 vreg-equivalents per extra row) -- stays under that fixed
    cost.  FIXED_EQ started at 320 (the standalone ~6us fixed cost of a small
    stream) but XLA overlaps adjacent colsum launches, so the realized
    saving is smaller: 320 merged a P=6 class into scircuit's stride-2
    pool and LOST 6%; 120 keeps only the cheap merges (cop20k +6%).

    ``s_rows`` adds the dominant WIDE-matrix fixed cost: every launch
    re-DMAs the whole (s_rows, 128) f32 x table into VMEM (the x
    BlockSpec maps every grid step to block 0, loaded once per call) —
    512 B/row = 0.083 vreg-equivalents of A-stream traffic per x row,
    discounted 50% for the overlap XLA does recover (livejournal
    attribution: 18 standalone streams sum to 4.3 ms vs 3.35 ms fused;
    26-vreg streams still cost ~79 us standalone, s_rows=37888).  For
    small matrices the term is negligible (scircuit s_rows=1336: +56)
    so the round-3 calibration regime is preserved.

    Factored out of build_wplan so the multi-chip builder can run it ONCE
    over the union of all chips' key masses (globally pinned class
    quantization; see ``pin_classes``)."""
    ROUND_EQ, ROW_EQ = 0.17, 0.083
    X_EQ = 0.5 * 512.0 / 6144.0          # x-table reload, overlap-halved
    FIXED_EQ = 120.0 + X_EQ * s_rows
    final_key: Dict[Tuple[int, int], Tuple[int, int]] = {
        k: k for k in key_mass}

    def _members(root):
        return [k for k, v in final_key.items() if v == root]

    # A root's vreg total is always recomputed from its current members
    # (an earlier version kept running totals, which went stale when a
    # merge's new_root coincided with a key previously merged elsewhere:
    # re-pointing that key moved its packets but not its credited mass).
    def _mass(root):
        return sum(key_mass.get(k, 0) for k in _members(root))

    changed = True
    while changed:
        changed = False
        roots = sorted({v for v in final_key.values()},
                       key=lambda k: (_mass(k), k))
        masses = {r: _mass(r) for r in roots}
        for c in roots:
            vc = masses[c]
            best = None
            for t in roots:
                if t == c or masses[t] < vc:
                    continue
                P_new = max(c[0], t[0])
                s_new = min(c[1], t[1])
                cost = (vc * (P_new - c[0]) * ROUND_EQ
                        + masses[t] * (P_new - t[0]) * ROUND_EQ
                        + vc * (SUB // s_new - SUB // c[1]) * ROW_EQ
                        + masses[t] * (SUB // s_new - SUB // t[1])
                        * ROW_EQ)
                if cost < FIXED_EQ and (best is None or cost < best[0]):
                    best = (cost, t)
            if best is not None:
                t = best[1]
                new_root = (max(c[0], t[0]), min(c[1], t[1]))
                for k in _members(c) + _members(t):
                    final_key[k] = new_root
                final_key.setdefault(new_root, new_root)
                key_mass.setdefault(new_root, 0)
                # If key new_root had been merged into a third root X, it
                # becomes a root again here; X keeps its other members and
                # both masses stay exact via _mass recomputation (packets
                # of key new_root are class/stride-exact in either stream).
                final_key[new_root] = new_root
                changed = True
                break
    return final_key


def _choose_w8(slens: np.ndarray, threshold: float) -> int:
    w8 = W8_CLASSES[0]
    for c in W8_CLASSES:
        occ = np.minimum(slens, SUB * c).sum() / (LANES * SUB * c)
        if occ >= threshold:
            w8 = c
    return w8


@gc_paused
@span("pack")
def build_wplan(csr: CSRMatrix, config: DaspConfig = DEFAULT_CONFIG,
                p_cap: int = 32, sym_ok: bool = True,
                pin_classes: Optional[Dict[Tuple[int, int],
                                           Tuple[int, int]]] = None
                ) -> WPlan:
    # sym_ok=False forbids the symmetric relabel even for square inputs
    # (column-slab sub-matrices must all keep original row order so their
    # partial y's sum).
    # p_cap <= 32 keeps slot metadata in 15 bits (round<<10|q<<7|lam), so
    # the index stream ships as int16 — 25% less HBM traffic at fp32.
    phase("pack.order")
    csr.check()
    import time as _time
    # Host-speed probe stored next to the pack wall: this box's ONE
    # burst-credit vCPU drifts 87x (fixed numpy probe 15 ms - 1.3 s), so
    # a raw pack_seconds is uninterpretable on its own.  The same
    # fixed argsort measured ~42 ms in a full-burst window — readers
    # normalize pack_seconds by probe_ms/42 for a calibrated number.
    # Only paid on production-size inputs (the probe costs ~0.1-1 s).
    probe_ms = 0.0
    if csr.nnz >= 4_000_000:
        _pa = np.random.default_rng(0).standard_normal(1_000_000)
        _t0 = _time.perf_counter()
        _pa.argsort()
        probe_ms = (_time.perf_counter() - _t0) * 1e3

    col_perm = row_perm = None
    if config.relabel != "off" and csr.nnz:
        from .relabel import (apply_col_perm, apply_sym_perm,
                              choose_relabel, first_touch_perm)
        # Square matrices get the SYMMETRIC permutation (rows relabeled by
        # the same map) so x and y share one index space and on-device
        # iteration (CG/PageRank) feeds y straight back into x.
        sym = sym_ok and csr.n_rows == csr.n_cols
        if config.relabel == "auto":
            col_perm = choose_relabel(csr, config.relabel_hub_deg,
                                      symmetric=sym)
        else:
            col_perm = first_touch_perm(csr, config.relabel_hub_deg)
        if col_perm is not None:
            csr = (apply_sym_perm(csr, col_perm) if sym
                   else apply_col_perm(csr, col_perm))
            col_perm = col_perm.astype(np.int32)
            row_perm = col_perm if sym else None
    # Independent row length-grouping (the reference's order_rid,
    # dasp_f64.h:959-976).  It COMPOSES on top of a symmetric relabel
    # (row_perm = rs[col_perm]): the decoupling gives up the shared x/y
    # index space that on-device iteration (CG/PageRank) feeds through —
    # iterative consumers pass row_sort="off" (examples/) — but on
    # power-law graphs the win is decisive: livejournal_like relabeled
    # blocks mix 2-nnz and 200-nnz rows, packing the SELL streams at 19%
    # fill (34.5M slots for 6.7M elements); the length-grouped model
    # costs 24x fewer quantized slots AND 29% fewer (block, window)
    # pairs (tools/rowsort_model.py — long rows concentrated in few
    # blocks SHARE their window spans instead of poisoning every block).
    if config.row_sort != "off" and csr.nnz:
        from .relabel import (apply_row_perm, choose_row_sort,
                              row_sort_perm)
        rs = (row_sort_perm(csr) if config.row_sort == "on"
              else choose_row_sort(csr, config.block_longest))
        if rs is not None:
            csr = apply_row_perm(csr, rs)
            row_perm = (rs if row_perm is None
                        else rs[row_perm]).astype(np.int32)
    n = csr.n_rows
    lens = csr.row_lengths.astype(np.int64)
    rpt = csr.row_ptr.astype(np.int64)
    cols_all = csr.col_idx.astype(np.int64)
    vals_all = csr.values.astype(np.float64)

    B = -(-n // LANES)           # 0 for an empty slab (multi-chip padding)
    is_long = lens >= config.block_longest

    packets: List[_Packet] = []
    ovf_r: List[np.ndarray] = []
    ovf_c: List[np.ndarray] = []
    ovf_v: List[np.ndarray] = []


    phase("pack.rows")
    # ---- per-block SELL slices + per-block remainder tails --------------
    # lane assignment per block: sell rows length-desc, pads last.
    block_lane_of_row = np.full(n, -1, dtype=np.int32)     # lane in slice b
    block_pad_lane = np.full(B, -1, dtype=np.int32)        # a zero lane

    # Row fragments emitted as long-style scalar outputs (big tails that
    # would otherwise inflate a 128-lane slice's width).
    FRAG_MIN = 64
    frags: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}   # row -> (col,val)

    def add_frag(row: int, colv: np.ndarray, valv: np.ndarray):
        if row in frags:
            pc, pv = frags[row]
            frags[row] = (np.concatenate([pc, colv]),
                          np.concatenate([pv, valv]))
        else:
            frags[row] = (colv, valv)

    # Vectorized primary packing.  Slices are STRIDED: a slice of stride
    # s hosts 8/s consecutive blocks, one per sublane LEVEL — block L's
    # rows live in sublanes [L*s, L*s+s) of every slice vreg and the
    # colsum kernel emits per-level sums.  Short-row blocks (the
    # reference's short1/22/34 strategies, ``dasp_f64.h:595-713``) thus
    # fill the vreg instead of leaving 7/8 sublanes as padding; medium
    # blocks keep stride 8 (the classic SELL slice).  Width choice and
    # element distribution run for ALL blocks at once, then batched
    # router calls retry congested slices at doubled stride / width.
    slice_of_block = np.full(B, -1, dtype=np.int64)
    level_of_block = np.zeros(B, dtype=np.int64)
    short_cut = min(SHORT_MAX, config.block_longest - 1)
    if n:
        blk = np.arange(n) // LANES
        is_short = (~is_long) & (lens > 0) & (lens <= short_cut)
        sellable = (~is_long) & (lens > short_cut)
        # one fused-key radix argsort instead of a 3-key lexsort (3 stable
        # passes over n rows; the fused key measured ~2x faster on
        # multi-M-row inputs, cf. relabel._rowcol_order): descending
        # length within (block, sellable-first) — lens < 2^32, blk < 2^30
        order = np.argsort(((blk.astype(np.int64) * 2 + ~sellable) << 32)
                           | (np.int64(0xFFFFFFFF) - lens),
                           kind="stable")
        lane_sorted = np.arange(n) - LANES * blk[order]
        sel_sorted = sellable[order]
        block_lane_of_row[order[sel_sorted]] = lane_sorted[sel_sorted]
        n_sell_b = np.bincount(blk[sellable], minlength=B)
        block_pad_lane[:] = np.where(n_sell_b < LANES, n_sell_b, -1)

        Lmat = np.zeros((B, LANES), dtype=np.int32)
        Lmat[blk[order], lane_sorted] = np.where(sel_sorted, lens[order], 0)
        nnz_sell_b = Lmat.sum(axis=1, dtype=np.int64)
        # Coverage per clip threshold, computed ONCE per distinct s*c value
        # (the s x W8 double loop below otherwise re-reduces the (B,128)
        # matrix ~48 times; {s*c} collapses to ~9 distinct powers of two).
        _cov_cache: Dict[int, np.ndarray] = {}

        def _coverage(clip: int) -> np.ndarray:
            cov = _cov_cache.get(clip)
            if cov is None:
                cov = np.minimum(Lmat, clip).sum(axis=1, dtype=np.int64)
                _cov_cache[clip] = cov
            return cov
        # per (stride, W8): coverage and the occupancy-chosen width, then
        # pick the stride minimizing slots + spill cost.  A spilled element
        # lands in the stride-8 shared rem slices at low occupancy (~8
        # slots each, measured fill explosion at lower weights), and a
        # stride choice may never spill MORE than the classic stride-8
        # choice would (its spills are genuine tails, handled by frags).
        SPILL_W = 8.0
        # Narrower strides must beat the stride-8 cost by this factor
        # (hidden P-cost; measured scircuit f32 same-window: marginal
        # stride-4 wins fragmented 3 streams into 5, -14% end to end).
        STRIDE_MARGIN = 0.8
        # A round-aware "ns" cost model (price the gather rounds a slice
        # will pay, not just its slots; calibrated NS_A=6.94/NS_B=2.49 on
        # v5e) was A/B'd against this slots model and REJECTED
        # (tools/costmodel_ab.py, 2026-08-20, interleaved same-window):
        # poisson3d 16.4 vs 56.5 GF (the ns model drives blocks to
        # stride-2 slices, 4.57 slots/nnz), cop20k tie, scircuit +6.6%
        # noise-level.  The per-cell round select (ops) had already
        # halved the round cost the model was calibrated for.
        best_cost = None
        s_choice = np.full(B, SUB, dtype=np.int64)
        w8_choice = np.full(B, W8_CLASSES[0], dtype=np.int64)
        cover8 = None
        w8_arr = np.array(W8_CLASSES, dtype=np.int64)
        for s in (SUB, 4, 2, 1):
            # Width per block = argmin of the same slots + spill cost the
            # stride comparison uses (this subsumes the reference's
            # "grow while >= 75% occupancy" rule, dasp_f64.h:1052-1083:
            # with SPILL_W ~ 8 the cost minimum sits where marginal slice
            # slots stop buying >1/8 of their size in covered elements —
            # the same knee, but it can stop at the intermediate widths
            # the occupancy ladder skipped).
            covs = np.stack([_coverage(s * c) for c in W8_CLASSES])
            costs = (LANES * s * w8_arr[:, None]
                     + SPILL_W * (nnz_sell_b[None] - covs))
            ci = np.argmin(costs, axis=0)
            w8_s = w8_arr[ci]
            cover = np.take_along_axis(covs, ci[None], 0)[0]
            cost = np.take_along_axis(costs, ci[None], 0)[0]
            if best_cost is None:          # s == 8: the reference choice
                best_cost = cost
                w8_choice = w8_s
                cover8 = cover
            else:
                # A narrower stride must win by a clear MARGIN: stride
                # only prices slots+spill, but packing more rows per
                # vreg widens the vreg's column-window union, raising
                # the gather-round class P the router assigns LATER —
                # a cost invisible here.  Measured (scircuit f32,
                # same-window): marginal stride-4 wins fragmented 3
                # streams into 5 (one at P=12) and cost 14% end to end.
                upd = (cost < STRIDE_MARGIN * best_cost) & (cover >= cover8)
                best_cost = np.where(upd, cost, best_cost)
                s_choice = np.where(upd, s, s_choice)
                w8_choice = np.where(upd, w8_s, w8_choice)

        # blocks whose best own slice would still be mostly padding dump
        # their few medium rows: 5-16 nnz go to the length-bucketed MED
        # shared slices, longer ones to the rem pool — instead of paying a
        # nearly-empty private slice
        dump = (LANES * s_choice * w8_choice > 3 * nnz_sell_b)
        is_med_bucket = np.zeros(n, dtype=bool)
        if dump.any():
            drows = np.flatnonzero(sellable & dump[blk])
            if drows.size:
                med = lens[drows] <= MED_BUCKETS[-1][0]
                is_med_bucket[drows[med]] = True
                rrows = drows[~med]
                if rrows.size:
                    dl = lens[rrows]
                    eidx = np.repeat(rpt[rrows], dl) + (
                        np.arange(int(dl.sum())) - np.repeat(
                            np.concatenate([[0], np.cumsum(dl)[:-1]]), dl))
                    ovf_r.append(np.repeat(rrows, dl))
                    ovf_c.append(cols_all[eidx])
                    ovf_v.append(vals_all[eidx])
                block_lane_of_row[drows] = -1
                sellable[drows] = False

        # Window-capacity width floor (round-4 R-MAT finding): a vreg's
        # routing table holds at most P_CLASSES[-1]=32 windows, and a
        # stride-s slice pools 8/s blocks' windows — the fill cost model
        # cannot see either.  Clustered-graph blocks with 50-300 distinct
        # 1024-windows (rmat_like: mean 75, p95 326 per block) were
        # given w8=1-2, so primary routing rejected most elements into
        # the shared rem slices (4278 slices at ~10% fill on rmat, then
        # 4% COO residue).  Raise w8 until the expected windows per vreg
        # stay under ~24 (margin for dealing imbalance); blocks inside
        # the cap are untouched (cop20k 1.3 windows/block, relabeled
        # poisson3d ~5).
        if sellable.any():
            # 24 beat {off, 32, 12} on rmat_like (slots/nnz 8.83 vs
            # 9.49/9.01/10.24, P-cost minimal) — margin below the 32-cap
            # absorbs dealing imbalance without padding blowup.
            WIN_VREG_TARGET = 24
            eblk = np.repeat(blk, lens)          # per-element block id
            em = np.repeat(sellable, lens)
            wbits = max(int(csr.n_cols - 1) // VREG, 1).bit_length()
            bw_key = np.unique((eblk[em].astype(np.int64) << wbits)
                               | (cols_all[em] >> 10).astype(np.int64))
            nw_b = (np.bincount(bw_key >> wbits, minlength=B)
                    if bw_key.size else np.zeros(B, np.int64))
            need = -(-nw_b * (SUB // s_choice) // WIN_VREG_TARGET)
            lift = need > w8_choice
            if lift.any():
                qi = np.searchsorted(w8_arr,
                                     np.minimum(need[lift], w8_arr[-1]))
                w8_choice[lift] = w8_arr[qi]

        rows_sell_all = np.flatnonzero(sellable)
        s_row0 = s_choice[blk[rows_sell_all]]
        w8_row0 = w8_choice[blk[rows_sell_all]]
        reg_all = np.minimum(lens[rows_sell_all], s_row0 * w8_row0)
        tail = lens[rows_sell_all] - reg_all
        # tails go to the shared rem slices (length-segregated there; a
        # per-row fragment vreg would be mostly padding for tails < 1024)
        tailed = np.flatnonzero(tail > 0)
        if tailed.size:
            st = rpt[rows_sell_all[tailed]] + reg_all[tailed]
            tl = tail[tailed]
            eidx = np.repeat(st, tl) + (
                np.arange(int(tl.sum())) - np.repeat(
                    np.concatenate([[0], np.cumsum(tl)[:-1]]), tl))
            ovf_r.append(np.repeat(rows_sell_all[tailed], tl))
            ovf_c.append(cols_all[eidx])
            ovf_v.append(vals_all[eidx])

        # group consecutive blocks with equal (stride, W8) into slices of
        # up to 8/stride blocks (one level each); dumped/empty blocks get
        # no slice (their primary gather reads the zero row)
        has_sell_b = np.bincount(blk[rows_sell_all], minlength=B) > 0
        slices: List[List] = []     # [stride, w8, [block ids]]
        for b in range(B):
            if not has_sell_b[b]:
                continue
            s, w8 = int(s_choice[b]), int(w8_choice[b])
            if (slices and slices[-1][0] == s and slices[-1][1] == w8
                    and len(slices[-1][2]) < SUB // s
                    and slices[-1][2][-1] == b - 1):
                slices[-1][2].append(b)
            else:
                slices.append([s, w8, [b]])

        def batch_route_slices(slice_ids):
            """Route the given slices' regular elements.  Returns
            (results, loss, rejects): results[sid] = (tiles, w8, p_used);
            loss per slice id; rejects = (rows, cols, vals)."""
            base_of = {}
            v_cursor = 0
            stride_v: List[int] = []
            for sid in slice_ids:
                s, w8, _ = slices[sid]
                base_of[sid] = v_cursor
                v_cursor += w8
                stride_v.extend([s] * w8)
            total_vregs = v_cursor
            sid_of_block = np.full(B, -1, dtype=np.int64)
            for sid in slice_ids:
                for b in slices[sid][2]:
                    sid_of_block[b] = sid
            sub_mask = sid_of_block[blk[rows_sell_all]] >= 0
            rows_sell = rows_sell_all[sub_mask]
            reg = reg_all[sub_mask]          # regular region is FIXED by
            s_row = s_row0[sub_mask]         # the first (stride, width)
            w8_row = w8_row0[sub_mask]       # choice
            c_row = np.maximum(1, -(-reg // w8_row))
            tot = int(reg.sum())
            estart = (np.concatenate([[0], np.cumsum(reg)[:-1]])
                      if reg.size else np.zeros(0, dtype=np.int64))
            k = np.arange(tot) - np.repeat(estart, reg)
            c_rep = np.repeat(c_row, reg)
            vreg_local = k // np.maximum(c_rep, 1)
            base_by_sid = np.zeros(len(slices), dtype=np.int64)
            for sid in slice_ids:
                base_by_sid[sid] = base_of[sid]
            vb = base_by_sid[sid_of_block[blk[rows_sell]]]
            vreg_id = np.repeat(vb, reg) + vreg_local
            ipref = (np.repeat(level_of_block[blk[rows_sell]] * s_row, reg)
                     + (k % c_rep)).astype(np.int64)
            elane = np.repeat(block_lane_of_row[rows_sell], reg)
            eidx2 = np.repeat(rpt[rows_sell], reg) + k
            erow = np.repeat(rows_sell, reg)
            ecol = cols_all[eidx2]
            eval_ = vals_all[eidx2]
            # Window-aligned dealing for stride-8 slices (see
            # _deal_windows): cuts gather rounds where the block's
            # window footprint per vreg exceeds footprint/width.
            if tot:
                s_rep = np.repeat(s_row, reg)
                m8 = s_rep == SUB
                if m8.any():
                    esid8 = sid_of_block[blk[erow[m8]]]
                    wvl, wip, wtake = _deal_windows(
                        esid8, ecol[m8], erow[m8], vreg_local[m8],
                        np.repeat(w8_row, reg)[m8], len(slices))
                    if wtake.any():
                        tk = wtake[esid8]
                        mi = np.flatnonzero(m8)[tk]
                        vreg_id[mi] += wvl[tk] - vreg_local[mi]
                        ipref[mi] = wip[tk]
            o2 = np.argsort(vreg_id, kind="stable")
            offsets = np.zeros(total_vregs + 1, dtype=np.int64)
            np.cumsum(np.bincount(vreg_id[o2], minlength=total_vregs),
                      out=offsets[1:])
            lane_s, ipref_s = elane[o2], ipref[o2]
            col_s, val_s, erow_s = ecol[o2], eval_[o2], erow[o2]
            routed = _route_concat(offsets, lane_s, ipref_s, col_s, val_s,
                                   p_cap, stride_v)
            ovf_sorted = np.concatenate([r[3] for r in routed]) \
                if routed else np.zeros(0, dtype=bool)
            loss = {}
            rej_b = blk[erow_s[ovf_sorted]] if ovf_sorted.any() else \
                np.zeros(0, dtype=np.int64)
            for sid in slice_ids:
                loss[sid] = 0
            if rej_b.size:
                u, c = np.unique(sid_of_block[rej_b], return_counts=True)
                for s_, c_ in zip(u.tolist(), c.tolist()):
                    loss[int(s_)] = int(c_)
            results = {}
            elem_rng = {}
            for sid in slice_ids:
                s, w8, _ = slices[sid]
                lo = base_of[sid]
                tiles = [(routed[v][0], routed[v][1], routed[v][2])
                         for v in range(lo, lo + w8)]
                p_used = max([1] + [t[2].size for t in tiles])
                results[sid] = (tiles, w8, p_used)
                elem_rng[sid] = (int(offsets[lo]), int(offsets[lo + w8]))
            rejects = (erow_s[ovf_sorted], col_s[ovf_sorted],
                       val_s[ovf_sorted])
            return (results, loss, rejects,
                    (elem_rng, erow_s, col_s, val_s))

        elems_b = np.bincount(blk[rows_sell_all], weights=reg_all,
                              minlength=B).astype(np.int64)
        final_results = {}      # sid -> (tiles, w8, p_used)

        def set_levels():
            for sid in pending:
                for L, b in enumerate(slices[sid][2]):
                    slice_of_block[b] = sid
                    level_of_block[b] = L

        pending = list(range(len(slices)))
        set_levels()
        for attempt in range(4):
            results, loss, rejects, elems = batch_route_slices(pending)
            elem_rng, el_r, el_c, el_v = elems
            still = []
            accepted = set()
            for sid in pending:
                s, w8, bl = slices[sid]
                n_el = int(elems_b[bl].sum())
                budget = 0.05 * max(n_el, 1)
                growable = (s < SUB) or (w8 != W8_CLASSES[-1])
                if loss[sid] > budget and growable and attempt < 3:
                    still.append(sid)
                    continue
                # Realized-fill floor: scattered blocks keep a private
                # slice priced on PRE-routing counts, then most elements
                # spill — the slice streams ~1024*w8 slots for a handful
                # of survivors (livejournal v7: ~3.3M slots at 0.9-7%
                # fill in w8=1 block slices).  Dump such slices
                # wholesale into the COO residue; large residues repack
                # as a sub-plan (RES_REPACK_MIN), so a dumped element
                # costs ~1 well-filled slot instead of ~10-100 here.
                routed_n = n_el - loss[sid]
                if (config.fill_dump > 0.0
                        and routed_n < config.fill_dump
                        * (LANES * SUB * w8)):
                    e0, e1 = elem_rng[sid]
                    if e1 > e0:
                        ovf_r.append(el_r[e0:e1])
                        ovf_c.append(el_c[e0:e1])
                        ovf_v.append(el_v[e0:e1])
                    continue            # not accepted: rejects included
                final_results[sid] = results[sid]
                accepted.add(sid)
            # keep rejects belonging to accepted slices
            if rejects[0].size:
                rj_sid = np.array([slice_of_block[blk[r]]
                                   for r in rejects[0]])
                keep = np.isin(rj_sid, list(accepted)) if accepted else \
                    np.zeros(rj_sid.size, dtype=bool)
                if keep.any():
                    ovf_r.append(rejects[0][keep])
                    ovf_c.append(rejects[1][keep])
                    ovf_v.append(rejects[2][keep])
            if not still:
                break
            # congested slices retry: double the stride (splitting the
            # block group) until 8, then double the width
            pending = []
            for sid in still:
                s, w8, bl = slices[sid]
                if s < SUB:
                    s2 = s * 2
                    cap = SUB // s2
                    slices[sid] = [s2, w8, bl[:cap]]
                    pending.append(sid)
                    for lo in range(cap, len(bl), cap):
                        slices.append([s2, w8, bl[lo:lo + cap]])
                        pending.append(len(slices) - 1)
                else:
                    w82 = W8_CLASSES[min(W8_CLASSES.index(w8) + 1,
                                         len(W8_CLASSES) - 1)]
                    slices[sid] = [s, w82, bl]
                    pending.append(sid)
            set_levels()
            # the regular region stays FIXED by the first (stride, width)
            # choice (tails were already carved); the retry only gains
            # routing room, so update the per-row stride/width views used
            # for ipref/vreg computation
            for sid in pending:
                s, w8, bl = slices[sid]
                for b in bl:
                    s_choice[b] = s
                    w8_choice[b] = w8
            s_row0 = s_choice[blk[rows_sell_all]]
            w8_row0 = w8_choice[blk[rows_sell_all]]

        for sid, (tiles, w8, p_used) in final_results.items():
            s = slices[sid][0]
            packets.append(_Packet("sell", w8, _p_class(p_used, p_cap),
                                   tiles, sid, stride=s))

    # ---- length-bucketed shared slices ----------------------------------
    # Rows with 1..SHORT_MAX nnz pack into strided shared slices ({1,2}
    # at stride 2, {3,4} at stride 4): 8/stride row LEVELS share each lane
    # column and the kernel emits per-level sums — the TPU shape of the
    # reference's short1/22/34 strategies (``dasp_f64.h:595-713``).
    # Rows of 5-16 nnz from DUMPED blocks go to medium buckets (stride 8,
    # width 1 or 2).  Each block's bucket rows sit block-atomically in one
    # level so one outgather source per bucket suffices; conflict rejects
    # spill to the rem levels.
    ALL_BUCKETS = SHORT_BUCKETS + MED_BUCKETS
    short_lane_of_row = np.full(n, -1, dtype=np.int32)
    short_bucket_of_row = np.full(n, -1, dtype=np.int32)
    short_slice_of_block = [np.full(B, -1, dtype=np.int64)
                            for _ in ALL_BUCKETS]
    short_level_of_block = [np.zeros(B, dtype=np.int64)
                            for _ in ALL_BUCKETS]
    n_short_slices = [0] * len(ALL_BUCKETS)
    if n:
        CAPS = LANES - 1                  # lane 127 reserved always-zero
        short_meta = []                   # (bi, sid, stride, w8) per slice
        cls_elems = []                    # per class: flat element arrays
        vreg_total = 0                    # global bucket-vreg counter
        # Outgather-slot budget gate for the MED classes (the 32/64
        # extension made primary + 2 short + 4 med = 7 committed slots
        # possible, leaving none for a block's long-scalar rows — caught
        # by the _emit invariant on livejournal).  Track per-block
        # committed slots (primary + buckets) and route med rows of
        # blocks at cap to the overflow pool instead (the pre-extension
        # behavior).  Short classes stay ungated: primary + 2 short = 3
        # can never breach the reserve.
        has_long_b0 = np.zeros(B, dtype=bool)
        has_long_b0[np.flatnonzero(is_long) // LANES] = True
        cap_b = K_SOURCES - np.where(has_long_b0, 2, 1)
        committed_b = (slice_of_block >= 0).astype(np.int64)
        prev_max = 0
        for bi, (max_len, s, bw8) in enumerate(ALL_BUCKETS):
            if bi < len(SHORT_BUCKETS):
                sel_mask = is_short & (lens > prev_max) & (lens <= max_len)
            else:
                sel_mask = is_med_bucket & (lens > prev_max) \
                    & (lens <= max_len)
                # keep one slot free for the block's rem level: med
                # classes displacing rem capacity pushed spill rows of
                # the same block straight to COO (fuzz regression)
                over = sel_mask & (committed_b[blk] >= cap_b[blk] - 1)
                orows = np.flatnonzero(over)
                if orows.size:
                    dl = lens[orows]
                    eidx = np.repeat(rpt[orows], dl) + (
                        np.arange(int(dl.sum())) - np.repeat(
                            np.concatenate([[0], np.cumsum(dl)[:-1]]), dl))
                    ovf_r.append(np.repeat(orows, dl))
                    ovf_c.append(cols_all[eidx])
                    ovf_v.append(vals_all[eidx])
                    sel_mask &= ~over
            prev_max = max_len
            sel_rows = np.flatnonzero(sel_mask)
            if sel_rows.size == 0:
                continue
            G = SUB // s                  # levels per slice
            ub, bstart = np.unique(blk[sel_rows], return_index=True)
            bstart = np.append(bstart, sel_rows.size)
            nb = np.diff(bstart)
            # rows beyond CAPS per block -> overflow (keep the first CAPS)
            if (nb > CAPS).any():
                keep = np.ones(sel_rows.size, dtype=bool)
                for j in np.flatnonzero(nb > CAPS):
                    keep[bstart[j] + CAPS:bstart[j + 1]] = False
                drop = sel_rows[~keep]
                dl = lens[drop]
                eidx = np.repeat(rpt[drop], dl) + (
                    np.arange(int(dl.sum())) - np.repeat(
                        np.concatenate([[0], np.cumsum(dl)[:-1]]), dl))
                ovf_r.append(np.repeat(drop, dl))
                ovf_c.append(cols_all[eidx])
                ovf_v.append(vals_all[eidx])
                sel_rows = sel_rows[keep]
                ub, bstart = np.unique(blk[sel_rows], return_index=True)
                bstart = np.append(bstart, sel_rows.size)
                nb = np.diff(bstart)
            # Sequential slice/level assignment: block-atomic per level,
            # scalar loop over BLOCKS only — all element math below is
            # one vectorized pass.  (The former per-level flush/append
            # closure concatenated ~24k times on livejournal's short-row
            # population: 21.5s of a 69s pack, the largest remaining
            # Python phase — VERDICT r3 item 5.)
            sid0 = n_short_slices[bi]
            slice_b = np.empty(ub.size, dtype=np.int64)
            level_b = np.empty(ub.size, dtype=np.int64)
            off_b = np.empty(ub.size, dtype=np.int64)
            sid, level, cnt = sid0, 0, 0
            nb_l = nb.tolist()
            for j, m in enumerate(nb_l):
                if cnt + m > CAPS:
                    level += 1
                    cnt = 0
                    if level == G:
                        sid += 1
                        level = 0
                slice_b[j] = sid
                level_b[j] = level
                off_b[j] = cnt
                cnt += m
            n_new = sid - sid0 + 1
            n_short_slices[bi] = sid0 + n_new
            for t in range(n_new):
                short_meta.append((bi, sid0 + t, s, bw8))
            short_slice_of_block[bi][ub] = slice_b
            short_level_of_block[bi][ub] = level_b
            committed_b[ub] += 1
            # per-row lane within the level, then one flat element pass
            lane_r = (np.repeat(off_b, nb) + np.arange(sel_rows.size)
                      - np.repeat(bstart[:-1], nb))
            short_lane_of_row[sel_rows] = lane_r
            short_bucket_of_row[sel_rows] = bi
            ln_r = lens[sel_rows]
            tot = int(ln_r.sum())
            starts = np.concatenate([[0], np.cumsum(ln_r)[:-1]])
            k = np.arange(tot) - np.repeat(starts, ln_r)
            eidx = np.repeat(rpt[sel_rows], ln_r) + k
            c_rep = np.repeat(np.maximum(1, -(-ln_r // bw8)), ln_r)
            v_of = k // c_rep
            vreg_e = (vreg_total
                      + np.repeat(np.repeat(slice_b - sid0, nb), ln_r)
                      * bw8 + v_of)
            cls_elems.append((
                vreg_e,
                np.repeat(lane_r, ln_r),
                np.repeat(np.repeat(level_b, nb) * s, ln_r)
                + (k % c_rep),
                cols_all[eidx], vals_all[eidx],
                np.repeat(sel_rows, ln_r)))
            vreg_total += n_new * bw8
        if short_meta:
            strides_flat = [m[2] for m in short_meta
                            for _ in range(m[3])]
            ve = np.concatenate([c[0] for c in cls_elems])
            o2 = np.argsort(ve, kind="stable")
            bounds = np.zeros(vreg_total + 1, dtype=np.int64)
            np.cumsum(np.bincount(ve[o2], minlength=vreg_total),
                      out=bounds[1:])
            sp = bounds[1:-1]
            le, ie, ce, vae, re_ = (
                np.concatenate([c[i] for c in cls_elems])[o2]
                for i in range(1, 6))
            parts = list(zip(np.split(le, sp), np.split(ie, sp),
                             np.split(ce, sp), np.split(vae, sp)))
            erows = np.split(re_, sp)
            routed = _route_vregs_batch(parts, p_cap, strides_flat)
            cur = 0
            for bi, sid, s, bw8 in short_meta:
                tiles = [(routed[cur + v][0], routed[cur + v][1],
                          routed[cur + v][2]) for v in range(bw8)]
                p_used = max(1, max(t[2].size for t in tiles))
                packets.append(_Packet(
                    f"short{bi}", bw8, _p_class(p_used, p_cap),
                    tiles, sid, stride=s))
                cur += bw8
            for pt, er, (vt, it, wl, om) in zip(parts, erows, routed):
                if om.any():
                    ovf_r.append(er[om])
                    ovf_c.append(pt[2][om])
                    ovf_v.append(pt[3][om])


    # ---- rem2: re-route conflict rejects per block ----------------------
    # Elements the first pass could not route get a second, sparser slice
    # per block (fresh routing tables); remaining rejects go to the COO
    # overflow (XLA fallback) which is then tiny.
    # Re-routed slices are SHARED by runs of consecutive blocks (127 rows
    # per slice, lane 127 reserved as an always-zero pad), so blocks with
    # only a handful of re-routed rows don't each pay a full 128-lane
    # slice.  A block's rows stay in one slice (block-atomic grouping) so
    # the output gather needs a single source per block per level.  Two
    # levels run (conflicts of level 1 re-route in level 2); the dregs
    # fall to the COO overflow.
    rem_lane_of_row = [np.full(n, -1, dtype=np.int32) for _ in range(2)]
    rem_slice_of_block = [np.full(B, -1, dtype=np.int64) for _ in range(2)]
    n_rem_slices = [0, 0]
    NEIGHBORHOOD = 8          # blocks per shared slice (locality bound)
    CAPL = LANES - 1          # lanes per slice (zero pad at 127)

    # Output-source budget: a block has K_SOURCES outgather slots shared by
    # its primary slice, length buckets, rem levels, and long-scalar rows
    # (dynamic allocation, see the out-table section).  Blocks already at
    # budget keep their overflow rows out of further rem levels (-> COO).
    if n:
        slots_committed = (slice_of_block >= 0).astype(np.int64)
        for bi in range(len(ALL_BUCKETS)):
            slots_committed += short_slice_of_block[bi] >= 0
        has_long_b = np.zeros(B, dtype=bool)
        lb = np.flatnonzero(is_long) // LANES
        has_long_b[lb] = True
        # reserve 2 slots for long-scalar rows, 1 otherwise (fragment risk)
        rem_budget = K_SOURCES - slots_committed - np.where(
            has_long_b, 2, 1)
    else:
        rem_budget = np.zeros(0, dtype=np.int64)

    def build_shared_level(level, o_rows, o_cols, o_vals):
        """Pack overflow triplets into shared slices; returns leftovers."""
        kind = "rem2" if level == 0 else "rem3"
        left_r, left_c, left_v = [], [], []
        order = np.lexsort((o_cols, o_rows))
        o_rows, o_cols, o_vals = o_rows[order], o_cols[order], o_vals[order]
        urows_all, row_counts = np.unique(o_rows, return_counts=True)
        row_start = np.zeros(urows_all.size + 1, dtype=np.int64)
        np.cumsum(row_counts, out=row_start[1:])
        ublocks = urows_all // LANES
        # per-block [start, end) ranges into the sorted urows_all — the
        # former per-block ``ublocks == b`` scans were O(blocks x rows)
        # and dominated this phase on power-law overflow pools
        ubs_all, ub_start = np.unique(ublocks, return_index=True)
        ub_end = np.append(ub_start[1:], ublocks.size)

        def emit(slice_rows, member_blocks):
            sid = n_rem_slices[level]
            n_rem_slices[level] += 1
            for mb in member_blocks:
                rem_slice_of_block[level][mb] = sid
            rem_lane_of_row[level][slice_rows] = np.arange(slice_rows.size)
            # rows' elements are contiguous runs in the (row,col)-sorted
            # stream: gather their index ranges instead of isin
            ri = np.searchsorted(urows_all, slice_rows)
            r0, r1 = row_start[ri], row_start[ri + 1]
            cnt = r1 - r0
            sel = (np.repeat(r0, cnt)
                   + (np.arange(int(cnt.sum()))
                      - np.repeat(np.concatenate([[0],
                                                  np.cumsum(cnt)[:-1]]),
                                  cnt)))
            er, ec, ev = o_rows[sel], o_cols[sel], o_vals[sel]
            # lane of each element = position of its row in slice_rows
            # (vectorized: slice_rows is small but er can be the whole
            # element pool — a per-element Python dict lookup cost ~40%
            # of the rem phase on wikitalk)
            sr_sort = np.argsort(slice_rows, kind="stable")
            lanes_e = sr_sort[np.searchsorted(slice_rows[sr_sort], er)]
            order2 = np.lexsort((ec, lanes_e))
            lanes_e, ec, ev, er = (lanes_e[order2], ec[order2],
                                   ev[order2], er[order2])
            starts = np.zeros(LANES + 1, dtype=np.int64)
            cnts = np.bincount(lanes_e, minlength=LANES)
            np.cumsum(cnts, out=starts[1:])
            local = np.arange(lanes_e.size) - starts[lanes_e]

            # width covers the slice's LONGEST row outright: profile-sorted
            # grouping makes slices length-homogeneous, so capacity drops
            # (which would cost a frag-vreg each) never happen; only
            # routing conflicts spill
            max_len = int(np.minimum(cnts, SUB * W8_CLASSES[-1]).max())
            w8 = next(c for c in W8_CLASSES if SUB * c >= max_len)
            w8_cap = min(w8 * 4, W8_CLASSES[-1])
            best = None
            while True:
                cap = SUB * w8
                keepm = local < cap
                n_drop = int((~keepm).sum())
                slen = np.minimum(cnts, cap)
                c = np.maximum(1, -(-slen // w8))
                tiles, p_used, n_ovf, ovfs = [], 1, 0, []
                parts_v, in_vs = [], []
                for v in range(w8):
                    lo = c[lanes_e] * v
                    in_v = keepm & (local >= lo) & (local < lo + c[lanes_e])
                    in_vs.append(in_v)
                    parts_v.append((lanes_e[in_v], local[in_v] - lo[in_v],
                                    ec[in_v], ev[in_v]))
                routed_v = _route_vregs_batch(parts_v, p_cap)
                for in_v, (vt, it, wl, om) in zip(in_vs, routed_v):
                    if om.any():
                        sel_v = np.flatnonzero(in_v)[om]
                        n_ovf += sel_v.size
                        ovfs.append(sel_v)
                    p_used = max(p_used, wl.size)
                    tiles.append((vt, it, wl))
                lost = n_ovf + n_drop
                cand = (tiles, p_used, n_ovf, ovfs, cap, lost)
                if best is None or lost < best[5]:
                    best = cand
                # grow the width only for routing CONFLICTS — growing to
                # chase a few long rows' capacity pads the whole slice
                # (measured occ 0.11 on power-law rem pools); capacity
                # tails cascade to the next level / fragments instead
                # economic growth: a width step costs ~w8 x 1024-slot
                # stream bytes while each residual conflict costs one COO
                # element-gather (~equal per-element); grow only while the
                # conflicts outweigh the step
                if n_ovf <= w8 or w8 >= w8_cap:
                    break
                w8 = W8_CLASSES[W8_CLASSES.index(w8) + 1]
            tiles, p_used, n_ovf, ovfs, cap, _ = best
            w8 = len(tiles)
            # conflicts -> next level / COO
            for sel_v in ovfs:
                left_r.append(er[sel_v])
                left_c.append(ec[sel_v])
                left_v.append(ev[sel_v])
            # beyond-capacity elements: the long level (built FIRST) drops
            # short tails that cascade into the short level's pool; the
            # short level (last) fragments its rare residue
            dropm = local >= cap
            if dropm.any():
                if level == 1:
                    left_r.append(er[dropm])
                    left_c.append(ec[dropm])
                    left_v.append(ev[dropm])
                else:
                    for r in np.unique(er[dropm]):
                        selr = dropm & (er == r)
                        add_frag(int(r), ec[selr], ev[selr])
            # Realized-fill floor (see the block-slice analog above):
            # shared pool slices whose width quantization leaves them
            # nearly empty (livejournal v7: ~3.3M slots at 0.9-9% fill
            # in the ss=8 pool levels) dump their survivors into the
            # COO residue instead of streaming ~1024*w8 slots for them.
            kept = int((local < cap).sum()) - n_ovf
            if (config.fill_dump > 0.0
                    and kept < config.fill_dump * (LANES * SUB * w8)):
                in_ovf = np.zeros(er.size, dtype=bool)
                for sel_v in ovfs:
                    in_ovf[sel_v] = True
                keptm = (local < cap) & ~in_ovf
                if keptm.any():
                    ovf_r.append(er[keptm])
                    ovf_c.append(ec[keptm])
                    ovf_v.append(ev[keptm])
                # roll back the slot bookkeeping claimed at emit entry
                n_rem_slices[level] -= 1
                for mb in member_blocks:
                    rem_slice_of_block[level][mb] = -1
                rem_lane_of_row[level][slice_rows] = -1
                return
            packets.append(_Packet(kind, w8, _p_class(p_used, p_cap),
                                   tiles, sid))

        # Block grouping: level 0 (short tails) groups ADJACENT blocks for
        # window locality; level 1 (longer rows) groups blocks by LENGTH
        # PROFILE so each slice's occupancy-chosen width fits its rows
        # (length heterogeneity, not locality, dominated its padding).
        if level == 0:
            block_order = ubs_all
        else:
            prof = np.maximum.reduceat(row_counts, ub_start) \
                if ub_start.size else np.zeros(0, dtype=row_counts.dtype)
            block_order = ubs_all[np.argsort(prof, kind="stable")]
        rem_used = (rem_slice_of_block[0] >= 0).astype(np.int64) \
            + (rem_slice_of_block[1] >= 0)
        cur_rows, cur_blocks, cur_count = [], [], 0
        for b in block_order:
            j = int(np.searchsorted(ubs_all, b))
            u0, u1 = int(ub_start[j]), int(ub_end[j])
            if rem_used[b] >= rem_budget[b]:
                # block out of outgather slots: rows cascade onward
                s0, s1 = row_start[u0], row_start[u1]
                left_r.append(o_rows[s0:s1])
                left_c.append(o_cols[s0:s1])
                left_v.append(o_vals[s0:s1])
                continue
            if (level == 0 and cur_blocks
                    and b - cur_blocks[0] >= NEIGHBORHOOD):
                emit(np.concatenate(cur_rows), cur_blocks)
                cur_rows, cur_blocks, cur_count = [], [], 0
            br = urows_all[u0:u1]
            if br.size > CAPL:
                cnts_b = row_counts[u0:u1]
                keep = br[np.argsort(-cnts_b, kind="stable")[:CAPL]]
                for r in np.setdiff1d(br, keep):
                    i = int(np.searchsorted(urows_all, r))
                    s0, s1 = row_start[i], row_start[i + 1]
                    add_frag(int(r), o_cols[s0:s1], o_vals[s0:s1])
                br = np.sort(keep)
            if cur_count + br.size > CAPL and cur_count:
                emit(np.concatenate(cur_rows), cur_blocks)
                cur_rows, cur_blocks, cur_count = [], [], 0
            cur_rows.append(br)
            cur_blocks.append(int(b))
            cur_count += br.size
        if cur_count:
            emit(np.concatenate(cur_rows), cur_blocks)
        if left_r:
            return (np.concatenate(left_r), np.concatenate(left_c),
                    np.concatenate(left_v))
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
                np.empty(0))

    if ovf_r:
        o_r = np.concatenate(ovf_r)
        o_c = np.concatenate(ovf_c)
        o_v = np.concatenate(ovf_v)
        ovf_r.clear()
        ovf_c.clear()
        ovf_v.clear()
        # length segregation: rows with many overflow elements go to the
        # LONG level (built first, width sized for its pool); its conflict
        # rejects and capacity tails — short by then — cascade into the
        # SHORT level's pool, whose residue goes to COO
        rcnt = np.bincount(o_r, minlength=n)
        small = rcnt[o_r] <= 2 * SUB
        if (~small).any():
            r1, c1, v1 = build_shared_level(1, o_r[~small], o_c[~small],
                                            o_v[~small])
        else:
            r1 = np.empty(0, dtype=np.int64)
            c1, v1 = np.empty(0, dtype=np.int64), np.empty(0)
        o_r = np.concatenate([o_r[small], r1])
        o_c = np.concatenate([o_c[small], c1])
        o_v = np.concatenate([o_v[small], v1])
        if o_r.size:
            o_r, o_c, o_v = build_shared_level(0, o_r, o_c, o_v)
        if o_r.size:
            ovf_r.append(o_r)
            ovf_c.append(o_c)
            ovf_v.append(o_v)

    # ---- long rows + fragments (original row order -> scalar order) -----
    long_rows = np.flatnonzero(is_long)
    scalar_owners = sorted(set(long_rows.tolist()) | set(frags))
    scalar_pos_of_row = {int(r): i for i, r in enumerate(scalar_owners)}
    # Phase 1: build every long vreg's element arrays, route them all in
    # ONE native batch call, then assemble packets.
    #
    # Element -> vreg assignment packs each row's WINDOW-GROUPS (runs of
    # equal col//1024 in the sorted stream) into vregs holding <= 32
    # windows each, adding vregs beyond ceil(len/1024) when the row's
    # windows don't fit (scattered zipf tails).
    LONG_WIN_CAP = P_CLASSES[-1]
    # Static-split padding guard, kept for the native ABI.  Measured on
    # rmat_like (2026-08-20): the serialized dynamic-round colsum cost
    # ~218 ns/vreg/round — 245x the static kernel's 0.89 — so static
    # splitting wins up to ~200x padding, and 32 IS the structural worst
    # case (32 windows x 1 element each per 1024-slot vreg): ceil(n_win/
    # 32) <= 32*ceil(len/1024) always, so the escape `nv_need >
    # DYN_PAD_MAX*nv_base` can never fire and every long vreg is
    # statically classed (the P>32 kernels were removed in round 5).
    DYN_PAD_MAX = 32
    row_cols: List[np.ndarray] = []   # per ROW, in vreg-emission order
    row_vals: List[np.ndarray] = []
    vreg_sizes: List[int] = []        # per vreg
    owners: List[int] = []            # per vreg
    # per-row column sort is a no-op when the CSR is already column-sorted
    # within rows (always true after a relabel; usual for .mtx inputs) —
    # one vectorized check avoids 3-4k per-row argsorts on graph matrices
    if csr.nnz > 1:
        d = np.diff(cols_all)
        brk = rpt[1:-1] - 1
        m = np.ones(d.size, dtype=bool)
        m[brk[(brk >= 0) & (brk < d.size)]] = False
        rows_sorted = bool(np.all(d[m] >= 0))
    else:
        rows_sorted = True
    # Native fast path: chunking decision, window bin-packing, routing and
    # reject retries all happen in ONE C++ call parallelized over rows
    # (native/router.cpp dasp_pack_long) — the numpy orchestration below
    # is the semantics oracle and the no-toolchain fallback.  The
    # reference's packers are likewise all-native OpenMP host loops
    # (dasp_f16.h:1162-1446).
    _nat = _native_router()
    _native_long_done = False
    if _nat and scalar_owners and _nat.has_pack_long():
        cls_tab = np.asarray(P_CLASSES, dtype=np.int64)

        def _pack_call(rs, re_, base_c, base_v):
            out = _nat.pack_long(rs, re_, base_c, base_v, LONG_WIN_CAP,
                                 LONG_P_CAP, DYN_PAD_MAX)
            vt_all, it_all, wins_cat, win_off, owner_ord, dregs = out
            wcnt = np.maximum(np.diff(win_off), 1)
            assert int(wcnt.max(initial=1)) <= LONG_WIN_CAP, \
                "native pack_long emitted a vreg over the 32-window cap"
            cls_arr = cls_tab[np.searchsorted(cls_tab, wcnt, side="left")]
            return (vt_all, it_all, wins_cat, win_off, owner_ord,
                    cls_arr, dregs)

        res_long = res_frag = None
        if long_rows.size:
            if rows_sorted:
                # zero-copy: route straight out of the CSR streams
                rs = rpt[long_rows]
                res_long = _pack_call(rs, rs + lens[long_rows],
                                      cols_all, vals_all)
                if res_long[6].size:       # dregs: absolute CSR positions
                    d = res_long[6]
                    ovf_r.append(np.searchsorted(rpt, d, side="right") - 1)
                    ovf_c.append(cols_all[d])
                    ovf_v.append(vals_all[d])
            else:
                parts_c = []
                parts_v = []
                for row in long_rows:
                    base, ln = int(rpt[row]), int(lens[row])
                    o = np.argsort(cols_all[base:base + ln], kind="stable")
                    parts_c.append(cols_all[base:base + ln][o])
                    parts_v.append(vals_all[base:base + ln][o])
                cat_c = np.concatenate(parts_c)
                cat_v = np.concatenate(parts_v)
                off = np.zeros(long_rows.size + 1, dtype=np.int64)
                np.cumsum(lens[long_rows], out=off[1:])
                res_long = _pack_call(off[:-1], off[1:], cat_c, cat_v)
                if res_long[6].size:
                    d = res_long[6]
                    ords = np.searchsorted(off, d, side="right") - 1
                    ovf_r.append(long_rows[ords])
                    ovf_c.append(cat_c[d])
                    ovf_v.append(cat_v[d])
        frag_rows = [r for r in scalar_owners if not is_long[r]]
        if frag_rows:
            parts_c = []
            parts_v = []
            for row in frag_rows:
                colv, valv = frags[row]
                o = np.argsort(colv, kind="stable")
                parts_c.append(colv[o])
                parts_v.append(valv[o])
            cat_c = np.concatenate(parts_c)
            cat_v = np.concatenate(parts_v)
            szs = np.fromiter((c.size for c in parts_c), dtype=np.int64,
                              count=len(parts_c))
            off = np.zeros(szs.size + 1, dtype=np.int64)
            np.cumsum(szs, out=off[1:])
            res_frag = _pack_call(off[:-1], off[1:], cat_c, cat_v)
            if res_frag[6].size:
                d = res_frag[6]
                ords = np.searchsorted(off, d, side="right") - 1
                ovf_r.append(np.asarray(frag_rows, dtype=np.int64)[ords])
                ovf_c.append(cat_c[d])
                ovf_v.append(cat_v[d])

        def _take(res, state, oi, row):
            vt_all, it_all, wins_cat, win_off, owner_ord, cls_arr, _ = res
            vi = state[0]
            nv = owner_ord.size
            by_cls: Dict[int, List] = {}
            while vi < nv and owner_ord[vi] == oi:
                wl = wins_cat[win_off[vi]:win_off[vi + 1]].astype(np.int64)
                by_cls.setdefault(int(cls_arr[vi]), []).append(
                    (vt_all[vi], it_all[vi], wl))
                vi += 1
            state[0] = vi
            for cls, tiles in by_cls.items():
                packets.append(_Packet("long", len(tiles), cls, tiles, row))

        li = fi = 0
        st_l, st_f = [0], [0]
        for row in scalar_owners:
            if is_long[row]:
                _take(res_long, st_l, li, row)
                li += 1
            else:
                _take(res_frag, st_f, fi, row)
                fi += 1
        _native_long_done = True

    for row in ([] if _native_long_done else scalar_owners):
        if is_long[row]:
            base, ln = int(rpt[row]), int(lens[row])
            colv = cols_all[base:base + ln]
            valv = vals_all[base:base + ln]
            if not rows_sorted:
                o = np.argsort(colv, kind="stable")
                colv, valv = colv[o], valv[o]
        else:
            colv, valv = frags[row]
            ln = colv.size
            o = np.argsort(colv, kind="stable")
            colv, valv = colv[o], valv[o]
        nv_base = -(-ln // VREG)
        w_of = colv // VREG
        # sequential dealing is optimal when each 1024-chunk already fits
        # the static window budget (dense sorted regions); the scattered
        # fallback deals sequentially too (dynamic round classes absorb
        # the window counts up to LONG_P_CAP).  Distinct windows per chunk
        # = boundary count in the sorted stream (no per-chunk unique).
        if ln:
            wcnt = np.cumsum(np.r_[1, (np.diff(w_of) != 0)])
            bounds = np.r_[np.arange(0, ln, VREG), ln]
            chunk_w = int((wcnt[np.minimum(bounds[1:], ln) - 1]
                           - wcnt[bounds[:-1]] + 1).max())
        else:
            chunk_w = 0
        sequential = chunk_w <= LONG_WIN_CAP
        if not sequential:
            starts = np.r_[0, np.flatnonzero(np.diff(w_of)) + 1]
            sizes = np.diff(np.r_[starts, ln])
            n_win = starts.size
            nv_need = max(nv_base, -(-n_win // LONG_WIN_CAP))
            sequential = nv_need > DYN_PAD_MAX * nv_base
        if sequential:
            row_cols.append(colv)
            row_vals.append(valv)
            for v in range(nv_base):
                vreg_sizes.append(min(VREG, ln - v * VREG))
                owners.append(int(row))
            continue
        # first-fit-decreasing bin-packing of window groups; groups larger
        # than a vreg are pre-chunked (a chunk fills a whole vreg)
        group_idx = []
        for gi in range(n_win):
            lo, sz = int(starts[gi]), int(sizes[gi])
            for c0 in range(0, sz, VREG):
                group_idx.append(np.arange(lo + c0, lo + min(c0 + VREG, sz)))
        group_idx.sort(key=len, reverse=True)
        bins: List[List] = []      # [slots_used, windows_used, [idx arrays]]
        for idxs in group_idx:
            for b in bins:
                if b[0] + idxs.size <= VREG and b[1] < LONG_WIN_CAP:
                    b[2].append(idxs)
                    b[0] += idxs.size
                    b[1] += 1
                    break
            else:
                bins.append([idxs.size, 1, [idxs]])
        sel = np.concatenate([i for b in bins for i in b[2]])
        row_cols.append(colv[sel])
        row_vals.append(valv[sel])
        for b in bins:
            vreg_sizes.append(b[0])
            owners.append(int(row))
    # Route in ONE native call over the concatenated element arrays,
    # retrying routing-cell rejects in FRESH vregs of the same row (a long
    # row's slots are position-free: the output is the total sum, so
    # rejected elements just cost an extra sparsely-filled vreg instead of
    # falling to the COO fallback, whose XLA element-gather runs at
    # ~0.05 Gelem/s).  Depth 3 leaves only conflict-of-conflict dregs.
    row_tiles: Dict[int, List] = {int(row): [] for row in scalar_owners}
    col_cat = (np.concatenate(row_cols) if row_cols
               else np.zeros(0, dtype=np.int64))
    val_cat = np.concatenate(row_vals) if row_vals else np.zeros(0)
    sizes_a = np.asarray(vreg_sizes, dtype=np.int64)
    for depth in range(3):
        offsets = np.zeros(sizes_a.size + 1, dtype=np.int64)
        np.cumsum(sizes_a, out=offsets[1:])
        t = np.arange(int(offsets[-1])) - np.repeat(offsets[:-1], sizes_a)
        lane_cat = t % LANES
        ipref_cat = (t // LANES) % SUB
        routed = _route_concat(offsets, lane_cat, ipref_cat, col_cat,
                               val_cat, LONG_P_CAP)
        rej: Dict[int, Tuple[List, List]] = {}
        for v, ((vt, it, wl, om), row) in enumerate(zip(routed, owners)):
            row_tiles[row].append((vt, it, wl))
            if om.any():
                cs, vs = rej.setdefault(row, ([], []))
                cs.append(col_cat[offsets[v]:offsets[v + 1]][om])
                vs.append(val_cat[offsets[v]:offsets[v + 1]][om])
        if not rej:
            break
        if depth == 2:
            for row, (cs, vs) in rej.items():
                cc = np.concatenate(cs)
                ovf_r.append(np.full(cc.size, row))
                ovf_c.append(cc)
                ovf_v.append(np.concatenate(vs))
            break
        nxt_c, nxt_v, nxt_sizes, nxt_owner = [], [], [], []
        for row, (cs, vs) in rej.items():
            colv = np.concatenate(cs)
            valv = np.concatenate(vs)
            o = np.argsort(colv, kind="stable")
            colv, valv = colv[o], valv[o]
            nxt_c.append(colv)
            nxt_v.append(valv)
            w_of = colv // VREG
            # sequential chunking: new vreg at 32 windows or 1024 slots
            new_w = np.r_[True, np.diff(w_of) != 0]
            wcount = np.cumsum(new_w)
            lo = 0
            while lo < colv.size:
                base_w = wcount[lo] - 1
                hi = int(np.searchsorted(
                    wcount, base_w + LONG_WIN_CAP, side="right"))
                hi = min(hi, lo + VREG, colv.size)
                nxt_sizes.append(hi - lo)
                nxt_owner.append(row)
                lo = hi
        col_cat = np.concatenate(nxt_c)
        val_cat = np.concatenate(nxt_v)
        sizes_a = np.asarray(nxt_sizes, dtype=np.int64)
        owners = nxt_owner
    for row in scalar_owners:
        # Class each vreg by ITS OWN window count: a long row's column-sorted
        # head has 1-2 windows while its scattered tail can use 32 — one
        # packet per round-class keeps the dense head out of the expensive
        # many-round stream (the per-row max classing measured 53% of all
        # vregs in the P=32 stream on power-law graphs; per-vreg classing
        # cuts the P-weighted vector cost ~5x).  Contributions of one row's
        # packets are summed by the glue via the long gather matrix.
        by_cls: Dict[int, List] = {}
        for vt, it, wl in row_tiles[row]:
            by_cls.setdefault(_p_class(max(wl.size, 1), LONG_P_CAP),
                              []).append((vt, it, wl))
        for cls, tiles in by_cls.items():
            packets.append(_Packet("long", len(tiles), cls, tiles, row))

    phase("pack.tables")
    # ---- assembly --------------------------------------------------------
    key_mass: Dict[Tuple[int, int], int] = {}     # (cls, stride) -> vregs
    for q in packets:
        key = (q.cls, q.stride)
        key_mass[key] = key_mass.get(key, 0) + q.w8
    # snapshot BEFORE merge_class_keys mutates the dict (it setdefaults
    # zero-mass roots, line ~613): stats must carry the true raw masses —
    # phantom zero-mass keys would flow into the multichip union merge
    # and could drag small real classes to high-P/low-stride roots
    raw_key_mass = dict(key_mass)
    if pin_classes is not None:
        # Globally pinned class quantization (multi-chip): the merge
        # decisions below are data-dependent, so independently packed row
        # slabs land the same row populations in DIFFERENT (P, stride)
        # stream keys and harmonize_wplans' elementwise-max union pads
        # heavily.  The multi-chip builder computes ONE merge map from
        # the union of all chips' raw key masses and repacks divergent
        # chips with it pinned here.
        final_key = {k: pin_classes.get(k, k) for k in key_mass}
    else:
        final_key = merge_class_keys(
            key_mass, s_rows=(-(-max(csr.n_cols, 1) // VREG)) * SUB)

    key_list = sorted({final_key[(p.cls, p.stride)] for p in packets})
    streams: List[WStream] = []
    sell_segments: List[SellSegment] = []
    long_groups: List[LongGroup] = []
    stream_idx: Dict[Tuple[int, int], int] = {}
    y2_row_of_slice = np.full(max(len(slices), 1) if n else 1, -1,
                              dtype=np.int64)
    y2_row_of_shortslice = [np.full(max(ns, 1), -1, dtype=np.int64)
                            for ns in n_short_slices]
    y2_row_of_remslice = [np.full(max(ns, 1), -1, dtype=np.int64)
                          for ns in n_rem_slices]
    out_row = 0

    # Per-category fill accounting (the reference's packing-quality CSV
    # fields, dasp_f64.h:1440-1441), accumulated per stream from one
    # vectorized per-vreg nonzero count — NOT by re-concatenating every
    # tile (which copied the whole plan once more).
    # codes: 0=sell 1=short buckets 2=rem2 3=rem3 4=long
    kind_slots = np.zeros(5, dtype=np.int64)
    kind_nnz = np.zeros(5, dtype=np.int64)

    def _kind_code(kind: str) -> int:
        if kind == "sell":
            return 0
        if kind.startswith("short"):
            return 1
        return {"rem2": 2, "rem3": 3, "long": 4}[kind]

    for key in key_list:
        cls, stride = key
        stream_idx[key] = len(streams)
        mine = [p for p in packets
                if final_key[(p.cls, p.stride)] == key]
        n_buckets = len(SHORT_BUCKETS) + len(MED_BUCKETS)
        kind_rank = {"sell": 0,
                     **{f"short{i}": 1 + i for i in range(n_buckets)},
                     "rem2": 1 + n_buckets, "rem3": 2 + n_buckets,
                     "long": 3 + n_buckets}
        mine.sort(key=lambda p: (kind_rank[p.kind], p.stride, p.w8,
                                 p.block))
        vals_parts, idx_parts, win_parts = [], [], []
        codes: List[int] = []          # kind code per emitted vreg
        vreg_cursor = 0
        i = 0
        while i < len(mine) and mine[i].kind != "long":
            j = i
            while (j < len(mine) and mine[j].kind == mine[i].kind
                   and mine[j].w8 == mine[i].w8
                   and mine[j].stride == mine[i].stride):
                j += 1
            run = mine[i:j]
            sell_segments.append(SellSegment(
                stream=stream_idx[key], vreg_offset=vreg_cursor,
                n_slices=len(run), w8=run[0].w8, out_row=out_row,
                stride=run[0].stride))
            code = _kind_code(run[0].kind)
            for p in run:
                codes.extend([code] * len(p.tiles))
                for vt, it, wl in p.tiles:
                    vals_parts.append(vt)
                    idx_parts.append(it)
                    win_parts.append(wl)
                if p.kind == "sell":
                    y2_row_of_slice[p.block] = out_row
                elif p.kind.startswith("short"):
                    y2_row_of_shortslice[int(p.kind[5:])][p.block] = out_row
                elif p.kind == "rem2":
                    y2_row_of_remslice[0][p.block] = out_row
                else:
                    y2_row_of_remslice[1][p.block] = out_row
                out_row += SUB // p.stride
                vreg_cursor += p.w8
            i = j
        long_here = [p for p in mine if p.kind == "long"]
        by_nvc: Dict[int, List[Tuple[_Packet, int]]] = {}
        for p in long_here:
            start = vreg_cursor
            codes.extend([4] * len(p.tiles))
            for vt, it, wl in p.tiles:
                vals_parts.append(vt)
                idx_parts.append(it)
                win_parts.append(wl)
            vreg_cursor += p.w8
            nv_c = 1 << int(np.ceil(np.log2(max(p.w8, 1))))
            by_nvc.setdefault(nv_c, []).append((p, start))
        nv_total = vreg_cursor
        for nv_c in sorted(by_nvc):
            plist = by_nvc[nv_c]
            idxm = np.full((len(plist), nv_c), nv_total, dtype=np.int64)
            spos = np.zeros(len(plist), dtype=np.int64)
            for k, (p, st) in enumerate(plist):
                idxm[k, :p.w8] = np.arange(st, st + p.w8)
                spos[k] = scalar_pos_of_row[p.block]
            long_groups.append(LongGroup(
                stream=stream_idx[key], idx=idxm.astype(np.int32),
                scalar_pos=spos))

        nv = len(win_parts)
        if nv == 0:
            continue
        vals = np.concatenate(vals_parts, axis=0)
        idx = np.concatenate(idx_parts, axis=0).astype(np.int32, copy=False)
        codes_a = np.asarray(codes, dtype=np.int64)
        nzv = np.count_nonzero(vals.reshape(nv, -1), axis=1)
        kind_nnz += np.bincount(codes_a, weights=nzv,
                                minlength=5).astype(np.int64)
        kind_slots += np.bincount(codes_a, minlength=5) * (SUB * LANES)
        counts = np.fromiter((wl.size for wl in win_parts),
                             dtype=np.int32, count=nv)
        wins = np.zeros((nv, cls), dtype=np.int32)
        tot_w = int(counts.sum())
        rowi = np.repeat(np.arange(nv), counts)
        coli = np.arange(tot_w) - np.repeat(
            np.cumsum(counts, dtype=np.int64) - counts, counts)
        wins[rowi, coli] = np.concatenate(win_parts) if tot_w else 0
        streams.append(WStream(P=cls, vals=vals, idx=idx,
                               wins=wins, win_counts=counts,
                               stride=stride))

    # long scalar rows appended to y2 after the slice rows
    n_long = len(scalar_owners)
    n_long_rows = -(-n_long // LONG_PACK) if n_long else 0
    long_row_base = out_row
    n_y2_rows = out_row + n_long_rows
    Z = n_y2_rows                                   # the all-zero row

    # ---- output-gather tables -------------------------------------------
    # block b's primary y2 row = its slice's first row + its level within
    # the (possibly strided, multi-block) slice
    y2_row_of_block = np.full(B, Z, dtype=np.int64)
    for b in range(B):
        sid = slice_of_block[b]
        if sid >= 0 and y2_row_of_slice[sid] >= 0:
            y2_row_of_block[b] = y2_row_of_slice[sid] + level_of_block[b]
    # Sources allocate K_SOURCES slots per block dynamically: primary,
    # then length buckets, rem levels, long-scalar rows — each appended
    # only when the block actually uses it (the slot budget above keeps
    # the total within K_SOURCES).
    # Vectorized source-slot allocation (the per-block Python loop cost
    # seconds at B ~ 20-40k blocks on the 1-vCPU build box): every source
    # family writes its blocks' (src row, lane perm) in one fancy-indexed
    # assignment, with a per-block slot cursor ``kcur`` giving the same
    # dynamic slot packing as the old loop (primary, buckets in order,
    # rem levels, long scalars).
    out_src = np.full((B, K_SOURCES), Z, dtype=np.int32)
    out_perm = np.zeros((B, K_SOURCES, LANES), dtype=np.int8)
    kcur = np.zeros(B, dtype=np.int64)

    def _padmat(arr, fill=-1):
        # np.empty + tail-only fill: a full np.full memset of the B*LANES
        # buffer per call measurably dominated this phase on multi-M-row
        # inputs (only the [n:] padding needs the sentinel).
        m = np.empty(B * LANES, dtype=np.int32)
        m[:n] = arr
        m[n:] = fill
        return m.reshape(B, LANES)

    def _emit(idx, src, perm):
        kc = kcur[idx]
        if int(kc.max(initial=0)) >= K_SOURCES:
            b = int(idx[np.argmax(kc)])
            raise AssertionError(
                f"block {b} needs {int(kcur[b]) + 1} outgather sources "
                f"(budget {K_SOURCES})")
        # out_perm is int8 and ``perm`` arrives int32 (np.where results):
        # fancy-indexed assignment downcasts SILENTLY, so range-check
        # first — a future sentinel (e.g. _padmat's -1 leaking through)
        # or a value >= 128 would otherwise wrap instead of failing.
        perm = np.asarray(perm)
        if perm.size and (int(perm.min()) < 0 or int(perm.max()) >= LANES):
            raise AssertionError(
                f"outgather lane perm out of int8 range "
                f"[{int(perm.min())}, {int(perm.max())}]")
        out_src[idx, kc] = src
        out_perm[idx, kc] = perm
        kcur[idx] += 1

    # primary slice
    lanes0 = _padmat(block_lane_of_row)
    idx = np.flatnonzero(y2_row_of_block != Z)
    if idx.size:
        pad0 = np.maximum(block_pad_lane, 0)
        _emit(idx, y2_row_of_block[idx],
              np.where(lanes0[idx] >= 0, lanes0[idx], pad0[idx, None]))
    # length-bucket slices (shared; lane 127 is the reserved zero pad)
    sb_mat = _padmat(short_bucket_of_row)
    sl_mat = _padmat(short_lane_of_row)
    for bi in range(len(ALL_BUCKETS)):
        sid = short_slice_of_block[bi]
        ok = sid >= 0
        ok[ok] = y2_row_of_shortslice[bi][sid[ok]] >= 0
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            continue
        src = (y2_row_of_shortslice[bi][sid[idx]]
               + short_level_of_block[bi][idx])
        _emit(idx, src, np.where(sb_mat[idx] == bi, sl_mat[idx], LANES - 1))
    # re-routed tails/conflict slices
    for level in range(2):
        sid = rem_slice_of_block[level]
        idx = np.flatnonzero(sid >= 0)
        if idx.size == 0:
            continue
        rl = _padmat(rem_lane_of_row[level])[idx]
        _emit(idx, y2_row_of_remslice[level][sid[idx]],
              np.where(rl >= 0, rl, LANES - 1))
    # long/fragment scalars (contiguous positions in row order per block,
    # so a block's scalars span at most 2 consecutive y2 scalar rows)
    if scalar_owners:
        spos_arr = np.full(n, -1, dtype=np.int32)
        so = np.asarray(scalar_owners, dtype=np.int64)
        spos_arr[so] = np.arange(so.size, dtype=np.int32)
        sp_mat = _padmat(spos_arr)
        has = sp_mat >= 0
        srow_mat = np.where(has, long_row_base + sp_mat // LONG_PACK,
                            np.int32(-1))
        BIG = np.int32(np.iinfo(np.int32).max)
        row_min = np.where(has, srow_mat, BIG).min(axis=1)
        row_max = srow_mat.max(axis=1)
        valid = row_max >= 0
        if np.any(valid) and int(
                (row_max[valid] - row_min[valid]).max(initial=0)) > 1:
            raise AssertionError("long rows of one block span >2 scalar rows")
        lane_mat = sp_mat % LONG_PACK
        for which in (row_min, row_max):
            sel = valid & (which < BIG)
            if which is row_max:
                sel &= row_max != row_min         # second distinct row only
            idx = np.flatnonzero(sel)
            if idx.size == 0:
                continue
            perm = np.where(srow_mat[idx] == which[idx, None],
                            lane_mat[idx], LANES - 1)
            _emit(idx, which[idx], perm)
    # unused k slots keep Z with perm 0 (Z is all zeros)

    overflow = None
    if ovf_r:
        orows = np.concatenate(ovf_r)
        overflow = from_coo(csr.n_rows, csr.n_cols, orows,
                            np.concatenate(ovf_c).astype(np.int32),
                            np.concatenate(ovf_v))

    padded = sum(s.vals.size for s in streams)
    # one clipped bincount instead of a comparison pass per length class
    lc = np.bincount(np.minimum(lens, 5), minlength=6) if n else \
        np.zeros(6, dtype=np.int64)
    census = {
        "row_long": int(long_rows.size),
        "row_block": int(n - lc[0] - long_rows.size),
        "row_zero": int(lc[0]),
        "n_overflow": int(orows.size) if ovf_r else 0,
        "short_row_1": int(lc[1]),
        "short_row_2": int(lc[2]),
        "short_row_3": int(lc[3]),
        "short_row_4": int(lc[4]),
        # strided/bucketed structure counts (no reference analog: the
        # short strategies there are kernel dispatch ranges)
        "bucket_slices": [int(ns) for ns in n_short_slices],
        "rem_slices": [int(ns) for ns in n_rem_slices],
        "n_frag": int(len(frags)),
        # nnz per category (reference CSV fields, dasp_f64.h:1440)
        "nnz_short": int(lc[1] + 2 * lc[2] + 3 * lc[3] + 4 * lc[4]),
        "nnz_long": int(lens[is_long].sum()),
    }
    # Per-category padded/original element counts — the reference's primary
    # packing-quality diagnostics (fill0_nnz_short / fill0_nnz_long /
    # origin_nnz_reg / fill0_nnz_reg, dasp_f64.h:1440-1441).  Mapping: the
    # strided bucket slices subsume the reference's short strategies, SELL
    # slices its regular medium region, long packets+fragments its long
    # part; rem slices are the irregular-tail analog (nnz_irreg below).
    stats = {
        "fill0_nnz_total": float(padded),
        "rate_fill0": float((padded - csr.nnz) / csr.nnz) if csr.nnz else 0.0,
        "overflow_frac": float(census["n_overflow"] / csr.nnz)
        if csr.nnz else 0.0,
        "fill0_nnz_short": float(kind_slots[1]),
        "fill0_nnz_long": float(kind_slots[4]),
        "origin_nnz_reg": float(kind_nnz[0]),
        "fill0_nnz_reg": float(kind_slots[0]),
        # the reference's irregular-tail CSR analog: elements re-routed
        # through shared rem slices, long-style fragments, or COO dregs
        "nnz_irreg": float(
            int(kind_nnz[2] + kind_nnz[3])
            + sum(v.size for _, v in frags.values())
            + (int(orows.size) if ovf_r else 0)),
        # raw (pre-merge) class masses + the applied merge map, as
        # JSON-able lists: the multi-chip builder unions chips' raw
        # masses into ONE global merge map and repacks divergent chips
        # with it pinned (see pin_classes / merge_class_keys)
        "key_mass": [[int(k[0]), int(k[1]), int(v)]
                     for k, v in sorted(raw_key_mass.items())],
        "class_map": [[list(k), list(v)]
                      for k, v in sorted(final_key.items())],
        # host-speed probe wall (ms) taken right before this pack; see
        # the probe comment at build_wplan entry (0 = small input,
        # probe skipped)
        "pack_probe_ms": round(probe_ms, 1),
    }
    plan = WPlan(
        n_rows=n, n_cols=csr.n_cols, nnz=csr.nnz, config=config,
        s_rows=(-(-max(csr.n_cols, 1) // VREG)) * SUB,
        streams=streams, sell=sell_segments, longs=long_groups,
        n_long=int(n_long),
        out_src=out_src,
        out_perm=out_perm.reshape(B * K_SOURCES, LANES),
        n_y2_rows=int(n_y2_rows), overflow=overflow,
        census=census, stats=stats, col_perm=col_perm, row_perm=row_perm)
    phase("pack.check")
    plan.check()
    return plan


# ---------------------------------------------------------------------------
# Multi-chip harmonization
# ---------------------------------------------------------------------------


def harmonize_wplans(plans: List[WPlan]) -> List[WPlan]:
    """Rewrite per-chip plans into ONE canonical shape signature so that
    ``shard_map`` can trace a single program over stacked arrays.

    Canonical form: for every P-class in the union, the stream holds the
    union's (segment-key -> max slice count) slices in a fixed order (pad
    slices are all-zero vregs), followed by a long-vreg tail padded to the
    max; long groups exist for every (P, nv_c) in the union, padded to the
    max row count with sentinel gather rows.  All plans come out with
    identical stream shapes, segment tuples, long-group shapes, B, n_long
    and n_y2_rows — only array *contents* differ.
    """
    # --- canonical stream signature -----------------------------------
    # Rank-matched slices: y2 assembly SUMS each slice's w8 vregs, so a
    # narrower chip slice embeds EXACTLY into a wider canonical slot with
    # trailing zero vregs.  Group slices by (class, seg_stride) (the only
    # shape-relevant features: seg_stride fixes the y2 rows per slice),
    # sort each chip's group width-descending, and take the elementwise
    # rank maximum as the canonical width ladder — the minimal ladder
    # that embeds every chip's sorted multiset.  Keying on w8 itself (the
    # previous scheme) made every chip pay FULL width for every other
    # chip's data-dependent med/rem cascade widths — measured 1.48x total
    # vregs on the 8-chip power-law dryrun vs ~1.15x here.
    #
    # Two further alignment moves, both exact because a vreg routed for
    # P_orig rounds runs unchanged in a stream with round cap P >= P_orig
    # (per-vreg win_counts mask the extra rounds; wins pad with zeros):
    #  * class COALESCING: merge a whole (P_lo, s) class into (P_hi, s)
    #    when the union ladder's pad saving beats the extra masked
    #    rounds (ROUND_EQ vreg-equivalents each, the packer's own
    #    calibration);
    #  * rank SPILL-UP: a lone wide slice (e.g. the window-floor lift
    #    firing on one chip's block in a small class) otherwise forces a
    #    full-width canonical slot on every chip — move the top rank of
    #    a low-P group into a same-stride higher-P group while that
    #    reduces pad net of round cost.
    n_chips = len(plans)
    ROUND_EQ = 0.17                    # masked-round cost, vreg-equivalents

    classes = sorted({(s.P, s.stride) for p in plans for s in p.streams})
    class_nv_total = {c: 0 for c in classes}
    for p in plans:
        for s in p.streams:
            class_nv_total[(s.P, s.stride)] += s.n_vregs

    # per-chip slice inventory: items carry their source segment so the
    # emitter can copy from the right stream wherever the slice lands
    def _inventory(plan):
        groups: Dict[Tuple[Tuple[int, int], int], List] = {}
        for seg in plan.sell:
            s = plan.streams[seg.stream]
            g = groups.setdefault(((s.P, s.stride), seg.stride), [])
            for k in range(seg.n_slices):
                g.append((seg.w8, seg, k))
        for g in groups.values():
            g.sort(key=lambda t: -t[0])     # stable: ties keep plan order
        return groups

    inv = [_inventory(p) for p in plans]     # chip -> (root, ss) -> slices
    tail_of = []                             # chip -> class -> tail vregs
    for p in plans:
        t = {}
        for si, s in enumerate(p.streams):
            sell_v = sum(seg.n_slices * seg.w8 for seg in p.sell
                         if seg.stream == si)
            t[(s.P, s.stride)] = s.n_vregs - sell_v
        tail_of.append(t)

    def _ladder(lists):
        n_max = max((len(l) for l in lists), default=0)
        widths = [0] * n_max
        for l in lists:
            for r, item in enumerate(l):
                widths[r] = max(widths[r], item[0])
        return widths

    def _pad_of(groupcfg, tailcfg):
        pad = 0
        for lists in groupcfg.values():
            widths = _ladder(lists)
            pad += sum(widths) * n_chips - sum(
                sum(it[0] for it in l) for l in lists)
        for per in tailcfg.values():
            pad += max(per) * n_chips - sum(per)
        return pad

    def _build_cfg(cmap):
        groupcfg: Dict[Tuple, List[List]] = {}
        tailcfg: Dict[Tuple[int, int], List[int]] = {}
        for d in range(n_chips):
            for (cls, ss), items in inv[d].items():
                gk = (cmap.get(cls, cls), ss)
                groupcfg.setdefault(gk, [[] for _ in range(n_chips)])
                groupcfg[gk][d] = sorted(
                    groupcfg[gk][d] + items, key=lambda t: -t[0])
            for cls, tv in tail_of[d].items():
                root = cmap.get(cls, cls)
                tailcfg.setdefault(root, [0] * n_chips)
                tailcfg[root][d] += tv
        # every group key must have one list per chip even when absent
        return groupcfg, tailcfg

    # greedy cost-weighed class coalescing
    cmap: Dict[Tuple[int, int], Tuple[int, int]] = {c: c for c in classes}
    while True:
        groupcfg, tailcfg = _build_cfg(cmap)
        pad_now = _pad_of(groupcfg, tailcfg)
        roots = sorted({cmap[c] for c in classes})
        best = None
        for lo in roots:
            for hi in roots:
                if hi == lo or hi[1] != lo[1] or hi[0] <= lo[0]:
                    continue
                trial = {c: (hi if cmap[c] == lo else cmap[c])
                         for c in classes}
                tg, tt = _build_cfg(trial)
                moved_nv = sum(class_nv_total[c] for c in classes
                               if cmap[c] == lo)
                cost = ROUND_EQ * (hi[0] - lo[0]) * moved_nv
                gain = pad_now - _pad_of(tg, tt) - cost
                if gain > 0 and (best is None or gain > best[0]):
                    best = (gain, trial)
        if best is None:
            break
        cmap = best[1]

    groupcfg, tailcfg = _build_cfg(cmap)
    roots = sorted({cmap[c] for c in classes})

    # rank spill-up: repeatedly move the widest rank of a low-P group
    # into a same-(stride, seg_stride) higher-P group while pad drops
    changed = True
    while changed:
        changed = False
        for (root, ss) in sorted(groupcfg):
            uppers = [r for r in roots
                      if r[1] == root[1] and r[0] > root[0]]
            if not uppers or not any(groupcfg[(root, ss)]):
                continue
            lists = groupcfg[(root, ss)]
            for up in uppers:
                ugk = (up, ss)
                ulists = groupcfg.get(ugk,
                                      [[] for _ in range(n_chips)])
                pad_before = (
                    sum(_ladder(lists)) * n_chips
                    - sum(sum(it[0] for it in l) for l in lists)
                    + sum(_ladder(ulists)) * n_chips
                    - sum(sum(it[0] for it in l) for l in ulists))
                new_lists = [l[1:] for l in lists]
                new_ulists = [sorted(ul + l[:1], key=lambda t: -t[0])
                              for ul, l in zip(ulists, lists)]
                pad_after = (
                    sum(_ladder(new_lists)) * n_chips
                    - sum(sum(it[0] for it in l) for l in new_lists)
                    + sum(_ladder(new_ulists)) * n_chips
                    - sum(sum(it[0] for it in l) for l in new_ulists))
                moved = [(l[0] if l else None) for l in lists]
                cost = ROUND_EQ * sum(
                    it[0] * (up[0]
                             - plans[d].streams[it[1].stream].P)
                    for d, it in enumerate(moved) if it is not None)
                if pad_before - pad_after > cost:
                    groupcfg[(root, ss)] = new_lists
                    groupcfg[ugk] = new_ulists
                    changed = True
                    break

    group_keys = sorted(groupcfg)
    rank_sig = {gk: _ladder(groupcfg[gk]) for gk in group_keys}
    long_tail = {root: max(per) for root, per in tailcfg.items()}
    for root in roots:
        long_tail.setdefault(root, 0)

    # long groups: concat a chip's same-(root, nv_c) groups (the assembly
    # sums per row, so concatenation is exact), signature = max rows
    long_sig: Dict[Tuple, int] = {}          # (root, nv_c) -> max rows
    for d, p in enumerate(plans):
        cnt: Dict[Tuple, int] = {}
        for lg in p.longs:
            s = p.streams[lg.stream]
            key = (cmap[(s.P, s.stride)], lg.idx.shape[1])
            cnt[key] = cnt.get(key, 0) + lg.idx.shape[0]
        for key, R in cnt.items():
            long_sig[key] = max(long_sig.get(key, 0), R)

    B_max = max(p.out_src.shape[0] for p in plans)
    n_long_canon = sum(long_sig.values())

    out_plans: List[WPlan] = []
    for d, p in enumerate(plans):
        new_streams: List[WStream] = []
        new_sell: List[SellSegment] = []
        new_longs: List[LongGroup] = []
        # maps for fixing out_src and long idx
        y2_map: Dict[int, int] = {}
        new_out_row = 0

        for root in roots:
            P, stride = root
            vals_parts, idx_parts, wins_parts, cnt_parts = [], [], [], []
            vreg_cursor = 0
            for gk in [g for g in group_keys if g[0] == root]:
                seg_stride = gk[1]
                rps = SUB // seg_stride          # y2 rows per slice
                widths = rank_sig[gk]
                own = groupcfg[gk][d]
                # emit canonical slices rank by rank, coalescing equal
                # canonical widths into SellSegment runs
                run = dict(w8=None, n=0, off=0, out=0)

                def _flush():
                    if run["n"]:
                        new_sell.append(SellSegment(
                            stream=len(new_streams),
                            vreg_offset=run["off"], n_slices=run["n"],
                            w8=run["w8"], out_row=run["out"],
                            stride=seg_stride))
                    run["n"] = 0

                for r, w_c in enumerate(widths):
                    if run["w8"] != w_c or not run["n"]:
                        _flush()
                        run.update(w8=w_c, off=vreg_cursor,
                                   out=new_out_row)
                    if r < len(own):
                        w8o, seg, k = own[r]
                        s_src = p.streams[seg.stream]
                        v0 = seg.vreg_offset + k * w8o
                        vals_parts.append(s_src.vals[v0 * SUB:
                                                     (v0 + w8o) * SUB])
                        idx_parts.append(s_src.idx[v0 * SUB:
                                                   (v0 + w8o) * SUB])
                        wins_parts.append(s_src.wins[v0:v0 + w8o])
                        cnt_parts.append(s_src.win_counts[v0:v0 + w8o])
                        for j in range(rps):
                            y2_map[seg.out_row + k * rps + j] = (
                                new_out_row + j)
                        padv = w_c - w8o
                    else:
                        padv = w_c
                    if padv:
                        vals_parts.append(np.zeros((padv * SUB, LANES)))
                        idx_parts.append(np.zeros((padv * SUB, LANES),
                                                  dtype=np.int32))
                        wins_parts.append(np.zeros((padv, P),
                                                   dtype=np.int32))
                        cnt_parts.append(np.ones(padv, dtype=np.int32))
                    vreg_cursor += w_c
                    new_out_row += rps
                    run["n"] += 1
                _flush()

            # long-vreg tails of every member stream, concatenated in
            # deterministic (P, stride) order, then padded to the union
            members = sorted(
                (si for si, s in enumerate(p.streams)
                 if cmap[(s.P, s.stride)] == root),
                key=lambda si: (p.streams[si].P, p.streams[si].stride))
            shifts: Dict[int, Tuple[int, int]] = {}
            for si in members:
                s = p.streams[si]
                sell_v = sum(seg.n_slices * seg.w8 for seg in p.sell
                             if seg.stream == si)
                tv = s.n_vregs - sell_v
                shifts[si] = (vreg_cursor - sell_v, s.n_vregs)
                if tv:
                    lo = sell_v * SUB
                    vals_parts.append(s.vals[lo:])
                    idx_parts.append(s.idx[lo:])
                    wins_parts.append(s.wins[sell_v:])
                    cnt_parts.append(s.win_counts[sell_v:])
                vreg_cursor += tv
            pad_tail = long_tail[root] - tailcfg.get(
                root, [0] * n_chips)[d]
            if pad_tail:
                vals_parts.append(np.zeros((pad_tail * SUB, LANES)))
                idx_parts.append(np.zeros((pad_tail * SUB, LANES),
                                          dtype=np.int32))
                wins_parts.append(np.zeros((pad_tail, P),
                                           dtype=np.int32))
                cnt_parts.append(np.ones(pad_tail, dtype=np.int32))
            nv_new = vreg_cursor + pad_tail
            if nv_new == 0:
                new_streams.append(WStream(
                    P=P, vals=np.zeros((0, LANES)),
                    idx=np.zeros((0, LANES), dtype=np.int32),
                    wins=np.zeros((0, P), dtype=np.int32),
                    win_counts=np.zeros(0, dtype=np.int32),
                    stride=stride))
                continue
            wins_cat = np.concatenate([
                w if w.shape[1] == P else
                np.pad(w, ((0, 0), (0, P - w.shape[1])))
                for w in wins_parts])
            new_streams.append(WStream(
                P=P,
                vals=np.concatenate(vals_parts),
                idx=np.concatenate(idx_parts).astype(np.int32),
                wins=wins_cat.astype(np.int32),
                win_counts=np.concatenate(cnt_parts).astype(np.int32),
                stride=stride))
            # remap long idx matrices of the member streams
            for si in members:
                shift, nv_old = shifts[si]
                for lg in p.longs:
                    if lg.stream != si:
                        continue
                    idx = lg.idx.astype(np.int64)
                    idx = np.where(idx >= nv_old, nv_new, idx + shift)
                    new_longs.append(LongGroup(
                        stream=len(new_streams) - 1,
                        idx=idx.astype(np.int32),
                        scalar_pos=lg.scalar_pos.copy()))

        # pad long groups to the canonical (root, nv_c) signature; a
        # chip's same-key groups concatenate (the assembly sums per row)
        final_longs: List[LongGroup] = []
        scalar_pad_cursor = p.n_long
        for (root, nv_c) in sorted(long_sig):
            R_max = long_sig[(root, nv_c)]
            stream_id = roots.index(root)
            nv_new = new_streams[stream_id].n_vregs
            match = [lg for lg in new_longs
                     if lg.stream == stream_id and lg.idx.shape[1] == nv_c]
            if match:
                mi = np.concatenate([m.idx for m in match])
                ms = np.concatenate([m.scalar_pos for m in match])
                R = mi.shape[0]
                idx = np.full((R_max, nv_c), nv_new, dtype=np.int32)
                idx[:R] = mi
                spos = np.zeros(R_max, dtype=np.int64)
                spos[:R] = ms
            else:
                R = 0
                idx = np.full((R_max, nv_c), nv_new, dtype=np.int32)
                spos = np.zeros(R_max, dtype=np.int64)
            # pad rows get fresh scalar positions past the real ones
            for k in range(R, R_max):
                spos[k] = scalar_pad_cursor
                scalar_pad_cursor += 1
            final_longs.append(LongGroup(stream=stream_id, idx=idx,
                                         scalar_pos=spos))

        # canonical y2 layout: slice rows then long rows then zero row
        n_long_rows = -(-n_long_canon // LONG_PACK) if n_long_canon else 0
        old_slice_rows = p.n_y2_rows - (
            (-(-p.n_long // LONG_PACK)) if p.n_long else 0)
        old_long_base = old_slice_rows
        for k in range((-(-p.n_long // LONG_PACK)) if p.n_long else 0):
            y2_map[old_long_base + k] = new_out_row + k
        n_y2_new = new_out_row + n_long_rows
        y2_map[p.n_y2_rows] = n_y2_new          # zero row

        src = p.out_src.astype(np.int64)
        new_src = np.full((B_max, K_SOURCES), n_y2_new, dtype=np.int32)
        for b in range(src.shape[0]):
            for k in range(K_SOURCES):
                new_src[b, k] = y2_map.get(int(src[b, k]), n_y2_new)
        new_perm = np.zeros((B_max * K_SOURCES, LANES), dtype=np.int8)
        new_perm[:p.out_perm.shape[0] // K_SOURCES * K_SOURCES] = 0
        # out_perm is stored (B*K, LANES) row-major by block
        B_old = p.out_src.shape[0]
        new_perm[:B_old * K_SOURCES] = p.out_perm

        out_plans.append(WPlan(
            n_rows=B_max * LANES,   # padded; callers trim per-slab
            n_cols=p.n_cols, nnz=p.nnz, config=p.config,
            s_rows=p.s_rows, streams=new_streams, sell=new_sell,
            longs=final_longs, n_long=n_long_canon,
            out_src=new_src, out_perm=new_perm, n_y2_rows=n_y2_new,
            overflow=p.overflow, census=p.census, stats=p.stats,
            col_perm=p.col_perm, row_perm=p.row_perm))
    return out_plans


# ---------------------------------------------------------------------------
# Serialization: the pack plan is a pure function of the matrix, so persist
# it (the reference repacks on every run, dasp_f64.h:486-1157).
# ---------------------------------------------------------------------------


def save_wplan(plan: WPlan, path) -> None:
    import json
    arrays = {}
    meta = dict(
        n_rows=plan.n_rows, n_cols=plan.n_cols, nnz=plan.nnz,
        s_rows=plan.s_rows, n_long=plan.n_long, n_y2_rows=plan.n_y2_rows,
        config=dataclasses.asdict(plan.config),
        census=plan.census, stats=plan.stats,
        streams=[(s.P, s.stride) for s in plan.streams],
        sell=[(g.stream, g.vreg_offset, g.n_slices, g.w8, g.out_row,
               g.stride) for g in plan.sell],
        longs=[lg.stream for lg in plan.longs],
        has_overflow=plan.overflow is not None)
    for i, s in enumerate(plan.streams):
        arrays[f"s{i}_vals"] = s.vals.astype(np.float64)
        arrays[f"s{i}_idx"] = s.idx
        arrays[f"s{i}_wins"] = s.wins
        arrays[f"s{i}_cnt"] = s.win_counts
    for i, lg in enumerate(plan.longs):
        arrays[f"l{i}_idx"] = lg.idx
        arrays[f"l{i}_pos"] = lg.scalar_pos
    arrays["out_src"] = plan.out_src
    arrays["out_perm"] = plan.out_perm
    if plan.col_perm is not None:
        arrays["col_perm"] = plan.col_perm
    sym = (plan.row_perm is not None and plan.col_perm is not None
           and (plan.row_perm is plan.col_perm
                or np.array_equal(plan.row_perm, plan.col_perm)))
    meta["sym_perm"] = sym
    if plan.row_perm is not None and not sym:
        arrays["row_perm"] = plan.row_perm      # independent row sort
    if plan.overflow is not None:
        arrays["ovf_rpt"] = plan.overflow.row_ptr
        arrays["ovf_cid"] = plan.overflow.col_idx
        arrays["ovf_val"] = plan.overflow.values
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_wplan(path) -> WPlan:
    import json
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    streams = [WStream(P=p, vals=z[f"s{i}_vals"], idx=z[f"s{i}_idx"],
                       wins=z[f"s{i}_wins"], win_counts=z[f"s{i}_cnt"],
                       stride=st)
               for i, (p, st) in enumerate(meta["streams"])]
    sell = [SellSegment(*t) for t in meta["sell"]]
    longs = [LongGroup(stream=s, idx=z[f"l{i}_idx"],
                       scalar_pos=z[f"l{i}_pos"])
             for i, s in enumerate(meta["longs"])]
    overflow = None
    if meta["has_overflow"]:
        overflow = CSRMatrix(meta["n_rows"], meta["n_cols"],
                             z["ovf_rpt"], z["ovf_cid"], z["ovf_val"])
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in meta["config"].items()}
    plan = WPlan(
        n_rows=meta["n_rows"], n_cols=meta["n_cols"], nnz=meta["nnz"],
        config=DaspConfig(**cfg), s_rows=meta["s_rows"], streams=streams,
        sell=sell, longs=longs, n_long=meta["n_long"],
        out_src=z["out_src"], out_perm=z["out_perm"],
        n_y2_rows=meta["n_y2_rows"], overflow=overflow,
        census=meta["census"], stats=meta["stats"],
        col_perm=z["col_perm"] if "col_perm" in z else None)
    if meta.get("sym_perm"):
        plan.row_perm = plan.col_perm
    elif "row_perm" in z:
        plan.row_perm = z["row_perm"]
    plan.check()
    return plan
