"""Column relabeling for window locality (runtime x-permutation).

No-locality matrices (power-law graphs) degrade because a vreg's 128
elements read x words scattered over many 1024-aligned windows, inflating
the per-vreg round count P (docs/DESIGN.md §3).  Relabeling columns cannot
change WHICH x words a vreg needs, but it changes WHERE they live: placing
hub columns (high degree) densely at the front and the low-degree tail in
first-touch order of the row-block traversal collapses most vregs' reads
into few windows.  Measured on wikitalk-like: 23% lower P-weighted vector
cost (tools/relabel_experiment.py).

The permutation is applied to x once per operator call on the host
(``prep_x``), outside the kernel hot loop — the same contract as the
reference's row permutation ``order_rid`` (dasp_f64.h:959-976), which
permutes Y and is undone outside the timed kernel (main_f64.cu:3-16).
y is untouched: only columns are relabeled, rows keep original order.
"""

from __future__ import annotations

import numpy as np

from .sparse import CSRMatrix


def _spread(blk: np.ndarray, cols: np.ndarray, n_cols: int) -> float:
    W = (n_cols >> 10) + 1
    key = blk * W + (cols >> 10)
    B = int(blk.max()) + 1 if blk.size else 1
    if B * W <= (1 << 28):
        seen = np.zeros(B * W, dtype=bool)
        seen[key] = True
        n_pairs = int(np.count_nonzero(seen))
    else:
        n_pairs = np.unique(key).size
    counts = np.bincount(blk)
    counts = counts[counts > 0]
    min_pairs = np.maximum(1, -(-counts // 1024)).sum()
    return float(n_pairs / max(min_pairs, 1))


def window_spread(csr: CSRMatrix, col_perm=None,
                  symmetric: bool = False) -> float:
    """Locality proxy: distinct 1024-column windows touched per 128-row
    block, relative to the minimum the block's element count could need.

    ~1 for banded/FEM matrices (reads already cluster; relabeling can only
    scramble them), >>1 for scattered/power-law columns (each block reads
    from many windows; first-touch relabeling collapses them).  With
    ``col_perm``, measures the spread the relabeled matrix WOULD have,
    without materializing it (``symmetric`` also permutes the rows — the
    square-matrix mode that keeps x and y in one index space).
    """
    if csr.nnz == 0 or csr.n_rows == 0:
        return 1.0
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths)
    cols = csr.col_idx.astype(np.int64)
    if col_perm is not None:
        cols = col_perm[cols]
        if symmetric:
            rows = col_perm[rows]
    return _spread(rows >> 7, cols, csr.n_cols)


def _sample_elements(csr: CSRMatrix, sample: int):
    """(row_ids, col_ids) of an evenly strided element subsample, computed
    WITHOUT materializing the nnz-sized row-id expansion first (on a 69
    Mnnz input that expansion is 550 MB of traffic for a 4M-element
    decision sample; searchsorted over the sampled positions is O(sample
    * log n) instead)."""
    if csr.nnz > sample:
        step = -(-csr.nnz // sample)     # ceil: keep the sample <= sample
                                         # (floor gave step=1 — i.e. ALL
                                         # elements — for nnz < 2*sample)
        idx = np.arange(0, csr.nnz, step, dtype=np.int64)
        rows = np.searchsorted(csr.row_ptr, idx, side="right") - 1
        return rows.astype(np.int64), csr.col_idx[idx].astype(np.int64)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths)
    return rows, csr.col_idx.astype(np.int64)


def _distinct_pairs(blk: np.ndarray, wins: np.ndarray, W: int) -> int:
    key = blk * W + wins
    B = int(blk.max()) + 1 if blk.size else 1
    if B * W <= (1 << 28):
        seen = np.zeros(B * W, dtype=bool)
        seen[key] = True
        return int(np.count_nonzero(seen))
    return np.unique(key).size


def choose_relabel(csr: CSRMatrix, hub_min_deg: int = 4,
                   symmetric: bool = False, sample: int = 4_000_000):
    """The "auto" policy: return a column perm iff first-touch relabeling
    would reduce the window spread (measured A/B on v5e: spread down =>
    +10-16% GF on power-law graphs; spread up => large regressions on
    banded/FEM, so never relabel those).

    Only the before/after comparison matters and both sides share the
    same per-block element counts, so the denominator cancels: compare
    distinct (block, window) pair counts directly, on a shared element
    subsample for large matrices (the decision needs one bit)."""
    if csr.nnz == 0:
        return None
    rows, cols = _sample_elements(csr, sample)
    W = (csr.n_cols >> 10) + 1
    before = _distinct_pairs(rows >> 7, cols >> 10, W)
    # Banded/FEM early-out: when the pre-relabel spread is already at the
    # per-block element-count minimum, relabeling can only scramble (the
    # auto gate would return None anyway) — skip building the permutation
    # and the "after" measurement entirely.  ``min_pairs`` is computed
    # from the SAME sampled elements as ``before`` (per-block sampled
    # counts), so both sides of the comparison see the same subsample.
    # Caveat (documented, accepted): for symmetric=True a row permutation
    # re-blocks rows, so the per-current-block bound is not a strict
    # lower bound over all permutations — but when the current blocking
    # is already within 5% of ITS minimum, the measured relabel gain is
    # nil on every suite arm, and the gate is what makes banded/FEM
    # square matrices decide in ~0.05s instead of paying first-touch.
    cnt = np.bincount(rows >> 7)
    cnt = cnt[cnt > 0]
    min_pairs = int(np.maximum(1, -(-cnt // 1024)).sum()) if cnt.size else 1
    if before <= 1.05 * min_pairs:
        return None
    perm = first_touch_perm(csr, hub_min_deg)
    prows = perm[rows] if symmetric else rows
    after = _distinct_pairs(prows >> 7, perm[cols] >> 10, W)
    # First-touch degenerates to a degree sort when nearly every column
    # clears the hub threshold (uniform-degree FEM/mesh matrices) — for
    # those, try a BFS level order (bfs_perm) and keep whichever proxy
    # wins.  Only when first-touch did not already win big: the BFS
    # costs an O(nnz) sweep.
    if symmetric and after > 0.7 * before:
        bperm = bfs_perm(csr)
        if bperm is not None:
            bafter = _distinct_pairs(bperm[rows] >> 7,
                                     bperm[cols] >> 10, W)
            if bafter < after:
                perm, after = bperm, bafter
    return perm if after <= 0.98 * before else None


def bfs_perm(csr: CSRMatrix, max_seeds: int = 1024):
    """Breadth-first (Cuthill-McKee-style) SYMMETRIC ordering for
    mesh-like square matrices.

    First-touch relabeling cannot help matrices whose columns are almost
    all above the hub threshold (uniform-degree FEM: the "hub" prefix
    degenerates to a degree sort, which scrambles mesh adjacency).  A BFS
    level order over the pattern graph puts topological neighbors in
    nearby labels, collapsing each 128-row block's reads into few
    1024-column windows — the classic bandwidth-reduction effect.
    Vectorized frontier sweep: O(nnz) total, each level one numpy pass.
    Within a level, nodes sort by the rank of their first parent in the
    previous level (the Cuthill-McKee grouping): adjacent subtrees stay
    adjacent, which measured 2.8x lower window spread than the degree
    sort on the assembled P1 mesh (3.6 vs 10.2, proxy units).

    Returns ``newpos`` (old id -> new id), or None for non-square
    matrices or when the graph fragments into more than ``max_seeds``
    nontrivial components (BFS locality means nothing there)."""
    if csr.n_rows != csr.n_cols or csr.nnz == 0:
        return None
    n = csr.n_rows
    deg = csr.row_lengths.astype(np.int64)
    # Pre-gate: BFS locality needs a mostly SYMMETRIC pattern (meshes,
    # undirected graphs).  Sample edges and check their transposes exist
    # — directed power-law dumps fail here in microseconds instead of
    # fragmenting through max_seeds components.
    nz = np.flatnonzero(deg)
    if nz.size == 0:
        return None
    samp = np.linspace(0, csr.nnz - 1, num=min(512, csr.nnz),
                       dtype=np.int64)
    s_rows = np.searchsorted(csr.row_ptr, samp, side="right") - 1
    s_cols = csr.col_idx[samp].astype(np.int64)
    hits = 0
    for r, c in zip(s_rows, s_cols):
        lo, hi = csr.row_ptr[c], csr.row_ptr[c + 1]
        # membership scan (columns within a row are NOT guaranteed sorted)
        hits += bool(np.any(csr.col_idx[lo:hi] == r))
    if hits < 0.5 * samp.size:
        return None
    visited = deg == 0                    # isolated rows: appended last
    order = np.empty(n, dtype=np.int64)
    pos = 0
    rpt = csr.row_ptr
    # seed scan cursor over ascending-degree order: total O(n) across
    # all components instead of O(n) per component
    seed_scan = nz[np.argsort(deg[nz], kind="stable")]
    cursor = 0
    for _ in range(max_seeds):
        while cursor < seed_scan.size and visited[seed_scan[cursor]]:
            cursor += 1
        if cursor >= seed_scan.size:
            break
        seed = seed_scan[cursor]
        visited[seed] = True
        order[pos] = seed
        pos += 1
        frontier = np.array([seed], dtype=np.int64)
        rank = np.zeros(n, dtype=np.int64)    # position in previous level
        while frontier.size:
            starts = rpt[frontier]
            counts = (rpt[frontier + 1] - starts).astype(np.int64)
            total = int(counts.sum())
            if total == 0:
                break
            flat = np.repeat(starts - np.concatenate(
                ([0], np.cumsum(counts[:-1]))), counts) + np.arange(total)
            nb_all = csr.col_idx[flat].astype(np.int64)
            parent = np.repeat(frontier, counts)
            new = ~visited[nb_all]
            nb, first = np.unique(nb_all[new], return_index=True)
            if nb.size == 0:
                break
            o = np.argsort(rank[parent[new]][first], kind="stable")
            nb = nb[o]
            visited[nb] = True
            order[pos:pos + nb.size] = nb
            rank[nb] = np.arange(nb.size)
            pos += nb.size
            frontier = nb
    else:
        return None                       # too fragmented for BFS to help
    if pos < n:
        # isolated (zero-degree) rows keep original relative order
        rest = np.flatnonzero(deg == 0)
        order[pos:pos + rest.size] = rest
        pos += rest.size
    assert pos == n
    newpos = np.empty(n, dtype=np.int64)
    newpos[order] = np.arange(n)
    return newpos


def first_touch_perm(csr: CSRMatrix, hub_min_deg: int = 4) -> np.ndarray:
    """Return ``newpos`` (old column id -> new column id).

    Columns with degree >= hub_min_deg go first, in descending-degree
    order (popular columns cluster into the leading windows, where the
    router's cell-sharing makes them broadcast for free).  Tail columns
    follow in first-touch order of the element traversal — consecutive
    row blocks touch consecutive tail labels, so a block's tail reads
    land in few windows.  Untouched (degree-0) columns go last.
    """
    nat = _native_perm()
    if nat is not None and csr.nnz:
        newpos = nat.first_touch(csr.col_idx, csr.n_cols, hub_min_deg)
        if newpos is not None:
            return newpos
    deg = np.bincount(csr.col_idx, minlength=csr.n_cols)
    hubs = np.flatnonzero(deg >= hub_min_deg)
    hubs = hubs[np.argsort(-deg[hubs], kind="stable")]
    is_hub = np.zeros(csr.n_cols, dtype=bool)
    is_hub[hubs] = True
    # First-touch position per column via one reversed scatter (duplicate
    # indices: the LAST write wins, so feeding the traversal reversed
    # leaves each column's FIRST occurrence) — replaces an np.unique sort
    # over the nnz-sized tail sequence (a 69M-element sort on
    # soc-LiveJournal1-scale inputs) with an O(nnz) pass plus an argsort
    # over columns only.  Masking preserved relative order, so first-touch
    # order within the tail == first-touch order in the full traversal.
    first_pos = np.empty(csr.n_cols, dtype=np.int64)
    first_pos[csr.col_idx[::-1]] = np.arange(csr.nnz - 1, -1, -1,
                                             dtype=np.int64)
    touched_tail = (deg > 0) & ~is_hub
    tail = np.flatnonzero(touched_tail)
    tail = tail[np.argsort(first_pos[tail], kind="stable")]
    untouched = np.flatnonzero((deg == 0) & ~is_hub)
    newpos = np.empty(csr.n_cols, dtype=np.int64)
    order = np.concatenate([hubs, tail, untouched])
    newpos[order] = np.arange(csr.n_cols)
    return newpos


def row_sort_perm(csr: CSRMatrix):
    """``newpos`` (old row id -> new row id) grouping rows by length
    class: stable descending-length order, the TPU analog of the
    reference's ``order_rid`` regrouping (``dasp_f64.h:959-976``).
    Long rows lead, then mediums by length, shorts, zero rows last —
    every 128-row SELL block sees near-uniform lengths, so the adaptive
    width fits all rows and the spill mass collapses.  Returns None when
    rows are already length-ordered."""
    lens = csr.row_lengths
    order = np.argsort(-lens.astype(np.int64), kind="stable")
    if np.array_equal(order, np.arange(csr.n_rows)):
        return None
    newpos = np.empty(csr.n_rows, dtype=np.int64)
    newpos[order] = np.arange(csr.n_rows)
    return newpos


def choose_row_sort(csr: CSRMatrix, block_longest: int = 256,
                    save_min: float = 0.10, spread_slack: float = 1.3,
                    sample: int = 4_000_000):
    """The row_sort="auto" policy: apply the length grouping when
    (a) a quantized-SELL-width model predicts at least ``save_min`` fill
    saving from uniform-length blocks, and (b) the sorted order does not
    scramble window locality (measured directly: the (block, window)
    pair count after sorting may grow at most ``spread_slack``x).
    Banded matrices fail (b) — their locality correlates with row index;
    popularity-localized graphs (webbase: hub columns) pass — their
    locality is row-invariant."""
    n = csr.n_rows
    if n < 8 * 128 or csr.nnz == 0:
        return None
    lens = np.minimum(csr.row_lengths.astype(np.int64), block_longest - 1)

    def cost(v):
        nb = (v.size // 128) * 128
        if nb == 0:
            return 1.0
        mx = v[:nb].reshape(-1, 128).max(axis=1)
        q = np.exp2(np.ceil(np.log2(np.maximum(mx, 1))))
        return float(q.sum())
    c_now = cost(lens)
    c_sorted = cost(np.sort(lens)[::-1])
    if c_sorted > (1.0 - save_min) * c_now:
        return None
    perm = row_sort_perm(csr)
    if perm is None:
        return None
    rows, cols = _sample_elements(csr, sample)
    W = (csr.n_cols >> 10) + 1
    sp_now = _distinct_pairs(rows >> 7, cols >> 10, W)
    sp_sorted = _distinct_pairs(perm[rows] >> 7, cols >> 10, W)
    if sp_sorted > spread_slack * sp_now:
        return None
    return perm


def apply_row_perm(csr: CSRMatrix, newpos: np.ndarray) -> CSRMatrix:
    """Permute ROWS only (columns untouched): new row ``newpos[r]`` is
    old row ``r``.  One flat gather — column order within rows is
    preserved, so no re-sort is needed."""
    n = csr.n_rows
    order = np.empty(n, dtype=np.int64)
    order[newpos] = np.arange(n)
    lens = csr.row_lengths.astype(np.int64)
    counts = lens[order]
    new_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ptr[1:])
    total = int(new_ptr[-1])
    starts = csr.row_ptr[order].astype(np.int64)
    flat = np.repeat(starts - new_ptr[:-1], counts) + np.arange(total)
    return CSRMatrix(n, csr.n_cols, new_ptr,
                     csr.col_idx[flat], csr.values[flat])


def _rowcol_order(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                  n_cols: int) -> np.ndarray:
    """argsort by (row, col) — fused into one int64 key when it fits
    (half the cost of a 2-key lexsort on multi-Mnnz inputs)."""
    if n_rows * n_cols < (1 << 62):
        # kind="stable" selects numpy's O(n) radix sort for ints
        # (measured 3.0s vs 4.0s introsort on 18.5M keys)
        return np.argsort(rows * np.int64(n_cols) + cols, kind="stable")
    return np.lexsort((cols, rows))


def _native_perm():
    try:
        from .io import native
        return native if native.available() else None
    except Exception:
        return None


def apply_col_perm(csr: CSRMatrix, newpos: np.ndarray) -> CSRMatrix:
    """Relabel columns by ``newpos`` and re-sort columns within each row
    (the packer's usual CSR ordering contract).  Native (OpenMP, per-row
    sorts) when libdasp_host is available; numpy argsort otherwise."""
    nat = _native_perm()
    if nat is not None and csr.nnz:
        res = nat.col_perm(csr.row_ptr, csr.col_idx, csr.values, newpos)
        if res is not None:
            new_c, new_v = res
            return CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr.copy(),
                             new_c.astype(csr.col_idx.dtype, copy=False),
                             new_v.astype(csr.values.dtype, copy=False))
    new_cid = newpos[csr.col_idx]
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths)
    o = _rowcol_order(rows, new_cid, csr.n_rows, csr.n_cols)
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr.copy(),
                     new_cid[o].astype(csr.col_idx.dtype),
                     csr.values[o].copy())


def apply_sym_perm(csr: CSRMatrix, newpos: np.ndarray) -> CSRMatrix:
    """Symmetric permutation of a square matrix: A' = P A P^T (rows and
    columns relabeled by the SAME ``newpos``).  The operator then works in
    one permuted index space end to end — on-device iterative loops
    (CG, PageRank) can feed y straight back into x, and only the entry
    vector is encoded / the exit vector decoded, on the host.

    Native path (libdasp_host.dasp_sym_perm: bucket-by-destination-row
    copy + per-row sorts, OpenMP) replaces the 18 Mnnz numpy argsort that
    dominated pack time; numpy is the portable fallback."""
    assert csr.n_rows == csr.n_cols, "symmetric perm needs a square matrix"
    nat = _native_perm()
    if nat is not None and csr.nnz:
        res = nat.sym_perm(csr.row_ptr, csr.col_idx, csr.values, newpos)
        if res is not None:
            row_ptr, new_c, new_v = res
            return CSRMatrix(csr.n_rows, csr.n_cols, row_ptr,
                             new_c.astype(csr.col_idx.dtype, copy=False),
                             new_v.astype(csr.values.dtype, copy=False))
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths)
    new_r = newpos[rows]
    new_c = newpos[csr.col_idx]
    o = _rowcol_order(new_r, new_c, csr.n_rows, csr.n_cols)
    lens_new = np.zeros(csr.n_rows, dtype=np.int64)
    lens_new[newpos] = csr.row_lengths
    row_ptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
    np.cumsum(lens_new, out=row_ptr[1:])
    return CSRMatrix(csr.n_rows, csr.n_cols, row_ptr,
                     new_c[o].astype(csr.col_idx.dtype),
                     csr.values[o].copy())


def permute_x(x: np.ndarray, newpos: np.ndarray, out: np.ndarray) -> None:
    """Scatter x into relabeled positions: ``out[newpos[c]] = x[c]``.
    ``out`` may be longer than x (padding stays untouched)."""
    out[newpos] = np.asarray(x)[: newpos.size]
