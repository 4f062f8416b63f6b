"""PageRank with dasp_tpu_torch -- the canonical power-law-graph SpMV
consumer (the port of ``examples/pagerank.py``).

Power iteration r <- d * A^T_colnorm r + (1-d)/n, with the whole loop on
the device: the iteration count is fixed, so on a card the loop is captured
once in a CUDA graph per (damping, iters) and one call is one replay, with
no host round trip.  Exercises exactly the short-row / long-row mix the
wikitalk-like benchmark measures.

Usage: python -m dasp_tpu_torch.examples.pagerank [n] [device]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import DaspConfig, SpMVOperator, from_coo
from ..ops.cuda_backend import _to_host
from ..utils import graphed
from ._common import matvec_into, require_shared_space, x_table


def build_transition(n: int, rng):
    """Column-normalized transposed adjacency of a power-law digraph
    (rows = destinations): r_new[dst] = sum_src P[dst,src] r[src]."""
    out_deg = np.minimum(rng.zipf(1.9, size=n), n // 2)
    src = np.repeat(np.arange(n), out_deg)
    dst = (np.minimum(rng.zipf(1.7, size=src.size), n) - 1).astype(np.int32)
    vals = 1.0 / np.repeat(out_deg.astype(np.float64), out_deg)
    return from_coo(n, n, dst, src.astype(np.int32), vals,
                    sum_duplicates=True)


def _make_run(op, damping: float, iters: int):
    """run() -> the ranks after ``iters`` iterations, a device tensor in
    the operator's internal index space."""
    n = op.n_rows
    teleport = (1.0 - damping) / n
    matvec = matvec_into(op, x_table(op))
    out = torch.empty(n, dtype=torch.float32, device=op.device)

    def loop() -> None:
        r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=op.device)
        for _ in range(iters):
            r = damping * matvec(r) + teleport
            # dangling mass redistributes uniformly (columns with no
            # outlinks contribute nothing through A; renormalize)
            r = r / r.sum()
        out.copy_(matvec(r) * damping + teleport)

    step = graphed(loop) if op.device.type == "cuda" else loop

    def run() -> torch.Tensor:
        step()
        return out
    return run


def pagerank(op, damping: float = 0.85, iters: int = 50) -> np.ndarray:
    """The ranks in original node order.  The loop feeds y straight back
    into x, so the operator must carry ONE shared x/y index space (pack
    with row_sort="off")."""
    require_shared_space(op, "pagerank()")
    # cache the loop (on a card: its graph) per (damping, iters), on the
    # operator, as the reference caches its jit
    cache = op.__dict__.setdefault("_pagerank_runs", {})
    if (damping, iters) not in cache:
        cache[damping, iters] = _make_run(op, damping, iters)
    # the loop runs in the operator's internal index space; decode to
    # original node order only at the exit
    return op.perm_out(_to_host(cache[damping, iters]()))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 100_000
    device = argv[1] if len(argv) > 1 else "cuda"
    rng = np.random.default_rng(0)
    csr = build_transition(n, rng)
    print(f"graph: {n} nodes, {csr.nnz} edges")
    t0 = time.time()
    # on-device iteration feeds y back into x: keep one shared index
    # space (no independent row grouping)
    op = SpMVOperator(csr, dtype="f32", config=DaspConfig(row_sort="off"),
                      device=device, force_streamed=True)
    print(f"pack+lower+upload setup: {time.time() - t0:.1f}s")
    t0 = time.time()
    pagerank(op)                           # builds the kernels, captures
    print(f"first call (kernel build, capture): {time.time() - t0:.2f}s")
    t0 = time.time()
    r = pagerank(op)
    dt = time.time() - t0
    print(f"50 iterations in {dt:.4f}s ({dt / 50 * 1e3:.4f} ms/iter)")
    top = np.argsort(-r)[:5]
    print("top-5 nodes:", list(zip(top.tolist(), np.round(r[top], 6))))
    # golden check against host power iteration
    rh = np.full(n, 1.0 / n)
    for _ in range(50):
        rh = 0.85 * csr.spmv(rh) + 0.15 / n
        rh = rh / rh.sum()
    rh = 0.85 * csr.spmv(rh) + 0.15 / n
    err = np.abs(r - rh).max() / np.abs(rh).max()
    print(f"vs host power iteration: rel err {err:.2e}")
    return 0 if err < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
