"""Share of the matrix's entries, in percent, that the pack leaves to the
COO residue (``plan.overflow``), which K6 sums by its trees: the
program's ``residue_nnz`` over ``nnz`` on its ``op.lower`` span
(``ops/cuda_backend.py:table_counts``).  None where the program counts
no residue."""

from benchmark.harness.tables import lower_counts


def read(run):
    c = lower_counts()
    if not c or not c.get("nnz") or "residue_nnz" not in c:
        return None
    return 100.0 * c["residue_nnz"] / c["nnz"]
