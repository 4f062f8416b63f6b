"""Value slots that one K6 step or pass reads, per entry of the matrix:
``slots`` over ``nnz`` as the program counts them on its ``op.lower``
span (``ops/cuda_backend.py:table_counts``): every vreg it reads, 1,024
slots with their padding, and one slot a residue entry.  1 would be no
padding at all.  None where the program counts no slots."""

from benchmark.harness.tables import lower_counts


def read(run):
    c = lower_counts()
    if not c or not c.get("nnz") or "slots" not in c:
        return None
    return c["slots"] / c["nnz"]
