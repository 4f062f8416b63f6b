"""What the host pack's per-layer metrics read from the program's own
counts of its lowered tables: the counts on the ``op.lower`` child of the
last main ``op.setup`` span (``dasp_tpu_torch/ops/cuda_backend.py:
table_counts``, counted once at set-up).  None where the program records
no such span or counts nothing on it, and never raises for that.
"""

from __future__ import annotations

from typing import Dict, Optional

from .spans import _children, _records


def lower_counts() -> Optional[Dict[str, int]]:
    recs = _records()
    if not recs:
        return None
    lowering = {r.id for r in recs if r.name == "op.lower"}
    roots = [r for r in recs if r.name == "op.setup"
             and r.parent not in lowering]
    if not roots:
        return None
    kid = _children(recs, {roots[-1].id}).get(roots[-1].id, {}).get(
        "op.lower")
    return None if kid is None or not kid.counts else dict(kid.counts)
