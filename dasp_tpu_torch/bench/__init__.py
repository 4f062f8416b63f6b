"""The port's bench: the calibrated SuiteSparse stand-ins (``suite.py``,
``fem.py``), the timing protocol on CUDA graphs and events
(``harness.py``), the per-arm check (``check.py``), the cuSPARSE baseline
(``baselines.py``), the reference's CSV schema (``record.py``) and the
CLI, ``python -m dasp_tpu_torch.bench`` (``__main__.py``)."""

from .harness import (BenchResult, bench_spmm, bench_spmv,  # noqa: F401
                      copy_rate_gbs, data_models, time_fn)
from .baselines import CuSparseBaseline, DenseBaseline  # noqa: F401
from .suite import SUITE, build_suite, geomean  # noqa: F401
from .record import append_record, record_from  # noqa: F401
