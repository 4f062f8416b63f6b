"""H100 counterparts of the TPU probes under ``tools/`` that reach a Pallas
kernel: ``gather_bench`` (T1, the rates of a stream, a shared-memory
gather and an L2 gather), ``roundcost_ab`` (T2, what a colsum window round
costs), ``stream_bench2`` (T3, the colsum's bandwidth ladder) and
``resident_probe`` (T4, the L2 residency of a chained loop)."""
