"""H100 counterparts of the TPU probes under ``tools/`` that reach a Pallas
kernel: ``resident_probe`` (T4, the L2 residency of a chained loop)."""
