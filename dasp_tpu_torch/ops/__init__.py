"""Device side of the port: the windowed-gather SpMV kernels (CUDA C++
under ``csrc/``, built by ``_build``), their plain PyTorch versions, and
the executor (``cuda_backend``)."""

from typing import Dict


def _counted():
    from .colsum import colsum
    from .colsum_multi import colsum_multi
    from .outgather import outgather
    from .resident import resident_loop, spmm_loop
    return (("colsum", colsum), ("colsum_multi", colsum_multi),
            ("outgather", outgather), ("resident", resident_loop),
            ("resident", spmm_loop))


def kernel_launches() -> Dict[str, int]:
    """Launches of every kernel instance of the SpMV path since the counts
    were last set to 0, from the wrappers' ``launches`` (each adds one
    where it launches its kernel), by instance: the f32 one bears the bare
    name ("resident", "resident_bf16", "resident_kv8",
    "resident_f64_kv8")."""
    return {"_".join([base] + [k for k in key.split("_") if k != "f32"]): n
            for base, fn in _counted() for key, n in fn.launches.items()}


def zero_kernel_launches() -> None:
    for _, fn in _counted():
        fn.launches = dict.fromkeys(fn.launches, 0)
