"""Device side of the port: the windowed-gather SpMV kernels (CUDA C++
under ``csrc/``, built by ``_build``), their plain PyTorch versions, and
the executor (``cuda_backend``)."""

from typing import Dict


def _counted():
    from .colsum import colsum
    from .colsum_multi import colsum_multi
    from .outgather import outgather
    from .resident import resident_loop
    return (("colsum", colsum), ("colsum_multi", colsum_multi),
            ("outgather", outgather), ("resident", resident_loop))


def kernel_launches() -> Dict[str, int]:
    """Launches of every kernel instance of the SpMV path since the counts
    were last set to 0, from the wrappers' ``launches`` (each adds one
    where it launches its kernel); the f32 instance bears the bare name."""
    return {base if d == "f32" else f"{base}_{d}": n
            for base, fn in _counted() for d, n in fn.launches.items()}


def zero_kernel_launches() -> None:
    for _, fn in _counted():
        fn.launches = dict.fromkeys(fn.launches, 0)
