"""Device side of the port: the windowed-gather SpMV kernels (CUDA C++
under ``csrc/``, built by ``_build``), their plain PyTorch versions, and
the f32 executor (``cuda_backend``)."""
