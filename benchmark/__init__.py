"""The benchmark of the PyTorch and CUDA port (``dasp_tpu_torch``): one
cell (a configuration under a traffic mix) per run, ``run.py``."""
