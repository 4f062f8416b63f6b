from .mmio import MatrixMarketError, load_matrix, read_mtx, write_mtx  # noqa: F401
