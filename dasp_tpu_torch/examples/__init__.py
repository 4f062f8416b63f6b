"""The two consumers that keep a whole iteration on the device: a
conjugate-gradient solver (``cg_solver``) and PageRank (``pagerank``),
the ports of ``examples/cg_solver.py`` and ``examples/pagerank.py``."""
