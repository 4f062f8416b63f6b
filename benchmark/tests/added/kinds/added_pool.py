"""A request kind added as a file of its own: each request is one SpMV,
``op(x)`` (encode, one K6 step, read back), on the next of a pool of
``pool`` vectors drawn from the seed, as a client that sends a vector and
waits for its y.  A seeded reservoir of ``checked`` requests keeps its y
for the check; the control is the reference's product one precision
lower on every vector of the pool."""

import time

import numpy as np

from benchmark.harness import drive
from benchmark.reference.csr import scaled_error
from benchmark.reference.lower import product_below


class Pool(drive.Kind):
    spmvs_per_unit = 1

    def __init__(self, op, a, p, rng):
        super().__init__()
        self.op, self.checked = op, int(p["checked"])
        dt = np.float64 if op.dtype == "f64" else np.float32
        self.xs = rng.standard_normal((int(p["pool"]), a.n_cols)).astype(dt)
        self.pick = np.random.default_rng(rng.integers(1 << 62))
        self.kept: list = []             # (pool index, y) of checked requests
        self.count = 0
        self.x2d = op._prep_x(self.xs[0])
        op(self.xs[0])                   # warm-up

    def unit(self):
        k = self.count % len(self.xs)
        t = time.perf_counter()
        y = self.op(self.xs[k])
        self.request_s.append(time.perf_counter() - t)
        if self.count < self.checked:
            self.kept.append((k, y))
        else:
            j = int(self.pick.integers(self.count + 1))
            if j < self.checked:
                self.kept[j] = (k, y)
        self.count += 1

    def alone(self):
        return (lambda: self.op.device_call(self.x2d)), 1, 1

    def judge(self, a, limits):
        err = max((scaled_error(a, self.xs[k], y) for k, y in self.kept),
                  default=float("inf"))
        return {"y_err": (err, limits["y_err"])}

    def control(self, a, below, device):
        self.kept = [(k, product_below(a, x, below))
                     for k, x in enumerate(self.xs)]


KIND = Pool
