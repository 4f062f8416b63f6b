"""The port's T2 probe (roundcost_ab) against the tool's own Pallas kernel.

``tools/roundcost_ab.py`` runs its sweep when imported, so its kernel
``make_colsum`` and the input draws of ``bench_one`` are taken out of the
source with ``ast`` and run with the tool's constants; UNROLL is lowered
to 8, which changes only the unroll.  The kernel runs in interpret mode
(``force_tpu_interpret_mode``) at NV = 128, one grid step; the port's
wrapper runs its plain version on the CPU.

Tolerance: 2e-6 on the error scaled by max(|ref|, 1).  Both sides multiply
the same f32 words; JAX's order of the sublane sum is not fixed.
"""

import ast
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dasp_tpu_torch.probes import roundcost_ab as t2
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = 2e-6
NV = 128
SRC = importlib.util.find_spec("tools.roundcost_ab").origin
CONSTS = dict(SUB=8, LANES=128, BV=128, UNROLL=8)


def _tool_function(name, cut=None, ret=None):
    """Function ``name`` of the tool, compiled with its constants; with
    ``cut``, its body ends before the first statement that contains
    ``cut`` and returns ``ret``."""
    with open(SRC) as fh:
        tree = ast.parse(fh.read(), SRC)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    if cut:
        i = next(i for i, s in enumerate(fn.body) if cut in ast.unparse(s))
        fn.body = fn.body[:i] + ast.parse(f"return {ret}").body
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, NV=NV, **CONSTS)
    exec(compile(ast.fix_missing_locations(ast.Module([fn], [])), SRC,
                 "exec"), ns)
    return ns[name]


@pytest.mark.parametrize("P", (1, 4, 8))
@pytest.mark.parametrize("variant", t2.VARIANTS)
def test_roundcost_plain_matches_tool(variant, P):
    """T2's plain version against the tool's make_colsum(P, S, NV, variant)
    in interpret mode, on the tool's inputs at NV = 128."""
    wins, vals, idx, x2d = t2.make_inputs(P, NV)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tool_function("make_colsum")(
            P, t2.S, NV, variant)(wins.numpy(), vals.numpy(), idx.numpy(),
                                  x2d.numpy()))
    got = t2.roundcost_probe(wins, vals, idx, x2d, variant)
    assert got.shape == ref.shape == (NV, 128) and got.dtype == torch.float32
    err = np.abs(got.numpy().astype(np.float64) - ref) / np.maximum(
        np.abs(ref), 1.0)
    assert float(err.max()) <= TOL


@pytest.mark.parametrize("P", (2, 5))
@pytest.mark.parametrize("variant", t2.VARIANTS)
def test_roundcost_plain_matches_tool_at_edge_rounds(variant, P):
    """T2's plain version against the tool's kernel in interpret mode at
    P = 2, the fewest rounds with a tag, and P = 5, whose 6-word wins rows
    the kernel stages a word a thread from addresses that are not 16-byte
    aligned, on the tool's inputs at NV = 128."""
    wins, vals, idx, x2d = t2.make_inputs(P, NV)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tool_function("make_colsum")(
            P, t2.S, NV, variant)(wins.numpy(), vals.numpy(), idx.numpy(),
                                  x2d.numpy()))
    got = t2.roundcost_probe(wins, vals, idx, x2d, variant)
    assert got.shape == ref.shape == (NV, 128)
    err = np.abs(got.numpy().astype(np.float64) - ref) / np.maximum(
        np.abs(ref), 1.0)
    assert float(err.max()) <= TOL


@pytest.mark.parametrize("P", (1, 4, 32))
def test_roundcost_make_inputs_are_the_tools(P):
    """make_inputs draws what the tool's bench_one (:126-134) draws."""
    draw = _tool_function("bench_one", cut="make_colsum(",
                          ret="wins, vals, idx, x2d")
    for want, got in zip(draw(P, "cur"), t2.make_inputs(P, NV)):
        assert got.dtype == torch.from_numpy(want).dtype
        assert np.array_equal(got.numpy(), want)
