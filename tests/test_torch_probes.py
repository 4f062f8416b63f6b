"""The port's T1 (gather_bench) and T3 (stream_bench2) probes against the
tools' own Pallas kernels, and the checks every probe wrapper makes.

On the CPU the wrappers run their plain PyTorch versions; the tools'
kernels run in interpret mode (``force_tpu_interpret_mode``).  The tools
run their sweeps when imported (stream_bench2) or keep their kernel bodies
inside ``main`` (gather_bench), so the kernels, bodies and input draws are
taken out of the sources with ``ast`` and run with the tools' constants;
UNROLL is lowered to 8, which changes only the unroll.  The CUDA kernels
are held against the plain versions on the card by ``chip_smoke.py``.

Tolerance: 2e-6 on the error scaled by max(|ref|, 1).  Both sides multiply
the same f32 words; JAX's order of the sublane sum is not fixed.  Against
K1's plain version (``colsum_plain``) the probes' plain versions agree bit
for bit where they compute K1's function.
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

import chip_smoke
from dasp_tpu_torch.ops.colsum import colsum_plain
from dasp_tpu_torch.probes import _colsum_probe
from dasp_tpu_torch.probes import gather_bench as t1
from dasp_tpu_torch.probes import resident_probe as t4
from dasp_tpu_torch.probes import roundcost_ab as t2
from dasp_tpu_torch.probes import stream_bench2 as t3
from tools import gather_bench as tool_t1
from dasp_tpu_torch.io.build import ensure_built

torch.set_num_threads(1)
# native/libdasp_host.so, built whole before any test of either package
# loads it: every xdist worker imports every test module first
ensure_built()
TOL = 2e-6
NV = 128                    # one TPU grid step of BV = 128 vregs
T3_SRC = importlib.util.find_spec("tools.stream_bench2").origin


def _scaled_err(ours, ref):
    ref = np.asarray(ref, dtype=np.float64)
    ours = np.asarray(ours, dtype=np.float64)
    return float((np.abs(ours - ref) / np.maximum(np.abs(ref), 1.0)).max())


def _tree(path):
    with open(path) as fh:
        return ast.parse(fh.read(), path)


def _function(tree, name):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _exec(nodes, path, **names):
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, **names)
    exec(compile(ast.fix_missing_locations(ast.Module(nodes, [])), path,
                 "exec"), ns)
    return ns


@pytest.mark.parametrize("body", t1.BODIES)
def test_gather_plain_matches_tool(body):
    """T1's plain version against the tool's pallas_stream_op on the
    bodies of its main (:76, :81-82, :87-88), at R = 2048."""
    main = _function(_tree(tool_t1.__file__), "main")
    calls = sorted((n for n in ast.walk(main) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "pallas_stream_op"),
                   key=lambda n: n.lineno)
    assert len(calls) == len(t1.BODIES)
    fn = eval(ast.unparse(calls[t1.BODIES.index(body)].args[0]),
              {"jnp": jnp})
    inp = t1.make_inputs(rows=t1.B)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(tool_t1.pallas_stream_op(fn)(
            inp[body].numpy(), inp["xw"].numpy()))
    got = t1.gather_probe(inp[body], inp["xw"], body)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _scaled_err(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("body", t1.BODIES)
def test_gather_plain_matches_tool_at_three_blocks(body):
    """T1's plain version against the tool's pallas_stream_op at R = 3 x
    2048, three grid steps of the tool, where the kernel's sublane blocks
    take unequal shares of the stream's chunks."""
    main = _function(_tree(tool_t1.__file__), "main")
    calls = sorted((n for n in ast.walk(main) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "pallas_stream_op"),
                   key=lambda n: n.lineno)
    fn = eval(ast.unparse(calls[t1.BODIES.index(body)].args[0]),
              {"jnp": jnp})
    inp = t1.make_inputs(rows=3 * t1.B, seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(tool_t1.pallas_stream_op(fn)(
            inp[body].numpy(), inp["xw"].numpy()))
    got = t1.gather_probe(inp[body], inp["xw"], body)
    assert got.shape == ref.shape == (3 * t1.B, 128)
    assert _scaled_err(got.numpy(), ref) <= TOL


def test_gather_make_inputs_are_the_tools(monkeypatch):
    """make_inputs draws what the tool's main("all") feeds its kernels
    (its timing replaced by a recorder), and xla_take is its flat take."""
    seen = []
    monkeypatch.setattr(tool_t1, "timed_loop", lambda op, idx, xw: seen.append(
        (np.asarray(idx), np.asarray(xw))) or 1.0)
    monkeypatch.setattr(tool_t1, "report", lambda *a: None)
    tool_t1.main("all")
    inp = t1.make_inputs()
    assert len(seen) == len(t1.WHICH)
    for body, (idx, xw) in zip(t1.WHICH, seen):
        assert np.array_equal(inp[body].numpy(), idx), body
        assert np.array_equal(inp["xw"].numpy(), xw)
    idx = inp["xla_take"][:64]
    assert torch.equal(t1.xla_take(idx.long(), inp["xw"]),
                       torch.from_numpy(np.array(jnp.take(
                           jnp.asarray(xw).ravel(), idx.numpy(),
                           mode="clip"))))


def _tool_t3_make(nv=NV):
    return _exec([_function(_tree(T3_SRC), "make")], T3_SRC, LANES=128,
                 SUB=8, NV=nv, BV=128, UNROLL=8, S=t3.S)["make"]


@pytest.mark.parametrize("step", [tag for tag, *_ in t3.LADDER])
def test_stream_plain_matches_tool(step):
    """T3's plain version against the tool's make(variant, P, stride) in
    interpret mode, every ladder step, at NV = 128."""
    _, variant, P, stride, _ = next(s for s in t3.LADDER if s[0] == step)
    vals, x2d, steps = t3.make_inputs(NV)
    wins, idx = steps[step[0]]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tool_t3_make()(variant, P, stride)(
            wins.numpy(), vals.numpy(), idx.numpy(), x2d.numpy()))
    got = t3.stream_probe(wins, vals, idx, x2d, variant, stride)
    assert got.shape == ref.shape == (NV * 8 // stride, 128)
    assert _scaled_err(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("step", [tag for tag, *_ in t3.LADDER])
def test_stream_plain_matches_tool_at_three_grid_steps(step):
    """T3's plain version against the tool's make in interpret mode at
    NV = 3 x 128 (three grid steps of the tool), a stream that is no
    multiple of the kernel's persistent grid."""
    _, variant, P, stride, _ = next(s for s in t3.LADDER if s[0] == step)
    vals, x2d, steps = t3.make_inputs(3 * NV, seed=3)
    wins, idx = steps[step[0]]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tool_t3_make(3 * NV)(variant, P, stride)(
            wins.numpy(), vals.numpy(), idx.numpy(), x2d.numpy()))
    got = t3.stream_probe(wins, vals, idx, x2d, variant, stride)
    assert got.shape == ref.shape == (3 * NV * 8 // stride, 128)
    assert _scaled_err(got.numpy(), ref) <= TOL


def test_stream_make_inputs_are_the_tools():
    """make_inputs draws what the tool's module level (:33-36) and its run
    calls (:139-144, in order, cut before the kernel) draw, and LADDER is
    those calls."""
    tree = _tree(T3_SRC)
    keep = {"LANES", "SUB", "NV", "BV", "UNROLL", "S", "rng", "vals", "idxh",
            "x2d"}
    head = [n for n in tree.body if isinstance(n, ast.Assign)
            and {m.id for t in n.targets for m in ast.walk(t)
                 if isinstance(m, ast.Name)} <= keep]
    run = _function(tree, "run")
    cut = next(i for i, s in enumerate(run.body)
               if "make(" in ast.unparse(s))
    run.body = run.body[:cut] + ast.parse("return idx, wins").body
    ns = _exec(head + [run], T3_SRC)
    calls = [n.value for n in tree.body if isinstance(n, ast.Expr)
             and isinstance(n.value, ast.Call)
             and getattr(n.value.func, "id", "") == "run"]
    vals, x2d, steps = t3.make_inputs()
    assert np.array_equal(vals.numpy(), np.asarray(ns["vals"]))
    assert np.array_equal(x2d.numpy(), np.asarray(ns["x2d"]))
    assert len(calls) == len(t3.LADDER)
    for call, (tag, variant, P, stride, same_win) in zip(calls, t3.LADDER):
        kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
        assert [ast.literal_eval(a) for a in call.args] == [tag, variant]
        assert (kw.get("P", 1), kw.get("stride", 8),
                kw.get("same_win", False)) == (P, stride, same_win)
        idx, wins = eval(compile(ast.Expression(call), T3_SRC, "eval"), ns)
        assert np.array_equal(steps[tag[0]][1].numpy(), np.asarray(idx)), tag
        assert np.array_equal(steps[tag[0]][0].numpy(), wins), tag


def test_probes_equal_k1_where_they_compute_it():
    """T2 flane at any P, T2 at P = 1 and T3 B equal K1's plain version at
    stride 8, and T3 C equals it at stride 2, bit for bit."""
    for P in (1, 4, 8, 32):
        wins, vals, idx, x2d = t2.make_inputs(P, NV)
        k1 = colsum_plain(wins, vals, idx, x2d, 8)
        for variant in (t2.VARIANTS if P == 1 else ("flane",)):
            assert torch.equal(
                t2.roundcost_probe(wins, vals, idx, x2d, variant), k1), \
                (P, variant)
        if P > 1:       # the tag at the slot is another function
            assert not torch.equal(
                t2.roundcost_probe(wins, vals, idx, x2d, "cur"), k1)
    vals, x2d, steps = t3.make_inputs(NV)
    for step, stride in (("B", 8), ("C", 2)):
        wins, idx = steps[step]
        assert torch.equal(t3.stream_probe(wins, vals, idx, x2d, "B", stride),
                           colsum_plain(wins, vals, idx, x2d, stride)), step


def test_probe_wrappers_refuse_bad_calls():
    """Wrong dtype, shape, variant or device raises; a CPU tensor runs the
    plain version and counts no launch."""
    inp = t1.make_inputs(rows=t1.B)
    idx, xw = inp["sublane"], inp["xw"]
    wins, vals, ridx, x2d = t2.make_inputs(4, 8)
    svals, sx2d, steps = t3.make_inputs(8)
    swins, sidx = steps["D"]
    before = [dict(f.launches) for f in (t1.gather_probe, t2.roundcost_probe,
                                         t3.stream_probe)]
    assert torch.equal(t1.gather_probe(idx, xw, "sublane"),
                       t1.gather_probe_plain(idx, xw, "sublane"))
    assert torch.equal(t2.roundcost_probe(wins, vals, ridx, x2d, "fboth"),
                       t2.roundcost_probe_plain(wins, vals, ridx, x2d,
                                                "fboth"))
    assert torch.equal(t3.stream_probe(swins, svals, sidx, sx2d, "B"),
                       t3.stream_probe_plain(swins, svals, sidx, sx2d, "B"))
    assert before == [dict(f.launches) for f in (
        t1.gather_probe, t2.roundcost_probe, t3.stream_probe)]
    bad = [
        (lambda: t1.gather_probe(idx.long(), xw, "lane"), "idx must be"),
        (lambda: t1.gather_probe(idx[:100], xw, "lane"), "multiple"),
        (lambda: t1.gather_probe(idx, xw[:64], "lane"), "xw must be"),
        (lambda: t1.gather_probe(idx, xw, "row"), "body"),
        (lambda: t1.gather_probe(idx.to("meta"), xw.to("meta"), "lane"),
         "unsupported device"),
        (lambda: t2.roundcost_probe(wins, vals.double(), ridx, x2d, "cur"),
         "vals must be"),
        (lambda: t2.roundcost_probe(wins, vals, ridx.int(), x2d, "cur"),
         "idx must be"),
        (lambda: t2.roundcost_probe(wins[:4], vals, ridx, x2d, "cur"),
         "vals must be"),
        (lambda: t2.roundcost_probe(wins, vals, ridx, x2d, "both"),
         "variant"),
        (lambda: t2.roundcost_probe(wins.to("meta"), vals.to("meta"),
                                    ridx.to("meta"), x2d.to("meta"), "cur"),
         "unsupported device"),
        (lambda: t2.make_inputs(33, 8), "P 33"),
        (lambda: t3.stream_probe(swins, svals, sidx, sx2d[:, :64], "B"),
         "x2d must be"),
        (lambda: t3.stream_probe(swins, svals, sidx, sx2d, "B", 3),
         "stride 3"),
        (lambda: t3.stream_probe(swins, svals, sidx, sx2d, "C"), "variant"),
        (lambda: t3.stream_probe(swins, svals, sidx[:8], sx2d, "B"),
         "idx must be"),
    ]
    for call, what in bad:
        with pytest.raises(ValueError, match=what):
            call()


def test_probe_entry_points_need_a_card(monkeypatch):
    """The probes' CLIs refuse to run without a CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (lambda: t1.main([]), lambda: t2.main(["8"]),
                 lambda: t3.main(["8"]), t4.main):
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            main()


def test_smoke_holds_the_probes_at_their_edge_sizes():
    """chip_smoke.probe_edges, the sizes the card holds T1-T3 to their
    plain versions at: the tools' sizes and 8x, one and three 2,048-row
    blocks of T1, T2 at P = 2 and 5, T3 at 3 x 128 vregs."""
    edges = chip_smoke.probe_edges(t1, t2, t3)
    assert edges["gather_bench"] == [t1.ROWS, 8 * t1.ROWS, t1.B, 3 * t1.B]
    assert {P for P, nv in edges["roundcost_ab"] if nv == t2.NV} == \
        set(t2.PS) | {2, 5}
    assert {P for P, nv in edges["roundcost_ab"] if nv == 8 * t2.NV} == \
        set(t2.PS)
    assert edges["stream_bench2"] == [t3.NV, 8 * t3.NV, 3 * NV]


@pytest.mark.parametrize("form", ("static", "one", "cur"))
def test_colsum_probe_bytes_count_each_input_once(form):
    """T2/T3's bound bytes: the tools' stream bytes (6 B a slot and the
    output), and what a call must move: vals, idx, the wins it reads (none
    for the static form) and each distinct 8-row window once (window 0
    alone for the static form), and the output."""
    nv, stride = 3, 2
    wins = torch.tensor([[0, 8, 16], [0, 16, 8], [0, 24, 8]],
                        dtype=torch.int32)
    vals = torch.zeros((nv * 8, 128), dtype=torch.float32)
    idx = torch.zeros((nv * 8, 128), dtype=torch.int16)
    out = nv * (8 // stride) * 128 * 4
    assert _colsum_probe.stream_bytes(nv, stride) == nv * 1024 * 6 + out
    windows, wins_b = (1, 0) if form == "static" else (3, 3 * 3 * 4)
    assert _colsum_probe.must_move(wins, vals, idx, form, stride) == (
        nv * 1024 * 6 + wins_b + windows * 8 * 128 * 4 + out)


@pytest.mark.parametrize("dtype", ("f32", "bf16", "f64"))
def test_resident_call_bytes_count_each_output_once(dtype):
    """chip_smoke.resident_bytes' bytes a K6 call must move grow by kv
    times (the words of an x table that A's columns reach, n_rows output
    words) over the tables read once: the output at the width the kernel
    writes it, bf16's pass Y at 2 bytes a word, f32 at a bf16 step's, the
    padded rows not counted."""
    import dasp_tpu_torch as dt
    from dasp_tpu_torch.sparse import mixed_categories
    csr = mixed_categories(300, np.random.default_rng(0))
    op = dt.SpMVOperator(csr, dtype=dtype, device="cpu")
    assert op.resident and op._meta.B_pad * 128 > op._meta.n_rows
    el = 8 if dtype == "f64" else 4
    y_el = 2 if dtype == "bf16" else el
    x_used = np.unique(csr.col_idx).size * el
    call = {kv: chip_smoke.resident_bytes(op, csr, kv)[1]
            for kv in (1, 2, 4, 8)}
    tables = call[2] - 2 * (x_used + op._meta.n_rows * y_el)
    assert tables > 0
    assert call[1] == tables + x_used + op._meta.n_rows * el
    for kv in (4, 8):
        assert call[kv] == tables + kv * (x_used + op._meta.n_rows * y_el)


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N__5f3a_00000000_11_resident_cu_9a1bEkernIfLi1EE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N__5f3a_00000000_11_resident_cu_9a1bEpassIfLi1EE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BRA 0x10 ;
"""


@pytest.mark.parametrize("case", ("same", "other build", "changed",
                                  "renamed", "missing"))
def test_sass_diff_compares_functions(case):
    """probes/sass_diff.py: the functions of cuobjdump -sass's output by
    name (the unnamed namespace's per-build hash left out), each of A's
    that a substring picks held line by line to B's of the same name, or
    of the name --rename maps it to."""
    from dasp_tpu_torch.probes import sass_diff
    a = sass_diff.functions(_SASS)
    assert sorted(a) == ["_ZN12ANONEkernIfLi1EE", "_ZN12ANONEpassIfLi1EE"]
    assert a["_ZN12ANONEkernIfLi1EE"].splitlines()[-1].endswith("EXIT ;")
    other = (_SASS if case == "same"
             else _SASS.replace("5f3a", "77c0").replace("9a1b", "0e0e"))
    names, renames = ["kern"], ()
    if case == "changed":
        other = other.replace("EXIT ;", "NOP ;\n        EXIT ;")
    elif case == "renamed":
        other = other.replace("passIfLi1", "passIfLb1")
        names, renames = ["pass"], [("Li1EE$", "Lb1EE")]
    elif case == "missing":
        other, names = other.replace("passIf", "passId"), ["pass"]
    rows = sass_diff.compare(a, sass_diff.functions(other), names, renames)
    want = {"same": "same", "other build": "same", "renamed": "same",
            "changed": "DIFFERENT (2 lines)", "missing": "missing"}[case]
    assert [v for _, v in rows] == [want]
    if case == "same":
        assert sass_diff.compare(a, a, ["nothing"]) == []
