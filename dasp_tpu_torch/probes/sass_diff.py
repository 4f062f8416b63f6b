"""Two builds of a kernel library, compared function by function in SASS.

    python -m dasp_tpu_torch.probes.sass_diff A.so B.so [name ...]
        [--rename OLD=NEW ...]

Runs ``cuobjdump -sass`` (beside the ``nvcc`` that builds the kernels) on
both libraries and prints, for each function of A whose name holds one of
the ``name`` substrings (default ``resident_kernel``), whether B holds the
same instructions under the same name: ``same`` or ``DIFFERENT (n
lines)``, or ``missing`` where B lacks it.  The unnamed namespace's hash,
which differs from one build to the next, is left out of the names;
``--rename OLD=NEW`` (a regular expression and its replacement) maps A's
names onto B's where a template parameter changed its type but not its
value.  Exit code 1 when any function differs or is missing.  Used to show
that a change to a kernel's source left another kernel's code as it was.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, Iterable, List, Tuple

from ..ops import _build

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def functions(text: str) -> Dict[str, str]:
    """{function name: its SASS lines} of ``cuobjdump -sass``'s output,
    the unnamed namespace's hash replaced by ``ANON``."""
    text = _ANON.sub("ANON", text)
    out: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur:
            out[cur].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def compare(a: Dict[str, str], b: Dict[str, str], names: Iterable[str],
            renames: Iterable[Tuple[str, str]] = ()) -> List[Tuple[str, str]]:
    """[(A's function name, "same" | "DIFFERENT (n lines)" | "missing")]
    for A's functions whose name holds one of ``names``, each looked up in
    B under its name after ``renames``' substitutions."""
    rows = []
    for name in sorted(k for k in a if any(n in k for n in names)):
        other = name
        for old, new in renames:
            other = re.sub(old, new, other)
        if other not in b:
            rows.append((name, "missing"))
            continue
        la, lb = a[name].splitlines(), b[other].splitlines()
        n = sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))
        rows.append((name, "same" if n == 0 else f"DIFFERENT ({n} lines)"))
    return rows


def sass(lib: str) -> str:
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def main(argv: List[str]) -> int:
    renames, rest = [], []
    it = iter(argv)
    for arg in it:
        if arg == "--rename":
            old, new = next(it).split("=", 1)
            renames.append((old, new))
        else:
            rest.append(arg)
    if len(rest) < 2:
        print(__doc__)
        return 2
    a, b = functions(sass(rest[0])), functions(sass(rest[1]))
    rows = compare(a, b, rest[2:] or ["resident_kernel"], renames)
    for name, verdict in rows:
        print(f"[sass] {verdict}: {name}")
    bad = sum(v != "same" for _, v in rows)
    print(f"[sass] {len(rows)} functions compared, {bad} not the same")
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
