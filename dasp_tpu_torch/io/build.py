"""Build ``native/libdasp_host.so`` once and whole, however many processes
ask for it at the same time.

``make`` writes its target in place, so a process that loads the library
while another process's ``make`` is still writing it reads a short file
(``OSError: ... file too short``); both packages' loaders then give up on
the library for the rest of the process.  ``ensure_built`` builds under an
exclusive ``flock`` on a lock file in the source directory, into a name of
its own (``TARGET`` set on make's command line overrides the Makefile's),
and renames the result over the library in one step: a reader sees no
library or a whole one, never part of one.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
from typing import Optional

from .native import _stale

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")
LIB = "libdasp_host.so"
LOCK = ".libdasp_host.so.lock"


def _fresh(lib: str, srcdir: str) -> bool:
    return os.path.exists(lib) and not _stale(lib, srcdir)


def ensure_built(cxx: Optional[str] = None,
                 srcdir: str = NATIVE_DIR) -> Optional[str]:
    """Path of ``srcdir``'s library, built first if it is missing or older
    than a source file; None (and the reason on stderr) if the build fails
    or ``srcdir`` has no Makefile.  ``cxx`` names the compiler (an exported
    CXX without OpenMP fails the Makefile's flags)."""
    lib = os.path.join(srcdir, LIB)
    if _fresh(lib, srcdir):
        return lib
    if not os.path.exists(os.path.join(srcdir, "Makefile")):
        return None
    with open(os.path.join(srcdir, LOCK), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(lib, srcdir):          # another process built it meanwhile
            return lib
        tmp = f"{LIB}.{os.getpid()}.tmp"
        cmd = ["make", "-C", srcdir, f"TARGET={tmp}"]
        if cxx:
            cmd.append(f"CXX={cxx}")
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(os.path.join(srcdir, tmp), lib)
        except (OSError, subprocess.SubprocessError) as e:
            # a broken toolchain must not SILENTLY fall back to the slow
            # Python router: say why the build failed
            tail = ""
            stderr = getattr(e, "stderr", None)
            if stderr:
                tail = ": " + stderr.decode("utf-8", "replace").strip(
                    ).splitlines()[-1][:200]
            print(f"dasp_tpu: native build failed ({e.__class__.__name__}"
                  f"{tail}); using the slow Python fallback",
                  file=sys.stderr)
            if os.path.exists(os.path.join(srcdir, tmp)):
                os.remove(os.path.join(srcdir, tmp))
            return None
    return lib
