"""REQUIRE-landmark coverage (reference: XERUS_TEST_COVERAGE turns every
REQUIRE into a registered landmark and un-hit landmarks are reported —
include/xerus/test/test.h:40-51, misc/check.h:30-44).

Enable with ``XERUS_TEST_COVERAGE=1``: every executed ``config.require``
call records its call site, and each process writes its hit set to
``.require_coverage_torch/<pid>.txt`` when it exits (the JAX package's
hits go to ``.require_coverage/``).  ``python -m
xerus_tpu_torch.misc.coverage [hits-files...]`` scans the port's own
source for require() call sites and reports the un-hit ones; by default
it reads the port's hit files.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Iterable, List, Set, Tuple

HITS_DIR = ".require_coverage_torch"

_HITS: Set[str] = set()


def record_caller(depth: int = 2) -> None:
    """Record the call site `depth` frames up (cheap string key)."""
    f = sys._getframe(depth)
    _HITS.add(f"{f.f_code.co_filename}:{f.f_lineno}")


def dump_at_exit() -> None:
    dump(os.path.join(HITS_DIR, f"{os.getpid()}.txt"))


def dump(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        for h in sorted(_HITS):
            fh.write(h + "\n")


def scan_sites(root: str | None = None) -> List[str]:
    """All `require(` call sites in the package source (file:line)."""
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"(?<![\w.])require\(")
    sites = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as fh:
                for ln, line in enumerate(fh, 1):
                    if pat.search(line) and "def require" not in line:
                        sites.append(f"{path}:{ln}")
    return sites


def report(hit_files: Iterable[str]) -> Tuple[int, int, List[str]]:
    hits: Set[str] = set()
    for hf in hit_files:
        with open(hf) as fh:
            hits.update(x.strip() for x in fh if x.strip())
    sites = scan_sites()
    missed = [s for s in sites if s not in hits]
    return len(sites), len(sites) - len(missed), missed


def main(argv: List[str]) -> int:
    import glob
    files = argv or sorted(glob.glob(os.path.join(HITS_DIR, "*.txt")))
    if not files:
        print("no hit files; run pytest with XERUS_TEST_COVERAGE=1 first")
        return 1
    total, hit, missed = report(files)
    print(f"require() landmarks: {hit}/{total} hit "
          f"({100.0 * hit / max(total, 1):.1f}%)")
    for m in missed:
        print(f"  MISSED {m}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
