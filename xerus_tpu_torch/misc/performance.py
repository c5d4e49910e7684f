"""Kernel-call performance analysis counters.

Equivalent of XERUS_PA_START/XERUS_PA_END + get_analysis()
(include/xerus/misc/performanceAnalysis.h:31-38): a global
group -> name -> parameter -> (count, total_seconds) map, fed by the
``pa_section`` context manager.  For on-device timing use torch.profiler
(misc/profiling.py); this covers host-side dispatch accounting like the reference's macros.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

_CALLS: Dict[str, Dict[str, Dict[str, Tuple[int, float]]]] = {}
_ENABLED = False


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


def pa_start() -> float:
    return time.perf_counter()


@contextlib.contextmanager
def pa_section(group: str, name: str, parameter: str = ""):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        g = _CALLS.setdefault(group, {})
        n = g.setdefault(name, {})
        cnt, tot = n.get(parameter, (0, 0.0))
        n[parameter] = (cnt + 1, tot + dt)


def get_analysis() -> str:
    lines = []
    for group in sorted(_CALLS):
        lines.append(f"# {group}")
        for name in sorted(_CALLS[group]):
            for param, (cnt, tot) in sorted(_CALLS[group][name].items()):
                lines.append(f"  {name}({param}): {cnt} calls, {tot * 1e6:.1f} us")
    return "\n".join(lines)


def clear_analysis() -> None:
    _CALLS.clear()
