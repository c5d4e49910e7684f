"""ctypes bridge to the native contraction-path optimizer
(``native/pathopt.cpp``).

The port's own loader for the JAX package's C++ source: it compiles that
source with g++ and the flags of ``native/Makefile`` into
``xerus_tpu_torch/_build/``, under a name that carries a hash of the source
and the flags (as ``build.py`` names the CUDA kernels), so it writes nothing
under ``native/`` and an edited source is rebuilt.  When no compiler is
available the search falls back to the pure-Python portfolio
(``heuristics.py``), a host planner as in the JAX package.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import List, Optional, Set, Tuple

import numpy as np

from .. import build

_LIB = None
_TRIED = False


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    return build.host_library_path("pathopt")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(build.build_host_library("pathopt"))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.pathopt_best_order.restype = ctypes.c_double
    lib.pathopt_best_order.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_best_order(network, ids: Set[int]) -> Optional[List[Tuple[int, int]]]:
    """Run the C++ search; returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    native_best_order.calls += 1
    ids_sorted = sorted(ids)
    remap = {nid: i for i, nid in enumerate(ids_sorted)}
    n = len(ids_sorted)
    sizes = np.zeros(n, dtype=np.float64)
    ea, eb, edim = [], [], []
    for nid in ids_sorted:
        node = network.nodes[nid]
        size = 1.0
        for link in node.neighbors:
            size *= link.dimension
            if (not link.external and link.other in ids
                    and link.other > nid):
                ea.append(remap[nid])
                eb.append(remap[link.other])
                edim.append(float(link.dimension))
        sizes[remap[nid]] = size
    ea_arr = np.asarray(ea, dtype=np.int32)
    eb_arr = np.asarray(eb, dtype=np.int32)
    ed_arr = np.asarray(edim, dtype=np.float64)
    out_pairs = np.zeros(2 * max(n - 1, 1), dtype=np.int32)
    out_len = np.zeros(1, dtype=np.int32)

    lib.pathopt_best_order(
        n, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(ea), ea_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        eb_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ed_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    k = int(out_len[0])
    inv = {i: nid for nid, i in remap.items()}
    return [(inv[int(out_pairs[2 * i])], inv[int(out_pairs[2 * i + 1])])
            for i in range(k)]


# searches the native library ran in this process (chip_smoke reads it)
native_best_order.calls = 0
