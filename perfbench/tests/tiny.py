"""A checkout of the benchmark cut to CPU sizes, for the tests.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``tmp`` and cuts each configuration's sizes (the Poisson system to d=8,
rank 4; the rounding to d=10, rank 16 -> 8) and each mix's pool and traced
calls there, so a whole run takes seconds on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SIZES = {"qtt_poisson": {"d": 8, "rank": 4},
         "tt_round": {"d": 10, "rank": 16, "target_rank": 8}}


def _edit(path, fn):
    with open(path) as fh:
        data = json.load(fh)
    fn(data)
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)


def tiny_root(tmp) -> str:
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    configs = os.path.join(root, "perfbench", "configs")
    for name in os.listdir(configs):
        _edit(os.path.join(configs, name),
              lambda c: c.update(SIZES[c["family"]]))
    mixes = os.path.join(root, "perfbench", "mixes")
    for name in os.listdir(mixes):
        def cut(m):
            m["pool"] = 2
            m["trace_calls"] = 2
            if m["check"].get("sample"):
                m["check"]["sample"] = 3
        _edit(os.path.join(mixes, name), cut)
    return root
