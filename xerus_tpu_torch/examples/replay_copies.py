"""Where a program's replay spends its time, with its input and output
copies made by a loop of ``copy_`` or by one ``torch._foreach_copy_``.

    python3 -m xerus_tpu_torch.examples.replay_copies [--trials N]
        [--families adf,rounding,poisson] [--out DIR]

From the root of a checkout on a machine with an NVIDIA card.  For each
family of chip_smoke's ``phase_warmup`` (the d=10 ADF iteration at
20,000 samples; the d=32 rank-256 -> 128 randomized rounding; the d=32
rank-30 Poisson family's f32 half-sweeps and df rounding to 15) and each
trial, both copy modes in turns (loop, foreach; then foreach, loop): the
cold calls, ``programs.clear()``, ``xt.warmup``, then the first call
and five steady calls of each entry, synchronized and timed on the host.
Each replay is split by CUDA events and the host clock into the input
copies, the graph and the output copies; a call's split sums its
replays.  ``foreach`` is what ``Program`` does; ``loop`` is the
one-``copy_``-a-tensor form it replaced.

Each line is printed as JSON and, with ``--out``, written to
``DIR/replay_copies.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

import xerus_tpu_torch as xt
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import (bench_round_instance,
                                      completion_instance,
                                      qtt_poisson_instance)
from xerus_tpu_torch.examples.warm_entries import kind_entries
from xerus_tpu_torch.ops import programs as pg
from xerus_tpu_torch.ops.adf_kernels import build_onehots

SEED = 0xBAADF00D
STEADY = 5
PARTS = ("dev_load", "dev_graph", "dev_out", "host_load", "host_launch",
         "host_out")
_SPLITS = []
_MODE = {"foreach": True}


def _copy(dst, src):
    if _MODE["foreach"]:
        torch._foreach_copy_(dst, src)
    else:
        for d, s in zip(dst, src):
            d.copy_(s)


def _load(self, leaves):
    _copy(self._static_in, leaves)


def _replay(self, leaves):
    """``Program._replay`` with CUDA events and host stamps between its
    parts."""
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stamps = [time.perf_counter()]
    evs[0].record()
    self._load(leaves)
    evs[1].record()
    stamps.append(time.perf_counter())
    self.graph.replay()
    evs[2].record()
    stamps.append(time.perf_counter())
    pg.add_counts(self.deltas)
    self.replays += 1
    pg.Program.replays += 1
    outs = pg._leaves(self._static_out)
    copies = [pg._fresh(t) for t in outs]
    _copy(copies, outs)
    evs[3].record()
    stamps.append(time.perf_counter())
    _SPLITS.append((evs, stamps))
    return pg._rebuild(self._static_out, iter(copies))


def _split():
    tot = [0.0] * 6
    for evs, stamps in _SPLITS:
        for i in range(3):
            tot[i] += evs[i].elapsed_time(evs[i + 1])
            tot[3 + i] += (stamps[i + 1] - stamps[i]) * 1e3
    return {"replays": len(_SPLITS), **dict(zip(PARTS, tot))}


def _walled(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def families(dev, names):
    """(name, warmup's arguments, its keywords, entries) for ``names``."""
    if "adf" in names:
        inst = completion_instance()
        ms = inst.measurements
        x = cores_to_torch(inst.truth, dev, torch.float64)
        dims = [c.shape[1] for c in x]
        adf = (build_onehots(torch.from_numpy(ms.positions).to(dev), dims,
                             torch.float64),
               torch.from_numpy(ms.measuredValues).to(dev))
        yield ("adf", (dims, int(x[1].shape[2])),
               dict(dtype="float64", num_measurements=len(ms.measuredValues),
                    kinds=()),
               kind_entries(("adf_iteration",), x, 1, adf=adf))
    if "rounding" in names:
        x = cores_to_torch(bench_round_instance(32, 2, 256), dev)
        yield ("rounding", ([2] * 32, 256),
               dict(target_rank=128, kinds=("randomized",)),
               kind_entries(("randomized",), x, 128))
    if "poisson" in names:
        xs, A, b = qtt_poisson_instance(32, 30, SEED)
        x, A, b = (cores_to_torch(t, dev) for t in (xs, A, b))
        yield ("poisson", ([2] * 32, 30),
               dict(op_rank=2, kinds=("als", "df_round")),
               kind_entries(("als", "df_round"), x, 15, A=A, b=b))


def trial(name, args, kw, entries, tag):
    pg.clear()
    for entry in entries.values():
        entry(False)
    pg.clear()
    xt.warmup(*args, **kw)
    rows = []
    for entry_name, entry in entries.items():
        walls, splits = [], []
        for _ in range(1 + STEADY):
            _SPLITS.clear()
            walls.append(_walled(lambda: entry(False)))
            splits.append(_split())
        ref = statistics.median(walls[1:])
        rows.append({"trial": tag, "family": name, "entry": entry_name,
                     "copies": "foreach" if _MODE["foreach"] else "loop",
                     "first_over_steady": walls[0] / ref, "walls_ms": walls,
                     "first": splits[0], "second": splits[1]})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--families", default="adf,rounding,poisson")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = xt.cuda_device()
    pg.Program._load, pg.Program._replay = _load, _replay
    out = {"device": smi, "rows": []}
    for name, args, kw, entries in families(dev, a.families.split(",")):
        for i in range(a.trials):
            for foreach in ((False, True) if i % 2 == 0 else (True, False)):
                _MODE["foreach"] = foreach
                for row in trial(name, args, kw, entries, i):
                    print(json.dumps(row), flush=True)
                    out["rows"].append(row)
    pg.clear()
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "replay_copies.json"), "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
