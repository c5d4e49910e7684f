"""One run of one cell: set-up, a closed-loop window, the check, one line.

The traffic generator is a closed loop with one caller, as a library's user
calls it: each call of the cell's entry starts when the last one has
returned, and ends synchronized with its result on the device.  The calls
cycle through a pool of inputs drawn from the seed, in an order drawn from
the seed.  Set-up warms the cell's own entry on its own inputs until its
calls run no eager program and capture nothing; the window then runs
calls for ``--seconds`` seconds.  With ``--trace 1`` the
window's first calls (the mix's ``trace_calls``) run under
torch.profiler, the next as many under torch's sync debug mode (switched
on around the entry alone), and the per-layer metrics are read;
otherwise the end-to-end ones.

After the window the peak device memory is read, the program's captured
state is freed, and the reference module judges the results the mix
checks (all of them, or a sample drawn from the seed) against the cell's
limits.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import os
import random
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace
from typing import Dict, List, Optional

from perfbench import trace as tr

# top-level module names no run may hold (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "xerus_tpu")
# what the reference modules may not import besides
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("xerus_tpu_torch",)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forbidden_modules(names=FORBIDDEN) -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(names))


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_cell(root: str, name: str):
    """(manifest, cell, config, mix, cell file) of the cell ``name``."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    mix = load_json(os.path.join(root, "perfbench", "mixes",
                                 cell["traffic"] + ".json"))
    cell_file = load_json(os.path.join(root, "perfbench", "cells",
                                       name + ".json"))
    return manifest, cell, config, mix, cell_file


def metrics_of(manifest: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those whose ``workloads`` list it; an end-to-end metric
    without the key, every cell (each per-layer metric lists its cells)."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def quantile(values: List[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    s = sorted(values)
    if len(s) == 1:
        return s[0]
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def _sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _reservoir(rng: random.Random, kept: List, size: Optional[int], seen: int,
               item) -> None:
    """Keep ``item`` (the ``seen``-th, from 0) in a uniform sample of at
    most ``size`` items; ``size`` None keeps every item."""
    if size is None or len(kept) < size:
        kept.append(item)
    else:
        j = rng.randrange(seen + 1)
        if j < size:
            kept[j] = item


def _changed(before: Dict, after: Dict, names) -> bool:
    return any(after.get(n, 0) != before.get(n, 0) for n in names)


def warm(system, order: List[int], device, spec: Dict) -> int:
    """Call the entry on the pool's inputs (each at least once) until
    ``spec["quiet_calls"]`` calls in a row move none of the counters in
    ``spec["until_quiet"]`` (eager runs, captures); at most
    ``spec["max_calls"]`` calls.  Returns the calls made."""
    quiet, calls = 0, 0
    while calls < spec["max_calls"]:
        before = system.counters()
        system.call(order[calls % len(order)])
        _sync(device)
        calls += 1
        quiet = 0 if _changed(before, system.counters(),
                              spec["until_quiet"]) else quiet + 1
        if quiet >= spec["quiet_calls"] and calls >= len(order):
            return calls
    raise RuntimeError(f"the entry still ran eager programs or captured "
                       f"after {calls} warm-up calls")


# the text of the warning torch's sync debug mode gives for each sync
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def counting_syncs(device):
    """Count the synchronizing calls that torch's sync debug mode reports
    inside the block; yields a one-item list that holds the count once the
    block has ended.  Only the block's own syncs count: the mode is off
    again before the caller's synchronize."""
    import torch
    box = [0]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    box[0] = sum(SYNC_WARNING in str(w.message) for w in seen)


def _by_input(walls: List[float], order: List[int], first: int) -> str:
    """The median wall of each pool input, in ms, over ``walls``, the
    window's calls from its ``first`` on."""
    by: Dict[int, List[float]] = {}
    for n, w in enumerate(walls, start=first):
        by.setdefault(order[n % len(order)], []).append(w)
    return ", ".join(f"{k}: {1e3 * quantile(v, 0.5):.2f}"
                     for k, v in sorted(by.items()))


def _number(x: float):
    """A JSON number, or its text where it is not finite."""
    return x if math.isfinite(x) else str(x)


def _power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, control: Optional[Dict] = None) -> Dict:
    """Set-up, window and check of cell ``name``; returns the result line
    as a dict (``checks`` last).  ``control`` (a cell file's ``control``
    or one of its ``faults``): ``args`` merged into the entry's arguments,
    ``reference`` putting the reference module's ``Control`` in the
    program's place, with ``fault`` as its keyword arguments, ``tf32``
    turning on TF32 float32 products (after the port has pinned them
    off)."""
    import torch
    manifest, cell, config, mix, cell_file = load_cell(root, name)
    ref = importlib.import_module(f"perfbench.reference.{config['family']}")
    drv = importlib.import_module(f"perfbench.drivers.{config['family']}")
    mix = dict(mix)
    if control and "args" in control:
        mix["args"] = {**mix.get("args", {}), **control["args"]}
    limits = cell_file["limits"]
    order = list(range(mix["pool"]))
    random.Random(seed).shuffle(order)
    sample = mix["check"].get("sample")
    log = lambda msg: print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    with drv.scope(device, config.get("dtype", "float64")):
        inputs = ref.make_inputs(config, seed, mix["pool"], device)
        if control and control.get("reference"):
            system = ref.Control(config, mix, inputs, device,
                                 **control.get("fault", {}))
        else:
            system = drv.System(config, mix, inputs, device)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        if control and control.get("tf32"):
            torch.backends.cuda.matmul.allow_tf32 = True
        warm_calls = warm(system, order, device, mix["warm"])
        setup_s = time.perf_counter() - t0
        log(f"{name}: set-up {setup_s:.3f} s ({warm_calls} warm-up calls)")

        # with --trace 1 the window's first calls run under the profiler,
        # the next as many under the sync count, the rest as untraced
        n_trace = int(mix["trace_calls"]) if trace else 0
        prof = None
        if n_trace:
            # started before the window: the profiler's own start-up takes
            # seconds
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()

        kept: List = []
        rng = random.Random(seed + 1)
        walls: List[float] = []
        syncs: List[int] = []
        before = system.counters()
        start = time.perf_counter()
        while True:
            i = len(walls)
            k = order[i % len(order)]
            t = time.perf_counter()
            if i < n_trace:
                with torch.profiler.record_function(tr.CALL_SPAN):
                    out = system.call(k)
                    _sync(device)
            elif i < 2 * n_trace:
                with counting_syncs(device) as seen:
                    out = system.call(k)
                _sync(device)
                syncs.append(seen[0])
            else:
                out = system.call(k)
                _sync(device)
            walls.append(time.perf_counter() - t)
            _reservoir(rng, kept, sample, i, (k, out))
            del out
            if i + 1 == n_trace:
                prof.stop()
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        if prof is not None and len(walls) < n_trace:  # the window ended first
            prof.stop()
        after = system.counters()
        log(f"{name}: {len(walls)} calls in {window_s:.3f} s")
        log(f"{name}: median wall by input (ms): "
            + _by_input(walls[2 * n_trace:], order, 2 * n_trace))
        if n_trace and len(walls) > 2 * n_trace:
            log(f"{name}: profiled calls {1e3 * quantile(walls[:n_trace], 0.5):.2f}"
                f" ms, untraced {1e3 * quantile(walls[2 * n_trace:], 0.5):.2f}"
                f" ms (medians)")

        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        checked = [(k, system.cores(res)) for k, res in kept]
        del kept, system
        drv.free()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        rows = ref.judge(config, inputs, checked, list(limits), device)
        log(f"{name}: checked {len(rows)} results in "
            f"{time.perf_counter() - t_check:.3f} s")

    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, walls=walls, calls=len(walls),
        counters={k: after[k] - before.get(k, 0) for k in after},
        config=config, mix=mix, cell=cell, traced_calls=min(n_trace,
                                                            len(walls)),
        syncs=sum(syncs), sync_calls=len(syncs), device_events=[],
        host_events=[], trace_window_s=None, busy_s=None)
    line: Dict = {}
    if prof is not None:
        dev_ev, host_ev = tr.events(prof)
        lo, hi = tr.window(host_ev)
        run.device_events = [e for e in dev_ev if e[2] > lo and e[1] < hi]
        run.host_events = host_ev
        run.trace_window_s = (hi - lo) * 1e-9
        run.busy_s = tr.busy_ns(dev_ev, lo, hi) * 1e-9
        line["breakdown"] = tr.breakdown(dev_ev, host_ev, lo, hi)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, name, kind):
        reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers = {n: max(r[n] for r in rows) if rows else math.inf
               for n in limits}
    failed = sum(any(not (r[n] <= limits[n]) for n in limits) for r in rows)
    correct = bool(rows) and failed == 0
    if device.type == "cuda":
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": int(cell["chips"]), "memory_peak_bytes": peak,
                    "power_limit": _power_limit()}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0, "power_limit": None}
    if trace:
        dev_info["busy_s"] = run.busy_s
        dev_info["window_s"] = run.trace_window_s
    out = {"correct": correct, "attempted": len(walls), "failed": failed,
           "metrics": metrics, "device": dev_info}
    out.update(line)
    out["checks"] = {n: {"value": _number(numbers[n]), "limit": limits[n]}
                     for n in limits}
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _, cell, _, _, _ = load_cell(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is "
              "False); this benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
