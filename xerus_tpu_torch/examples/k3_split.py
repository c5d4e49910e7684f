"""Where a K3 call's time goes on the card.

    python3 -m xerus_tpu_torch.examples.k3_split [--routes] [--crossover]

Run from the root of a checkout on a machine with an NVIDIA card.  For the
three sizes the completion paths use (all 4^10 entries and 20,000 samples
of the d=10, n=4, rank-8 shape; 400 samples of benchmark workload 5's d=5,
n=4, rank-3 shape), in float64 and float32, it times with CUDA events

- the whole wrapper launch (``ops.tt_eval._launch``: handing the cores to
  the kernel, then the kernel),
- the hand-over alone, and
- the kernel alone on cores handed over once,

and the host's wall time per wrapper launch, the kernel's phases from its
own time stamps, and prints the registers and spills ptxas reported; then
the same split at shapes that leave the shared-memory tables (rank 160; 40
sites).

``--routes`` instead times only the wrapper launch at those other shapes.
It uses nothing of the wrapper but ``_launch``, so a copy of this file
dropped into another version's ``examples/`` times that version's kernel
at the same shapes.
``--crossover`` instead times, at the d=10 shape and a range of M, one run
per site against merged runs: the measurements per block from which a
table pays for its build (``ops.tt_eval.MERGE_MIN_PER_BLOCK``).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

# (name, dims, ranks, M); M None = every entry of the grid
SIZES = [("grid 4^10", [4] * 10, [4] + [8] * 7 + [4], None),
         ("M=20000", [4] * 10, [4] + [8] * 7 + [4], 20_000),
         ("M=400 workload 5", [4] * 5, [3] * 4, 400)]
# shapes that leave the shared-memory tables: ranks above 32, more sites
# than the by-value table holds
OTHER_ROUTES = [("rank 160", [4] * 6, [160] * 5, 20_000),
                ("40 sites", [2] * 40, [2] * 39, 20_000),
                ("40 sites", [2] * 40, [2] * 39, 1_000_000)]
# --crossover: M from 256 to 8192 measurements per block of 132, and the
# groupings held against one run per site
CROSSOVER_M = [33_792, 67_584, 135_168, 270_336, 540_672, 1_081_344]
CROSSOVER_RUNS = [((0, 3), (4, 6), (7, 9)), ((0, 4), (5, 9))]
SEED = 0xBAADF00D


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median of per-call CUDA-event times in ms, the calls queued behind
    a device-side sleep so that each event pair times the device's work."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_us(fn, reps: int = 200) -> float:
    """Host wall time per call in microseconds (enqueue only; one
    synchronize at the end)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _inputs(dims, ranks, M, dtype, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    rs = [1] + list(ranks) + [1]
    cores = [torch.tensor(rng.standard_normal((rs[k], n, rs[k + 1]))
                          / np.sqrt(rs[k]), dtype=dtype, device=dev)
             for k, n in enumerate(dims)]
    if M is None:
        P = np.indices(dims).reshape(len(dims), -1).T
    else:
        P = np.stack([rng.integers(0, n, size=M) for n in dims], axis=1)
    return cores, torch.tensor(np.ascontiguousarray(P), dtype=torch.int64,
                               device=dev)


def phase_us(te, launch, reps: int = 5):
    """The shared-memory route's phases from the kernel's own time stamps
    (global timer, thread 0 of every block), in microseconds: the spread of
    the blocks' starts, the medians over blocks of staging the cores,
    building the tables and taking the measurements (warp 0), and the span
    from the first block's start to the last stamp.  None on the
    device-memory route."""
    import torch
    if launch.plan.route != te.ROUTE_SMEM:
        return None
    stamps = torch.zeros((launch.plan.blocks, 4), dtype=torch.int64,
                         device=launch.positions.device)
    for _ in range(reps):
        te.launch_plan(launch, stamps)
    torch.cuda.synchronize()
    st = stamps.double().cpu() / 1e3
    t0 = st[:, 0].min()
    return {"start_spread": float(st[:, 0].max() - t0),
            "stage": float((st[:, 1] - st[:, 0]).median()),
            "build": float((st[:, 2] - st[:, 1]).median()),
            "measure": float((st[:, 3] - st[:, 2]).median()),
            "span": float(st[:, 3].max() - t0)}


def split_rows(dev, sizes=SIZES):
    """One dict per size and dtype: wrapper, hand-over and kernel ms (CUDA
    events), host microseconds per wrapper launch, the route."""
    import torch
    from xerus_tpu_torch.ops import tt_eval as te
    rows = []
    for name, dims, ranks, M in sizes:
        for dtype in (torch.float64, torch.float32):
            cores, pos = _inputs(dims, ranks, M, dtype, dev)
            launch = te.plan_launch(cores, pos)
            rows.append({
                "phases": phase_us(te, launch),
                "size": name, "dtype": str(dtype).split(".")[1],
                "M": pos.shape[0], "route": launch.route,
                "wrapper_ms": time_ms(lambda: te._launch(cores, pos)),
                "hand_over_ms": time_ms(lambda: te.plan_launch(cores, pos)),
                "kernel_ms": time_ms(lambda: te.launch_plan(launch)),
                "host_us": host_us(lambda: te._launch(cores, pos))})
    return rows


def ptxas_lines(name: str = "tt_eval"):
    """The 'registers' and 'spill' lines ptxas printed for kernel
    ``name`` in this process's build (empty if the library was cached)."""
    from xerus_tpu_torch import build
    log = build.build_log.get(name, {}).get("ptxas", "")
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def print_split(dev, sizes=SIZES):
    for row in split_rows(dev, sizes):
        print(f"breakdown: K3 {row['size']} {row['dtype']} (M={row['M']}): "
              f"wrapper launch {row['wrapper_ms']:.4f} ms, hand-over alone "
              f"{row['hand_over_ms']:.4f} ms, kernel alone "
              f"{row['kernel_ms']:.4f} ms (CUDA events, median of 50 queued "
              f"calls), host {row['host_us']:.1f} us per wrapper launch; "
              f"route: {row['route']}")
        ph = row["phases"]
        if ph:
            print(f"breakdown: K3 {row['size']} {row['dtype']} phases by the "
                  f"kernel's time stamps (us): blocks start within "
                  f"{ph['start_spread']:.2f}, cores staged in "
                  f"{ph['stage']:.2f}, tables built in {ph['build']:.2f}, "
                  f"measurements {ph['measure']:.2f} (medians over blocks), "
                  f"first start to last stamp {ph['span']:.2f}")
    for line in ptxas_lines():
        print(f"breakdown: K3 ptxas: {line}")


def print_routes(dev):
    """Wrapper-launch ms at OTHER_ROUTES, float64 and float32."""
    import torch
    from xerus_tpu_torch.ops import tt_eval as te
    for name, dims, ranks, M in OTHER_ROUTES:
        for dtype in (torch.float64, torch.float32):
            cores, pos = _inputs(dims, ranks, M, dtype, dev)
            ms = time_ms(lambda: te._launch(cores, pos))
            print(f"routes: K3 {name} d={len(dims)} n={max(dims)} "
                  f"r={max(ranks)} M={M} {str(dtype).split('.')[1]}: wrapper "
                  f"launch {ms:.4f} ms (CUDA events, median of 50 queued "
                  f"calls)")


def print_crossover(dev):
    """Kernel ms by grouping over CROSSOVER_M at the d=10, n=4, rank-8
    shape; a grouping whose tables do not fit is left out."""
    import torch
    from xerus_tpu_torch.ops import tt_eval as te
    _name, dims, ranks, _M = SIZES[0]
    per_site = tuple((k, k) for k in range(len(dims)))
    for dtype in (torch.float64, torch.float32):
        for M in CROSSOVER_M:
            cores, pos = _inputs(dims, ranks, M, dtype, dev)
            parts = []
            for runs in [per_site] + CROSSOVER_RUNS:
                launch = te.plan_launch(cores, pos, groups=runs)
                if launch.plan.route != te.ROUTE_SMEM:
                    continue
                label = "+".join(str(b - a + 1) for a, b in runs)
                ms = time_ms(lambda: te.launch_plan(launch))
                parts.append(f"{label} {ms:.4f}")
            chosen = te.plan_launch(cores, pos).plan
            takes = "+".join(str(g.last - g.first + 1) for g in chosen.groups)
            print(f"crossover: K3 d=10 n=4 r=8 {str(dtype).split('.')[1]} "
                  f"M={M} ({M // chosen.blocks} per block), kernel ms: "
                  f"{', '.join(parts)}; the plan takes {takes}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("k3_split: needs an NVIDIA card")
    import xerus_tpu_torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = xerus_tpu_torch.cuda_device()
    if args.routes:
        print_routes(dev)
    elif args.crossover:
        print_crossover(dev)
    else:
        print_split(dev, SIZES + OTHER_ROUTES)


if __name__ == "__main__":
    main()
