#!/usr/bin/env python3
"""Chip check of xerus_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds every CUDA kernel of the
port's main path from ``xerus_tpu_torch/csrc`` with nvcc, holds each kernel
against its plain PyTorch version and float64 on the card, then drives the
main path once at full width: the d=32, rank-30 QTT Poisson mixed-precision
ALS solve (f32 half-sweeps to the f32 plateau, then two double-word
half-sweeps), the instance of ``bench.py``'s north-star row.  It checks the
host-f64 residual, that the solve went through the kernels (launch counts),
and that a small solve on the card agrees with the same solve on the CPU.

Every phase raises on failure and nothing is caught, so the exit code is 0
only if every phase passed.  Without a CUDA card, or without the package
beside it, it exits non-zero and prints no result.  The second-to-last
stdout line is a JSON object with one entry per kernel; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 0xBAADF00D
D, RANK = 32, 30
MAX_F32_SWEEPS, DF_SWEEPS = 16, 2
RESIDUAL_BAR = 1e-10
# 22 interior sites of ranks (30, 30) give 1800-row local systems, past the
# 2^20 kernel gate; 3 refinement iterations each, 2 df half-sweeps
EXPECTED_K1_LAUNCHES = 22 * 3 * DF_SWEEPS
K1_SHAPES = [(1800, 1800), (1030, 997), (130, 190)]
K1_REL_TOL = 1e-12


def _time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median of per-call CUDA-event times, in ms.

    The calls are queued behind a device-side sleep (about 0.1 s), so they
    run back to back on the card and each event pair times the device's
    work, not the host's enqueue.  Back to back, the (1800, 1800) pair
    (26 MB) stays in the 50 MB L2 between calls."""
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


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(HERE, "xerus_tpu_torch")):
        print(f"chip_smoke: no xerus_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"devices {torch.cuda.device_count()}")
    return smi


def phase_build():
    from xerus_tpu_torch import build
    t0 = time.perf_counter()
    build.load_kernel_library("df_matvec")
    secs = time.perf_counter() - t0
    print(f"build: df_matvec in {secs:.2f} s")
    for name, log in build.build_log.items():
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev):
    """K1 against its plain version and the f64 product at the path's
    shapes; times at (1800, 1800)."""
    import numpy as np
    from xerus_tpu_torch.ops import df32
    from xerus_tpu_torch.ops.df_matvec import df_matvec, df_matvec_reference
    max_abs = 0.0
    timing = {}
    for (m, k) in K1_SHAPES:
        rng = np.random.Generator(np.random.PCG64(SEED + m * k))
        A = rng.normal(size=(m, k))
        x = rng.normal(size=(k,))
        args = (*df32.df_from_f64(A, dev), *df32.df_from_f64(x, dev))
        kern = df32.df_to_f64(*df_matvec(*args))
        plain = df32.df_to_f64(*df_matvec_reference(*args))
        exact = A @ x
        rel_k = np.linalg.norm(kern - exact) / np.linalg.norm(exact)
        rel_p = np.linalg.norm(plain - exact) / np.linalg.norm(exact)
        diff = float(np.max(np.abs(kern - plain)))
        max_abs = max(max_abs, diff)
        print(f"K1 df_matvec ({m}, {k}): kernel rel err {rel_k:.3e}, plain "
              f"rel err {rel_p:.3e} (vs f64, bar {K1_REL_TOL:g}); "
              f"max |kernel - plain| {diff:.3e}")
        if not (rel_k <= K1_REL_TOL and rel_p <= K1_REL_TOL):
            raise AssertionError(f"K1 at ({m}, {k}) misses the f64 bar")
        if (m, k) == K1_SHAPES[0]:
            timing["ms"] = _time_ms(lambda: df_matvec(*args))
            timing["plain_ms"] = _time_ms(lambda: df_matvec_reference(*args))
            gbps = 2 * m * k * 4 / (timing["ms"] * 1e-3) / 1e9
            print(f"K1 df_matvec ({m}, {k}) time: kernel "
                  f"{timing['ms'] * 1e3:.2f} us ({gbps:.0f} GB/s of A), plain "
                  f"{timing['plain_ms'] * 1e3:.2f} us (CUDA events, median "
                  f"of 50 queued calls after 5 warm-up calls)")
    return max_abs, timing


def _solve(d, rank, dev, df_sweeps=DF_SWEEPS):
    from xerus_tpu_torch.convert import cores_to_df, cores_to_torch
    from xerus_tpu_torch.examples import qtt_poisson_instance
    from xerus_tpu_torch.ops.mixed_precision import als_f32_df_run
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    inputs = (cores_to_torch(xs, dev), cores_to_torch(A, dev),
              cores_to_torch(b, dev), cores_to_df(A, dev), cores_to_df(b, dev))
    return (A, b), lambda: als_f32_df_run(*inputs, MAX_F32_SWEEPS, df_sweeps)


def phase_slice(dev):
    """The main path at full width, counted and checked."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import df_to_numpy
    from xerus_tpu_torch.examples import host_poisson_residual
    from xerus_tpu_torch.ops.df_matvec import df_matvec
    (A64, b64), run = _solve(D, RANK, dev)
    torch.cuda.synchronize()
    df_matvec.launches = 0
    t0 = time.perf_counter()
    out, hist, cnt = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = df_matvec.launches
    sol = df_to_numpy(out)
    if not all(np.all(np.isfinite(c)) for c in sol):
        raise AssertionError("non-finite cores in the solution")
    res = host_poisson_residual(sol, A64, b64)
    print(f"slice d={D} rank={RANK}: host-f64 residual {res:.3e} (bar "
          f"{RESIDUAL_BAR:g}), f32 half-sweeps {cnt}, df half-sweeps "
          f"{DF_SWEEPS}, f32 history "
          f"{[f'{v:.3e}' for v in hist[:cnt].tolist()]}, "
          f"solve wall {wall:.3f} s, K1 launches {launches}")
    if not res <= RESIDUAL_BAR:
        raise AssertionError(f"residual {res:.3e} above {RESIDUAL_BAR:g}")
    if launches != EXPECTED_K1_LAUNCHES:
        raise AssertionError(f"K1 launched {launches} times in the solve, "
                             f"expected {EXPECTED_K1_LAUNCHES}")
    return launches


def phase_breakdown(dev):
    """Where the solve's time goes: a second full solve, then the f32 phase
    alone (df_sweeps=0); the df phase is the difference."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import mixed_precision as mp
    from xerus_tpu_torch.ops.df32 import df_from_f64
    _, run_all = _solve(D, RANK, dev)
    _, run_f32 = _solve(D, RANK, dev, df_sweeps=0)
    for name, run in (("full solve (repeat)", run_all),
                      ("f32 phase alone", run_f32)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        print(f"breakdown: {name} {time.perf_counter() - t0:.3f} s wall")
    a = np.random.Generator(np.random.PCG64(SEED)).normal(size=(60, 30))
    ah, al = df_from_f64(a, dev)
    mp.df_qr(ah, al)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        mp.df_qr(ah, al)
    torch.cuda.synchronize()
    print(f"breakdown: df_qr (60, 30) {(time.perf_counter() - t0) / 5 * 1e3:.1f}"
          f" ms per call (44 of the solve's 62 df_qr calls are 60 x 30)")


def phase_small_agreement(dev):
    """A small solve on the card against the same solve on the CPU, where
    the plain versions run."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import df_to_numpy
    _, run_gpu = _solve(8, 5, dev)
    _, run_cpu = _solve(8, 5, torch.device("cpu"))
    g_out, _, g_cnt = run_gpu()
    c_out, _, c_cnt = run_cpu()

    def full(cores):
        t = np.ones((1, 1))
        for c in cores:
            t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
        return t.reshape(-1)

    g, c = full(df_to_numpy(g_out)), full(df_to_numpy(c_out))
    rel = np.linalg.norm(g - c) / np.linalg.norm(c)
    print(f"small d=8 rank=5: card vs CPU solution rel diff {rel:.3e} "
          f"(bar 1e-9), f32 half-sweeps {g_cnt} vs {c_cnt}")
    if not (rel <= 1e-9 and g_cnt == c_cnt):
        raise AssertionError("card and CPU disagree on the small solve")


def main():
    sys.path.insert(0, HERE)
    phase_environment()
    import torch
    import xerus_tpu_torch
    dev = xerus_tpu_torch.cuda_device()
    phase_build()
    max_abs, timing = phase_kernels(dev)
    phase_small_agreement(dev)
    launches = phase_slice(dev)
    phase_breakdown(dev)
    print(json.dumps({"kernels": [{
        "name": "df_matvec", "route": "cuda",
        "source": "xerus_tpu_torch/csrc/df_matvec.cu",
        "replaces": "xerus_tpu/ops/pallas_df.py:60",
        "launches": launches, "max_abs_err": max_abs,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
