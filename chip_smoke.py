#!/usr/bin/env python3
"""Chip check of xerus_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds every CUDA kernel of the
port's main paths from ``xerus_tpu_torch/csrc`` with nvcc (one nvcc per
source, all started together), holds each kernel against its plain PyTorch
version and float64 on the card, then drives the two main paths once at
full width:

- the d=32, rank-30 QTT Poisson mixed-precision ALS solve (f32
  half-sweeps to the f32 plateau, then two double-word half-sweeps), the
  instance of ``bench.py``'s north-star row; kernel K1 (df_matvec);
- TT rounding of ``bench.py``'s workload-1 instance (d=32, n=2, rank 256
  -> 128) and its numerically rank-96 "cliff" variant, deterministic
  (gemm_exact and svd truncation) and randomized (cholqr1); kernel K2
  (gemm_exact);
- tensor completion: the d=10, n=4, rank-8 instance from 20,000 samples
  (measure, rank-adaptive ADF solve, test, every entry of the recovered TT
  and of the truth), benchmark workload 5 on the card and on the CPU, and
  IHT; kernel K3 (tt_eval).

It checks the host-f64 residual of the solve, the f32-vs-f64 log-norm
of every rounding and the completion's residuals against the JAX
package's own numbers, that each path went through its kernel (launch counts,
zeroed just before the path and read just after), and that a small solve
and a small rounding on the card agree with the same on the CPU.

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

KERNELS = ("df_matvec", "gemm_exact", "tt_eval")

# rounding: bench.py workload 1
ROUND_D, ROUND_N, ROUND_RANK, ROUND_TARGET, OVERSAMPLE = 32, 2, 256, 128, 8
# trunc-mode bonds of the static schedule: sites 8..24, each (256, 256),
# keep 128 in a 128 bucket; the ramp bonds take exact splits
EXPECTED_K2_LAUNCHES = 17
ROUND_F64_BAR = 2e-4      # f32-vs-f64 log-norm, svd and gemm_exact
GE_VS_SVD_BAR = 1e-4      # gemm_exact log-norm vs the svd chain's
RAND_VS_SVD_BAR = 1e-4    # randomized log-norm above the svd chain's
# K2 against its plain version: (kind, B, M, keep, keep_cap); the
# reference's three kinds (tests/test_pallas_lowering.py) and the slice's
# bond shape
K2_CASES = [("generic", 256, 512, 96, 128), ("cliff", 256, 512, 96, 128),
            ("overranked", 256, 512, 96, 128), ("slice", 256, 256, 128, 128)]
K2_ERR_TOL = 5e-6         # |truncation error kernel - plain|, f32
K2_F64_RTOL = 1e-8        # f64 truncation error vs the SVD's

# completion: K3 against its plain version, (name, dims, ranks, M)
K3_CASES = [("slice", [4] * 10, [4] + [8] * 7 + [4], 20_000),
            ("ragged", [2, 5, 3, 4], [2, 4, 3], 17),
            ("tail", [3] * 4, [2] * 3, 13), ("empty", [3] * 4, [2] * 3, 0),
            ("rank 160", [2] * 3, [160, 160], 50)]
K3_RTOL = {"float64": 1e-12, "float32": 1e-5}   # of max |plain|
# measure the truth, test the samples, every entry of x and of the truth
EXPECTED_K3_LAUNCHES = 4
COMPLETION_TARGET = 1e-8
# the JAX package on the CPU (float64, check_every="device", jax 0.9.0) on
# the d=10 instance: sample residual and full-grid relative error after 588
# iterations at ranks [4, 8, ..., 8, 4]; the port must stay within
# max(1e-8, 10x) of each
JAX_D10_RESIDUAL = 0.6785049587588636
JAX_D10_GRID_ERR = 2.597094923462056
IHT_ITERATIONS = 5


def _wall_ms(fn, reps: int = 3) -> float:
    """Median host wall time of ``fn`` in ms, synchronized before and after
    each call: for plain versions that read flags to the host."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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
    from concurrent.futures import ThreadPoolExecutor
    from xerus_tpu_torch import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.load_kernel_library, KERNELS))
    secs = time.perf_counter() - t0
    print(f"build: {', '.join(KERNELS)} in {secs:.2f} s (one nvcc each, "
          f"in parallel)")
    for name, log in build.build_log.items():
        print(f"  nvcc {name}: {log['seconds']:.2f} s")
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


def _k2_input(kind, B, M, keep, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "generic":
        return rng.standard_normal((B, M)) * rng.uniform(0.1, 1.0,
                                                         size=(B, 1))
    if kind == "cliff":
        U, _ = np.linalg.qr(rng.standard_normal((B, B)))
        V, _ = np.linalg.qr(rng.standard_normal((M, B)))
        s = np.concatenate([np.linspace(10.0, 1.0, keep),
                            np.full(B - keep, 1e-6)])
        return (U * s) @ V.T
    if kind == "overranked":
        return rng.standard_normal((B, 7)) @ rng.standard_normal((7, M))
    return rng.standard_normal((B, M))


def _k2_run(cur, keep, cap, kernel):
    """One truncation by K2 or by its plain version; (vt, flags)."""
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    mask = (torch.arange(cap, device=cur.device) < keep).to(cur.dtype)
    if kernel:
        vt0, vt_bal, flags = ge.gemm_exact_kernel(cur, keep, cap)
        okp, conv, it, ns, syncs = flags.tolist()
        info = dict(okp=bool(okp), converged=bool(conv), outer=it, ns=ns,
                    syncs=syncs)
    else:
        vt0, vt_bal, okp_t, conv_t, it = ge._gemm_exact_body(
            cur, mask, *ge._gemm_exact_tuning(cur.dtype))
        info = dict(okp=bool(okp_t), converged=bool(conv_t), outer=it)
    return ge._finish_gemm_exact(vt0, vt_bal, info["okp"], mask), info


def _trunc_err(cur, vt):
    """||cur - cur vt^T vt||^2 / ||cur||^2 in float64."""
    c, v = cur.double(), vt.double()
    return float(((c - (c @ v.T) @ v).norm() ** 2 / c.norm() ** 2).item())


def phase_k2(dev):
    """K2 against its plain version on the card: the reference's three
    kinds and the slice's bond shape in f32, one small f64 case against
    the SVD; bitwise repeat launches; times at the slice's shape."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    max_abs = 0.0
    timing = {}
    for kind, B, M, keep, cap in K2_CASES:
        cur = torch.tensor(_k2_input(kind, B, M, keep, SEED + B + M),
                           dtype=torch.float32, device=dev)
        vk, fk = _k2_run(cur, keep, cap, True)
        vp, fp = _k2_run(cur, keep, cap, False)
        ek, ep = _trunc_err(cur, vk), _trunc_err(cur, vp)
        a = ge.gemm_exact_kernel(cur, keep, cap)
        b = ge.gemm_exact_kernel(cur, keep, cap)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = abs(ek - ep)
        max_abs = max(max_abs, diff)
        print(f"K2 gemm_exact {kind} ({B}, {M}) keep {keep} cap {cap} f32: "
              f"trunc err kernel {ek:.9e} plain {ep:.9e} (|diff| {diff:.3e}, "
              f"bar {K2_ERR_TOL:g}); kernel {fk}; plain {fp}; repeat "
              f"launches bitwise equal: {same}")
        if not (diff < K2_ERR_TOL and same and fk["converged"]
                and fp["converged"]):
            raise AssertionError(f"K2 {kind}: kernel and plain disagree, "
                                 "did not certify, or repeat differs")
        if kind == "slice":
            timing["ms"] = _time_ms(lambda: ge.gemm_exact_kernel(cur, keep,
                                                                 cap),
                                    reps=20, warmup=2)
            timing["plain_ms"] = _wall_ms(lambda: _k2_run(cur, keep, cap,
                                                          False))
            print(f"K2 gemm_exact slice ({B}, {M}) time: kernel "
                  f"{timing['ms']:.3f} ms (CUDA events, median of 20 queued "
                  f"launches after 2 warm-up launches), plain "
                  f"{timing['plain_ms']:.3f} ms (host wall clock around "
                  f"torch.cuda.synchronize(), median of 3; it reads its loop "
                  f"conditions to the host)")
    A = _k2_input("generic", 40, 24, 5, SEED)
    s = np.linalg.svd(A, compute_uv=False)
    e_svd = float(np.sum(s[5:] ** 2) / np.sum(s ** 2))
    cur = torch.tensor(A, dtype=torch.float64, device=dev)
    vk, fk = _k2_run(cur, 5, 8, True)
    vp, fp = _k2_run(cur, 5, 8, False)
    ek, ep = _trunc_err(cur, vk), _trunc_err(cur, vp)
    print(f"K2 gemm_exact f64 (40, 24) keep 5 cap 8: trunc err kernel "
          f"{ek:.15e} plain {ep:.15e} svd {e_svd:.15e} (rtol bar "
          f"{K2_F64_RTOL:g}); kernel {fk}; plain {fp}")
    if not (abs(ek - e_svd) <= K2_F64_RTOL * e_svd
            and abs(ep - e_svd) <= K2_F64_RTOL * e_svd and fk["converged"]):
        raise AssertionError("K2 f64 misses the SVD truncation error")
    return max_abs, timing


def _round(method, cores):
    from xerus_tpu_torch.ops import round_kernels as rk
    if method == "randomized":
        return rk._round_randomized(cores, ROUND_TARGET, OVERSAMPLE,
                                    qr_method="cholqr1")
    return rk.tt_round_sweep_segmented(cores, ROUND_TARGET, method=method)


def _to_host(cores):
    return [c.double().cpu().numpy() for c in cores]


def phase_small_rounding(dev):
    """A small rounding (d=10, rank 16 -> 8, f32) on the card against the
    same rounding on the CPU, where the plain versions run."""
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          host_tt_distance, host_tt_log_norm)
    from xerus_tpu_torch.ops import round_kernels as rk
    host = bench_round_instance(10, 2, 16, SEED)
    for method in ("gemm_exact", "svd"):
        g = _to_host(rk.tt_round_sweep_segmented(
            list(cores_to_torch(host, dev)), 8, method=method))
        c = _to_host(rk.tt_round_sweep_segmented(
            list(cores_to_torch(host, torch.device("cpu"))), 8,
            method=method))
        lg, lc = host_tt_log_norm(g), host_tt_log_norm(c)
        eg, ec = host_tt_distance(host, g), host_tt_distance(host, c)
        print(f"small rounding d=10 rank 16->8 {method}: card vs CPU "
              f"log-norm {lg:.9f} vs {lc:.9f}, truncation error {eg:.9e} vs "
              f"{ec:.9e} (bars 1e-5 and 1e-3 relative)")
        if not (abs(lg - lc) <= 1e-5 * abs(lc) and abs(eg - ec) <= 1e-3 * ec):
            raise AssertionError(f"card and CPU disagree on the small "
                                 f"{method} rounding")


def phase_round_slice(dev):
    """The rounding path at full width, counted and checked: gemm_exact
    and svd on the random and the cliff instance, randomized cholqr1 on
    the random one; one warm-up rounding each, then the counted one."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          cliff_instance, cpu_round_sweep,
                                          host_tt_log_norm)
    from xerus_tpu_torch.ops import gemm_exact as ge
    from xerus_tpu_torch.ops import round_kernels as rk
    host = bench_round_instance(ROUND_D, ROUND_N, ROUND_RANK, SEED)
    shapes = [c.shape for c in host]
    flops = {"det": rk.round_flops(shapes, ROUND_TARGET),
             "randomized": rk.randomized_round_flops(shapes, ROUND_TARGET,
                                                     OVERSAMPLE)}
    k2_launches = 0
    for inst, cs in (("random", host), ("cliff", cliff_instance(host))):
        t0 = time.perf_counter()
        ref = host_tt_log_norm(cpu_round_sweep(cs, ROUND_TARGET))
        print(f"round {inst}: f64 LAPACK chain log-norm {ref:.9f} "
              f"({time.perf_counter() - t0:.2f} s on the host)")
        cores = list(cores_to_torch(cs, dev))
        lnorm = {}
        methods = ("gemm_exact", "svd") + (("randomized",)
                                           if inst == "random" else ())
        for method in methods:
            _round(method, cores)
            torch.cuda.synchronize()
            ge.reset_counters()
            reads0 = rk.host_bool.reads
            t0 = time.perf_counter()
            out = _round(method, cores)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ge.gemm_exact_kernel.launches
            reads = rk.host_bool.reads - reads0
            cnt = {k: getattr(ge.trunc_step_gemm_exact, k)
                   for k in ("calls", "svd_fallbacks", "lq_finishes",
                             "outer_iters", "ns_iters", "grid_syncs")}
            t0 = time.perf_counter()
            _round(method, cores)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            h = _to_host(out)
            if not all(np.all(np.isfinite(c)) for c in h):
                raise AssertionError(f"round {inst} {method}: non-finite")
            if max(c.shape[2] for c in h[:-1]) > ROUND_TARGET:
                raise AssertionError(f"round {inst} {method}: rank above "
                                     f"{ROUND_TARGET}")
            lnorm[method] = host_tt_log_norm(h)
            rel = abs(lnorm[method] - ref) / abs(ref)
            fl = flops["randomized" if method == "randomized" else "det"]
            print(f"round {inst} {method} d={ROUND_D} rank {ROUND_RANK}->"
                  f"{ROUND_TARGET}: wall {wall:.4f} s / {wall2:.4f} s (two "
                  f"runs after a warm-up), {fl / min(wall, wall2) / 1e12:.4f} "
                  f"TFLOP/s by the analytic count, f32-vs-f64 log-norm rel "
                  f"err {rel:.3e}, K2 launches {launches}, host flag reads "
                  f"{reads} + {launches} K2 flag reads, gemm_exact {cnt}")
            if method == "gemm_exact":
                k2_launches += launches
                if launches != EXPECTED_K2_LAUNCHES:
                    raise AssertionError(
                        f"K2 launched {launches} times in the {inst} "
                        f"rounding, expected {EXPECTED_K2_LAUNCHES}")
            if method != "randomized" and not rel <= ROUND_F64_BAR:
                raise AssertionError(f"round {inst} {method}: log-norm rel "
                                     f"err {rel:.3e} above {ROUND_F64_BAR:g}")
        d_ge = abs(lnorm["gemm_exact"] - lnorm["svd"]) / abs(lnorm["svd"])
        print(f"round {inst}: gemm_exact vs svd log-norm rel diff "
              f"{d_ge:.3e} (bar {GE_VS_SVD_BAR:g})")
        if not d_ge <= GE_VS_SVD_BAR:
            raise AssertionError(f"round {inst}: gemm_exact and svd differ")
        if "randomized" in lnorm:
            above = (lnorm["randomized"] - lnorm["svd"]) / abs(lnorm["svd"])
            print(f"round {inst}: randomized log-norm above svd's by "
                  f"{above:.3e} relative (bar {RAND_VS_SVD_BAR:g})")
            if not above <= RAND_VS_SVD_BAR:
                raise AssertionError("randomized rounding log-norm above "
                                     "the svd chain's")
    return k2_launches


def phase_round_breakdown(dev):
    """Where a gemm_exact rounding's time goes: the Newton-Schulz QR sweep
    alone, then the whole rounding."""
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import bench_round_instance
    from xerus_tpu_torch.ops import round_kernels as rk
    cores = list(cores_to_torch(bench_round_instance(
        ROUND_D, ROUND_N, ROUND_RANK, SEED), dev))
    for name, fn in (("ns QR sweep alone",
                      lambda: rk._qr_sweep_segmented(cores, 3, "ns")),
                     ("cholqr QR sweep alone (svd path)",
                      lambda: rk._qr_sweep_segmented(cores, 3, "cholqr")),
                     ("gemm_exact rounding",
                      lambda: _round("gemm_exact", cores))):
        reads0 = rk.host_bool.reads
        ms = _wall_ms(fn)
        print(f"breakdown: {name} {ms:.2f} ms wall (median of 3), "
              f"{(rk.host_bool.reads - reads0) // 4} host reads per run")


def _k3_inputs(dims, ranks, M, dtype, dev, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rs = [1] + list(ranks) + [1]
    host = [rng.standard_normal((rs[k], n, rs[k + 1])) / np.sqrt(rs[k])
            for k, n in enumerate(dims)]
    P = np.stack([rng.integers(0, n, size=M) for n in dims],
                 axis=1).reshape(M, len(dims)).astype(np.int64)
    cores = [torch.tensor(c, dtype=dtype, device=dev) for c in host]
    return host, P, cores, torch.tensor(P, device=dev)


def _host_eval(host, P):
    """The TT at the positions in float64 numpy."""
    import numpy as np
    F = np.ones((P.shape[0], 1))
    for k, c in enumerate(host):
        F = np.einsum("ma,amb->mb", F, np.asarray(c, np.float64)[:, P[:, k], :])
    return F[:, 0]


def phase_k3(dev):
    """K3 against its plain version and a float64 numpy contraction on the
    card, f64 and f32, at the completion slice's shape and the edge cases;
    one launch per call; times over all 4^10 entries at the slice's
    shape."""
    import numpy as np
    import torch
    from xerus_tpu_torch.examples import full_grid_positions
    from xerus_tpu_torch.ops import tt_eval as te
    max_abs = 0.0
    for name, dims, ranks, M in K3_CASES:
        for dtype in (torch.float64, torch.float32):
            host, P, cores, pos = _k3_inputs(dims, ranks, M, dtype, dev,
                                             SEED + M)
            launches0 = te.tt_eval_at_points.launches
            kern = te.tt_eval_at_points(cores, pos)
            torch.cuda.synchronize()
            launched = te.tt_eval_at_points.launches - launches0
            plain = te.tt_eval_at_points_reference(cores, pos)
            exact = _host_eval(host, P)
            k64 = kern.double().cpu().numpy()
            scale = float(np.abs(exact).max()) if M else 1.0
            diff = float((kern - plain).abs().max()) if M else 0.0
            err = float(np.abs(k64 - exact).max()) if M else 0.0
            bar = K3_RTOL[str(dtype).split(".")[1]]
            max_abs = max(max_abs, diff)
            print(f"K3 tt_eval {name} d={len(dims)} n={max(dims)} "
                  f"r={max(ranks)} M={M} {dtype}: max |kernel - plain| "
                  f"{diff:.3e}, max |kernel - f64| {err:.3e}, max |f64| "
                  f"{scale:.3e} (bar {bar:g} relative), launches {launched}")
            if not (kern.shape == (M,) and launched == 1
                    and diff <= bar * scale and err <= bar * scale):
                raise AssertionError(f"K3 {name} {dtype}: kernel disagrees "
                                     "or did not launch once")
    dims, ranks = K3_CASES[0][1], K3_CASES[0][2]
    _h, _P, cores, _pos = _k3_inputs(dims, ranks, 1, torch.float64, dev, SEED)
    grid = torch.from_numpy(full_grid_positions(dims)).to(dev)
    timing = {"ms": _time_ms(lambda: te._launch(cores, grid), reps=20),
              "plain_ms": _time_ms(
                  lambda: te.tt_eval_at_points_reference(cores, grid),
                  reps=20)}
    print(f"K3 tt_eval time over all {grid.shape[0]} entries (d=10, n=4, "
          f"r=8, f64): kernel {timing['ms']:.4f} ms (padding the cores "
          f"included), plain {timing['plain_ms']:.4f} ms (CUDA events, "
          f"median of 20 queued calls after 5 warm-up calls)")
    return max_abs, timing


def _adf(inst, dev, max_iterations):
    import torch
    from xerus_tpu_torch.algorithms import ADFVariant
    from xerus_tpu_torch.convert import cores_to_torch
    return ADFVariant(max_iterations, COMPLETION_TARGET, 0.9999)(
        list(cores_to_torch(inst.start, dev, torch.float64)),
        inst.measurements, max_ranks=inst.max_ranks, check_every="device")


def phase_completion_small(dev):
    """Benchmark workload 5 (d=5, n=4, rank 3, 400 samples) on the card and
    on the CPU, where the plain versions run: both below the target at
    ranks [3, 3, 3, 3], the largest entry found exactly, and the two
    recovered tensors alike."""
    import numpy as np
    import torch
    from xerus_tpu_torch.algorithms import find_largest_entry
    from xerus_tpu_torch.examples import host_full_tensor, workload5_instance
    full = {}
    for name, device in (("card", dev), ("CPU", torch.device("cpu"))):
        inst = workload5_instance()
        t0 = time.perf_counter()
        out = _adf(inst, device, 400)
        pos = find_largest_entry(out.cores, accuracy=0.05)
        wall = time.perf_counter() - t0
        h = [c.cpu().numpy() for c in out.cores]
        arr = np.abs(host_full_tensor(h))
        frac = float(arr[pos] / arr.max())
        test = inst.measurements.test(out.cores)
        full[name] = host_full_tensor(h)
        print(f"completion workload 5 on the {name}: sample residual "
              f"{out.residual:.3e} (target {COMPLETION_TARGET:g}), test "
              f"{test:.3e}, {out.iterations} iterations, ranks {out.ranks}, "
              f"largest entry {pos}, found_entry_frac_of_max {frac}, wall "
              f"{wall:.3f} s")
        if not (out.residual < COMPLETION_TARGET and out.ranks == [3] * 4
                and frac == 1.0):
            raise AssertionError(f"workload 5 on the {name} misses a bar")
    rel = (np.linalg.norm(full["card"] - full["CPU"])
           / np.linalg.norm(full["CPU"]))
    print(f"completion workload 5: card vs CPU recovered tensor rel diff "
          f"{rel:.3e} (bar 1e-6)")
    if not rel <= 1e-6:
        raise AssertionError("card and CPU disagree on workload 5")


def phase_completion_slice(dev):
    """The completion path at full width, counted and checked: K3 measures
    the truth at the 20,000 samples, the rank-adaptive ADF solve recovers
    the TT, K3 tests it on the samples and evaluates it and the truth on
    all 4^10 entries."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (completion_instance,
                                          full_grid_positions,
                                          host_full_tensor)
    from xerus_tpu_torch.ops import round_kernels as rk
    from xerus_tpu_torch.ops import tt_eval as te
    inst = completion_instance()
    ms = inst.measurements
    cpu_values = ms.measuredValues.copy()
    truth = list(cores_to_torch(inst.truth, dev, torch.float64))
    dims = [c.shape[1] for c in truth]
    grid = torch.from_numpy(full_grid_positions(dims)).to(dev)
    torch.cuda.synchronize()
    te.reset_counters()
    reads0 = rk.host_bool.reads
    ms.measure(truth)
    t0 = time.perf_counter()
    out = _adf(inst, dev, 2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    test = ms.test(out.cores)
    x_grid = te.tt_eval_at_points(out.cores, grid)
    t_grid = te.tt_eval_at_points(truth, grid)
    torch.cuda.synchronize()
    launches = te.tt_eval_at_points.launches
    reads = rk.host_bool.reads - reads0
    xg, tg = x_grid.cpu().numpy(), t_grid.cpu().numpy()
    grid_err = float(np.linalg.norm(xg - tg) / np.linalg.norm(tg))
    hx = host_full_tensor([c.cpu().numpy() for c in out.cores])
    ht = host_full_tensor(inst.truth)
    host_err = float(np.linalg.norm(hx - ht) / np.linalg.norm(ht))
    k3_vs_host = max(float(np.abs(xg - hx).max() / np.abs(hx).max()),
                     float(np.abs(tg - ht).max() / np.abs(ht).max()))
    meas_diff = float(np.abs(ms.measuredValues - cpu_values).max())
    res_bar = max(COMPLETION_TARGET, 10 * JAX_D10_RESIDUAL)
    err_bar = max(COMPLETION_TARGET, 10 * JAX_D10_GRID_ERR)
    print(f"completion slice d=10 n=4 rank 8, 20000 samples: sample "
          f"residual {out.residual:.3e} (bar {res_bar:g}; JAX on the CPU "
          f"{JAX_D10_RESIDUAL:.3e}), test {test:.3e}, full-grid rel err "
          f"{grid_err:.3e} (host f64 {host_err:.3e}; bar {err_bar:g}; JAX "
          f"{JAX_D10_GRID_ERR:.3e}), {out.iterations} iterations, ranks "
          f"{out.ranks}, host reads {reads}, solve wall {wall:.3f} s, K3 "
          f"launches {launches}; K3 vs host f64 on the grid {k3_vs_host:.3e} "
          f"(bar 1e-12), card vs CPU measured values {meas_diff:.3e}")
    if not (all(np.isfinite(xg)) and xg.shape == (4 ** 10,)
            and out.residual <= res_bar and test <= res_bar
            and grid_err <= err_bar and k3_vs_host <= 1e-12
            and abs(grid_err - host_err) <= 1e-12 * max(host_err, 1e-300)
            + 1e-15 and meas_diff <= 1e-12):
        raise AssertionError("the completion slice misses a bar")
    if launches != EXPECTED_K3_LAUNCHES:
        raise AssertionError(f"K3 launched {launches} times in the "
                             f"completion path, expected "
                             f"{EXPECTED_K3_LAUNCHES}")
    return launches


def phase_iht(dev):
    """IHT at workload 5's size on the card (K3 once per iteration and once
    per step-size trial) against the same on the CPU."""
    import numpy as np
    import torch
    from xerus_tpu_torch.algorithms import IHT
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import workload5_instance
    from xerus_tpu_torch.examples.completion import random_tt
    from xerus_tpu_torch.ops import tt_eval as te
    inst = workload5_instance()
    start = random_tt([4] * 5, 3, np.random.default_rng(SEED))
    start[0] = start[0] / np.linalg.norm(start[0])   # unit norm
    res = {}
    for name, device in (("card", dev), ("CPU", torch.device("cpu"))):
        x0 = list(cores_to_torch(start, device, torch.float64))
        te.reset_counters()
        t0 = time.perf_counter()
        _x, res[name] = IHT(x0, inst.measurements, IHT_ITERATIONS)
        wall = time.perf_counter() - t0
        print(f"IHT workload 5 on the {name}: {IHT_ITERATIONS} iterations "
              f"from a random unit-norm rank-3 TT, residual "
              f"{res[name]:.9e}, K3 launches "
              f"{te.tt_eval_at_points.launches}, wall {wall:.3f} s")
        if name == "card" and te.tt_eval_at_points.launches != 8 * IHT_ITERATIONS:
            raise AssertionError("IHT did not evaluate through K3 once per "
                                 "iteration and step-size trial")
    if not abs(res["card"] - res["CPU"]) <= 1e-8 * res["CPU"]:
        raise AssertionError("card and CPU disagree on IHT")


def main():
    sys.path.insert(0, HERE)
    phase_environment()
    import torch
    import xerus_tpu_torch
    dev = xerus_tpu_torch.cuda_device()
    phase_build()
    k1_max_abs, k1_timing = phase_kernels(dev)
    k2_max_abs, k2_timing = phase_k2(dev)
    k3_max_abs, k3_timing = phase_k3(dev)
    phase_small_agreement(dev)
    phase_small_rounding(dev)
    phase_completion_small(dev)
    k1_launches = phase_slice(dev)
    k2_launches = phase_round_slice(dev)
    k3_launches = phase_completion_slice(dev)
    phase_iht(dev)
    phase_breakdown(dev)
    phase_round_breakdown(dev)
    print(json.dumps({"kernels": [
        {"name": "df_matvec", "route": "cuda",
         "source": "xerus_tpu_torch/csrc/df_matvec.cu",
         "replaces": "xerus_tpu/ops/pallas_df.py:60",
         "launches": k1_launches, "max_abs_err": k1_max_abs,
         "ms": k1_timing["ms"], "plain_ms": k1_timing["plain_ms"]},
        {"name": "gemm_exact", "route": "cuda",
         "source": "xerus_tpu_torch/csrc/gemm_exact.cu",
         "replaces": "xerus_tpu/ops/tt_kernels.py:1232",
         "launches": k2_launches, "max_abs_err": k2_max_abs,
         "ms": k2_timing["ms"], "plain_ms": k2_timing["plain_ms"]},
        {"name": "tt_eval", "route": "cuda",
         "source": "xerus_tpu_torch/csrc/tt_eval.cu",
         "replaces": "xerus_tpu/ops/pallas_tt_eval.py:45",
         "launches": k3_launches, "max_abs_err": k3_max_abs,
         "ms": k3_timing["ms"], "plain_ms": k3_timing["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
