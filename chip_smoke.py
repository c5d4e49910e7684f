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
zeroed just before the path and read just after; K2's bonds on its cluster
route), and that a small solve and a small rounding on the card agree with
the same on the CPU.  Beside each kernel's time it prints its bound (bytes
over the HBM rate or operations over the FP32/FP64 rate, whichever is
larger; K2's operations from its flags) and, for K2, the time of
torch.linalg.svd(driver="gesvd") on the same bond.

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
# K2's f64 case on the cluster route, then shapes past one cluster's shared
# memory, which take the grid route: (kind, B, M, keep, keep_cap, dtype)
K2_F64_CASE = ("generic", 40, 24, 5, 8, "float64")
K2_GRID_CASES = [("cliff", 512, 1024, 256, 256, "float32"),
                 ("generic", 264, 200, 8, 8, "float64")]

# completion: K3 against its plain version, (name, dims, ranks, M, route):
# the slice's shape with few and many measurements (one run per site, merged
# runs), ragged ranks and modes, n = 3 and 5, M = 0, 1, one tile and one
# either side of it, prime M, an odd d whose positions start 8 bytes off a
# 16-byte boundary (plain loads instead of bulk copies), tables between 48
# and 227 KB, the R = 16 and R = 32 instantiations, 24 sites, tables that
# leave no room beside the ring for the build's scratch (no fetch under the
# build), and the shapes that leave the shared-memory route: ranks above 32
# (frontier in device memory) and more sites than the by-value table holds
# (frontier in registers, at both capacities)
K3_SLICE_RANKS = [4] + [8] * 7 + [4]
K3_CASES = [("slice", [4] * 10, K3_SLICE_RANKS, 20_000, "tables"),
            ("slice, merged runs", [4] * 10, K3_SLICE_RANKS, 300_007,
             "tables"),
            ("ragged", [2, 5, 3, 4], [2, 4, 3], 17, "tables"),
            ("tail", [3] * 4, [2] * 3, 13, "tables"),
            ("empty", [3] * 4, [2] * 3, 0, "tables"),
            ("one", [3] * 4, [2] * 3, 1, "tables"),
            ("tile - 1", [4] * 5, [3] * 4, 31, "tables"),
            ("tile", [4] * 5, [3] * 4, 32, "tables"),
            ("tile + 1", [4] * 5, [3] * 4, 33, "tables"),
            ("n=3, prime M", [3] * 7, [5] * 6, 100_003, "tables"),
            ("n=5, ragged ranks, prime M", [5] * 7, [3, 7, 8, 8, 5, 2],
             65_537, "tables"),
            ("odd d, 8-byte aligned positions", [4] * 5, [3] * 4, 401,
             "tables"),
            ("stack 82 KB", [4] * 10, [16] * 9, 20_000, "tables"),
            ("rank 32", [4] * 6, [32] * 5, 5_000, "tables"),
            ("long chain, scratch inside the ring", [2] * 24, [2] * 23,
             200_000, "tables"),
            ("12 sites", [4] * 12, [8] * 11, 300_001, "tables"),
            ("rank 16, merged runs", [4] * 10, [16] * 9, 500_000, "tables"),
            ("rank 160", [2] * 3, [160, 160], 50, "device"),
            ("d past the table", [2] * 40, [2] * 39, 1_000, "device"),
            ("d past the table, rank 12", [3] * 26, [12] * 25, 5_000,
             "device")]
K3_ROUTES = {"tables": "shared-memory tables",
             "device": "device-memory cores"}
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

# NVIDIA's H100 SXM data sheet: HBM rate, FP32 and FP64 rates without
# tensor cores; a kernel's bound is the larger of its bytes (each input
# read once, each output written once) over the first and its operations
# over the rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# K1's FP32 operations per matrix element: df_mul (3 multiplies, 1 FMA
# counted 2, 2 adds, fast_two_sum's 3) and df_add (two_sum's 6, 2 adds,
# fast_two_sum's 3), csrc/df_matvec.cu
K1_OPS_PER_ELEMENT = 21


def _bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            timing["bound_ms"], timing["bound_by"] = _bound(
                (2 * m * k + 2 * k + 2 * m) * 4,
                K1_OPS_PER_ELEMENT * m * k, "float32")
            timing["library_ms"] = None   # no PyTorch call computes a df product
            print(f"K1 df_matvec ({m}, {k}) time: kernel "
                  f"{timing['ms'] * 1e3:.2f} us ({gbps:.0f} GB/s of A), plain "
                  f"{timing['plain_ms'] * 1e3:.2f} us (CUDA events, median "
                  f"of 50 queued calls after 5 warm-up calls); bound "
                  f"{timing['bound_ms'] * 1e3:.2f} us by {timing['bound_by']}"
                  f", {timing['bound_ms'] / timing['ms']:.1%} of it reached")
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
        info = dict(zip(ge.FLAGS, flags.tolist()))
        info["okp"], info["converged"] = (bool(info["okp"]),
                                          bool(info["converged"]))
    else:
        ns0, rows0 = ge._gemm_exact_body.ns_iters, ge._gemm_exact_body.ns_row_iters
        vt0, vt_bal, okp_t, conv_t, it = ge._gemm_exact_body(
            cur, mask, *ge._gemm_exact_tuning(cur.dtype))
        info = dict(okp=bool(okp_t), converged=bool(conv_t), outer=it,
                    ns=ge._gemm_exact_body.ns_iters - ns0,
                    ns_rows=ge._gemm_exact_body.ns_row_iters - rows0)
    return ge._finish_gemm_exact(vt0, vt_bal, info["okp"], mask), info


def _trunc_err(cur, vt):
    """||cur - cur vt^T vt||^2 / ||cur||^2 in float64."""
    c, v = cur.double(), vt.double()
    return float(((c - (c @ v.T) @ v).norm() ** 2 / c.norm() ** 2).item())


def _k2_check(kind, B, M, keep, cap, dtype, dev, seed):
    """One K2 case on the card against its plain version: f32 within
    K2_ERR_TOL of the plain version's truncation error, f64 both within
    K2_F64_RTOL of the SVD's; both certified, two repeat launches bitwise
    equal, and the flags' route the one gemm_exact_route chose before the
    launch.  Returns (input, |kernel - plain| truncation error, kernel
    flags)."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    A = _k2_input(kind, B, M, keep, seed)
    cur = torch.tensor(A, dtype=getattr(torch, dtype), device=dev)
    vk, fk = _k2_run(cur, keep, cap, True)
    vp, fp = _k2_run(cur, keep, cap, False)
    ek, ep = _trunc_err(cur, vk), _trunc_err(cur, vp)
    a = ge.gemm_exact_kernel(cur, keep, cap)
    b = ge.gemm_exact_kernel(cur, keep, cap)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    route = ge.gemm_exact_route(B, M, cap, cur.dtype)
    diff = abs(ek - ep)
    if dtype == "float32":
        agree = diff < K2_ERR_TOL
        bars = f"|diff| {diff:.3e}, bar {K2_ERR_TOL:g}"
    else:
        s = np.linalg.svd(A, compute_uv=False)
        e_svd = float(np.sum(s[keep:] ** 2) / np.sum(s ** 2))
        agree = (abs(ek - e_svd) <= K2_F64_RTOL * e_svd
                 and abs(ep - e_svd) <= K2_F64_RTOL * e_svd)
        bars = f"svd {e_svd:.15e}, rtol bar {K2_F64_RTOL:g}"
    print(f"K2 gemm_exact {kind} ({B}, {M}) keep {keep} cap {cap} "
          f"{dtype}: {'cluster' if route else 'grid'} route; trunc err "
          f"kernel {ek:.15e} plain {ep:.15e} ({bars}); kernel {fk}; plain "
          f"{fp}; repeat launches bitwise equal: {same}")
    if not (agree and same and fk["converged"] and fp["converged"]):
        raise AssertionError(f"K2 {kind} ({B}, {M}) {dtype}: kernel and "
                             "plain disagree, did not certify, or repeat "
                             "differs")
    if fk["cluster_ctas"] != route:
        raise AssertionError(f"K2 {kind} ({B}, {M}) {dtype}: the flags "
                             f"report {fk['cluster_ctas']} CTAs per cluster,"
                             f" gemm_exact_route chose {route}")
    return cur, diff, fk


def phase_k2(dev):
    """K2 against its plain version on the card: the reference's three
    kinds and the slice's bond shape in f32, one small f64 case against
    the SVD, and an f32 and an f64 shape past one cluster (grid route);
    bitwise repeat launches; at the slice's shape the cluster route, the
    kernel's time beside its bound (FLOPs from its flags), the plain
    version's and the gesvd call's."""
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    max_abs = 0.0
    timing = {}
    for kind, B, M, keep, cap in K2_CASES:
        cur, diff, fk = _k2_check(kind, B, M, keep, cap, "float32", dev,
                                  SEED + B + M)
        max_abs = max(max_abs, diff)
        if kind == "slice":
            if not fk["cluster_ctas"]:
                raise AssertionError("K2 slice bond did not take the "
                                     "cluster route")
            timing["ms"] = _time_ms(lambda: ge.gemm_exact_kernel(cur, keep,
                                                                 cap),
                                    reps=20, warmup=2)
            timing["plain_ms"] = _wall_ms(lambda: _k2_run(cur, keep, cap,
                                                          False))
            timing["library_ms"] = _time_ms(
                lambda: torch.linalg.svd(cur, full_matrices=False,
                                         driver="gesvd"), reps=20, warmup=2)
            flops = ge.gemm_exact_flops(B, M, cap, fk["outer"], fk["ns"],
                                        fk["ns_rows"],
                                        ge._gemm_exact_tuning(cur.dtype)[2])
            timing["bound_ms"], timing["bound_by"] = _bound(
                (B * M + 2 * cap * M) * 4, flops, "float32")
            print(f"K2 gemm_exact slice ({B}, {M}) time: kernel "
                  f"{timing['ms']:.3f} ms (CUDA events, median of 20 queued "
                  f"launches after 2 warm-up launches), plain "
                  f"{timing['plain_ms']:.3f} ms (host wall clock around "
                  f"torch.cuda.synchronize(), median of 3; it reads its loop "
                  f"conditions to the host), torch.linalg.svd(driver="
                  f"'gesvd') {timing['library_ms']:.3f} ms (CUDA events, "
                  f"median of 20)")
            print(f"K2 gemm_exact slice: route cluster of "
                  f"{fk['cluster_ctas']} CTAs, {fk['barriers']} cluster "
                  f"barriers, {fk['outer']} outer and {fk['ns']} Newton-"
                  f"Schulz steps ({fk['ns_rows']} in the row polar); "
                  f"{flops / 1e9:.3f} GFLOP by gemm_exact_flops, bound "
                  f"{timing['bound_ms']:.4f} ms by {timing['bound_by']} "
                  f"(FP32 67 TFLOP/s), {timing['bound_ms'] / timing['ms']:.2%}"
                  f" of it reached, {flops / timing['ms'] / 1e9:.3f} TFLOP/s")
    _k2_check(*K2_F64_CASE, dev, SEED)
    for kind, B, M, keep, cap, dtype in K2_GRID_CASES:
        _cur, diff, fk = _k2_check(kind, B, M, keep, cap, dtype, dev,
                                   SEED + B + M)
        if fk["cluster_ctas"]:
            raise AssertionError(f"K2 {kind} ({B}, {M}) {dtype} took the "
                                 "cluster route, expected the grid route")
        if dtype == "float32":
            max_abs = max(max_abs, diff)
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
        lnorm, walls = {}, {}
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
                   for k in ge.TRUNC_COUNTERS}
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
            walls[method] = min(wall, wall2)
            if method == "gemm_exact":
                k2_launches += launches
                if launches != EXPECTED_K2_LAUNCHES:
                    raise AssertionError(
                        f"K2 launched {launches} times in the {inst} "
                        f"rounding, expected {EXPECTED_K2_LAUNCHES}")
                if cnt["cluster_bonds"] != launches:
                    raise AssertionError(f"{inst} rounding: only "
                                         f"{cnt['cluster_bonds']} of "
                                         f"{launches} K2 bonds took the "
                                         "cluster route")
                if cnt["svd_fallbacks"]:
                    raise AssertionError(f"{inst} rounding: "
                                         f"{cnt['svd_fallbacks']} K2 bonds "
                                         "did not certify and took the SVD "
                                         "fallback")
            if method != "randomized" and not rel <= ROUND_F64_BAR:
                raise AssertionError(f"round {inst} {method}: log-norm rel "
                                     f"err {rel:.3e} above {ROUND_F64_BAR:g}")
        d_ge = abs(lnorm["gemm_exact"] - lnorm["svd"]) / abs(lnorm["svd"])
        print(f"round {inst}: gemm_exact vs svd log-norm rel diff "
              f"{d_ge:.3e} (bar {GE_VS_SVD_BAR:g}); wall gemm_exact "
              f"{walls['gemm_exact']:.4f} s vs svd {walls['svd']:.4f} s "
              f"(the faster of the two timed runs each)")
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


def _k2_bond_times(cores):
    """K2's device time in one gemm_exact rounding: CUDA events around each
    call of the wrapper (its output allocation and flag fill included,
    a few us), with each bond's shape, column bucket and flags."""
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    kernel = ge.gemm_exact_kernel
    bonds = []

    def timed(cur, keep, cap):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = kernel(cur, keep, cap)
        end.record()
        bonds.append((tuple(cur.shape), cap, start, end, out[2]))
        return out

    # the wrapper counts its launches on whatever the module's name holds
    timed.launches = kernel.launches
    torch.cuda.synchronize()
    ge.gemm_exact_kernel = timed
    try:
        _round("gemm_exact", cores)
    finally:
        ge.gemm_exact_kernel = kernel
    torch.cuda.synchronize()
    return [((B, M), cap, start.elapsed_time(end),
             dict(zip(ge.FLAGS, flags.tolist())))
            for (B, M), cap, start, end, flags in bonds]


def phase_round_breakdown(dev):
    """Where a gemm_exact rounding's time goes: K2's device time bond by
    bond beside its bound, the Newton-Schulz QR sweep alone, then the
    whole rounding."""
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import bench_round_instance
    from xerus_tpu_torch.ops import gemm_exact as ge
    from xerus_tpu_torch.ops import round_kernels as rk
    cores = list(cores_to_torch(bench_round_instance(
        ROUND_D, ROUND_N, ROUND_RANK, SEED), dev))
    polish = ge._gemm_exact_tuning(torch.float32)[2]
    total = bound = 0.0
    bonds = _k2_bond_times(cores)
    for n, ((B, M), cap, ms, f) in enumerate(bonds):
        b_ms, _by = _bound((B * M + 2 * cap * M) * 4, ge.gemm_exact_flops(
            B, M, cap, f["outer"], f["ns"], f["ns_rows"], polish), "float32")
        total, bound = total + ms, bound + b_ms
        print(f"breakdown: K2 bond {n} ({B}, {M}) cap {cap}: {ms:.3f} ms, "
              f"bound {b_ms:.4f} ms; outer {f['outer']}, Newton-Schulz "
              f"{f['ns']}, certified {f['converged']}, CTAs per cluster "
              f"{f['cluster_ctas']}")
    times = sorted(ms for _s, _c, ms, _f in bonds)
    print(f"breakdown: K2 device time per gemm_exact rounding (random "
          f"instance): {total:.3f} ms over {len(bonds)} launches (CUDA "
          f"events around each wrapper call), per bond {times[0]:.3f} to "
          f"{times[-1]:.3f} ms, median {statistics.median(times):.3f}; "
          f"bound {bound:.3f} ms, sum over the launches of (time - bound) "
          f"{total - bound:.3f} ms")
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


def _k3_inputs(dims, ranks, M, dtype, dev, seed, off_boundary=False):
    """Cores and positions from a seed; ``off_boundary``: the positions are
    rows 1.. of a larger array, 8 bytes off a 16-byte boundary for odd d."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rs = [1] + list(ranks) + [1]
    host = [rng.standard_normal((rs[k], n, rs[k + 1])) / np.sqrt(rs[k])
            for k, n in enumerate(dims)]
    P = np.stack([rng.integers(0, n, size=M) for n in dims],
                 axis=1).reshape(M, len(dims)).astype(np.int64)
    cores = [torch.tensor(c, dtype=dtype, device=dev) for c in host]
    if off_boundary:
        pos = torch.zeros((M + 1, len(dims)), dtype=torch.int64,
                          device=dev)[1:]
        pos.copy_(torch.tensor(P))
        if pos.data_ptr() % 16 != 8:
            raise AssertionError("the view is not 8 bytes off a boundary")
    else:
        pos = torch.tensor(P, device=dev)
    return host, P, cores, pos


def _host_eval(host, P):
    """The TT at the positions in float64 numpy."""
    import numpy as np
    F = np.ones((P.shape[0], 1))
    for k, c in enumerate(host):
        F = np.einsum("ma,amb->mb", F, np.asarray(c, np.float64)[:, P[:, k], :])
    return F[:, 0]


def _k3_bound(plan, dims, ranks, n_pts, dtype):
    """K3's bound over n_pts measurements: positions and values moved once
    and the cores read once, against the FMAs of the evaluation the launch
    plan runs: the core elements one measurement multiplies, and every
    block's table build.  Returns (FMAs per entry, (bound_ms, bound_by))."""
    size = 8 if dtype == "float64" else 4
    rs = [1] + list(ranks) + [1]
    d = len(dims)
    build = plan.blocks * sum(st.rows * st.rl_k * st.core_row
                              for st in plan.steps)
    core_bytes = sum(rs[k] * dims[k] * rs[k + 1] for k in range(d)) * size
    return plan.loads_per_entry, _bound(
        n_pts * d * 8 + n_pts * size + core_bytes,
        2 * (plan.loads_per_entry * n_pts + build), dtype)


def _k3_bad_index(dev):
    """An index outside its site's own mode size, in the last, partial tile:
    NaN there and nowhere else, counted exactly, and the wrapper raises;
    input the wrapper rejects before a launch changes no launch count."""
    import torch
    from xerus_tpu_torch.ops import tt_eval as te
    dims, ranks, M = [2, 5, 3, 4], [2, 4, 3], 32 * 3 + 5
    for dtype in (torch.float64, torch.float32):
        _h, _P, cores, pos = _k3_inputs(dims, ranks, M, dtype, dev, SEED)
        good = te.tt_eval_at_points(cores, pos)
        bad_pos = pos.clone()
        bad_pos[M - 2, 0] = 2      # inside the largest mode, outside site 0's
        bad_pos[M - 4, 2] = -1
        bad_pos[M - 1, 1] = 5
        bad_pos[M - 1, 3] = 4      # two in one measurement count once
        out, bad = te._launch(cores, bad_pos)
        rows = torch.tensor([M - 4, M - 2, M - 1], device=dev)
        keep = torch.ones(M, dtype=torch.bool, device=dev)
        keep[rows] = False
        launches0 = te.tt_eval_at_points.launches
        raised = False
        try:
            te.tt_eval_at_points(cores, bad_pos)
        except ValueError as exc:
            raised = "3 of" in str(exc)
        launched = te.tt_eval_at_points.launches - launches0
        rejected = 0
        for args in ((cores, pos.int()), ([c.half() for c in cores], pos)):
            try:
                te.tt_eval_at_points(*args)
            except TypeError:
                rejected += 1
        quiet = te.tt_eval_at_points.launches - launches0 - launched
        print(f"K3 tt_eval bad indices in the last partial tile {dtype}: "
              f"count {int(bad.sum().item())} (3 expected), NaN at them "
              f"{bool(torch.isnan(out[rows]).all())}, others equal "
              f"{torch.equal(out[keep], good[keep])}, wrapper raised "
              f"{raised} after {launched} launch, {rejected} rejected inputs "
              f"launched {quiet} times")
        if not (int(bad.sum().item()) == 3 and torch.isnan(out[rows]).all()
                and torch.equal(out[keep], good[keep]) and raised
                and launched == 1 and rejected == 2 and quiet == 0):
            raise AssertionError("K3 mishandles out-of-range indices")


def phase_k3(dev):
    """K3 against its plain version and a float64 numpy contraction on the
    card, f64 and f32, at the completion slice's shape and the edge cases:
    one launch per call, a bitwise-equal repeat, the route the plan chose;
    out-of-range indices; times over all 4^10 entries at the slice's shape
    in f64 and f32 beside their bounds; where a call's time goes at the
    three sizes the paths use."""
    import numpy as np
    import torch
    from xerus_tpu_torch.examples import full_grid_positions, k3_split
    from xerus_tpu_torch.ops import tt_eval as te
    max_abs = 0.0
    for name, dims, ranks, M, route in K3_CASES:
        for dtype in (torch.float64, torch.float32):
            host, P, cores, pos = _k3_inputs(dims, ranks, M, dtype, dev,
                                             SEED + M, "8-byte" in name)
            launches0 = te.tt_eval_at_points.launches
            kern = te.tt_eval_at_points(cores, pos)
            torch.cuda.synchronize()
            launched = te.tt_eval_at_points.launches - launches0
            took = te.tt_eval_at_points.route
            same = torch.equal(kern, te.tt_eval_at_points(cores, pos))
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
                  f"{scale:.3e} (bar {bar:g} relative), launches {launched}, "
                  f"repeat bitwise equal: {same}; {took}")
            if not (kern.shape == (M,) and launched == 1 and same
                    and diff <= bar * scale and err <= bar * scale):
                raise AssertionError(f"K3 {name} {dtype}: kernel disagrees, "
                                     "did not launch once or does not repeat")
            plain_loads = "8-byte" in name and "plain loads" not in took
            if not took.startswith(K3_ROUTES[route]) or plain_loads:
                raise AssertionError(f"K3 {name} {dtype}: took '{took}', "
                                     f"expected {K3_ROUTES[route]}")
    _k3_bad_index(dev)
    dims, ranks = K3_CASES[0][1], K3_CASES[0][2]
    grid = torch.from_numpy(full_grid_positions(dims)).to(dev)
    n_pts = grid.shape[0]
    timing = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        _h, _P, cores, _pos = _k3_inputs(dims, ranks, 1, dtype, dev, SEED)
        ms = _time_ms(lambda: te._launch(cores, grid), reps=20)
        plain_ms = _time_ms(
            lambda: te.tt_eval_at_points_reference(cores, grid), reps=20)
        # the timed launch's output against the plain version's
        kern, _bad = te._launch(cores, grid)
        plain = te.tt_eval_at_points_reference(cores, grid)
        diff = float((kern - plain).abs().max())
        scale = float(plain.abs().max())
        max_abs = max(max_abs, diff)
        fmas, (bound_ms, bound_by) = _k3_bound(
            te.plan_launch(cores, grid).plan, dims, ranks, n_pts, name)
        print(f"K3 tt_eval time over all {n_pts} entries (d=10, n=4, r=8, "
              f"{name}): kernel {ms:.4f} ms (the core hand-over included), "
              f"plain {plain_ms:.4f} ms (CUDA events, median of 20 queued "
              f"calls after 5 warm-up calls); max |kernel - plain| "
              f"{diff:.3e} of max |plain| {scale:.3e}; bound {bound_ms:.4f} "
              f"ms by {bound_by} (the plan's {fmas} FMAs per entry and its "
              f"table builds counted), {bound_ms / ms:.1%} of it reached; "
              f"{te.tt_eval_at_points.route}")
        if diff > K3_RTOL[name] * scale:
            raise AssertionError(f"K3 grid {name}: kernel disagrees with "
                                 "its plain version")
        if dtype == torch.float64:
            # no PyTorch call evaluates a TT at points
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    k3_split.print_split(dev)
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
    def entry(name, source, replaces, launches, max_abs, timing):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs, "ms": timing["ms"],
                "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"],
                "bound_by": timing["bound_by"],
                "library_ms": timing["library_ms"]}

    print(json.dumps({"kernels": [
        entry("df_matvec", "xerus_tpu_torch/csrc/df_matvec.cu",
              "xerus_tpu/ops/pallas_df.py:60", k1_launches, k1_max_abs,
              k1_timing),
        entry("gemm_exact", "xerus_tpu_torch/csrc/gemm_exact.cu",
              "xerus_tpu/ops/tt_kernels.py:1232", k2_launches, k2_max_abs,
              k2_timing),
        entry("tt_eval", "xerus_tpu_torch/csrc/tt_eval.cu",
              "xerus_tpu/ops/pallas_tt_eval.py:45", k3_launches, k3_max_abs,
              k3_timing)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
