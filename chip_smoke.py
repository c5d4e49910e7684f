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
  instance of ``bench.py``'s north-star row; kernel K1 (df_matvec) and
  K1q (df_qr: the CGS2 df QR, one launch per call), inside the captured
  programs (``ops/programs.py``: one CUDA graph per half-sweep) that the
  solve replays: its plain version (``eager=True``), a one-shot solve
  (the programs' first calls run eagerly), a second that captures, a
  third that replays and a fourth that replays under torch.profiler, whose
  K1 and K1q kernels counted on the device are the kernels line's
  launches; all held bit for bit, with walls, graph nodes, pool memory
  and the df phase's idle share eager and replayed;
- TT rounding of ``bench.py``'s workload-1 instance (d=32, n=2, rank 256
  -> 128) and its numerically rank-96 "cliff" variant, deterministic
  (gemm_exact and svd truncation) and randomized (cholqr1); kernel K2
  (gemm_exact); the gemm_exact rounding's Newton-Schulz QR sweep in
  chunks of masked steps against its per-step loop (host reads,
  iterations, outputs bit for bit);
- TT rounding past one cluster, at the TPU kernel's reach: the d=32
  rank-512 -> 256 and rank-1024 -> 512 instances, gemm_exact (their 15
  and 13 trunc bonds on K2's grid route, ``csrc/gemm_exact_grid.cuh``)
  and svd against the host f64 chain, K2's time bond by bond beside its
  bound; a bond that does not certify must be the plain version's own
  decision on the card (ROADMAP fault 7);
- the rest of TT rounding on the same instance and its f64 LAPACK chain:
  double-word rounding (``tt_round_df_from_f64``: df CholeskyQR with
  CGS2 fallbacks, whose column loops are K1c (df_chol: the df Cholesky's
  diagonal blocks and panel substitutions) and K1q, each held against its
  plain version on the inputs recorded there, one call per shape; the
  Gram-route df SVD) to 128 and, on a cliff of 1e-9 below f32's
  resolution, with eps 1e-7, each rounding's CGS2 sites listed with K1q's
  deficiency decisions near their threshold held to the plain version's;
  the
  Ozaki split GEMM at bench.py's 512^3 (each slice GEMM bit-exact)
  beside torch.matmul in float64; the kappa=1e10 df Cholesky solve at
  n=1800 and df_svd of one (512, 256) unfolding; the cholqr,
  gram_parallel, subspace_parallel and streaming roundings in f32 and
  f64, and through ``TTTensor.round_fast`` on the card and under
  ``host()``;
- the JAX package's last compiled programs as captured programs
  (``ops/programs.py``): the df rounding's site programs (CGS2 selected on
  the device, each site's df_svd seeded on K4) and ``df_solve_spd_chol``'s
  program at the end of the rounding phase, then ``phase_round_programs``:
  the randomized cholqr1 rounding at rank 256 -> 128 and 1024 -> 512,
  'exact' and 'bf16_frontier', and with Householder panels at rank 256,
  the fused apply + round on slice 2's rank-256 TT, and the SPD half-sweep
  over 10 Poisson systems in one batched program against the loop of
  single sweeps; first-call, eager and replayed walls, idle shares, graph
  nodes and pools, every replay bitwise its eager run, no host read in a
  replay, K4 and K1q counted by kernel name in a replayed df rounding;
- tensor completion: the d=10, n=4, rank-8 instance from 20,000 samples
  (measure, rank-adaptive ADF solve, test, every entry of the recovered TT
  and of the truth; the solve's iteration program replayed and its plain
  loop, walls, ms per iteration and idle shares), benchmark workload 5 on
  the card and on the CPU, and IHT; kernel K3 (tt_eval);
- the object layer in float64 through its public names (no hand kernel:
  torch.matmul and torch.linalg): SVD, QR/RQ/QC/CQ, the Cholesky, LU and
  least-squares solves of ``x(i) << b(j) / A(j, i)``, a contraction and a
  planned chain, sparse x dense on the device, file round trips and the
  gesdd fixture, each object call timed beside the bare torch call, then
  rerun under ``host()`` and held against the card's results;
- the column-pivoted Householder QR (``ops/pivoted_qr.py``, no hand
  kernel) as a captured program at the rank-30 QTT cores' left and right
  splits and at (256, 256), held against its plain run on the CPU and
  each replay bitwise its eager run, timed beside the SVD route; then
  the ``XERUS_TPU_QC_METHOD=qrp`` QC / CQ route through ``move_core`` on
  a d=32 rank-30 TTTensor and its rank-deficient double, held against
  the SVD route (ranks, log-norms, inner products), walls and host syncs;
- the tensor network and the TT classes in float64 through the public
  names: the rounding instance as a ``TTTensor`` rounded by
  ``round_fast(128, "gemm_exact")`` (K2, counted), ``round_fast(128,
  "svd")`` and the object ``round(128)``; the Poisson residual of the
  solve's solution as ``frob_norm(A(i/2, j/2) * x(j&0) - b(i&0))`` in TT
  form; inner products as the TT sweep, through the DSL's planned order
  and as a lazy network on the native path optimizer's order; the TT-SVD
  round trip of the completion truth; a BINARY file round trip; K2's
  float64 bonds beside their bound and float64 gesvd; then the same at
  d=12 on the card and under ``host()``, held against each other;
- the algorithms layer through the public names: the north-star solve by
  ``xt.als_spd_fused`` on the instance's objects (K1, counted) against
  the core-level run, ``xt.ALS_SPD`` in float64 at d=32 rank 30 with its
  residual in TT form, the README's Quick start against a dense solve,
  ALS / ALS_SPD_CG / ASD_SPD / DMRG_SPD / als_spd_mixed at d=8 on the
  card and under ``host()``, completion on ``TTTensor``s (the d=10
  instance through ``xt.ADFVariant`` with K3 counted, workload 5 through
  the host-bump loop, IHT), the largest entry of the d=10 truth against
  its full grid, and UQ-ADF on the card and under ``host()``;
- K4 and K5 (small_eigh, small_svd: Jacobi eigh and SVD in float64,
  ``csrc/jacobi.cu``) against their plain versions and torch.linalg at the
  eigensolver path's shapes and (256, 256), graded splits, a penalized
  Ritz matrix, a rank-deficient split, two cluster sizes and route gmem
  against route cluster bitwise, route gmem past a cluster's shared
  memory against torch.linalg, and K4's route cta against its cluster
  route on one CTA;
- the eigensolver and the rest of the algorithms layer through the public
  names, in float64: workload 4 (the d=32 Heisenberg chain's ground state
  at max_rank 16) by ``xt.smallest_eigenvalue`` with the dense local eigh
  and with the card's default Lanczos sweeps (captured half-sweep
  programs on K4 and K5: no eigh/svd info check, a replay bitwise its
  eager run, K4 and K5 counted by kernel name on the device in a replayed
  solve), against the recorded CPU energy and residual and the JAX
  package's CPU Lanczos energy, then at max_rank 32 and 64 and as a
  4-start race; ``dmrg_groundstate_scan`` with the dense local eigh
  (eager) on the d=6 chain against its exact ground energy;
  ``xt.dmrg_solve`` (its splits on K5), the fused apply + round on
  slice 2's rank-256 TT, the Riemannian kit, SD, CG,
  ``decomposition_als``, ``randomTTSVD`` and the cascade example on the
  card and under ``host()``;
- the sparse QR of the object layer at benchmarks/sparseqr_scale.py's
  largest size (4096 x 2048): random scatter on the dense Heath route
  (its QR on the card, the rank decision held to LAPACK's on the host)
  and a banded pattern on the native Givens route, reconstruction and
  orthonormality bars, each route's wall beside torch.linalg.qr, the
  dense route's card memory, ``xt.calculate_qc`` on the sparse Tensor;
- the rounding speed presets on slice 2's instance and at rank 1024 ->
  512, both with the bf16 study's damping: 'bf16_frontier' (cuBLAS bf16
  GEMMs, counted) within 1.1x of 'exact''s truncation error, the Gram at
  one bf16 pass as the control, torch's TF32 and reduced-precision flags
  still off, walls and TFLOP/s, and ``TTTensor.round_fast(speed=...)``;
- the parallel layer in a one-rank NCCL group: every parallel entry and
  both ``mesh=`` arguments against the serial path
  (``examples/parallel_checks.py``), each wall beside the serial one;
- ``xt.warmup`` last, after every phase whose launches the kernels line
  counts (its calls move the counters): the Poisson family (the f32
  half-sweeps in each ALS solver's call form, the df rounding to 15),
  the rank-256 rounding family (gram, svd, randomized), workload 4's Lanczos
  half-sweep and the d=10 ADF iteration; each entry's cold first call,
  the first call after warmup (a replay with no capture, bitwise the
  steady calls, within 1.2x of their wall) and the programs' held bytes.

It checks the host-f64 residual of the solve, the f32-vs-f64 log-norm
of every rounding and the completion's residuals against the JAX
package's own numbers, that each path went through its kernel (launch counts,
zeroed just before the path and read just after; K2's bonds on its cluster
route), and that a small solve and a small rounding on the card agree with
the same on the CPU; the df column loops once per wrapper call on their
kernels, each route past shared memory bitwise equal to the route it
stands for and held against the plain loop at a size that needs it.
Beside each kernel's time it prints its bound (bytes
over the HBM rate or operations over the FP32/FP64 rate, whichever is
larger; K2's operations from its flags) and, for K2, the time of
torch.linalg.svd(driver="gesvd") on the same bond; K2's grid route is its
own entry (``gemm_exact_grid``: the rank-512 rounding's launches, times
at (512, 512) keep 256 and (1024, 1024) keep 512).

Every phase raises on failure and nothing is caught, so the exit code is 0
only if every phase passed.  Without a CUDA card, or without the package
beside it, it exits non-zero and prints no result.  The second-to-last
stdout line is a JSON object with one entry per kernel; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

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

# K1q (ops/df_loops.py, csrc/df_qr.cu): the CGS2 df QR in one launch, one
# per df_qr call; the solve makes one a site but the last per df
# half-sweep, each on the one-CTA route
EXPECTED_K1Q_LAUNCHES = DF_SWEEPS * (D - 1)
# the solve wall and one (60, 30) df_qr while df_qr ran as an eager loop of
# torch operations on the card (this script's slice and breakdown lines on
# an H100 80GB HBM3 at 700 W, before K1q)
EAGER_SOLVE_WALL_S, EAGER_DF_QR_MS = 27.960, 260.1
# K1q and K1c against their plain versions on the card: each backward error
# (||QR - A|| / ||A|| and ||Q^T Q - I||, ||L L^T - A|| / ||A||,
# ||X L^T - A|| / (||X|| ||L||), in float64) within 2x the plain version's
# plus four units of the df format's 2^-48 resolution: a (2, 2) factor's
# ||Q^T Q - I|| lies 3 units (1.068e-14) from the plain version's
# 4.699e-15 by summation order alone
DF_LOOP_FACTOR, DF_LOOP_FLOOR = 2.0, 2.0 ** -46
# CGS2 sites of the random and the cliff df rounding while the df column
# loops ran eagerly (the same lines, the same card): the orthogonality
# defects that choose CGS2 now come from the kernels
EAGER_CGS2_SITES = (7, 23)
# a cluster barrier (examples/exchange_probe.py on an H100 80GB HBM3) and
# the cluster barriers of one K1q column on the cluster route: one pull
# all-reduce per projection round, one for the norm (a deficient column
# adds two)
CLUSTER_BARRIER_US, K1Q_BARRIERS_PER_COLUMN = 0.548, 3
# a K1q column's norm within this factor of its deficiency threshold, either
# side: its decision could turn on the summation order, so the CGS2 site
# lines hold it against the plain version's
CGS2_NEAR = 10.0

KERNELS = ("df_matvec", "df_qr", "df_chol", "gemm_exact", "tt_eval",
           "jacobi")

# rounding: bench.py workload 1
ROUND_D, ROUND_N, ROUND_RANK, ROUND_TARGET, OVERSAMPLE = 32, 2, 256, 128, 8
# trunc-mode bonds of the static schedule: sites 8..24, each (256, 256),
# keep 128 in a 128 bucket; the ramp bonds take exact splits
EXPECTED_K2_LAUNCHES = 17
K2_CLUSTER_CTAS = 16      # CTAs of K2's cluster route (flags' cluster_ctas)
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
# the grid route at the TPU kernel's reach: the middle trunc bond of the
# d=32 rank-512 -> 256 and rank-1024 -> 512 roundings ((512, 512) keep 256,
# (1024, 1024) keep 512), captured from their svd roundings on the card
K2_GRID_BONDS = [(512, 256), (1024, 512)]
# the d=32 roundings past one cluster, all on the grid route: (rank,
# target, K2 launches): at 512 -> 256 the trunc-mode bonds are sites
# 9..23, each (512, 512), keep and bucket 256; at 1024 -> 512 sites
# 10..22, each (1024, 1024), keep and bucket 512
GRID_ROUNDINGS = [(512, 256, 15), (1024, 512, 13)]

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

# NVIDIA's H100 SXM data sheet: HBM rate, the FP32 rate without tensor
# cores (their TF32 is inexact) and the FP64 rate of the tensor cores
# (DMMA, exact IEEE float64); a kernel's bound is the larger of its bytes
# (each input read once, each output written once) over the first and its
# operations over the rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
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


def _solve(d, rank, dev, df_sweeps=DF_SWEEPS, eager=False):
    from xerus_tpu_torch.convert import cores_to_df, cores_to_torch
    from xerus_tpu_torch.examples import qtt_poisson_instance
    from xerus_tpu_torch.ops.mixed_precision import als_f32_df_run
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    inputs = (cores_to_torch(xs, dev), cores_to_torch(A, dev),
              cores_to_torch(b, dev), cores_to_df(A, dev), cores_to_df(b, dev))
    return (A, b), lambda: als_f32_df_run(*inputs, MAX_F32_SWEEPS, df_sweeps,
                                          eager=eager)


class _ProgramLog:
    """Keeps the programs (ops/programs.py) captured while it stands."""

    def __enter__(self):
        from xerus_tpu_torch.ops import programs as pg
        self.pg, self.real, self.programs = pg, pg.Program._capture, []
        log = self

        def capture(program, *args):
            out = log.real(program, *args)
            log.programs.append(program)
            return out
        pg.Program._capture = capture
        return self

    def __exit__(self, *exc):
        self.pg.Program._capture = self.real

    def lines(self):
        return [f"{p.name}: {p.nodes} graph nodes, private pool "
                f"{p.pool_bytes / 2 ** 20:.1f} MiB reserved, capture and "
                f"instantiation {p.capture_s:.3f} s"
                for p in self.programs]


def _max_abs_per_core(a, b):
    import numpy as np
    return [float(np.max(np.abs(x - y))) for x, y in zip(a, b)]


def _device_events(prof):
    """The device activities torch.profiler recorded, as (name, start ns,
    end ns), read from its raw results: building its FunctionEvent tree
    for the 250,000 kernels of a replayed Lanczos solve took most of a
    minute on the host."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _kernel_counts(fn, names):
    """``fn()`` once under torch.profiler (CUDA activity): its result and,
    for each of ``names``, the device kernels whose name holds it; a kernel
    replayed in a CUDA graph counts like one launched alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [name for name, _, _ in _device_events(prof)]
    return out, [sum(n in k for k in kernels) for n in names]


# kernel names of K1 and K1q (csrc/df_matvec.cu, csrc/df_qr.cu)
K1_KERNEL, K1Q_KERNEL = "df_matvec_kernel", "df_qr_kernel"


def phase_slice(dev):
    """The main path at full width, counted and checked: the solve's plain
    version (``eager=True``) for the comparison, then the solve through
    the programs four times: the first runs each program eagerly (a
    one-shot solve; ``programs.EAGER_CALLS``), the second captures them
    (after one eager warm-up run each, which is its result), the third
    replays them only and is timed, the fourth replays them under
    torch.profiler, which counts K1 and K1q by kernel name on the device:
    those counts go into the kernels line.  Every count is zeroed just
    before each run and read just after; every run equals the plain
    version bit for bit (cores and f32 history)."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import df_to_numpy
    from xerus_tpu_torch.examples import host_poisson_residual
    from xerus_tpu_torch.ops import df_loops as dl
    from xerus_tpu_torch.ops import mixed_precision as mp
    from xerus_tpu_torch.ops import programs as pg
    from xerus_tpu_torch.ops.df_matvec import df_matvec
    (A64, b64), run = _solve(D, RANK, dev)
    _, run_eager = _solve(D, RANK, dev, eager=True)

    def counted(fn):
        torch.cuda.synchronize()
        df_matvec.launches = dl.df_qr_launch.launches = 0
        mp.df_qr.calls = 0
        e0, c0, r0 = (pg.Program.eager_runs, pg.Program.captures,
                      pg.Program.replays)
        t0 = time.perf_counter()
        out, hist, cnt = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (df_matvec.launches, dl.df_qr_launch.launches,
                  mp.df_qr.calls, pg.Program.captures - c0,
                  pg.Program.replays - r0, pg.Program.eager_runs - e0)
        return df_to_numpy(out), hist[:cnt].tolist(), cnt, wall, counts

    eager = counted(run_eager)
    with _ProgramLog() as log:
        first = counted(run)
        second = counted(run)
    replay = counted(run)
    profiled, (k1_dev, k1q_dev) = _kernel_counts(
        lambda: counted(run), (K1_KERNEL, K1Q_KERNEL))
    names = ("eager", "one-shot (programs run eagerly)",
             "second call (captures)", "replay", "replay under profiler")
    runs = (eager, first, second, replay, profiled)
    for name, (sol, hist, cnt, wall, n) in zip(names, runs):
        if not all(np.all(np.isfinite(c)) for c in sol):
            raise AssertionError(f"{name}: non-finite cores in the solution")
        res = host_poisson_residual(sol, A64, b64)
        print(f"slice d={D} rank={RANK} ({name}): host-f64 residual "
              f"{res:.3e} (bar {RESIDUAL_BAR:g}), f32 half-sweeps {cnt}, df "
              f"half-sweeps {DF_SWEEPS}, f32 history "
              f"{[f'{v:.3e}' for v in hist]}, solve wall {wall:.3f} s "
              f"({EAGER_SOLVE_WALL_S:.3f} s with the eager df_qr loop), K1 "
              f"launches {n[0]}, df_qr calls {n[2]}, K1q launches {n[1]}, "
              f"program eager runs {n[5]}, captures {n[3]}, replays {n[4]}")
        if not res <= RESIDUAL_BAR:
            raise AssertionError(f"{name}: residual {res:.3e} above "
                                 f"{RESIDUAL_BAR:g}")
        if n[0] != EXPECTED_K1_LAUNCHES:
            raise AssertionError(f"{name}: K1 launched {n[0]} times in the "
                                 f"solve, expected {EXPECTED_K1_LAUNCHES}")
        if not n[1] == n[2] == EXPECTED_K1Q_LAUNCHES:
            raise AssertionError(f"{name}: K1q launched {n[1]} times for "
                                 f"{n[2]} df_qr calls, expected "
                                 f"{EXPECTED_K1Q_LAUNCHES}")
    if first[4][3:5] != (0, 0) or second[4][3] < 3 or replay[4][3] != 0 \
            or replay[4][4] != replay[2] + DF_SWEEPS:
        raise AssertionError(f"programs: the one-shot solve captured "
                             f"{first[4][3]} and replayed {first[4][4]}, the "
                             f"second captured {second[4][3]}, the third "
                             f"captured {replay[4][3]} and replayed "
                             f"{replay[4][4]} (expected none, every program, "
                             f"none and every f32 and df half-sweep)")
    print(f"slice programs: the replay under torch.profiler ran "
          f"{k1_dev} {K1_KERNEL} and {k1q_dev} {K1Q_KERNEL} kernels on the "
          f"device (the counters through replays: {profiled[4][0]} and "
          f"{profiled[4][1]})")
    if (k1_dev, k1q_dev) != (EXPECTED_K1_LAUNCHES, EXPECTED_K1Q_LAUNCHES):
        raise AssertionError(f"the replayed solve ran {k1_dev} K1 and "
                             f"{k1q_dev} K1q kernels on the device, expected "
                             f"{EXPECTED_K1_LAUNCHES} and "
                             f"{EXPECTED_K1Q_LAUNCHES}")
    for line in log.lines():
        print(f"slice programs: {line}")
    for name, other in zip(names[1:], runs[1:]):
        diff = _max_abs_per_core(other[0], eager[0])
        same = other[1] == eager[1] and other[2] == eager[2]
        print(f"slice programs: {name} vs eager solution: max |diff| "
              f"{max(diff):.3e} over the {len(diff)} cores, "
              f"{sum(x > 0 for x in diff)} cores differ, f32 histories "
              f"equal: {same}")
        if max(diff) != 0.0 or not same:
            raise AssertionError(f"slice programs: the {name} solve is not "
                                 "the eager solve bit for bit")
    print(f"slice programs: eager wall {eager[3]:.3f} s, one-shot "
          f"{first[3]:.3f} s, second call {second[3]:.3f} s (eager warm-ups "
          f"and {sum(p.capture_s for p in log.programs):.3f} s of "
          f"captures), replay {replay[3]:.3f} s; pool memory "
          f"{sum(p.pool_bytes for p in log.programs) / 2 ** 20:.1f} MiB in "
          f"{len(log.programs)} programs, "
          f"{pg.held_bytes() / 2 ** 20:.1f} MiB held by all live programs")
    return (k1_dev, k1q_dev), replay[0], host_poisson_residual(
        replay[0], A64, b64), {"hist": replay[1], "wall": replay[3],
                               "eager wall": eager[3],
                               "one-shot wall": first[3],
                               "capture wall": second[3]}


def _device_busy(fn, top: int = 0):
    """``fn`` once under torch.profiler (CUDA activity): (host wall s,
    device busy s or None where the profiler saw no device time, kernels),
    busy the union of the kernels' intervals; with ``top``, a fourth item:
    the ``top`` kernel names by summed device time, as (name, s, count)
    (every name for ``top`` < 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_events(prof)
    spans = sorted((a, b) for _, a, b in kernels)
    busy, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    out = (wall, (busy * 1e-9 if spans else None), len(spans))
    if not top:
        return out
    by_name = {}
    for name, a, b in kernels:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (b - a) * 1e-9, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return out + ([(name, t, n) for name, (t, n) in
                   (ranked if top < 0 else ranked[:top])],)


def phase_breakdown(dev, smi):
    """Where the solve's time goes: the solve's plain version again (K1q's
    inputs recorded, one call per shape), then the f32 phase alone
    (df_sweeps=0, replayed programs); the df phase is the difference.  The
    df half-sweeps alone, from the f32 phase's seed, under torch.profiler,
    eagerly and replayed, give the device's idle share there.  K1q is held
    on the recorded inputs against its plain version and float64
    (``_loop_checks``).  Returns K1q's rows and its max |kernel -
    plain|."""
    import torch
    from xerus_tpu_torch.convert import cores_to_df
    from xerus_tpu_torch.ops import mixed_precision as mp
    _, run_all = _solve(D, RANK, dev, eager=True)
    (A64, b64), run_f32 = _solve(D, RANK, dev, df_sweeps=0)

    def timed(name, run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        print(f"breakdown: {name} {time.perf_counter() - t0:.3f} s wall")
        return out

    rec = _LoopRecorder()
    with rec:
        timed("full solve (repeat, eager)", run_all)
    seed = timed("f32 phase alone (replayed)", run_f32)[0]
    A_df, b_df = cores_to_df(A64, dev), cores_to_df(b64, dev)
    for name, eager in (("eager", True), ("replayed", False)):
        wall, busy, kernels = _device_busy(
            lambda: mp.df_als_multi_sweep(seed, A_df, b_df, DF_SWEEPS,
                                          eager=eager))
        idle = ("not measured (the profiler saw no device time)"
                if busy is None else f"{1.0 - busy / wall:.3f}")
        print(f"breakdown: df phase alone, {name} ({DF_SWEEPS} df "
              f"half-sweeps from the f32 phase's seed) {wall:.3f} s wall "
              f"under torch.profiler, {kernels} kernels, device busy "
              f"{busy if busy is None else round(busy, 4)} s, idle share "
              f"{idle} ({smi})")
    rows, max_abs, fails = _loop_checks(rec, "Poisson")
    k = rows["df_qr"][(60, 30)]
    print(f"breakdown: df_qr (60, 30) {k['ms']:.4f} ms per call (K1q, CUDA "
          f"events; the eager loop {EAGER_DF_QR_MS} ms), plain version "
          f"on the card {k['plain_ms']:.1f} ms, bound {k['bound_ms']:.5f} "
          f"ms; 44 of the solve's 62 df_qr calls are 60 x 30 ({smi})")
    if fails:
        raise AssertionError("breakdown: " + "; ".join(fails))
    return rows["df_qr"], max_abs["df_qr"]


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
        retries0, stops0 = ge._power_orth.retries, ge._power_orth.stops
        vt0, vt_bal, okp_t, conv_t, it = ge._gemm_exact_body(
            cur, mask, *ge._gemm_exact_tuning(cur.dtype))
        info = dict(okp=bool(okp_t), converged=bool(conv_t), outer=it,
                    ns=ge._gemm_exact_body.ns_iters - ns0,
                    ns_rows=ge._gemm_exact_body.ns_row_iters - rows0,
                    retries=ge._power_orth.retries - retries0,
                    retry_stops=ge._power_orth.stops - stops0)
    return ge._finish_gemm_exact(vt0, vt_bal, info["okp"], mask), info


def _proj_dist(vt, ref):
    """||vt^T vt - ref^T ref||_F / ||ref^T ref||_F in float64: the distance
    of two kept row spaces, whatever their bases."""
    a, b = vt.double(), ref.double()
    P = b.T @ b
    return float(((a.T @ a - P).norm() / P.norm()).item())


def _trunc_err(cur, vt):
    """||cur - cur vt^T vt||^2 / ||cur||^2 in float64."""
    c, v = cur.double(), vt.double()
    return float(((c - (c @ v.T) @ v).norm() ** 2 / c.norm() ** 2).item())


def _k2_check(kind, B, M, keep, cap, dtype, dev, seed, cur=None):
    """One K2 case on the card against its plain version: f32 within
    K2_ERR_TOL of the plain version's truncation error, f64 both within
    K2_F64_RTOL of the SVD's; both certified, two repeat launches bitwise
    equal, and the flags' route the one gemm_exact_route chose before the
    launch.  ``cur``: the input on the card, else drawn by ``kind`` from
    ``seed``.  Returns (input, |kernel - plain| truncation error, kernel
    flags)."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    if cur is None:
        A = _k2_input(kind, B, M, keep, seed)
        cur = torch.tensor(A, dtype=getattr(torch, dtype), device=dev)
    else:
        A = cur.double().cpu().numpy()
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
                                        ge._gemm_exact_tuning(cur.dtype)[2],
                                        fk["retries"], fk["retry_stops"])
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
                  f"{flops / 1e9:.3f} GFLOP by gemm_exact_flops (Grams on "
                  f"and above the diagonal), bound "
                  f"{timing['bound_ms']:.4f} ms by {timing['bound_by']} "
                  f"(FP32 67 TFLOP/s), {timing['bound_ms'] / timing['ms']:.2%}"
                  f" of it reached, {flops / timing['ms'] / 1e9:.3f} TFLOP/s")
    _k2_graded(dev)
    _k2_check(*K2_F64_CASE, dev, SEED)
    for kind, B, M, keep, cap, dtype in K2_GRID_CASES:
        _cur, diff, fk = _k2_check(kind, B, M, keep, cap, dtype, dev,
                                   SEED + B + M)
        if fk["cluster_ctas"]:
            raise AssertionError(f"K2 {kind} ({B}, {M}) {dtype} took the "
                                 "cluster route, expected the grid route")
        if dtype == "float32":
            max_abs = max(max_abs, diff)
    return max_abs, timing, _k2_grid_bonds(dev)


def _k2_graded(dev):
    """ROADMAP fault 7 on the cluster route: the graded (128, 128) keep-64
    bond of tests/test_torch_k2_fault7.py (``k2_grid.graded_bond``), whose
    power steps' one-stage Newton-Schulz ends at the cap, against its
    plain version (``_k2_check``); both must take two-stage retries."""
    import torch
    from xerus_tpu_torch.examples import k2_grid
    g = k2_grid.GRADED_BOND
    cur = torch.tensor(k2_grid.graded_bond(**g), dtype=torch.float32,
                       device=dev)
    _cur, _diff, fk = _k2_check("graded (fault 7)", g["B"], g["M"],
                                g["keep"], g["keep"], "float32", dev, SEED,
                                cur=cur)
    if not fk["cluster_ctas"]:
        raise AssertionError("K2 graded bond did not take the cluster route")
    if not fk["retries"]:
        raise AssertionError("K2 took no two-stage retry on the graded "
                             "bond: the cluster route's retry did not run")


def _k2_grid_bonds(dev):
    """The grid route at the rank-512 and rank-1024 roundings' bond shapes
    (each instance's middle trunc bond): against its plain version, then
    timed beside its bound and gesvd (examples/k2_grid.py).  Returns the
    kernels line's grid entry: the (512, 512) keep-256 numbers, the
    (1024, 1024) keep-512 ones with the suffix _1024."""
    from xerus_tpu_torch.examples import k2_grid
    out = {"max_abs_err": 0.0}
    for rank, target in K2_GRID_BONDS:
        t0 = time.perf_counter()
        bonds = k2_grid.bond_inputs(rank, target, dev)
        cur, keep, cap = bonds[len(bonds) // 2]
        B, M = cur.shape
        _cur, diff, fk = _k2_check(f"rank-{rank} middle bond", B, M, keep,
                                   cap, "float32", dev, SEED, cur=cur)
        if fk["cluster_ctas"]:
            raise AssertionError(f"K2 ({B}, {M}) took the cluster route, "
                                 "expected the grid route")
        out["max_abs_err"] = max(out["max_abs_err"], diff)
        t = k2_grid.time_bond(cur, keep, cap)
        plain = _wall_ms(lambda: _k2_run(cur, keep, cap, False), reps=1)
        f = t["flags"]
        print(f"K2 grid route ({B}, {M}) keep {keep} cap {cap} float32: "
              f"kernel {t['ms']:.3f} ms (CUDA events, median of 20 queued "
              f"launches after 2 warm-ups), torch.linalg.svd(driver="
              f"'gesvd') {t['gesvd_ms']:.3f} ms (the same), plain "
              f"{plain:.3f} ms (host wall, synchronized); {f['outer']} outer "
              f"and {f['ns']} Newton-Schulz steps ({f['ns_rows']} in the row "
              f"polar), {f['barriers']} grid barriers, "
              f"{f['barriers'] / t['ms'] * 1e-3:.3f} per us; "
              f"{t['gflop']:.3f} GFLOP by gemm_exact_flops (Grams on and "
              f"above the diagonal), bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} (FP32 67 TFLOP/s), "
              f"{t['reached']:.2%} of it reached, "
              f"{t['gflop'] / t['ms']:.3f} TFLOP/s; kernel / gesvd "
              f"{t['ms'] / t['gesvd_ms']:.3f}x "
              f"({time.perf_counter() - t0:.1f} s for this bond)")
        sfx = "" if rank == K2_GRID_BONDS[0][0] else f"_{rank}"
        out.update({f"ms{sfx}": t["ms"], f"plain_ms{sfx}": plain,
                    f"bound_ms{sfx}": t["bound_ms"],
                    f"bound_by{sfx}": t["bound_by"],
                    f"library_ms{sfx}": t["gesvd_ms"]})
    return out


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
    refs, chains, f32_rel = {}, {}, {}
    for inst, cs in (("random", host), ("cliff", cliff_instance(host))):
        t0 = time.perf_counter()
        chains[inst] = cpu_round_sweep(cs, ROUND_TARGET)
        ref = host_tt_log_norm(chains[inst])
        print(f"round {inst}: f64 LAPACK chain log-norm {ref:.9f} "
              f"({time.perf_counter() - t0:.2f} s on the host)")
        refs[inst] = ref
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
            f32_rel[inst, method] = rel
            if (inst, method) == ("random", "gemm_exact"):
                ge_f32 = rel
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
                if cnt["retries"]:
                    _retries_at_the_cap(inst, cores)
            if method != "randomized" and not rel <= ROUND_F64_BAR:
                raise AssertionError(f"round {inst} {method}: log-norm rel "
                                     f"err {rel:.3e} above {ROUND_F64_BAR:g}")
        _ns_loops(inst, cores, lnorm["gemm_exact"])
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
    return k2_launches, refs["random"], ge_f32, {
        "host": host, "chain": chains["random"], "ref": refs["random"],
        "svd_f32_rel": f32_rel["random", "svd"]}


def _retries_at_the_cap(inst, cores):
    """A two-stage retry of K2 in the rank-256 rounding must be a property
    of its bond, not of K2's sums: each bond K2 retried on is rerun by the
    plain version on the host with exactly rounded products
    (``k2_grid.plain_run``), which must end one-stage power steps at the
    Newton-Schulz cap there too and certify (ROADMAP fault 7)."""
    from xerus_tpu_torch.examples import k2_grid
    t0 = time.perf_counter()
    for n, (cur, keep, cap, _ms, f, _out) in enumerate(
            k2_grid.k2_calls(cores, ROUND_TARGET)):
        if not f["retries"]:
            continue
        r = k2_grid.plain_run(cur.cpu(), keep, cap, exact=True)
        print(f"round {inst}: K2 bond {n} took {f['retries']} two-stage "
              f"retries ({f['retry_stops']} stopped after the first stage; "
              f"{f['outer']} outer steps); the plain version on the host "
              f"with exactly rounded products: certified {r['certified']} "
              f"in {r['outer']} outer steps, {r['orths_at_the_cap']} "
              f"orthonormalizations at the cap, {r['retries']} retries "
              f"({r['retry_stops']} stopped)")
        if not (r["certified"] and r["orths_at_the_cap"]):
            raise AssertionError(f"round {inst}: K2 retried at bond {n}, "
                                 "whose power steps do not reach the cap "
                                 "with exactly rounded products")
    print(f"round {inst}: retried bonds checked on the host in "
          f"{time.perf_counter() - t0:.1f} s")


def phase_round_grid(dev):
    """The d=32 roundings at the TPU kernel's reach, rank 512 -> 256 and
    1024 -> 512 (``GRID_ROUNDINGS``); returns K2's launches in the counted
    rank-512 rounding."""
    return [_round_grid(dev, *r) for r in GRID_ROUNDINGS][0]


def _round_grid(dev, rank, target, expected):
    """The d=32 rank-``rank`` -> ``target`` rounding, whose ``expected``
    trunc bonds take K2's grid route: gemm_exact and svd, one rounding
    after a warm-up each, held to the host f64 chain and to each other;
    K2's launches, routes and SVD fallbacks counted; then K2's device time
    bond by bond beside each bond's bound.  A bond that does not certify
    must be the plain version's own decision on the card, and bond 0 must
    certify (ROADMAP fault 7, repaired by the two-stage retry).  Returns
    K2's launches in the counted gemm_exact rounding."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          cpu_round_sweep, host_tt_log_norm,
                                          k2_grid)
    t_phase = time.perf_counter()
    host = bench_round_instance(32, ROUND_N, rank, SEED)
    t0 = time.perf_counter()
    ref = host_tt_log_norm(cpu_round_sweep(host, target))
    print(f"round rank {rank}: f64 LAPACK chain log-norm {ref:.9f} "
          f"({time.perf_counter() - t0:.2f} s on the host)")
    cores = list(cores_to_torch(host, dev))
    lnorm, launches = {}, 0
    for method in ("gemm_exact", "svd"):
        out, wall, n_k2, cnt = k2_grid.rounding_wall(cores, target, method)
        h = _to_host(out)
        if not all(np.all(np.isfinite(c)) for c in h):
            raise AssertionError(f"round rank {rank} {method}: "
                                 "non-finite")
        if max(c.shape[2] for c in h[:-1]) > target:
            raise AssertionError(f"round rank {rank} {method}: rank "
                                 f"above {target}")
        lnorm[method] = host_tt_log_norm(h)
        rel = abs(lnorm[method] - ref) / abs(ref)
        print(f"round rank {rank}->{target} {method} d=32: wall "
              f"{wall:.4f} s (one rounding after a warm-up, synchronized), "
              f"f32-vs-f64 log-norm rel err {rel:.3e} (bar "
              f"{ROUND_F64_BAR:g}), K2 launches {n_k2}, gemm_exact {cnt}")
        if method == "gemm_exact":
            launches = n_k2
            if launches != expected:
                raise AssertionError(f"K2 launched {launches} times in the "
                                     f"rank-{rank} rounding, expected "
                                     f"{expected}")
            if cnt["cluster_bonds"]:
                raise AssertionError(f"{cnt['cluster_bonds']} bonds of the "
                                     f"rank-{rank} rounding took the "
                                     "cluster route, expected the grid "
                                     "route")
            fallbacks = cnt["svd_fallbacks"]
        if not rel <= ROUND_F64_BAR:
            raise AssertionError(f"round rank {rank} {method}: log-norm"
                                 f" rel err {rel:.3e} above {ROUND_F64_BAR:g}")
    d_ge = abs(lnorm["gemm_exact"] - lnorm["svd"]) / abs(lnorm["svd"])
    print(f"round rank {rank}: gemm_exact vs svd log-norm rel diff "
          f"{d_ge:.3e} (bar {GE_VS_SVD_BAR:g})")
    if not d_ge <= GE_VS_SVD_BAR:
        raise AssertionError(f"round rank {rank}: gemm_exact and svd "
                             "differ")
    bonds = k2_grid.k2_calls(cores, target)
    total = bound = 0.0
    for n, (cur, keep, cap, ms, f, _out) in enumerate(bonds):
        B, M = cur.shape
        b_ms, _by, _flop = k2_grid.k2_bound(B, M, cap, f, torch.float32)
        total, bound = total + ms, bound + b_ms
        print(f"breakdown: K2 grid bond {n} ({B}, {M}) cap {cap}: {ms:.3f} "
              f"ms, bound {b_ms:.4f} ms; outer {f['outer']}, Newton-Schulz "
              f"{f['ns']}, two-stage retries {f['retries']}, grid barriers "
              f"{f['barriers']}, certified {f['converged']}, CTAs per "
              f"cluster {f['cluster_ctas']}")
        if n == 0 and not f["converged"]:
            raise AssertionError(f"K2 grid bond 0 of the rank-{rank} "
                                 "rounding did not certify (fault 7)")
        if not f["converged"]:
            _vp, fp = _k2_run(cur, keep, cap, False)
            print(f"fault 7: K2 grid bond {n} did not certify in "
                  f"{f['outer']} outer steps ({f['retries']} retries); the "
                  f"plain version on the card certifies: {fp['converged']} "
                  f"({fp['outer']} outer, {fp['retries']} retries)")
            if fp["converged"]:
                raise AssertionError(f"K2 grid bond {n} did not certify "
                                     "where its plain version does")
    if sum(not f["converged"] for *_x, f, _out in bonds) != fallbacks:
        raise AssertionError("the SVD fallbacks of the counted rounding and "
                             "of the timed one differ")
    if bonds:   # none on the CPU, where the plain version runs
        times = sorted(ms for _c, _k, _cap, ms, _f, _out in bonds)
        print(f"breakdown: K2 grid device time per rank-{rank} gemm_exact "
              f"rounding: {total:.3f} ms over {len(bonds)} launches, per bond "
              f"{times[0]:.3f} to {times[-1]:.3f} ms, median "
              f"{statistics.median(times):.3f}; bound {bound:.3f} ms "
              f"({bound / total:.2%} of it reached); phase "
              f"{time.perf_counter() - t_phase:.1f} s")
    return launches


class _Forward:
    """Stands in for ``_ns_orth_cols`` in ops/round_kernels.py: calls
    ``fn`` and records each call's Newton-Schulz count; ``iterations`` is
    the real function's counter."""

    def __init__(self, real, fn):
        self.real, self.fn, self.counts = real, fn, []

    @property
    def iterations(self):
        return self.real.iterations

    @iterations.setter
    def iterations(self, n):
        self.real.iterations = n

    def __call__(self, *args, **kw):
        n0 = self.real.iterations
        out = self.fn(*args, **kw)
        self.counts.append(self.real.iterations - n0)
        return out


def _ns_loops(inst, cores, lnorm):
    """The gemm_exact rounding with the QR sweep's Newton-Schulz loop in
    chunks of ``NS_CHUNK`` masked steps (one host read each) and with the
    per-step loop (one read per step): outputs bit for bit, iterations
    call by call, K2 launches and fallbacks, host reads and walls."""
    import numpy as np
    import torch
    from xerus_tpu_torch.examples import host_tt_log_norm
    from xerus_tpu_torch.ops import gemm_exact as ge
    from xerus_tpu_torch.ops import round_kernels as rk
    real = rk._ns_orth_cols
    runs = {}
    for name, fn in (("chunked", real), ("per-step",
                                         rk._ns_orth_cols_stepwise)):
        rk._ns_orth_cols = _Forward(real, fn)
        try:
            torch.cuda.synchronize()
            ge.reset_counters()
            reads0 = rk.host_bool.reads
            t0 = time.perf_counter()
            out = _round("gemm_exact", cores)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[name] = (_to_host(out), rk.host_bool.reads - reads0, wall,
                          rk._ns_orth_cols.counts,
                          ge.gemm_exact_kernel.launches,
                          ge.trunc_step_gemm_exact.svd_fallbacks)
        finally:
            rk._ns_orth_cols = real
    (h0, r0, w0, c0, k0, f0), (h1, r1, w1, c1, k1, f1) = runs.values()
    same = all(np.array_equal(a, b) for a, b in zip(h0, h1))
    ln = host_tt_log_norm(h0)
    print(f"round {inst} gemm_exact Newton-Schulz QR sweep: chunks of "
          f"{rk.NS_CHUNK} steps {r0} host reads, {w0:.4f} s; per-step loop "
          f"{r1} host reads, {w1:.4f} s; iterations {sum(c0)} / {sum(c1)} "
          f"over {len(c0)} calls (per call {c0}); outputs bitwise equal "
          f"{same}; K2 launches {k0} / {k1}, fallbacks {f0} / {f1}; "
          f"log-norm {ln:.9f} (the counted run's {lnorm:.9f}, diff "
          f"{abs(ln - lnorm):.3e})")
    if not (same and c0 == c1 and k0 == k1 == EXPECTED_K2_LAUNCHES
            and f0 == f1 == 0):
        raise AssertionError(f"round {inst}: the chunked Newton-Schulz "
                             "loop differs from the per-step loop")


# the rest of TT rounding (phase_rounding_rest): double-word rounding on
# the slice's instance, the Ozaki split GEMM at bench.py's 512^3
# (bench.py:381-393), the df solve at the Poisson local systems' size on
# tests/test_df32.py:209's construction, and the uniform, parallel and
# streaming roundings
# f64 quality: 1e-10 from the f64 chain.  The JAX package on a CPU, its
# df_eigh seeded by LAPACK's float32 eigh, reaches only 1.733e-08 here and
# 2.432e-04 on the cliff below (tests/test_torch_rounding_reference.py);
# the port's seed on the card is a float64 eigh rounded to float32 (K4,
# as every float32 eigh on the card runs in float64), which separates the
# clusters that freeze the reference's refinement.
DF_ROUND_BAR = 1e-10      # log-norm vs the f64 chain
DF_CLIFF = (96, 1e-9, 1e-7)   # signal rank, tail scale, eps
DF_CLIFF_BAR = 1e-10      # distance to the svd-eps chain
JAX_DF_REACH = (1.7334063460197896e-08, 2.4320608940789682e-04)
OZAKI_N = 512
OZAKI_BAR = 1e-13          # of max (|A||B|), tests/test_df32.py:161
# n, kappa, refinement steps: the default 3 reach 4.384e-10 in the JAX
# package (CPU) on this matrix, 5 reach 3.461e-13
DF_SOLVE = (1800, 1e10, 5)
DF_SOLVE_BAR = 1e-10
DF_SVD_BAR = 1e-13         # singular values vs f64 gesvd, of sigma_max
# cholqr's log-norm vs the svd chain, gemm_exact's bar (the JAX package:
# 9.706e-08 in float32, 2.834e-16 in float64)
CHOLQR_BAR = {"float64": 1e-4, "float32": 1e-4}
# error <= factor x the svd chain's error (tests/test_tt.py:381-383;
# gram_parallel takes subspace_parallel's)
QUASI_FACTORS = {"gram_parallel": 2.0, "subspace_parallel": 2.0,
                 "streaming": 15.0}
# round_fast f64, card vs host(), relative: 1e-10, or 10x the JAX
# package's own change when the cores move by 1e-15 relative where that is
# larger (the parallel methods amplify rounding: 1.086e-10 for
# gram_parallel and 7.237e-08 for subspace_parallel on this instance;
# cholqr 2.410e-14, streaming 5.080e-12)
ROUND_REST_CARD_HOST = 1e-10
CARD_HOST_BARS = {"cholqr": ROUND_REST_CARD_HOST,
                  "gram_parallel": 10.0 * 1.0863118849463502e-10,
                  "subspace_parallel": 10.0 * 7.23677299907354e-08,
                  "streaming": ROUND_REST_CARD_HOST}
BF16_FLOPS = 989e12        # H100 SXM data sheet, dense bf16 tensor cores


def _spd(n, kappa, seed=7):
    """tests/test_df32.py's SPD construction: Q diag(logspace) Q^T."""
    import numpy as np
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.logspace(0, -np.log10(kappa), n)
    return (Q * lam) @ Q.T


def _ozaki_checks(dev):
    """Ozaki at 512^3 against the f64 product; each slice GEMM bit-exact
    against the float64 product of the same slices; ms beside the bound
    and torch.matmul in float64."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import ozaki as oz
    from xerus_tpu_torch.ops.df32 import df_to_f64
    n = OZAKI_N
    rng = np.random.Generator(np.random.PCG64(SEED))
    A = rng.normal(size=(n, n)).astype(np.float32)
    B = rng.normal(size=(n, n)).astype(np.float32)
    At, Bt = torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)
    z = torch.zeros_like(At)
    ch, cl = oz.ozaki_matmul(At, z, Bt, z)
    ref = A.astype(np.float64) @ B.astype(np.float64)
    err = (np.abs(df_to_f64(ch, cl) - ref).max()
           / (np.abs(A).astype(np.float64) @ np.abs(B)).max())
    delta = oz._slice_width(n)
    s = int(np.ceil(24 / delta))
    A_sl, _ = oz.ozaki_split(At, 1, delta, s)
    B_sl, _ = oz.ozaki_split(Bt, 0, delta, s)
    inexact = sum(not torch.equal(oz._gemm_exact(a, b).double(),
                                  a.double() @ b.double())
                  for a in A_sl for b in B_sl)
    ms = _time_ms(lambda: oz.ozaki_matmul(At, z, Bt, z), reps=20)
    A64, B64 = At.double(), Bt.double()
    ms64 = _time_ms(lambda: A64 @ B64, reps=20)
    nbytes = 6 * n * n * 4
    t_ops = (s * s * 2.0 * n ** 3 / BF16_FLOPS
             + 5 * 2.0 * n ** 3 / PEAK_FLOPS["float32"]) * 1e3
    bound = max(nbytes / HBM_BYTES_PER_S * 1e3, t_ops)
    print(f"rounding rest: Ozaki {n}^3 (bench.py's): error {err:.3e} of "
          f"max |A||B| (bar {OZAKI_BAR:g}); {s}x{s} slice GEMMs (delta "
          f"{delta}, bf16 in, f32 out), {inexact} not bit-exact against "
          f"the float64 product of the same slices; {ms:.4f} ms (CUDA "
          f"events, median of 20) beside the bound {bound:.4f} ms "
          f"(operations: {s * s} bf16 GEMMs at 989 TFLOP/s + 5 f32 at 67) "
          f"and torch.matmul float64 {ms64:.4f} ms")
    fails = []
    if not err <= OZAKI_BAR:
        fails.append(f"Ozaki error {err:.3e}")
    if inexact:
        fails.append(f"{inexact} slice GEMMs not exact")
    return fails


def _df_linalg_checks(dev, host):
    """The kappa=1e10 df solve at n=1800 and df_svd of one (512, 256)
    unfolding of the slice instance."""
    import numpy as np
    import scipy.linalg
    import torch
    from xerus_tpu_torch.ops import df_matvec as dfm
    from xerus_tpu_torch.ops import round_kernels as rk
    from xerus_tpu_torch.ops.df32 import df_from_f64, df_to_f64
    from xerus_tpu_torch.ops.df_cholesky import df_solve_spd_chol
    from xerus_tpu_torch.ops.df_eigh import df_svd
    fails = []
    n, kappa, steps = DF_SOLVE
    A = _spd(n, kappa)
    b = A @ np.random.default_rng(3).normal(size=n)
    Ah, Al = df_from_f64(A, dev)
    bh, bl = df_from_f64(b, dev)
    f32_finite = bool(torch.isfinite(rk._cholesky(Ah)).all())
    k1 = dfm.df_matvec.launches
    loops0 = _loop_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xh, xl = df_solve_spd_chol(Ah, Al, bh, bl, refine_iters=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (_q, blk, trsm), calls = [
        tuple(a - b for a, b in zip(x, y))
        for x, y in zip(_loop_counts(), loops0)]
    x = df_to_f64(xh, xl)
    res = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    print(f"rounding rest: df_solve_spd_chol n={n} kappa={kappa:g}, "
          f"{steps} refinement steps: relative residual {res:.3e} (bar "
          f"{DF_SOLVE_BAR:g}) in {wall:.3f} "
          f"s, {dfm.df_matvec.launches - k1} K1 launches (the refinement "
          f"residuals), K1c launches {blk} (blocks) + {trsm} (panels); "
          f"the f32 Cholesky "
          f"of the same matrix is {'finite' if f32_finite else 'non-finite'}")
    if not res <= DF_SOLVE_BAR:
        fails.append(f"df solve residual {res:.3e}")
    if (_q, blk, trsm) != calls or not (blk and trsm):
        fails.append(f"df solve: K1c launches {(blk, trsm)} for wrapper "
                     f"calls {calls[1:]}")
    if f32_finite:
        fails.append("the f32 Cholesky did not fail at kappa 1e10")
    M = np.asarray(host[ROUND_D // 2], np.float64).reshape(
        2 * ROUND_RANK, ROUND_RANK)
    checks = _linalg_checks()
    t0 = time.perf_counter()
    out = df_svd(*df_from_f64(M, dev))
    sv = df_to_f64(out[2], out[3])
    wall = time.perf_counter() - t0
    ref = scipy.linalg.svd(M, compute_uv=False, lapack_driver="gesvd")
    err = np.abs(sv - ref).max() / ref[0]
    print(f"rounding rest: df_svd of core {ROUND_D // 2}'s ({M.shape[0]}, "
          f"{M.shape[1]}) unfolding: singular values {err:.3e} of sigma_max "
          f"from f64 gesvd (bar {DF_SVD_BAR:g}), {wall:.3f} s, "
          f"{_linalg_checks() - checks} eigh info checks")
    if not err <= DF_SVD_BAR:
        fails.append(f"df_svd singular values {err:.3e}")
    return fails


def _linalg_checks():
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    return dk.linalg_host_checks()


def _loop_fns():
    """K1q's and K1c's launch functions (ops/df_loops.py), as the module
    first held them: their counters are theirs even while a recorder
    stands in for them."""
    if not _LOOP_FNS:
        from xerus_tpu_torch.ops import df_loops as dl
        _LOOP_FNS.update(df_qr=dl.df_qr_launch,
                         df_chol_block=dl.df_chol_block_launch,
                         df_trsm_rlt=dl.df_trsm_rlt_launch)
    return _LOOP_FNS


_LOOP_FNS = {}
LOOP_ENTRIES = ("df_qr", "df_chol_block", "df_trsm_rlt")


def _loop_counts():
    """(launches, wrapper calls), each in LOOP_ENTRIES' order."""
    from xerus_tpu_torch.ops import mixed_precision as mp
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    wrappers = (mp.df_qr, dc._df_chol_unblocked, dc._df_trsm_rlt)
    return (tuple(_loop_fns()[e].launches for e in LOOP_ENTRIES),
            tuple(w.calls for w in wrappers))


class _LoopRecorder:
    """Stands in for K1q's and K1c's launch functions while a path runs:
    counts the launches per (entry, shape) and keeps a copy of the inputs
    of each shape's first call.  Launches are the real functions' own (a
    stand-in's ``launches`` is its function's)."""

    class _Standin:
        def __init__(self, rec, name, fn):
            self.rec, self.name, self.fn = rec, name, fn

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

        def __call__(self, *args):
            key = (self.name, tuple(args[0].shape))
            self.rec.calls[key] = self.rec.calls.get(key, 0) + 1
            if key not in self.rec.inputs:
                self.rec.inputs[key] = [a.clone() if hasattr(a, "clone")
                                        else a for a in args]
            return self.fn(*args)

    def __init__(self):
        self.calls, self.inputs = {}, {}

    def _swap(self, fns):
        dl = importlib.import_module("xerus_tpu_torch.ops.df_loops")
        for name, fn in fns.items():
            setattr(dl, name + "_launch", fn)

    def __enter__(self):
        self._swap({n: self._Standin(self, n, f)
                    for n, f in _loop_fns().items()})
        return self

    def __exit__(self, *exc):
        self._swap(_loop_fns())


def _loop_bound(entry, shape):
    """(bound_ms, bound_by): bytes (each input read once, each output
    written once; a triangular factor's lower half) at the HBM rate, or
    FP32 operations at K1's 21 per df multiply-add term (CGS2: 2 m r^2
    terms; the Cholesky block B^3 / 6; the substitution m B^2 / 2)."""
    m, n = shape
    if entry == "df_qr":
        nbytes, terms = (4 * m * n + 2 * n * n) * 4, 2 * m * n * n
    elif entry == "df_chol_block":
        nbytes, terms = (2 * n * n + n * (n + 1)) * 4, n ** 3 / 6
    else:
        nbytes, terms = (4 * m * n + n * (n + 1)) * 4, m * n * n / 2
    return _bound(nbytes, K1_OPS_PER_ELEMENT * terms, "float32")


def _loop_checks(rec, path):
    """K1q and K1c against their plain versions (on the card) and float64
    on the inputs ``rec`` recorded on ``path``, one call per shape: the
    backward errors (df_loops' helpers) within DF_LOOP_FACTOR x the plain
    version's + DF_LOOP_FLOOR, df_qr's deficient columns (R's zeroed
    diagonal) equal column by column, any flip printed with the column's
    norm and threshold, two launches bitwise equal.  Beside each shape's
    kernel time (CUDA events, median of 20 queued calls): the plain
    version's (host wall of the synchronized call the check makes, with no
    warm-up call before it, so not comparable with a warmed call's time:
    it is an eager loop), the bound, the float64 library call on the same shape
    (torch.linalg.qr / cholesky / solve_triangular; it computes in f64,
    not in df) and, on K1q's cluster route, the floor of its cluster
    barriers.  Returns ({entry: {shape: row}}, {entry: max |kernel -
    plain|}, failures)."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import df_loops as dl
    from xerus_tpu_torch.ops import mixed_precision as mp
    from xerus_tpu_torch.ops.df32 import df_to_f64
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    fns = _loop_fns()
    rows, fails = {e: {} for e in LOOP_ENTRIES}, []
    max_abs = dict.fromkeys(LOOP_ENTRIES, 0.0)

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def held(name, k, p):
        ok = all(a <= DF_LOOP_FACTOR * b + DF_LOOP_FLOOR for a, b in zip(k, p))
        if not ok:
            fails.append(f"{name}: kernel {k} against plain {p}")
        return ok

    for (entry, shape), args in sorted(rec.inputs.items()):
        name = f"{path} {entry} {shape}"
        plan = args[-1]
        fn = fns[entry]
        dev = args[0].device
        if entry == "df_qr":
            ah, al = args[0], args[1]
            r = shape[1]
            A = df_to_f64(ah, al)
            stats = torch.zeros((r, 2), device=dev)
            kq, kr = fn(ah, al, plan, stats)
            again = fn(ah, al, plan)
            same = all(torch.equal(x, y) for x, y in
                       zip((*kq, *kr), (*again[0], *again[1])))
            (pq, pr), plain_ms = walled(lambda: mp.df_qr_reference(ah, al))
            Q, R = df_to_f64(*kq), df_to_f64(*kr)
            PQ, PR = df_to_f64(*pq), df_to_f64(*pr)
            ek = dl.qr_backward_errors(Q, R, A)
            ep = dl.qr_backward_errors(PQ, PR, A)
            diff = max(np.abs(Q - PQ).max(), np.abs(R - PR).max())
            kd, pd = np.diag(R) == 0.0, np.diag(PR) == 0.0
            st = stats.cpu().numpy()
            flips = [f"column {j}: kernel {'deficient' if kd[j] else 'kept'}"
                     f" (norm {st[j, 0]:.6e}, threshold {st[j, 1]:.6e}), "
                     f"plain {'deficient' if pd[j] else 'kept'}"
                     for j in np.flatnonzero(kd != pd)]
            if flips:
                fails.append(f"{name}: deficient decisions differ")
            verdict = (f"||QR - A||/||A|| {ek[0]:.3e} (plain {ep[0]:.3e}), "
                       f"||Q^T Q - I|| {ek[1]:.3e} (plain {ep[1]:.3e}), "
                       f"deficient columns {int(kd.sum())}, "
                       + ("; ".join(flips) if flips else
                          "the plain version's column by column"))
            run = lambda: fn(ah, al, plan)
            A64 = torch.from_numpy(A).to(dev)
            lib = lambda: torch.linalg.qr(A64)
        elif entry == "df_chol_block":
            ah, al = args[0], args[1]
            A = df_to_f64(ah, al)
            kl = fn(ah, al, plan)
            again = fn(ah, al, plan)
            same = all(torch.equal(x, y) for x, y in zip(kl, again))
            pl, plain_ms = walled(
                lambda: dc._df_chol_unblocked_reference(ah, al))
            L, PL = df_to_f64(*kl), df_to_f64(*pl)
            ek = (dl.chol_backward_error(L, A),)
            ep = (dl.chol_backward_error(PL, A),)
            diff = np.abs(L - PL).max()
            verdict = (f"||LL^T - A||/||A|| {ek[0]:.3e} (plain {ep[0]:.3e})")
            run = lambda: fn(ah, al, plan)
            A64 = torch.from_numpy(A).to(dev)
            lib = lambda: torch.linalg.cholesky(A64)
        else:
            ah, al, lh, ll = args[:4]
            A, L = df_to_f64(ah, al), df_to_f64(lh, ll)
            kx = fn(ah, al, lh, ll, plan)
            again = fn(ah, al, lh, ll, plan)
            same = all(torch.equal(x, y) for x, y in zip(kx, again))
            px, plain_ms = walled(
                lambda: dc._df_trsm_rlt_reference(ah, al, lh, ll))
            X, PX = df_to_f64(*kx), df_to_f64(*px)
            ek = (dl.trsm_backward_error(X, L, A),)
            ep = (dl.trsm_backward_error(PX, L, A),)
            diff = np.abs(X - PX).max()
            verdict = (f"||XL^T - A||/(||X|| ||L||) {ek[0]:.3e} (plain "
                       f"{ep[0]:.3e})")
            run = lambda: fn(ah, al, lh, ll, plan)
            A64 = torch.from_numpy(A).to(dev)
            L64 = torch.from_numpy(L).to(dev)
            lib = lambda: torch.linalg.solve_triangular(L64.T, A64,
                                                        upper=True,
                                                        left=False)
        held(name, ek, ep)
        if not same:
            fails.append(f"{name}: two launches differ")
        max_abs[entry] = max(max_abs[entry], float(diff))
        ms = _time_ms(run, reps=20, warmup=2)
        f64_ms = _time_ms(lib, reps=20, warmup=2)
        bound_ms, bound_by = _loop_bound(entry, shape)
        floor = ""
        if entry == "df_qr" and plan.route != "cta":
            floor = (f", cluster-barrier floor {shape[1]} columns x "
                     f"{K1Q_BARRIERS_PER_COLUMN} x {CLUSTER_BARRIER_US} us "
                     f"= {shape[1] * K1Q_BARRIERS_PER_COLUMN * CLUSTER_BARRIER_US * 1e-3:.3f} ms")
        launches = rec.calls[entry, shape]
        rows[entry][shape] = {"launches": launches, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "f64_ms": f64_ms}
        print(f"df loops: {name} route {plan.route}, {launches} launches: "
              f"{verdict}; max |kernel - plain| {diff:.3e}, repeat bitwise "
              f"{'equal' if same else 'DIFFERENT'}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by "
              f"{bound_by}{floor}, float64 library call {f64_ms:.4f} ms")
    return rows, max_abs, fails


# shapes past the kernels' shared memory, where the plans take route gmem:
# a CGS2 site of a rank-512 df rounding, a df_cholesky(block=256)
# diagonal block, a panel of 1536 columns
GMEM_SHAPES = {"df_qr": (1024, 512), "df_chol_block": (256, 256),
               "df_trsm_rlt": (256, 1536)}


def _gmem_checks(rec, dev):
    """Route gmem, the plans' route for shapes past shared memory.  On
    every shape ``rec`` recorded (K1q's cluster-route shapes, all of
    K1c's), bitwise against the route the path took: the same steps in
    the same orders with the operands in global memory.  Then at
    GMEM_SHAPES through the wrappers (one call each, recorded), held by
    ``_loop_checks`` against the plain loop and float64.  Returns
    (rows, max |kernel - plain|, failures) as ``_loop_checks`` does."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import df_loops as dl
    from xerus_tpu_torch.ops import mixed_precision as mp
    from xerus_tpu_torch.ops.df32 import df_from_f64
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    fns, fails = _loop_fns(), []
    equal, tried = dict.fromkeys(LOOP_ENTRIES, 0), dict.fromkeys(
        LOOP_ENTRIES, 0)
    for (entry, shape), args in sorted(rec.inputs.items()):
        plan = args[-1]
        if entry == "df_qr" and plan.route != "cluster":
            continue    # route cta keeps one band: another summation order
        a = fns[entry](*args[:-1], plan)
        b = fns[entry](*args[:-1], dl.gmem_plan(entry, shape))
        if entry == "df_qr":
            a, b = (*a[0], *a[1]), (*b[0], *b[1])
        tried[entry] += 1
        if all(torch.equal(x, y) for x, y in zip(a, b)):
            equal[entry] += 1
        else:
            fails.append(f"{entry} {shape}: route gmem differs from route "
                         f"{plan.route}")
    print(f"df loops: route gmem bitwise equal to the path's route at "
          + ", ".join(f"{equal[e]} of {tried[e]} {e} shapes"
                      for e in LOOP_ENTRIES))
    if not all(tried.values()):
        fails.append(f"route gmem compared at {tried} shapes")

    rng = np.random.default_rng(SEED)
    m, r = GMEM_SHAPES["df_qr"]
    a = rng.normal(size=(m, r))
    a[:, r // 3], a[:, r // 2] = 2.0 * a[:, 1], 0.0
    a[:, r - 1] = a[:, 0] - 3.0 * a[:, 2]
    B = GMEM_SHAPES["df_chol_block"][0]
    Qm, _ = np.linalg.qr(rng.normal(size=(B, B)))
    spd = (Qm * np.logspace(0, -6, B)) @ Qm.T
    mt, Bt = GMEM_SHAPES["df_trsm_rlt"]
    L = np.tril(rng.normal(size=(Bt, Bt)), -1) * 0.1 + np.diag(
        rng.uniform(0.5, 2.0, size=Bt))
    big = _LoopRecorder()
    with big:
        mp.df_qr(*df_from_f64(a, dev))
        dc._df_chol_unblocked(*df_from_f64(spd, dev))
        dc._df_trsm_rlt(*df_from_f64(rng.normal(size=(mt, Bt)), dev),
                        *df_from_f64(L, dev))
    for (entry, shape), args in big.inputs.items():
        if args[-1].route != "gmem":
            fails.append(f"{entry} {shape}: route {args[-1].route}, not "
                         "gmem")
    rows, max_abs, more = _loop_checks(big, "past shared memory")
    return rows, max_abs, fails + more


def _loop_summary(rows):
    """Means over shapes of ms, plain_ms, bound_ms and f64_ms, weighted
    by the launches recorded at each."""
    n = sum(r["launches"] for r in rows.values())
    return {k: sum(r["launches"] * r[k] for r in rows.values()) / n
            for k in ("ms", "plain_ms", "bound_ms", "f64_ms")}


def _df_round(cores64, target, eps, dev):
    """One timed tt_round_df_from_f64 with its CGS2 sites, host reads,
    info checks, K1 launches and K1q / K1c counts (``_loop_counts``
    differences)."""
    import torch
    from xerus_tpu_torch.ops import df_matvec as dfm
    from xerus_tpu_torch.ops import df_rounding as dr
    from xerus_tpu_torch.ops import round_kernels as rk
    before = (dr.tt_round_df.cgs2_fallbacks, rk.host_bool.reads,
              _linalg_checks(), dfm.df_matvec.launches)
    loops0 = _loop_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dr.tt_round_df_from_f64(cores64, target, eps=eps, device=dev)
    wall = time.perf_counter() - t0
    after = (dr.tt_round_df.cgs2_fallbacks, rk.host_bool.reads,
             _linalg_checks(), dfm.df_matvec.launches)
    loops = [tuple(a - b for a, b in zip(x, y))
             for x, y in zip(_loop_counts(), loops0)]
    return out, wall, [a - b for a, b in zip(after, before)], loops


def _df_round_loop_fails(name, fb, k1, loops, sites):
    """A df rounding's launch checks: no K1 (the column loops are K1c's
    and K1q's), every Cholesky block, panel and CGS2 call on a kernel (one
    launch per wrapper call), one K1q launch per orthogonalized site (both
    branches run, the defect selects on the device) and ``sites`` of them
    taking CGS2."""
    (q, blk, trsm), calls = loops
    fails = []
    if k1:
        fails.append(f"{name}: {k1} K1 launches")
    if (q, blk, trsm) != calls:
        fails.append(f"{name}: launches {(q, blk, trsm)} for wrapper calls "
                     f"{calls}")
    if q != ROUND_D - 1 or fb != sites or blk == 0 or trsm == 0:
        fails.append(f"{name}: K1q {q} for {ROUND_D - 1} sites, {fb} CGS2 "
                     f"sites (expected {sites}), K1c {blk} blocks and "
                     f"{trsm} panels")
    return fails


def _cgs2_sites(name, cores64, dev, sites):
    """tt_round_df's left-to-right orthogonalization of ``cores64`` site by
    site on the card (its make_qr_apply step run eagerly; the target and
    eps do not enter it): the sites whose CholeskyQR defect passes
    CGS2_DEFECT and so take CGS2, printed beside ``sites`` (their number
    while the df column loops ran eagerly), and at every site K1q's
    deficiency decisions from its norms and thresholds (``stats``), held
    against the plain version's where a column's norm lies within
    CGS2_NEAR of its threshold.  Prints one line; returns the failures
    (a flipped decision)."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import df_loops as dl
    from xerus_tpu_torch.ops import df_rounding as dr
    from xerus_tpu_torch.ops import mixed_precision as mp
    from xerus_tpu_torch.ops.df32 import df_from_f64, df_to_f64
    from xerus_tpu_torch.ops.ozaki import ozaki_matmul
    pairs = [df_from_f64(c, dev) for c in cores64]
    ch, cl = [p[0] for p in pairs], [p[1] for p in pairs]
    taken, defects, deficient, near, flips = [], [], 0, 0, []
    for k in range(len(ch) - 1):
        rl, n, rr = ch[k].shape
        mh, ml = ch[k].reshape(rl * n, rr), cl[k].reshape(rl * n, rr)
        qh, ql, _rh, _rl = dr._df_qr_chol(mh, ml)
        gh, gl = ozaki_matmul(qh.T, ql.T, qh, ql)
        eye = torch.eye(rr, dtype=gh.dtype, device=dev)
        defect = float(torch.linalg.vector_norm((gh - eye) + gl))
        defects.append(defect)
        stats = torch.zeros((rr, 2), device=dev)
        dl.df_qr_launch(mh, ml, dl.df_qr_plan(rl * n, rr), stats)
        st = stats.cpu().numpy().astype(np.float64)
        kd = st[:, 0] <= st[:, 1]
        deficient += int(kd.sum())
        ratio = st[:, 0] / st[:, 1]
        close = (ratio > 1.0 / CGS2_NEAR) & (ratio < CGS2_NEAR)
        near += int(close.sum())
        if close.any():
            pd = np.diag(df_to_f64(*mp.df_qr_reference(mh, ml)[1])) == 0.0
            flips += [f"site {k} column {j}: kernel "
                      f"{'deficient' if kd[j] else 'kept'} (norm "
                      f"{st[j, 0]:.6e}, threshold {st[j, 1]:.6e}), plain "
                      f"{'deficient' if pd[j] else 'kept'}"
                      for j in np.flatnonzero(kd != pd)]
        qh, ql, ph, pl, took = dr._qr_apply(mh, ml, ch[k + 1].reshape(rr, -1),
                                            cl[k + 1].reshape(rr, -1))
        if bool(took):
            taken.append(k)
        ch[k], cl[k] = qh.reshape(rl, n, rr), ql.reshape(rl, n, rr)
        ch[k + 1] = ph.reshape(ch[k + 1].shape)
        cl[k + 1] = pl.reshape(cl[k + 1].shape)
    border = sorted(range(len(defects)),
                    key=lambda k: abs(np.log(defects[k] / dr.CGS2_DEFECT)))
    print(f"df loops: {name}: CGS2 sites {taken} ({len(taken)}; eager "
          f"loops: {sites}); the defects nearest CGS2_DEFECT "
          f"{dr.CGS2_DEFECT:g}: "
          + ", ".join(f"site {k} {defects[k]:.3e}" for k in border[:3])
          + f"; K1q deficient columns {deficient} over the sites, {near} "
          f"within {CGS2_NEAR:g}x of their threshold, held to the plain "
          f"version: " + ("; ".join(flips) if flips else "no flipped "
                          "decision"))
    return [f"{name}: K1q's deficiency decisions flip: " + "; ".join(flips)
            ] if flips else []


def _df_programs(dev, smi, cases):
    """The df rounding's site programs (make_qr_apply, make_svd_site,
    make_trunc_apply) on ``cases`` (name, float64 cores, target, eps, CGS2
    sites), each rounded once already in this phase: its plain version
    (``eager=True``), then programmed calls until one captures nothing and
    runs no program eagerly (a replayed rounding), then one more under
    torch.profiler counting K4 (the seed of each site's df_svd) and K1q by
    kernel name on the device; then df_solve_spd_chol's program.  Fails
    unless the replayed rounding is bitwise the plain one, reads one σ a
    truncated site and the CGS2 count once, makes no eigh info check and
    runs one K4 and one K1q a site.  Returns K4's launches in a replayed
    df rounding."""
    import numpy as np
    from xerus_tpu_torch.ops import df_rounding as dr
    from xerus_tpu_torch.ops import small_eig as se
    from xerus_tpu_torch.ops import programs as pg
    from xerus_tpu_torch.ops.df32 import df_from_f64
    fails = []
    for name, cores64, target, eps, sites in cases:
        walls = {}
        t0 = time.perf_counter()
        plain = dr.tt_round_df_from_f64(cores64, target, eps, dev, eager=True)
        walls["eager"] = time.perf_counter() - t0
        calls = []
        while True:
            counts0 = (pg.Program.captures, pg.Program.eager_runs)
            out, wall, (fb, reads, checks, k1), loops = _df_round(
                cores64, target, eps, dev)
            calls.append(wall)
            if (pg.Program.captures, pg.Program.eager_runs) == counts0:
                break
            if len(calls) == 4:
                fails.append(f"{name}: still capturing at call "
                             f"{len(calls) + 1}")
                break
        same = all(a.shape == b.shape and (a == b).all()
                   for a, b in zip(out, plain))
        # each truncated site's df_svd solves the (rl, rl) Gram of its left
        # rank on K4
        routes = {m: se.eigh_plan(m).route for m in
                  sorted({int(c.shape[0]) for c in cores64[1:]})}
        _, (k4, k1q) = _kernel_counts(
            lambda: dr.tt_round_df_from_f64(cores64, target, eps, dev),
            (K4_KERNEL, K1Q_KERNEL))
        print(f"programs: {name}: eager {walls['eager']:.3f} s, programmed "
              f"calls {', '.join(f'{w:.3f}' for w in calls)} s (after this "
              f"phase's first; the last replays every site program); "
              f"replayed bitwise the eager rounding: {same}; per replayed "
              f"rounding: host reads {reads} ({ROUND_D - 1} spectra and the "
              f"CGS2 count with K4's health record), eigh info checks "
              f"{checks}, CGS2 sites {fb} (eager loops: {sites}), K1q "
              f"launches {loops[0][0]} (every site: both branches run), "
              f"on the device under torch.profiler {k4} {K4_KERNEL} and "
              f"{k1q} {K1Q_KERNEL} kernels; K4's route by Gram size "
              f"{routes} ({smi})")
        if not same:
            fails.append(f"{name}: the replayed rounding differs from the "
                         "eager one")
        if reads != ROUND_D or checks or k4 != ROUND_D - 1 \
                or k1q != ROUND_D - 1:
            fails.append(f"{name}: host reads {reads}, info checks {checks},"
                         f" K4 {k4}, K1q {k1q} on the device (expected "
                         f"{ROUND_D}, 0, {ROUND_D - 1}, {ROUND_D - 1})")
        fails += _df_round_loop_fails(name, fb, k1, loops, sites)
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    n, kappa, steps = DF_SOLVE
    A = _spd(n, kappa)
    b = A @ np.random.default_rng(3).normal(size=n)
    args = df_from_f64(A, dev) + df_from_f64(b, dev)
    dc.make_df_solve_spd_chol.cache_clear()
    _programmed(f"df_solve_spd_chol n={n} kappa={kappa:g} {steps} steps",
                lambda: dc.make_df_solve_spd_chol(n, "float32", 64,
                                                  steps)(*args),
                lambda: dc.df_solve_spd_chol(*args, refine_iters=steps),
                lambda: dc.make_df_solve_spd_chol(n, "float32", 64, steps),
                smi)
    if fails:
        raise AssertionError("programs: " + "; ".join(fails))
    return k4


def _rest_method(method, cores):
    from xerus_tpu_torch.ops import round_uniform as ru
    if method == "streaming":
        return ru.tt_round_streaming_uniform(cores, ROUND_TARGET)
    return ru.tt_round_sweep_uniform(cores, ROUND_TARGET, method=method)


def phase_rounding_rest(dev, smi, slice_round):
    """The rest of TT rounding at full width, on phase_round_slice's
    instance and float64 LAPACK chain: double-word rounding (random and
    a 1e-9 cliff with eps), the Ozaki GEMM, the df solve and SVD, the
    uniform, parallel and streaming roundings in f32 and f64 at core
    level and through ``TTTensor.round_fast`` (card vs ``host()``).
    The df roundings and the df solve run with K1q's and K1c's inputs
    recorded (``_LoopRecorder``); each entry is then held on one call per
    shape (``_loop_checks``).  Returns those rows, each entry's largest
    |kernel - plain| and its launches in the df roundings and the df
    solve."""
    import numpy as np
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (cliff_instance, cpu_round_sweep,
                                          host_tt_distance, host_tt_log_norm)
    from xerus_tpu_torch.ops import mixed_precision as mp
    from xerus_tpu_torch.ops import round_kernels as rk
    from xerus_tpu_torch.ops import round_uniform as ru
    from xerus_tpu_torch.ops.df32 import df_from_f64
    t_phase = time.perf_counter()

    def lap(what):
        print(f"rounding rest: {what} done at "
              f"{time.perf_counter() - t_phase:.1f} s into the phase")

    def loop_counts(fb, k1, loops):
        return (f"CGS2 sites {fb} of {ROUND_D - 1}, K1 launches {k1}, K1q "
                f"launches {loops[0][0]}, K1c launches {loops[0][1]} "
                f"(blocks) + {loops[0][2]} (panels)")

    host, chain, ref = (slice_round["host"], slice_round["chain"],
                        slice_round["ref"])
    fails = []
    host64 = [np.asarray(c, np.float64) for c in host]

    # double-word rounding of the slice instance, counted, with K1q's and
    # K1c's inputs recorded; their counts zeroed here and read after the
    # df solve
    rec = _LoopRecorder()
    for fn in _loop_fns().values():
        fn.launches = 0
    with rec:
        out, wall, (fb, reads, checks, k1), loops = _df_round(
            host64, ROUND_TARGET, 0.0, dev)
    rel = abs(host_tt_log_norm(out) - ref) / abs(ref)
    dist = host_tt_distance(out, chain) / np.exp(ref)
    svd32 = slice_round["svd_f32_rel"]
    print(f"rounding rest: tt_round_df d={ROUND_D} rank {ROUND_RANK}->"
          f"{ROUND_TARGET}: log-norm {rel:.3e} from the f64 chain (bar "
          f"{DF_ROUND_BAR:g}; the JAX package's CPU run "
          f"{JAX_DF_REACH[0]:.4g}; the f32 svd rounding's {svd32:.3e} "
          f"{'misses' if svd32 > DF_ROUND_BAR else 'MEETS'} it), distance "
          f"to the f64 chain {dist:.3e} relative (no bar: the cut is "
          f"gapless), wall {wall:.2f} s, host reads {reads}, eigh info "
          f"checks {checks}, {loop_counts(fb, k1, loops)} (eager loops: "
          f"{EAGER_CGS2_SITES[0]} CGS2 sites)")
    if not rel <= DF_ROUND_BAR:
        fails.append(f"df rounding log-norm {rel:.3e}")
    if not svd32 > DF_ROUND_BAR:
        fails.append("the f32 svd rounding meets the df bar: no contrast")
    fails += _df_round_loop_fails("df rounding", fb, k1, loops,
                                  EAGER_CGS2_SITES[0])

    # the cliff below f32's resolution, rounded with eps
    sig, scale, eps = DF_CLIFF
    cl64 = cliff_instance(host64, sig, scale)
    t0 = time.perf_counter()
    chain_c = cpu_round_sweep(cl64, ROUND_RANK, eps=eps)
    t_chain = time.perf_counter() - t0
    with rec:
        out_c, wall, (fb, reads, checks, k1), loops = _df_round(
            cl64, ROUND_RANK, eps, dev)
    r_df = [int(c.shape[2]) for c in out_c[:-1]]
    r_ch = [int(c.shape[2]) for c in chain_c[:-1]]
    dist = (host_tt_distance(out_c, chain_c)
            / np.exp(host_tt_log_norm(chain_c)))
    print(f"rounding rest: tt_round_df cliff (slots past {sig} x {scale:g}) "
          f"to {ROUND_RANK} with eps {eps:g}: interior ranks "
          f"{'equal' if r_df == r_ch else 'DIFFER FROM'} the f64 svd-eps "
          f"chain's (max {max(r_df)} vs {max(r_ch)}; the chain took "
          f"{t_chain:.1f} s on the host), distance {dist:.3e} relative (bar "
          f"{DF_CLIFF_BAR:g}; the JAX package's CPU run "
          f"{JAX_DF_REACH[1]:.4g}), wall {wall:.2f} s, host reads {reads}, "
          f"eigh info checks {checks}, {loop_counts(fb, k1, loops)} (eager "
          f"loops: {EAGER_CGS2_SITES[1]} CGS2 sites)")
    if r_df != r_ch:
        fails.append(f"cliff ranks {r_df} vs {r_ch}")
    if not dist <= DF_CLIFF_BAR:
        fails.append(f"cliff distance {dist:.3e}")
    fails += _df_round_loop_fails("cliff rounding", fb, k1, loops,
                                  EAGER_CGS2_SITES[1])
    lap("the df roundings")
    fails += _ozaki_checks(dev)
    with rec:
        fails += _df_linalg_checks(dev, host)
    path_launches = dict(zip(LOOP_ENTRIES, _loop_counts()[0]))
    lap("Ozaki and the df linear algebra")
    # K1q's cluster route at the rounding's (512, 256), on an unfolding of
    # the instance where no CGS2 site recorded one (0 launches: not a path
    # call)
    key = ("df_qr", (2 * ROUND_RANK, ROUND_RANK))
    if key not in rec.inputs:
        extra = _LoopRecorder()
        with extra:
            mp.df_qr(*df_from_f64(host64[ROUND_D // 2].reshape(
                2 * ROUND_RANK, ROUND_RANK), dev))
        if key in extra.inputs:     # none on the CPU (a rehearsal)
            rec.inputs[key], rec.calls[key] = extra.inputs[key], 0
    loop_rows, loop_max_abs, loop_fails = _loop_checks(rec, "rounding rest")
    fails += loop_fails
    gmem_rows, gmem_abs, gmem_fails = _gmem_checks(rec, dev)
    fails += gmem_fails
    for e in LOOP_ENTRIES:
        loop_max_abs[e] = max(loop_max_abs[e], gmem_abs[e])
    lap("K1q and K1c on their recorded inputs")
    fails += _cgs2_sites(f"tt_round_df d={ROUND_D} rank {ROUND_RANK}",
                         host64, dev, EAGER_CGS2_SITES[0])
    fails += _cgs2_sites(f"tt_round_df cliff {sig} x {scale:g}", cl64, dev,
                         EAGER_CGS2_SITES[1])
    lap("the CGS2 sites")
    t0 = time.perf_counter()
    df_k4 = _df_programs(dev, smi, [
        (f"tt_round_df d={ROUND_D} rank {ROUND_RANK}->{ROUND_TARGET}",
         host64, ROUND_TARGET, 0.0, EAGER_CGS2_SITES[0]),
        (f"tt_round_df cliff to {ROUND_RANK} eps {eps:g}", cl64, ROUND_RANK,
         eps, EAGER_CGS2_SITES[1])])
    print(f"programs: the df programs block {time.perf_counter() - t0:.1f} "
          "s")
    lap("the df site programs")

    # the uniform, parallel and streaming roundings at core level
    e_svd = host_tt_distance(host, chain)
    for dtype in (torch.float32, torch.float64):
        cores = list(cores_to_torch(host, dev, dtype))
        for method in ("cholqr", "gram_parallel", "subspace_parallel",
                       "streaming"):
            _rest_method(method, cores)
            torch.cuda.synchronize()
            reads0, checks0 = rk.host_bool.reads, _linalg_checks()
            t0 = time.perf_counter()
            h = _to_host(_rest_method(method, cores))
            wall = time.perf_counter() - t0
            reads = rk.host_bool.reads - reads0
            checks = _linalg_checks() - checks0
            name = f"{method} {str(dtype)[6:]}"
            if not all(np.all(np.isfinite(c)) for c in h):
                fails.append(f"{name}: non-finite")
                continue
            if method == "cholqr":
                q = abs(host_tt_log_norm(h) - ref) / abs(ref)
                bar = CHOLQR_BAR[str(dtype)[6:]]
                verdict = f"log-norm {q:.3e} from the svd chain (bar {bar:g})"
                ok = q <= bar
            else:
                q = host_tt_distance(host, h) / e_svd
                verdict = (f"error {q:.4f}x the svd chain's (bar "
                           f"{QUASI_FACTORS[method]:g}x)")
                ok = q <= QUASI_FACTORS[method]
            print(f"rounding rest: {name} d={ROUND_D} rank {ROUND_RANK}->"
                  f"{ROUND_TARGET}: {verdict}, wall {wall:.4f} s (after a "
                  f"warm-up), host reads {reads}, eigh info checks {checks}")
            if not ok:
                fails.append(f"{name}: {verdict}")

    lap("the core-level roundings")

    # round_fast on the TTTensor in float64, card vs host(), one set of
    # streaming sketches for both
    cpu = torch.device("cpu")
    sk = ru._streaming_sketches(ROUND_D, ROUND_N, ROUND_TARGET, 32,
                                torch.float64, cpu)
    real_sketches = ru._streaming_sketches
    ru._streaming_sketches = (
        lambda d, n, l, psi, dtype, device, generator=None:
        tuple([t.to(device, dtype) for t in part] for part in sk))
    rng = np.random.default_rng(SEED)
    pert = [c * (1.0 + 1e-15 * rng.standard_normal(c.shape))
            for c in host64]

    def run(cores, d_, method):
        t = xt.convert.tt_from_numpy(cores, device=d_)
        reads0, checks0 = rk.host_bool.reads, _linalg_checks()
        if d_.type == "cpu":
            with xt.host():
                t0 = time.perf_counter()
                t.round_fast(ROUND_TARGET, method=method)
                wall = time.perf_counter() - t0
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.round_fast(ROUND_TARGET, method=method)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return ([np.asarray(c.to_ndarray()) for c in t.components], wall,
                rk.host_bool.reads - reads0, _linalg_checks() - checks0)

    try:
        for method in ("cholqr", "gram_parallel", "subspace_parallel",
                       "streaming"):
            card, w_card, reads, checks = run(host64, dev, method)
            cpu_r, w_cpu, _r, _c = run(host64, cpu, method)
            cpu_p = run(pert, cpu, method)[0]
            nrm = np.exp(host_tt_log_norm(cpu_r))
            diff = host_tt_distance(card, cpu_r) / nrm
            sens = host_tt_distance(cpu_p, cpu_r) / nrm
            bar = CARD_HOST_BARS[method]
            print(f"rounding rest: TTTensor.round_fast({ROUND_TARGET}, "
                  f"{method!r}) f64: card vs host() {diff:.3e} relative "
                  f"(bar {bar:.3e}, from the JAX package's change under "
                  f"a 1e-15 relative perturbation of the cores; host()'s "
                  f"own change {sens:.3e}), wall card {w_card:.3f} s / "
                  f"host() {w_cpu:.3f} s, card host reads {reads}, eigh info "
                  f"checks {checks}, max rank "
                  f"{max(c.shape[-1] for c in card[:-1])}")
            if not diff <= bar:
                fails.append(f"round_fast {method}: card vs host() "
                             f"{diff:.3e}")
    finally:
        ru._streaming_sketches = real_sketches
    print(f"rounding rest: phase {time.perf_counter() - t_phase:.1f} s "
          f"({smi})")
    if fails:
        raise AssertionError("rounding rest: " + "; ".join(fails))
    return loop_rows, loop_max_abs, path_launches, gmem_rows, df_k4


def _k2_bond_times(cores, inputs=None):
    """K2's device time in one gemm_exact rounding to ROUND_TARGET, bond by
    bond (``examples/k2_grid.py`` ``k2_calls``: CUDA events around each
    call of the wrapper): each bond's shape, column bucket, ms and flags.
    A list ``inputs`` receives each launch's (cur, keep, keep_cap,
    outputs)."""
    from xerus_tpu_torch.examples import k2_grid
    calls = k2_grid.k2_calls(cores, ROUND_TARGET)
    if inputs is not None:
        inputs.extend((cur, keep, cap, out)
                      for cur, keep, cap, _ms, _f, out in calls)
    return [(tuple(cur.shape), cap, ms, f)
            for cur, _keep, cap, ms, f, _out in calls]


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
            B, M, cap, f["outer"], f["ns"], f["ns_rows"], polish,
            f["retries"], f["retry_stops"]), "float32")
        total, bound = total + ms, bound + b_ms
        print(f"breakdown: K2 bond {n} ({B}, {M}) cap {cap}: {ms:.3f} ms, "
              f"bound {b_ms:.4f} ms; outer {f['outer']}, Newton-Schulz "
              f"{f['ns']}, retries {f['retries']}, certified "
              f"{f['converged']}, CTAs per cluster {f['cluster_ctas']}")
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


# K4 and K5 (ops/small_eig.py, csrc/jacobi.cu): Jacobi eigh and SVD in
# float64 at the eigensolver path's shapes: the Ritz problems (m = 24 for
# Lanczos, 3 for LOBPCG; batch 4 for the multistart race) and the masked
# splits (2r, 2r) at max_rank 16 / 32 / 64 and (60, 60) in dmrg_solve at
# rank 30; then (256, 256): the seed of the df rounding's df_svd at its
# widest bonds (K4 on route cluster) and a wide SVD.  Each against its
# plain version, torch.linalg.eigh /
# svd(driver="gesvd") and its bound; value gaps relative to the largest
# value, ||Q^T Q - I|| as its largest entry, reconstructions relative in
# the Frobenius norm, all within JAC_BAR up to n = 128 and JAC_BAR n / 128
# past it: rounding grows with the rotations a column takes (about
# sweeps x n; K4's (256, 256) reconstruction 1.339e-13 on an H100)
JAC_EIGH = [("Ritz, Lanczos", 1, 24), ("Ritz, multistart", 4, 24),
            ("Ritz, LOBPCG", 1, 3), ("Ritz, LOBPCG multistart", 4, 3),
            ("past the path", 1, 256)]
JAC_SVD = [("split, rank 16", 1, 32, 32), ("split, multistart", 4, 32, 32),
           ("split, rank 32", 1, 64, 64), ("split, rank 64", 1, 128, 128),
           ("split, dmrg_solve rank 30", 1, 60, 60),
           ("past the path", 1, 256, 256)]
JAC_BAR = 1e-13
# graded splits (sigma = logspace(0, -11) under seeded orthogonal factors,
# the grading of the DMRG blocks): K5's QR-preconditioned Jacobi must take
# at most JAC_GRADED_SWEEPS sweeps (one-sided Jacobi alone took up to 27)
JAC_GRADED = [("graded split, rank 16", 32), ("graded split, rank 64", 128)]
JAC_GRADED_SWEEPS = 12
# pairs of cluster sizes that must give the same bits: (kind, n, sizes)
JAC_CLUSTER_PAIRS = [("eigh", 64, (1, 2)), ("eigh", 256, (8, 16)),
                     ("svd", 64, (2, 4)), ("svd", 128, (4, 8))]
# route gmem (the columns in global memory) against route cluster at the
# same plan, which must give the same bits: (kind, n, cluster size)
JAC_GMEM_PAIRS = [("eigh", 64, 2), ("eigh", 256, 16), ("svd", 32, 1),
                  ("svd", 128, 16)]
# past a cluster's shared memory, where the plans take route gmem: against
# torch.linalg only (the plain version would take minutes there)
JAC_PAST_SMEM = [("eigh", 512), ("svd", 384)]
# K4's route cluster on one CTA against route cta at the Ritz shapes
JAC_ONE_CTA = [24, 3]
# the main shapes of the kernels line: the rank-16 Lanczos solve's
JAC_MAIN = {"small_eigh": "Ritz, Lanczos", "small_svd": "split, rank 16"}
# kernel names of K4 (its cta and cluster routes share the prefix) and K5
# (csrc/jacobi.cu), counted on the device
K4_KERNEL, K5_KERNEL = "small_eigh_", "small_svd_kernel"


def _ritz_matrix(rng, m=24, valid=10):
    """A Lanczos Ritz matrix as dmrg_kernels._ritz_smallest makes it: a
    tridiagonal block of ``valid`` steps, the other directions lifted by
    1e4 (max|T| + 1)."""
    import numpy as np
    T = np.zeros((m, m))
    a, b = rng.standard_normal(valid), rng.random(valid - 1)
    T[:valid, :valid] = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    return T + np.diag([0.0] * valid + [1e4 * (np.abs(T).max() + 1.0)]
                       * (m - valid))


def _deficient_split(rng, r=16, n=2, right=3):
    """The (r n, n r) two-site block at a chain's boundary: the left bond
    of true rank 2 and ``right`` on the right, the padded rows and columns
    exact zeros; sigma is zero from min(2 n, n right) on."""
    import numpy as np
    G = np.zeros((r, n, n, r))
    G[:2, :, :, :right] = rng.standard_normal((2, n, n, right))
    return G.reshape(r * n, n * r)


def _function_ops(kind, shape):
    """FP64 operations the function needs, whatever computes it (Golub and
    Van Loan's counts): a symmetric eigh with its vectors about 9 m^3 a
    matrix (the symmetric QR algorithm); a thin SVD with U and V of R
    rows and C <= R columns min(14 R C^2 + 8 C^3, 6 R C^2 + 20 C^3)
    (Golub-Reinsch or R-SVD).  The bound counts these."""
    B = shape[0]
    if kind == "eigh":
        return B * 9 * shape[1] ** 3
    R, C = max(shape[1:]), min(shape[1:])
    return B * min(14 * R * C * C + 8 * C ** 3, 6 * R * C * C + 20 * C ** 3)


def _jacobi_ops(kind, shape, h):
    """FP64 operations Jacobi did in one launch, from its health record
    ``h``: K4 the pair tests of every sweep and the rotations done; K5
    besides them the pivoted QR (4 R C^2 - 4 C^3 / 3), the left factor's
    reflectors (4 R C^2) and the final norms.  Printed beside the bound,
    which counts ``_function_ops``."""
    B = shape[0]
    if kind == "eigh":
        m = shape[1]
        pairs = m * (m - 1) // 2
        return h["total_sweeps"] * pairs * 6 + h["rotations"] * (18 * m + 20)
    R, C = max(shape[1:]), min(shape[1:])
    pairs = C * (C - 1) // 2
    return (h["total_sweeps"] * pairs * 6 * C
            + h["rotations"] * (12 * C + 20)
            + B * (8 * R * C * C - 4 * C ** 3 // 3 + 2 * C * C))


def _graded(n, seed):
    """sigma = logspace(0, -11, n) under seeded orthogonal factors."""
    import numpy as np
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((n, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (U * np.logspace(0, -11, n)) @ V.T


def _jacobi_case(kind, name, A, dev, smi):
    """One K4 or K5 case on the card: kernel, plain version, torch.linalg
    on the same input; gaps, orthogonality, reconstruction, times, bound.
    Returns (row, fails)."""
    import torch
    from xerus_tpu_torch.ops import small_eig as se
    fails = []
    shape = tuple(A.shape)
    se.check_health(dev)
    if kind == "eigh":
        plan = se.eigh_plan(shape[1])
        w, V, st = se.small_eigh_launch(A)
        h = se.check_health(dev)
        wp, Vp, sp = se.small_eigh_plain(A)
        wl = torch.linalg.eigh(A)[0]
        vals, plain_vals, lib_vals = w, wp, wl
        factors = [V]
        rec = V @ torch.diag_embed(w) @ V.transpose(1, 2)
        run = lambda: se.small_eigh_launch(A)              # noqa: E731
        plain = lambda: se.small_eigh_plain(A)             # noqa: E731
        lib = lambda: torch.linalg.eigh(A)                 # noqa: E731
        nbytes = 8 * A.numel() * 2 + 8 * w.numel()
        lib_name = "torch.linalg.eigh"
    else:
        plan = se.svd_plan(*shape[1:])
        U, S, Vh, st = se.small_svd_launch(A)
        h = se.check_health(dev)
        Up, Sp, Vhp, sp = se.small_svd_plain(A)
        Sl = torch.linalg.svd(A, full_matrices=False, driver="gesvd")[1]
        vals, plain_vals, lib_vals = S, Sp, Sl
        factors = [U, Vh.transpose(1, 2)]
        rec = U @ torch.diag_embed(S) @ Vh
        run = lambda: se.small_svd_launch(A)               # noqa: E731
        plain = lambda: se.small_svd_plain(A)              # noqa: E731
        lib = lambda: torch.linalg.svd(A, full_matrices=False,  # noqa: E731
                                       driver="gesvd")
        nbytes = 8 * (A.numel() + U.numel() + S.numel() + Vh.numel())
        lib_name = "torch.linalg.svd(gesvd)"
    torch.cuda.synchronize()
    scale = float(lib_vals.abs().max()) or 1.0
    gap_plain = float((vals - plain_vals).abs().max())
    gap_lib = float((vals - lib_vals).abs().max()) / scale
    orth = max(float((Q.transpose(1, 2) @ Q - torch.eye(
        Q.shape[-1], dtype=Q.dtype, device=dev)).abs().max())
        for Q in factors)
    rel = float((rec - A).norm() / (A.norm() if float(A.norm()) else 1.0))
    reps = 50 if A.shape[-1] <= 64 else 10
    ms = _time_ms(run, reps=reps)
    plain_ms = _wall_ms(plain, reps=1)
    lib_ms = _time_ms(lib, reps=reps)
    ops, jac_ops = _function_ops(kind, shape), _jacobi_ops(kind, shape, h)
    bound_ms, bound_by = _bound(nbytes, ops, "float64")
    sweeps = st.tolist()
    print(f"jacobi: K{4 if kind == 'eigh' else 5} {name} {shape}: route "
          f"{plan.route} ({plan.ctas} CTA{'s' if plan.ctas > 1 else ''} of "
          f"{plan.threads} threads a matrix), sweeps {sweeps} (plain "
          f"{sp.tolist()}), rotations "
          f"{h['rotations']}, Jacobi's FP64 operations {jac_ops} against "
          f"the function's {ops} (the bound's, {jac_ops / ops:.2f}x); gap "
          f"to the plain version {gap_plain:.3e}, "
          f"value gap to {lib_name} {gap_lib:.3e} of the largest, "
          f"||Q^T Q - I|| {orth:.3e}, ||A - rec|| / ||A|| {rel:.3e} (bar "
          f"{JAC_BAR * max(1.0, max(shape[1:]) / 128):g}); {ms:.4f} ms, plain {plain_ms:.2f} ms, {lib_name} "
          f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
          f"({bound_ms / ms:.2%} reached); {smi}")
    bar = JAC_BAR * max(1.0, max(shape[1:]) / 128)
    if not (min(sweeps) > 0 and gap_plain <= bar * scale
            and gap_lib <= bar and orth <= bar and rel <= bar):
        fails.append(f"K{4 if kind == 'eigh' else 5} {name} {shape}")
    row = {"shape": list(shape), "route": plan.route, "ctas": plan.ctas,
           "threads": plan.threads, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms, "max_abs_err": gap_plain,
           "sweeps_max": max(sweeps), "ops": ops, "jacobi_ops": jac_ops}
    return row, fails


def _jacobi_past_smem(kind, n, rng, dev, smi):
    """K4 or K5 at (1, n, n) on route gmem against torch.linalg: value
    gap, orthogonality and reconstruction within JAC_BAR n / 128, and both
    times.  Returns the fails."""
    import torch
    from xerus_tpu_torch.ops import small_eig as se
    A = torch.from_numpy(rng.standard_normal((1, n, n))).to(dev)
    if kind == "eigh":
        A = A + A.transpose(1, 2)
        plan = se.eigh_plan(n)
        run = lambda: se.small_eigh_launch(A)              # noqa: E731
        lib = lambda: torch.linalg.eigh(A)                 # noqa: E731
        w, V, st = run()
        vals, lib_vals, factors = w, lib()[0], [V]
        rec = V @ torch.diag_embed(w) @ V.transpose(1, 2)
        lib_name = "torch.linalg.eigh"
    else:
        plan = se.svd_plan(n, n)
        run = lambda: se.small_svd_launch(A)               # noqa: E731
        lib = lambda: torch.linalg.svd(A, full_matrices=False,  # noqa: E731
                                       driver="gesvd")
        U, S, Vh, st = run()
        vals, lib_vals, factors = S, lib()[1], [U, Vh.transpose(1, 2)]
        rec = U @ torch.diag_embed(S) @ Vh
        lib_name = "torch.linalg.svd(gesvd)"
    se.check_health(dev)
    scale = float(lib_vals.abs().max())
    gap = float((vals - lib_vals).abs().max()) / scale
    orth = max(float((Q.transpose(1, 2) @ Q - torch.eye(
        n, dtype=Q.dtype, device=dev)).abs().max()) for Q in factors)
    rel = float((rec - A).norm() / A.norm())
    ms, lib_ms = _time_ms(run, reps=5), _time_ms(lib, reps=5)
    bar = JAC_BAR * n / 128
    print(f"jacobi: K{4 if kind == 'eigh' else 5} past a cluster's shared "
          f"memory (1, {n}, {n}): route {plan.route} ({plan.ctas} CTAs of "
          f"{plan.threads} threads, {plan.smem} bytes of shared memory "
          f"each), sweeps {st.tolist()}; value gap to {lib_name} {gap:.3e} "
          f"of the largest, ||Q^T Q - I|| {orth:.3e}, ||A - rec|| / ||A|| "
          f"{rel:.3e} (bar {bar:g}); {ms:.4f} ms, {lib_name} {lib_ms:.4f} "
          f"ms ({ms / lib_ms:.2f}x); {smi}")
    if not (plan.route == se.GMEM and int(st[0]) > 0 and gap <= bar
            and orth <= bar and rel <= bar):
        return [f"K{4 if kind == 'eigh' else 5} (1, {n}, {n}) on route gmem"]
    return []


def _jacobi_one_cta(rng, dev, smi):
    """K4's route cluster forced onto one CTA against route cta at the
    Ritz shapes: both times on the same input, and their eigenvalues
    within JAC_BAR.  Returns the fails."""
    import torch
    from xerus_tpu_torch.ops import small_eig as se
    fails = []
    for m in JAC_ONE_CTA:
        A = rng.standard_normal((1, m, m))
        A = torch.from_numpy(A + A.transpose(0, 2, 1)).to(dev)
        one = se.eigh_plan(m, se.CLUSTER, 1)
        w_cta = se.small_eigh_launch(A)[0]
        w_one = se.small_eigh_launch(A, one)[0]
        se.check_health(dev)
        gap = float((w_cta - w_one).abs().max()) / float(w_cta.abs().max())
        ms_cta = _time_ms(lambda: se.small_eigh_launch(A), reps=50)
        ms_one = _time_ms(lambda: se.small_eigh_launch(A, one), reps=50)
        print(f"jacobi: K4 (1, {m}, {m}): route cta {ms_cta:.4f} ms, route "
              f"cluster on one CTA ({one.threads} threads, mm {one.mm}) "
              f"{ms_one:.4f} ms ({ms_one / ms_cta:.2f}x); eigenvalue gap "
              f"{gap:.3e} of the largest; {smi}")
        if gap > JAC_BAR:
            fails.append(f"K4 (1, {m}, {m}) on one cluster CTA")
    return fails


def phase_jacobi(dev, smi):
    """K4 and K5 against their plain versions and torch.linalg on the card
    at the eigensolver path's shapes and (256, 256), and K5 on graded
    splits (at most ``JAC_GRADED_SWEEPS`` sweeps); the penalized Ritz
    matrix; a rank-deficient boundary split (an orthonormal U where sigma
    is zero); two cluster sizes bitwise equal, and route gmem bitwise route
    cluster; route gmem past a cluster's shared memory against
    torch.linalg; K4's route cluster on one CTA against route cta at the
    Ritz shapes.  Returns {kernel: {"rows":
    {case: row}, "max_abs_err": ...}}."""
    import numpy as np
    import torch
    from xerus_tpu_torch.ops import small_eig as se
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    out = {"small_eigh": {"rows": {}}, "small_svd": {"rows": {}}}
    fails = []
    for name, B, m in JAC_EIGH:
        A = rng.standard_normal((B, m, m))
        A = torch.from_numpy(A + A.transpose(0, 2, 1)).to(dev)
        row, f = _jacobi_case("eigh", name, A, dev, smi)
        out["small_eigh"]["rows"][name] = row
        fails += f
    for name, B, M, N in JAC_SVD:
        A = torch.from_numpy(rng.standard_normal((B, M, N))).to(dev)
        row, f = _jacobi_case("svd", name, A, dev, smi)
        out["small_svd"]["rows"][name] = row
        fails += f
    for name, n in JAC_GRADED:
        A = torch.from_numpy(_graded(n, SEED + n)[None]).to(dev)
        row, f = _jacobi_case("svd", name, A, dev, smi)
        out["small_svd"]["rows"][name] = row
        fails += f
        print(f"jacobi: K5 {name} ({n}, {n}), sigma 1 .. 1e-11: "
              f"{row['sweeps_max']} sweeps (bar {JAC_GRADED_SWEEPS}; "
              f"one-sided Jacobi alone took up to 27 on the DMRG splits)")
        if row["sweeps_max"] > JAC_GRADED_SWEEPS:
            fails.append(f"K5 {name}: {row['sweeps_max']} sweeps")
    for kernel in out.values():
        kernel["max_abs_err"] = max(r["max_abs_err"]
                                    for r in kernel["rows"].values())

    # the penalized Ritz matrix: the valid block's lowest pair resolved to
    # its own scale under a 1e4 (max|T| + 1) lift
    T = _ritz_matrix(rng)
    w, V, st = se.small_eigh(torch.from_numpy(T[None]).to(dev))
    ref_w, ref_v = np.linalg.eigh(T[:10, :10])
    v0 = V[0, :, 0].cpu().numpy()
    gap = abs(float(w[0, 0]) - ref_w[0]) / np.abs(T[:10, :10]).max()
    align = 1.0 - abs(float(v0[:10] @ ref_v[:, 0]))
    print(f"jacobi: K4 penalized Ritz matrix (24, 10 valid): lowest "
          f"eigenvalue gap {gap:.3e} of the block's scale, 1 - |<v, v_ref>| "
          f"{align:.3e}, lifted components {np.abs(v0[10:]).max():.3e}, "
          f"sweeps {st.tolist()}")
    if not (gap <= JAC_BAR and align <= JAC_BAR and int(st[0]) > 0):
        fails.append("the penalized Ritz matrix")

    # a rank-deficient split: sigma zero within the kept rank
    A = torch.from_numpy(np.stack([_deficient_split(rng)
                                   for _ in range(2)])).to(dev)
    U, S, Vh, st = se.small_svd(A)
    zeros = int((S[0] == 0).sum())
    orth = float((U.transpose(1, 2) @ U - torch.eye(32, dtype=U.dtype,
                                                    device=dev)).abs().max())
    rel = float((U @ torch.diag_embed(S) @ Vh - A).norm() / A.norm())
    print(f"jacobi: K5 rank-deficient split (32, 32), rank "
          f"{32 - zeros}: {zeros} zero sigma, ||U^T U - I|| {orth:.3e} with "
          f"the completion, ||A - U S Vh|| / ||A|| {rel:.3e}, sweeps "
          f"{st.tolist()}")
    if not (zeros == 32 - min(2 * 2, 2 * 3) and orth <= JAC_BAR and rel <= JAC_BAR
            and int(st.min()) > 0):
        fails.append("the rank-deficient split")

    # every element's arithmetic is the same whichever CTA does it: two
    # cluster sizes of a route give the same bits
    same = []
    for kind, n, sizes in JAC_CLUSTER_PAIRS:
        A = torch.from_numpy(rng.standard_normal((2, n, n))).to(dev)
        if kind == "eigh":
            A = A + A.transpose(1, 2)
            a, b = (se.small_eigh_launch(A, se.eigh_plan(n, se.CLUSTER, c))
                    for c in sizes)
        else:
            a, b = (se.small_svd_launch(A, se.svd_plan(n, n, c))
                    for c in sizes)
        same.append(all(torch.equal(x, y) for x, y in zip(a, b)))
    se.check_health(dev)
    print("jacobi: cluster sizes bitwise equal: " + ", ".join(
        f"K{4 if kind == 'eigh' else 5} (2, {n}, {n}) on {sizes[0]} and "
        f"{sizes[1]} CTAs {ok}" for (kind, n, sizes), ok
        in zip(JAC_CLUSTER_PAIRS, same)))
    if not all(same):
        fails.append("two cluster sizes differ")
    # route gmem runs route cluster's steps in the same orders
    same = []
    for kind, n, c in JAC_GMEM_PAIRS:
        A = torch.from_numpy(rng.standard_normal((2, n, n))).to(dev)
        if kind == "eigh":
            A = A + A.transpose(1, 2)
            a, b = (se.small_eigh_launch(A, se.eigh_plan(n, r, c))
                    for r in (se.CLUSTER, se.GMEM))
        else:
            a, b = (se.small_svd_launch(A, se.svd_plan(n, n, c, r))
                    for r in (se.CLUSTER, se.GMEM))
        same.append(all(torch.equal(x, y) for x, y in zip(a, b)))
    se.check_health(dev)
    print("jacobi: route gmem bitwise route cluster: " + ", ".join(
        f"K{4 if kind == 'eigh' else 5} (2, {n}, {n}) on {c} CTA"
        f"{'s' if c > 1 else ''} {ok}" for (kind, n, c), ok
        in zip(JAC_GMEM_PAIRS, same)))
    if not all(same):
        fails.append("route gmem differs from route cluster")
    for kind, n in JAC_PAST_SMEM:
        fails += _jacobi_past_smem(kind, n, rng, dev, smi)
    fails += _jacobi_one_cta(rng, dev, smi)
    print(f"jacobi: phase {time.perf_counter() - t0:.1f} s")
    if fails:
        raise AssertionError("jacobi: " + "; ".join(fails))
    return out


def _adf(inst, dev, max_iterations):
    import torch
    from xerus_tpu_torch.algorithms import ADFVariant, adf_cores
    from xerus_tpu_torch.convert import cores_to_torch
    return adf_cores(
        ADFVariant(max_iterations, COMPLETION_TARGET, 0.9999),
        list(cores_to_torch(inst.start, dev, torch.float64)),
        inst.measurements, max_ranks=inst.max_ranks, check_every="device")


def phase_completion_small(dev):
    """Benchmark workload 5 (d=5, n=4, rank 3, 400 samples) on the card and
    on the CPU, where the plain versions run: both below the target at
    ranks [3, 3, 3, 3], the largest entry found exactly, and the two
    recovered tensors alike."""
    import numpy as np
    import torch
    from xerus_tpu_torch.algorithms import find_largest_entry_cores
    from xerus_tpu_torch.examples import host_full_tensor, workload5_instance
    full = {}
    for name, device in (("card", dev), ("CPU", torch.device("cpu"))):
        inst = workload5_instance()
        t0 = time.perf_counter()
        out = _adf(inst, device, 400)
        pos = find_largest_entry_cores(out.cores, accuracy=0.05)
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
    _adf_programs(inst, dev, out, wall)
    return launches, {"residual": out.residual, "iterations": out.iterations,
                      "ranks": out.ranks, "grid error": grid_err,
                      "wall": wall}


def _adf_programs(inst, dev, out, wall):
    """The d=10 solve again with its iteration program replayed (the main
    path's run ran it eagerly ``programs.EAGER_CALLS`` times, then captured
    it) and eagerly (the plain loop of ``adf_adaptive_run``,
    ``eager=True``): iterations, ranks, histories and cores equal to the
    main path's bit for bit, walls and ms per iteration; then 20
    iterations of each under torch.profiler for the device's idle
    share."""
    import functools
    import torch
    from xerus_tpu_torch.ops import adf_kernels as ak
    real = ak.adf_adaptive_run

    def run(eager, iterations=2000):
        ak.adf_adaptive_run = functools.partial(real, eager=eager)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = _adf(inst, dev, iterations)
            torch.cuda.synchronize()
            return o, time.perf_counter() - t0
        finally:
            ak.adf_adaptive_run = real

    runs = {"main path's run (captures)": (out, wall),
            "replay": run(False), "eager": run(True)}
    for name, (o, w) in runs.items():
        hist_diff = max(abs(a - b) for a, b in zip(o.history, out.history))
        cores_equal = all(torch.equal(a, b) for a, b in zip(o.cores,
                                                             out.cores))
        print(f"completion programs: {name} {w:.3f} s, {o.iterations} "
              f"iterations ({w / o.iterations * 1e3:.3f} ms each), ranks "
              f"{o.ranks}, residual {o.residual:.6e}; against the main "
              f"path's run: max |history diff| {hist_diff:.3e}, cores "
              f"bitwise equal {cores_equal}")
        if o.iterations != out.iterations or o.ranks != out.ranks \
                or hist_diff != 0.0 or not cores_equal:
            raise AssertionError(f"completion {name}: iterations, ranks, "
                                 "history or cores differ from the main "
                                 "path's run")
    for eager in (True, False):
        w, busy, kernels = _device_busy(lambda: run(eager, 20))
        idle = ("not measured (the profiler saw no device time)"
                if busy is None else f"{1.0 - busy / w:.3f}")
        print(f"completion programs: 20 iterations "
              f"{'eager' if eager else 'replayed'} under torch.profiler "
              f"{w:.3f} s wall, {kernels} kernels, device busy "
              f"{busy if busy is None else round(busy, 4)} s, idle share "
              f"{idle}")


def phase_iht(dev):
    """IHT at workload 5's size on the card (K3 once per iteration and once
    per step-size trial) against the same on the CPU."""
    import numpy as np
    import torch
    from xerus_tpu_torch.algorithms import iht_cores
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
        _x, res[name] = iht_cores(x0, inst.measurements, IHT_ITERATIONS)
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
    return res["card"]


# the object layer (misc/, core/, indexing/) through its public names, in
# float64: each case against host numpy/scipy, then rerun under host() on
# the CPU; the SPD and non-symmetric systems have the size of slice 1's
# interior local systems
OBJ_SVD_DIMS = [32, 32, 32, 32]          # split 2 | 2: 1024 x 1024, 8 MB
OBJ_TALL_DIMS = [2048, 512]
OBJ_N = 1800
OBJ_LSQ = (2048, 1024, 512)              # rows, columns, rank
OBJ_CON = (1024, 32, 8)                  # i = j, k = l, m
OBJ_SPARSE = (4096, 0.005, 1024)         # [n, n] at this fill x [n, cols]
OBJ_REL = 1e-12                          # reconstructions, spectra, products
OBJ_SOLVE_REL = 1e-10                    # solve residuals, least squares
OBJ_REPS = 5


def _rel(a, b) -> float:
    import numpy as np
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _solve_route(perf):
    """The last solve route a solve entered, from the performance counters."""
    sections = perf._CALLS.get("Dense LAPACK", {})
    taken = [route for section, route in (("Solve (Cholesky)", "cholesky"),
                                          ("Solve (PLU)", "lu"),
                                          ("Solve Least Squares",
                                           "least squares"))
             if section in sections]
    return taken[-1] if taken else None


def _objects_cases(xt, timer):
    """Every case of the objects phase on the current compute device.
    Checks the bars that need no second device and returns the gauge-free
    results (reconstructions, spectra, ranks, solutions, products) for the
    card-vs-CPU comparison.  ``timer(name, object_fn, bare_fn)`` times
    both calls (on the card only)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from xerus_tpu_torch.core import factorizations as fact
    from xerus_tpu_torch.indexing import evaluate as ev
    from xerus_tpu_torch.misc import performance as perf
    out = {}

    def check(name, value, bar):
        print(f"objects: {name} {value:.3e} (bar {bar:g})")
        if not value <= bar:
            raise AssertionError(f"objects: {name} {value:.3e} above {bar:g}")

    def np_rank(s):
        return max(int(np.sum(s >= 16 * np.finfo(np.float64).eps * s[0])), 1)

    def orth(q):
        """max |Q^T Q - I| of a matrix with orthonormal columns."""
        eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
        return float((q.T @ q - eye).abs().max())

    xt.set_seed(SEED)
    A = xt.Tensor.random(OBJ_SVD_DIMS)
    rows_a = OBJ_SVD_DIMS[0] * OBJ_SVD_DIMS[1]
    sq = f"{rows_a}x{A.size // rows_a}"
    a_np = A.to_ndarray().reshape(rows_a, -1)
    i, j, k, l, m, r1, r2 = xt.indices(7)

    # SVD through the DSL
    U, S, Vt, rec = (xt.Tensor() for _ in range(4))

    def svd():
        (U(i, j, r1), S(r1, r2), Vt(r2, k, l)) << xt.SVD(A(i, j, k, l))

    svd()
    rec(i, j, k, l) << U(i, j, r1) * S(r1, r2) * Vt(r2, k, l)
    s = np.diag(S.to_ndarray())
    s_np = np.linalg.svd(a_np, compute_uv=False)
    check(f"SVD {sq} reconstruction", _rel(rec.to_ndarray(),
                                           A.to_ndarray()), OBJ_REL)
    check("SVD singular values vs numpy, max |ds| / s0",
          float(np.abs(s - s_np).max() / s_np[0]), OBJ_REL)
    out["svd rec"], out["svd s"] = rec.to_ndarray(), s
    US = xt.contract(U, S, 1)             # dense x the SVD's sparse S
    if xt.config.device.type == "cuda" and not (torch.is_tensor(US._dense)
                                                and US._dense.is_cuda):
        raise AssertionError("objects: U * S left the card")
    a_dev = A.to_torch().reshape(rows_a, -1)
    timer(f"SVD {sq} (DSL)", svd, lambda: fact._svd(a_dev))

    # QR, RQ, QC, CQ on A, on a tall matricization and on a rank-512 matrix
    xt.set_seed(SEED + 1)
    tall = xt.Tensor.random(OBJ_TALL_DIMS)
    g = np.random.Generator(np.random.PCG64(SEED + 2))
    rows, cols, rank = OBJ_LSQ
    low = g.normal(size=(rows, rank)) @ g.normal(size=(rank, cols))
    deficient = xt.Tensor.from_ndarray(low)
    tall_name = "x".join(map(str, OBJ_TALL_DIMS))
    for tname, t, split in ((sq, A, 2), (tall_name, tall, 1),
                            (f"{rows}x{cols} rank {rank}", deficient, 1)):
        s_ref = np.linalg.svd(t.to_ndarray().reshape(
            int(np.prod(t.dimensions[:split])), -1), compute_uv=False)
        for kind in ("QR", "RQ", "QC", "CQ"):
            if kind in ("QR", "RQ") and "rank" in tname:
                continue
            L, R = xt.Tensor(), xt.Tensor()
            f = getattr(xt, kind)
            lhs = (i, j)[:split]
            rhs = (k, l)[:t.degree() - split]

            def run(L=L, R=R, f=f, t=t, lhs=lhs, rhs=rhs):
                (L(*lhs, r1), R(r1, *rhs)) << f(t(*lhs, *rhs))

            run()
            r = L.dimensions[-1]
            got = xt.contract(L, R, 1).to_ndarray()
            check(f"{kind} {tname} reconstruction",
                  _rel(got, t.to_ndarray()), OBJ_REL)
            q = (L.to_torch().reshape(-1, r) if kind in ("QR", "QC")
                 else R.to_torch().reshape(r, -1).T)
            check(f"{kind} {tname} orthogonality max |Q^T Q - I|", orth(q),
                  OBJ_REL)
            if kind in ("QC", "CQ"):
                print(f"objects: {kind} {tname} rank {r}, host numpy's rank "
                      f"by the same rule {np_rank(s_ref)}")
                if r != np_rank(s_ref):
                    raise AssertionError(f"objects: {kind} {tname} rank {r}")
            out[f"{kind} {tname}"] = got
            out[f"{kind} {tname} rank"] = r
            if tname == tall_name:
                mat = t.to_torch().reshape(OBJ_TALL_DIMS)
                bare = {"QR": lambda: torch.linalg.qr(mat),
                        "RQ": lambda: torch.linalg.qr(
                            torch.flip(mat, [0]).T),
                        "QC": lambda: fact._svd(mat),
                        "CQ": lambda: fact._svd(mat.T)}[kind]
                timer(f"{kind} {tname} (DSL)", run, bare)

    # x(i) << b(j) / A(j, i): SPD (Cholesky), non-symmetric (LU),
    # rank-deficient rectangular (minimum-norm least squares)
    g = np.random.Generator(np.random.PCG64(SEED + 3))
    G = g.normal(size=(OBJ_N, OBJ_N))
    systems = {"SPD": G @ G.T / OBJ_N + np.eye(OBJ_N),
               "non-symmetric": G / np.sqrt(OBJ_N) + 2 * np.eye(OBJ_N),
               "rank-deficient": low}
    for name, mat in systems.items():
        M = xt.Tensor.from_ndarray(mat)
        b = xt.Tensor.from_ndarray(g.normal(size=mat.shape[0]))
        x = xt.Tensor()

        def solve(M=M, b=b, x=x):
            x(i) << b(j) / M(j, i)

        perf.enable(True)
        perf.clear_analysis()
        try:
            solve()
            route = _solve_route(perf)
        finally:
            perf.enable(False)
            perf.clear_analysis()
        xv, bv = x.to_ndarray(), b.to_ndarray()
        if name == "rank-deficient":
            ref = np.linalg.lstsq(mat, bv, rcond=None)[0]
            check(f"solve {name} {mat.shape[0]}x{mat.shape[1]} (route "
                  f"{route}) vs numpy's minimum-norm solution",
                  _rel(xv, ref), OBJ_SOLVE_REL)
        else:
            check(f"solve {name} {OBJ_N}x{OBJ_N} (route {route}) residual",
                  _rel(mat @ xv, bv), OBJ_SOLVE_REL)
        want = {"SPD": "cholesky", "non-symmetric": "lu",
                "rank-deficient": "least squares"}[name]
        if route != want:
            raise AssertionError(f"objects: solve {name} took {route}")
        out[f"solve {name}"] = xv
        m_dev, b_dev = M.to_torch(), b.to_torch()[:, None]
        bare = {"SPD": lambda: torch.cholesky_solve(
                    b_dev, torch.linalg.cholesky(m_dev)),
                "non-symmetric": lambda: torch.linalg.solve(m_dev, b_dev),
                "rank-deficient": lambda: fact._svd(m_dev)}[name]
        timer(f"solve {name} ({route})", solve, bare)

    # contraction and a planned chain
    n_i, n_k, n_m = OBJ_CON
    xt.set_seed(SEED + 4)
    B = xt.Tensor.random([n_i, n_k, n_k])
    D = xt.Tensor.random([n_k, n_i, n_k])
    F = xt.Tensor.random([n_i, n_m])
    C, E = xt.Tensor(), xt.Tensor()

    def con():
        C(i, j) << B(i, k, l) * D(k, j, l)

    def chain():
        E(i, m) << B(i, k, l) * D(k, j, l) * F(j, m)

    con()
    chain()
    bn, dn, fn = B.to_ndarray(), D.to_ndarray(), F.to_ndarray()
    check("contraction C(i,j) << B(i,k,l) * D(k,j,l) vs np.einsum",
          _rel(C.to_ndarray(), np.einsum("ikl,kjl->ij", bn, dn,
                                         optimize=True)), OBJ_REL)
    check("chain E(i,m) << B(i,k,l) * D(k,j,l) * F(j,m) vs np.einsum",
          _rel(E.to_ndarray(), np.einsum("ikl,kjl,jm->im", bn, dn, fn,
                                         optimize=True)), OBJ_REL)
    labels = ((0, 1, 2), (1, 3, 2), (3, 4))
    shapes = (tuple(B.dimensions), tuple(D.dimensions), tuple(F.dimensions))
    plan = ev.contraction_plan(labels, (0, 4), shapes)
    print(f"objects: chain plan {plan}: "
          f"{ev.plan_flops(labels, shapes, plan):,} FLOPs planned, "
          f"{ev.plan_flops(labels, shapes, ev.left_to_right_plan(3)):,} "
          f"left to right")
    out["contraction"], out["chain"] = C.to_ndarray(), E.to_ndarray()
    b_dev, d_dev, f_dev = B.to_torch(), D.to_torch(), F.to_torch()
    timer(f"contraction {n_i}x{n_k * n_k}x{n_i} (DSL)", con,
          lambda: torch.tensordot(b_dev, d_dev, dims=([1, 2], [0, 2])))
    timer("chain (DSL, planned) vs torch.einsum (left to right)", chain,
          lambda: torch.einsum("ikl,kjl,jm->im", b_dev, d_dev, f_dev))

    # sparse x dense past DEVICE_SPARSE_THRESHOLD
    n_s, fill, n_c = OBJ_SPARSE
    xt.set_seed(SEED + 5)
    Sp = xt.Tensor.random([n_s, n_s], n=int(fill * n_s * n_s))
    Dd = xt.Tensor.random([n_s, n_c])
    P = xt.Tensor()

    def sparse():
        P(i, j) << Sp(i, k) * Dd(k, j)

    sparse()
    pos, val = Sp.sparse_coo()
    csr = sp.csr_matrix((val, (pos // n_s, pos % n_s)), shape=(n_s, n_s))
    check(f"sparse [{n_s}, {n_s}] ({len(val)} entries) x dense "
          f"[{n_s}, {n_c}] vs scipy", _rel(P.to_ndarray(),
                                           csr @ Dd.to_ndarray()), OBJ_REL)
    if not (Sp.is_sparse() and P.is_dense()):
        raise AssertionError("objects: sparse x dense must give dense")
    out["sparse"] = P.to_ndarray()
    if P._dense.device.type != xt.config.device.type:
        raise AssertionError("objects: the sparse product left the device")
    with warnings.catch_warnings():       # torch's beta notes on sparse
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([pos // n_s, pos % n_s])),
            torch.from_numpy(val), (n_s, n_s)).to(Dd.to_torch().device)
        csr_dev, d_dev = coo.to_sparse_csr(), Dd.to_torch()
    timer("sparse x dense (DSL, index_add_) vs torch sparse CSR @ dense",
          sparse, lambda: csr_dev @ d_dev)
    if d_dev.device.type == "cuda":       # where the object call's time goes
        from xerus_tpu_torch.ops.sparse_kernels import sparse_times_dense
        coo_ms = _wall_ms(Sp.sparse_coo, OBJ_REPS)
        dev_ms = _wall_ms(lambda: sparse_times_dense(pos, val, (n_s, n_s),
                                                     d_dev), OBJ_REPS)
        print(f"objects: sparse x dense split: the {{position: value}} dict "
              f"to sorted COO on the host {coo_ms:.3f} ms, COO upload + "
              f"gather + index_add_ {dev_ms:.3f} ms (median of {OBJ_REPS})")

    # the captured matrix on which gesdd returned nan
    fx = np.load(os.path.join(HERE, "tests", "data",
                              "gesdd_failure_96x96.npy"))
    T = xt.Tensor.from_ndarray(fx)
    U2, S2, V2 = xt.calculate_svd(T, 1)
    Cq, Qq = xt.calculate_cq(T, 1)
    s2 = np.diag(S2.to_ndarray())
    if not np.isfinite(s2).all():
        raise AssertionError("objects: gesdd fixture spectrum not finite")
    check("gesdd fixture 96x96 SVD reconstruction",
          _rel(xt.contract(xt.contract(U2, S2, 1), V2, 1).to_ndarray(), fx),
          OBJ_REL)
    check("gesdd fixture 96x96 CQ reconstruction",
          _rel(xt.contract(Cq, Qq, 1).to_ndarray(), fx), OBJ_REL)
    out["gesdd s"], out["gesdd cq rank"] = s2, Cq.dimensions[-1]
    fx_dev = T.to_torch()
    timer("gesdd fixture 96x96 SVD", lambda: xt.calculate_svd(T, 1),
          lambda: fact._svd(fx_dev))
    out["factors"] = (U, S, Vt)
    return out


def phase_objects(dev, smi):
    """The object layer on the card at the widths the port's paths reach,
    in float64: SVD, QR/RQ/QC/CQ, the three solve routes, a contraction
    and a planned chain, sparse x dense on the device, files, the gesdd
    fixture; each object call timed beside the bare torch call, then every
    case rerun under host() and held against the card's results."""
    import tempfile
    import numpy as np
    import xerus_tpu_torch as xt
    t0 = time.perf_counter()

    def timer(name, obj, bare):
        t_obj, t_bare = _wall_ms(obj, OBJ_REPS), _wall_ms(bare, OBJ_REPS)
        print(f"objects time: {name}: object call {t_obj:.3f} ms, bare "
              f"torch call {t_bare:.3f} ms (median of {OBJ_REPS}, "
              f"synchronized; {smi})")

    if xt.config.device.type != "cuda" or xt.config.device != dev:
        raise AssertionError("objects: the object layer's default device is "
                             "not the card")
    card = _objects_cases(xt, timer)
    U, S, Vt = card.pop("factors")
    build = os.path.join(HERE, "xerus_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for fmt in ("BINARY", "TSV"):
            for name, t in (("U", U), ("S", S), ("Vt", Vt)):
                path = os.path.join(tmp, f"{name}.{fmt}")
                t1 = time.perf_counter()
                xt.save_to_file(t, path, getattr(xt.FileFormat, fmt))
                back = xt.load_from_file(path)
                secs = time.perf_counter() - t1
                same = (back.dimensions == t.dimensions
                        and back.representation == t.representation
                        and np.array_equal(back.to_ndarray(), t.to_ndarray()))
                print(f"objects: save/load {fmt} {name} {t.dimensions} "
                      f"{t.representation.name}: bitwise {same}, "
                      f"{os.path.getsize(path):,} bytes, {secs:.3f} s")
                if not same:
                    raise AssertionError(f"objects: {fmt} round trip of "
                                         f"{name} not bitwise")
    card_secs = time.perf_counter() - t0
    with xt.host():
        cpu = _objects_cases(xt, lambda *args: None)
    cpu.pop("factors")
    worst = 0.0
    for key, value in card.items():
        if isinstance(value, np.ndarray):
            worst = max(worst, _rel(value, cpu[key]))
        elif value != cpu[key]:
            raise AssertionError(f"objects: card and CPU differ on {key}")
    print(f"objects: card vs CPU (host()) over {len(card)} results: worst "
          f"relative difference {worst:.3e} (bar {OBJ_REL:g}); card part "
          f"{card_secs:.1f} s, whole phase {time.perf_counter() - t0:.1f} s")
    if not worst <= OBJ_REL:
        raise AssertionError("objects: card and CPU disagree")


# the column-pivoted Householder QR (phase_pivoted_qr): the left and right
# splits of the rank-30 QTT cores and a square block, float64
QRP_SHAPES = [(60, 30), (30, 60), (256, 256)]
QRP_REL = 1e-12            # sign-fixed factors vs the CPU, contract checks
QRP_TT = (32, 30)          # d, rank of the object route's TTTensor
QRP_TT_REL = 1e-12         # log-norms and inner products vs the SVD route


def _qrp_signs(r):
    import torch
    s = torch.sign(torch.diagonal(r))
    return torch.where(s == 0, torch.ones_like(s), s)


def _qrp_program_case(shape, dev, smi):
    """householder_qrp as a program at ``shape`` on the card: two eager
    calls, the capture, two replays; held against the plain version on
    the CPU (pivots over the numerical rank, sign-fixed factors, contract)
    and each replay bitwise the eager run; times by CUDA events beside the
    SVD route's."""
    import numpy as np
    import torch
    from xerus_tpu_torch.core import factorizations as fact
    from xerus_tpu_torch.ops import pivoted_qr as pq
    from xerus_tpu_torch.ops.programs import Program
    m, n = shape
    host = torch.from_numpy(np.random.default_rng([SEED, m, n]).normal(
        size=shape))
    a = host.to(dev)
    prog = Program(pq.householder_qrp, f"qrp[{m}x{n}]")
    walls, outs = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(prog(a))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    eager = pq.householder_qrp(a)
    same = [_bitwise(o, eager) for o in outs]
    q0, r0, p0 = pq.householder_qrp(host)
    q, r, p = (t.cpu() for t in outs[-1])
    diag = torch.diagonal(r0).abs()
    rank = int((diag >= 16 * np.finfo(np.float64).eps * diag[0]).sum())
    pivots = bool(torch.equal(p[:rank], p0[:rank]))
    s, s0 = _qrp_signs(r), _qrp_signs(r0)
    gap_q = float((q * s - q0 * s0).abs().max() / q0.abs().max())
    gap_r = float((s[:, None] * r - s0[:, None] * r0).abs().max()
                  / r0.abs().max())
    k = min(m, n)
    contract = float((host[:, p.long()] - q @ r).abs().max()
                     / host.abs().max())
    orth = float((q.T @ q - torch.eye(k, dtype=q.dtype)).abs().max())
    d = torch.diagonal(r).abs()
    monotone = bool((d[:-1] >= d[1:] - QRP_REL * d[0]).all())
    reps, warmup = 20, 2
    t_replay = _time_ms(lambda: prog(a), reps=reps, warmup=warmup)
    t_eager = _time_ms(lambda: pq.householder_qrp(a), reps=5, warmup=1)
    t_svd = _time_ms(lambda: fact._svd_robust(a), reps=5, warmup=1)
    print(f"qrp: ({m}, {n}) float64: replay {t_replay:.4f} ms, eager "
          f"{t_eager:.4f} ms (CUDA events), capture and instantiation "
          f"{prog.capture_s:.3f} s, {prog.nodes} graph nodes, pool "
          f"{prog.pool_bytes / 2 ** 20:.1f} MiB; SVD route (_svd_robust, "
          f"gesvd) {t_svd:.4f} ms; call walls "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms (eager, eager, "
          f"capture, replay, replay); rank {rank}, pivots over it equal to "
          f"the CPU's {pivots}, sign-fixed Q / R vs the CPU {gap_q:.2e} / "
          f"{gap_r:.2e}, |a[:, perm] - q r| {contract:.2e}, |q^T q - I| "
          f"{orth:.2e}, |diag R| non-increasing {monotone}, each call "
          f"bitwise the eager run {same} ({smi})")
    fails = []
    if (prog.eager_runs, prog.captures, prog.replays) != (
            2, 1, 2 + reps + warmup):
        fails.append(f"{prog.eager_runs} eager runs, {prog.captures} "
                     f"captures, {prog.replays} replays")
    if not all(same):
        fails.append(f"calls bitwise the eager run: {same}")
    if not pivots:
        fails.append("pivots differ from the CPU's over the rank")
    if not max(gap_q, gap_r, contract, orth) <= QRP_REL or not monotone:
        fails.append(f"factors {gap_q:.2e} / {gap_r:.2e}, contract "
                     f"{contract:.2e}, orthonormality {orth:.2e}, "
                     f"monotone {monotone}")
    if fails:
        raise AssertionError(f"qrp: ({m}, {n}): {'; '.join(fails)}")


def _qrp_move_core(tt, method):
    """tt's core moved to the end and back on the ``method`` QC route:
    (the TT, wall in s, syncs torch's sync debug mode reports)."""
    import torch
    from xerus_tpu_torch.core import factorizations as fact
    z = tt.copy()
    saved = fact._QC_METHOD
    fact._QC_METHOD = method
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                z.move_core(tt.num_components() - 1)
                z.move_core(0)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall = time.perf_counter() - t0
    finally:
        fact._QC_METHOD = saved
    return z, wall, sum("synchroniz" in str(w.message) for w in caught)


def phase_pivoted_qr(dev, smi):
    """The column-pivoted Householder QR (ops/pivoted_qr.py) as a captured
    program at the QTT splits' shapes and (256, 256), held against the CPU,
    then the QC / CQ route XERUS_TPU_QC_METHOD=qrp through move_core on a
    d=32 rank-30 TTTensor and on its rank-deficient double x + x, held
    against the SVD route (ranks, log-norms, inner products)."""
    import math
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.ops import pivoted_qr as pq
    from xerus_tpu_torch.ops.programs import Program
    t0 = time.perf_counter()
    for shape in QRP_SHAPES:
        _qrp_program_case(shape, dev, smi)
    t_programs = time.perf_counter() - t0
    d, rank = QRP_TT
    xt.set_seed(SEED)
    x = xt.TTTensor.random([2] * d, rank)
    double = x.copy()
    double.canonicalized = False
    double = double + double
    for name, tt in ((f"rank-{rank}", x), ("x + x", double)):
        runs = {}
        for method in ("svd", "qrp", "svd", "qrp", "qrp", "qrp"):
            counts0 = (Program.eager_runs, Program.captures, Program.replays)
            z, wall, syncs = _qrp_move_core(tt, method)
            counts = [b - a for a, b in zip(counts0, (
                Program.eager_runs, Program.captures, Program.replays))]
            runs.setdefault(method, []).append((z, wall, syncs, counts))
        (zs, *_), (zq, *_) = runs["svd"][-1], runs["qrp"][-1]
        ns, nq = zs.frob_norm(), zq.frob_norm()
        log_gap = abs(math.log(nq) - math.log(ns)) / abs(math.log(ns))
        inner_gap = abs(xt.tt.inner(zq, zs) - ns * ns) / (ns * ns)
        print(f"qrp: move_core 0 -> {d - 1} -> 0, d={d} {name} (ranks in "
              f"{max(tt.ranks())}, out {max(zq.ranks())}): walls qrp "
              f"{' / '.join(f'{r[1]:.3f}' for r in runs['qrp'])} s "
              f"(programs eager / captured / replayed "
              f"{', '.join(str(r[3]) for r in runs['qrp'])}), svd "
              f"{' / '.join(f'{r[1]:.3f}' for r in runs['svd'])} s; host "
              f"syncs qrp {runs['qrp'][-1][2]}, svd {runs['svd'][-1][2]}; "
              f"ranks equal {zq.ranks() == zs.ranks()}, log-norm gap "
              f"{log_gap:.2e}, <qrp, svd> / |svd|^2 - 1 {inner_gap:.2e} "
              f"({smi})")
        if zq.ranks() != zs.ranks():
            raise AssertionError(f"qrp: {name}: ranks {zq.ranks()} against "
                                 f"the SVD route's {zs.ranks()}")
        if not max(log_gap, inner_gap) <= QRP_TT_REL:
            raise AssertionError(f"qrp: {name}: log-norm gap {log_gap:.2e}, "
                                 f"inner product gap {inner_gap:.2e}")
        # a shape met once a pass runs eagerly in the first two passes, is
        # captured in the third and replayed from the fourth on
        if sum(runs["qrp"][-1][3][:2]) or not runs["qrp"][-1][3][2]:
            raise AssertionError(f"qrp: {name}: the fourth qrp pass ran "
                                 f"{runs['qrp'][-1][3]} programs eager / "
                                 "captured / replayed")
    print(f"qrp: phase {time.perf_counter() - t0:.1f} s (programs "
          f"{t_programs:.1f} s), {pq.make_qrp.cache_info().currsize} "
          f"cached programs")


# the tensor network and TT classes (phase_tt_objects): the full-width
# instances of the first three slices through the public names, in
# float64, and the same at d=12 on the card and under host()
TT_SMALL = (12, 32, 16)                  # d, rank, target of the rerun
TT_LOGNORM_BAR = 1e-10     # svd round_fast and round() vs the host f64 chain
# gemm_exact vs svd log-norm: tighter than JAX's contract of 1e-8
# (tt/ttnetwork.py:746-748), between the float64 reading and the float32
# rounding's, which the phase requires this bar to refuse
TT_GE_BAR = 1e-10
# K2 against its plain version on each float64 bond of the rounding, set
# between the float64 readings and those of K2 run in float32 on the same
# bonds, which the phase requires these bars to refuse:
# ||P_kernel - P_plain||_F / ||P_plain||_F of the kept projectors
# P = vt^T vt (no gap at rank 128: the kept space turns by up to 4.5e-7
# where the two stop a few outer steps apart; float32 1.4e-3 and more),
# and the relative difference of the truncation errors
# ||cur - cur P||^2 / ||cur||^2 (float64 3e-14 at most, float32 1e-6 and
# more; NVIDIA H100, PERF.md)
K2_F64_PROJ_BAR = 1e-5
K2_F64_ERR_BAR = 1e-10
TT_DIFF_BAR = 1e-10        # frob_norm(z - w) / frob_norm(w) in TT form
TT_RESIDUAL_BAR = 1e-10    # the Poisson residual through objects
TT_RESIDUAL_ABS = 1e-12    # ... against the host-f64 residual of the slice
TT_REL = 1e-12             # inner routes, TT-SVD round trip, card vs host()
# results at the level of rounding noise: card and host() are each held
# to the bar, not to each other (y - w, gemm_exact against round(), is
# printed; gemm_exact is held to svd by its log-norm)
TT_NOISE = {"z - w": TT_DIFF_BAR, "TT-SVD error": TT_REL,
            "truth cast error": TT_REL}
TT_UNCOMPARED = ("y - w", "K2 launches")


def _tt_objects_cases(xt, round_host, target, poisson, truth, timer):
    """Steps 1-3 of the phase on the current compute device: the three
    object roundings of ``round_host``'s cores, the Poisson residual of
    ``poisson`` = (x, A, b) cores through the DSL, the three inner-product
    routes, the TT-SVD round trip of ``truth`` and a file round trip.
    Returns the gauge-free results; ``timer(name, fn)`` runs a timed
    call and returns its value."""
    import math
    import tempfile
    import numpy as np
    from xerus_tpu_torch.examples import host_full_tensor
    from xerus_tpu_torch.indexing import evaluate as ev
    from xerus_tpu_torch.network import heuristics, native
    from xerus_tpu_torch.ops import gemm_exact as ge
    from xerus_tpu_torch.tt import dsl as tt_dsl
    tt = xt.convert.tt_from_numpy
    out = {}
    fallbacks0 = tt_dsl.tt_assign.dense_fallbacks

    # 1. rounding through objects
    y, z, w = (tt(round_host) for _ in range(3))
    ge.reset_counters()
    timer("y.round_fast(gemm_exact)",
          lambda: y.round_fast(target, method="gemm_exact"))
    out["K2 launches"] = ge.gemm_exact_kernel.launches
    out["K2 svd fallbacks"] = ge.trunc_step_gemm_exact.svd_fallbacks
    timer("z.round_fast(svd)", lambda: z.round_fast(target, method="svd"))
    timer("w.round", lambda: w.round(target))
    i, j = xt.indices(2)
    for name, t in (("y", y), ("z", z), ("w", w)):
        out[f"{name} log-norm"] = math.log(t.frob_norm())
        out[f"{name} ranks"] = t.ranks()
        out[f"{name} flags"] = (t.canonicalized, t.corePosition)
    w_norm = w.frob_norm()
    out["z - w"] = xt.frob_norm(z(i & 0) - w(i & 0)) / w_norm
    out["y - w"] = xt.frob_norm(y(i & 0) - w(i & 0)) / w_norm

    # 2. the Poisson residual through objects
    xs, A_c, b_c = poisson
    x, A, b = tt(xs), tt(A_c, operator=True), tt(b_c)
    out["residual"] = timer("Poisson residual", lambda: xt.frob_norm(
        A(i / 2, j / 2) * x(j & 0) - b(i & 0))) / b.frob_norm()

    # 3. networks and conversions: inner(y, x) three ways
    out["inner sweep"] = timer("inner sweep", lambda: xt.tt.inner(y, x))
    s = xt.Tensor()
    timer("inner DSL", lambda: s() << y(i & 0) * x(i & 0))
    out["inner DSL"] = float(s[0])
    terms = [t for f in (y(i & 0), x(i & 0)) for t in ev._resolve_term(f)]
    mapping = {}
    ops = tuple(tuple(mapping.setdefault(l, len(mapping)) for l in t.labels)
                for t in terms)
    shapes = tuple(tuple(t.tensor.dimensions) for t in terms)
    out["DSL plan FLOPs"] = ev.plan_flops(
        ops, shapes, ev.contraction_plan(ops, (), shapes))
    net = xt.TensorNetwork()
    net() << y(i & 0) * x(i & 0)
    ids = {n for n, node in enumerate(net.nodes) if not node.erased}
    heuristics._PATH_CACHE.clear()
    calls0 = native.native_best_order.calls
    order = heuristics.best_contraction_order(net, ids)
    out["native search"] = native.native_best_order.calls > calls0
    graph = heuristics._Graph(net, ids)
    out["network plan FLOPs"] = int(2 * sum(graph.merge(a, c)
                                            for a, c in order))
    out["inner network"] = float(timer("inner network",
                                       lambda: net.to_tensor()[0]))
    out["|y| |x|"] = y.frob_norm() * x.frob_norm()
    out["inner y.w"] = xt.tt.inner(y, w)
    s2 = xt.Tensor()
    s2() << y(i & 0) * w(i & 0)
    out["inner y.w DSL"] = float(s2[0])

    # TT-SVD round trip of the completion truth
    T = xt.Tensor(tt(truth))
    ref = host_full_tensor(truth)
    out["truth cast error"] = _rel(T.to_ndarray().reshape(-1), ref)
    svd = timer("TT-SVD 4^10", lambda: xt.TTTensor(T, eps=1e-12))
    out["TT-SVD ranks"] = svd.ranks()
    back = xt.Tensor(svd)
    out["TT-SVD error"] = (back - T).frob_norm() / T.frob_norm()

    # file round trip of y
    build = os.path.join(HERE, "xerus_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "y.BINARY")
        xt.save_to_file(y, path, xt.FileFormat.BINARY)
        back_y = xt.load_from_file(path)
        out["file bitwise"] = (
            type(back_y) is type(y)
            and (back_y.canonicalized, back_y.corePosition)
            == (y.canonicalized, y.corePosition)
            and all(np.array_equal(a.to_ndarray(), c.to_ndarray())
                    for a, c in zip(back_y.components, y.components)))
    out["dense fallbacks"] = tt_dsl.tt_assign.dense_fallbacks - fallbacks0
    return out


def _tt_objects_bars(r, ref=None, host_residual=None):
    """The bars every run of the cases is held to."""
    fails = []
    if ref is not None:
        for name in ("z", "w"):
            rel = abs(r[f"{name} log-norm"] - ref) / abs(ref)
            if not rel <= TT_LOGNORM_BAR:
                fails.append(f"{name} log-norm {rel:.3e} from the f64 chain")
    ge_rel = abs(r["y log-norm"] - r["z log-norm"]) / abs(r["z log-norm"])
    if not ge_rel <= TT_GE_BAR:
        fails.append(f"gemm_exact log-norm {ge_rel:.3e} from svd's")
    if not r["y ranks"] == r["z ranks"] == r["w ranks"]:
        fails.append("the three roundings' ranks differ")
    if any(r[f"{n} flags"] != (True, 0) for n in "yzw"):
        fails.append("a rounding is not canonical at core 0")
    for key, bar in TT_NOISE.items():
        if not r[key] <= bar:
            fails.append(f"{key} {r[key]:.3e} above {bar:g}")
    if host_residual is not None:
        if not (r["residual"] <= TT_RESIDUAL_BAR and abs(
                r["residual"] - host_residual) <= TT_RESIDUAL_ABS):
            fails.append(f"residual {r['residual']:.3e} vs host "
                         f"{host_residual:.3e}")
    scale = r["|y| |x|"]
    for key in ("inner DSL", "inner network"):
        if not abs(r[key] - r["inner sweep"]) <= TT_REL * scale:
            fails.append(f"{key} {r[key]!r} vs the sweep "
                         f"{r['inner sweep']!r}")
    if not abs(r["inner y.w DSL"] - r["inner y.w"]) <= TT_REL * abs(
            r["inner y.w"]):
        fails.append("inner(y, w) routes differ")
    if not r["native search"]:
        fails.append("the native path optimizer did not plan the network")
    if not max(r["TT-SVD ranks"]) <= 8:
        fails.append(f"TT-SVD ranks {r['TT-SVD ranks']} above 8")
    if not r["file bitwise"]:
        fails.append("BINARY round trip of y not bitwise")
    if r["dense fallbacks"]:
        fails.append(f"{r['dense fallbacks']} TT expressions went dense")
    return fails


def _tt_card_vs_host(card, cpu):
    """(worst relative difference, failures) of the d=12 results on the
    card against the same under host(): each run held to the bars, ranks,
    flags and plans equal, values to TT_REL (log-norms absolutely, the
    norms' relative difference; the inner(y, x) routes relative to
    |y| |x|)."""
    fails = _tt_objects_bars(card) + _tt_objects_bars(cpu)
    worst = 0.0
    for key, value in card.items():
        if key in TT_NOISE or key in TT_UNCOMPARED:
            continue
        if isinstance(value, float):
            if key.endswith("log-norm"):
                scale = 1.0
            elif key in ("inner sweep", "inner DSL", "inner network"):
                scale = card["|y| |x|"]
            else:
                scale = abs(cpu[key])
            diff = abs(value - cpu[key]) / scale
            worst = max(worst, diff)
            if not diff <= TT_REL:
                fails.append(f"{key}: card {value!r}, host {cpu[key]!r}")
        elif value != cpu[key]:
            fails.append(f"{key}: card {value!r}, host {cpu[key]!r}")
    return worst, fails


def _k2_f64_against_plain(inputs):
    """K2 against its plain version on each captured float64 bond
    (``_k2_bond_times``' inputs): by decision, and by output through the
    kept projectors and the truncation errors (gauge-free); the float32
    control runs K2 on the same bond in float32.  Returns the plain
    version's certification per bond and, per bond, the kernel's
    {"proj", "err"} distances to the plain version and the control's
    {"proj32", "err32"} and the plain version's wall time "plain_ms" (one
    synchronized run)."""
    import torch
    from xerus_tpu_torch.ops import gemm_exact as ge
    plain_ok, dist = [], []
    for n, (cur, keep, cap, (vt0, vt_bal, flags)) in enumerate(inputs):
        fk = dict(zip(ge.FLAGS, flags.tolist()))
        mask = (torch.arange(cap, device=cur.device) < keep).to(cur.dtype)
        vk = ge._finish_gemm_exact(vt0, vt_bal, bool(fk["okp"]), mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vp, fp = _k2_run(cur, keep, cap, False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        v32, f32 = _k2_run(cur.float(), keep, cap, True)
        plain_ok.append(fp["converged"])
        ep = _trunc_err(cur, vp)
        dist.append({"proj": _proj_dist(vk, vp),
                     "err": abs(_trunc_err(cur, vk) - ep) / ep,
                     "proj32": _proj_dist(v32, vp),
                     "err32": abs(_trunc_err(cur, v32) - ep) / ep,
                     "plain_ms": plain_ms})
        d = dist[-1]
        print(f"tt objects K2 f64 bond {n} against its plain version: "
              f"projector distance {d['proj']:.3e} (bar "
              f"{K2_F64_PROJ_BAR:g}), float32 control {d['proj32']:.3e}; "
              f"truncation error {d['err']:.3e} relative (bar "
              f"{K2_F64_ERR_BAR:g}), float32 control {d['err32']:.3e}; "
              f"outer kernel {fk['outer']}, plain {fp['outer']}, float32 "
              f"{f32['outer']}")
    return plain_ok, dist


def phase_tt_objects(dev, smi, solution, host_residual, round_ref,
                     ge_f32):
    """The tensor network and the TT classes (network/, tt/) through the
    public names in float64: the d=32 rank-256 TT rounded to 128 by
    round_fast('gemm_exact') (K2, counted), round_fast('svd') and the
    object round(); the d=32 Poisson residual of the slice's solution
    through A(i/2, j/2) * x(j&0) - b(i&0) in TT form; inner products three
    ways; the TT-SVD round trip of the completion truth; a BINARY file
    round trip; K2's float64 bonds beside their bound and gesvd, each
    held against its plain version by output; then the same at d=12 on
    the card and under host(), held against each other.  ``ge_f32`` is
    the float32 gemm_exact rounding's log-norm error on the same instance
    (phase_round_slice), the control that TT_GE_BAR must refuse.  Every
    float64 bond must take the 16-CTA cluster route.  Returns the K2
    launches and K2's float64 times on the largest bond (ms, plain_ms,
    bound_ms, library_ms: gesvd) and per rounding."""
    import math
    import numpy as np
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          completion_instance,
                                          qtt_poisson_instance)
    from xerus_tpu_torch.ops import gemm_exact as ge
    from xerus_tpu_torch.ops import round_kernels as rk
    t_phase = time.perf_counter()
    if xt.config.device != dev:
        raise AssertionError("tt objects: the default device is not the card")
    walls = {}

    def timer(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        return value

    truth = completion_instance().truth
    round_host = bench_round_instance(ROUND_D, ROUND_N, ROUND_RANK, SEED)
    _xs, A_c, b_c = qtt_poisson_instance(D, RANK, SEED)
    r = _tt_objects_cases(xt, round_host, ROUND_TARGET,
                          (solution, A_c, b_c), truth, timer)
    launches = r["K2 launches"]
    print(f"tt objects d={ROUND_D} rank {ROUND_RANK}->{ROUND_TARGET} f64: "
          f"log-norms gemm_exact {r['y log-norm']:.12f}, svd "
          f"{r['z log-norm']:.12f}, round() {r['w log-norm']:.12f}, host "
          f"f64 chain {round_ref:.12f} (bars {TT_LOGNORM_BAR:g} for svd "
          f"and round(), {TT_GE_BAR:g} gemm_exact vs svd); frob_norm(z - w)"
          f" / |w| {r['z - w']:.3e}, (y - w) {r['y - w']:.3e} (TT form, bar "
          f"{TT_DIFF_BAR:g}); K2 launches {launches}, SVD fallbacks "
          f"{r['K2 svd fallbacks']}; ranks {sorted(set(r['y ranks']))}")
    print(f"tt objects Poisson d={D}: |A x - b| / |b| through objects "
          f"{r['residual']:.6e} vs host f64 {host_residual:.6e} (bars "
          f"{TT_RESIDUAL_BAR:g}, {TT_RESIDUAL_ABS:g} absolute); dense "
          f"fallbacks {r['dense fallbacks']}")
    print(f"tt objects inner(y, x): sweep {r['inner sweep']!r}, DSL "
          f"{r['inner DSL']!r} ({r['DSL plan FLOPs']:,} FLOPs planned), "
          f"network {r['inner network']!r} ({r['network plan FLOPs']:,} "
          f"FLOPs, native search {r['native search']}); |y| |x| "
          f"{r['|y| |x|']:.6e}; inner(y, w) sweep {r['inner y.w']!r}, DSL "
          f"{r['inner y.w DSL']!r}")
    print(f"tt objects conversions: completion truth cast error "
          f"{r['truth cast error']:.3e}, TT-SVD(eps 1e-12) ranks "
          f"{r['TT-SVD ranks']}, round trip error {r['TT-SVD error']:.3e}; "
          f"BINARY file of y bitwise {r['file bitwise']}")
    fails = _tt_objects_bars(r, round_ref, host_residual)
    if launches != EXPECTED_K2_LAUNCHES:
        fails.append(f"K2 launched {launches} times, expected "
                     f"{EXPECTED_K2_LAUNCHES}")

    # object calls beside the core-level sweep on the same cores
    cores = [torch.from_numpy(np.asarray(c, np.float64)).to(dev)
             for c in round_host]
    for method in ("gemm_exact", "svd"):
        timer(f"core-level {method}", lambda: rk.tt_round_sweep_segmented(
            cores, ROUND_TARGET, method=method))
    print("tt objects time (ms, one synchronized call each; "
          f"{smi}): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))

    # K2 in float64 bond by bond, and its largest bond alone
    polish = ge._gemm_exact_tuning(torch.float64)[2]
    inputs = []
    bonds = _k2_bond_times(cores, inputs)
    total = bound = 0.0
    for n, ((B, M), cap, ms, f) in enumerate(bonds):
        b_ms, _by = _bound((B * M + 2 * cap * M) * 8, ge.gemm_exact_flops(
            B, M, cap, f["outer"], f["ns"], f["ns_rows"], polish), "float64")
        total, bound = total + ms, bound + b_ms
        print(f"tt objects K2 f64 bond {n} ({B}, {M}) cap {cap}: {ms:.3f} ms,"
              f" bound {b_ms:.4f} ms; route "
              f"{'cluster' if f['cluster_ctas'] else 'grid'} of "
              f"{f['cluster_ctas']} CTAs, outer {f['outer']}, Newton-Schulz "
              f"{f['ns']}, {1e3 * ms / (f['ns'] + f['outer']):.3f} us per "
              f"iteration (device time over Newton-Schulz + outer steps), "
              f"certified {f['converged']}, okp {f['okp']}")
    print(f"tt objects K2 f64: {total:.3f} ms of device time over "
          f"{len(bonds)} launches per rounding, bound {bound:.3f} ms")
    off_cluster = [n for n, (_s, _c, _ms, f) in enumerate(bonds)
                   if f["cluster_ctas"] != K2_CLUSTER_CTAS]
    if off_cluster:
        fails.append(f"K2 f64 bonds {off_cluster} did not take the "
                     f"{K2_CLUSTER_CTAS}-CTA cluster route")
    # a bond that does not certify within the reference's float64 cap
    # takes the SVD fallback: the object path must fall back exactly where
    # the plain version does
    plain_ok, dist = _k2_f64_against_plain(inputs)
    worst = {k: max(d[k] for d in dist) for k in ("proj", "err")}
    least = {k: min(d[k] for d in dist) for k in ("proj32", "err32")}
    kernel_ok = [bool(f["converged"]) for _s, _c, _ms, f in bonds]
    print(f"tt objects K2 f64 certification, bond by bond: kernel "
          f"{''.join('c' if ok else '-' for ok in kernel_ok)}, plain "
          f"version {''.join('c' if ok else '-' for ok in plain_ok)} (c: "
          f"certified within {ge._gemm_exact_tuning(torch.float64)[0]} "
          f"outer steps, -: SVD fallback); object path fallbacks "
          f"{r['K2 svd fallbacks']}; against the plain version at most "
          f"{worst['proj']:.3e} in the projectors (float32 control at "
          f"least {least['proj32']:.3e}, bar {K2_F64_PROJ_BAR:g}) and "
          f"{worst['err']:.3e} in the truncation errors (control at least "
          f"{least['err32']:.3e}, bar {K2_F64_ERR_BAR:g}); log-norm "
          f"float32 control {ge_f32:.3e} (bar {TT_GE_BAR:g})")
    if kernel_ok != plain_ok:
        fails.append("K2 and its plain version certify different bonds")
    if r["K2 svd fallbacks"] != plain_ok.count(False):
        fails.append(f"{r['K2 svd fallbacks']} SVD fallbacks on the object "
                     f"path, {plain_ok.count(False)} in the plain version")
    for key, bar in (("proj", K2_F64_PROJ_BAR), ("err", K2_F64_ERR_BAR)):
        if not worst[key] <= bar:
            fails.append(f"K2's float64 {key} {worst[key]:.3e} from the "
                         "plain version's")
        if not least[key + "32"] > bar:
            fails.append(f"the {key} bar does not refuse K2 in float32")
    if not ge_f32 > TT_GE_BAR:
        fails.append("the gemm_exact log-norm bar does not refuse the "
                     "float32 rounding")
    big = max(range(len(bonds)), key=lambda k: (
        bonds[k][0][0] * bonds[k][0][1], bonds[k][2]))
    cur, keep, cap, _out = inputs[big]
    f = bonds[big][3]
    kernel_ms = _time_ms(lambda: ge.gemm_exact_kernel(cur, keep, cap),
                         reps=10, warmup=2)
    gesvd_ms = _time_ms(lambda: torch.linalg.svd(
        cur, full_matrices=False, driver="gesvd"), reps=10, warmup=2)
    flops = ge.gemm_exact_flops(cur.shape[0], cur.shape[1], cap, f["outer"],
                                f["ns"], f["ns_rows"], polish)
    b_ms, by = _bound((cur.numel() + 2 * cap * cur.shape[1]) * 8, flops,
                      "float64")
    first = ge.gemm_exact_kernel(cur, keep, cap)
    second = ge.gemm_exact_kernel(cur, keep, cap)
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    print(f"tt objects K2 f64 largest bond {tuple(cur.shape)} keep {keep} "
          f"cap {cap} (the slowest of the equal shapes, certified "
          f"{f['converged']}): kernel {kernel_ms:.3f} ms, gesvd f64 "
          f"{gesvd_ms:.3f} ms (CUDA events, median of 10), plain version "
          f"{dist[big]['plain_ms']:.1f} ms (one synchronized run); "
          f"{flops / 1e9:.3f} GFLOP, bound {b_ms:.4f} ms by {by} (FP64 "
          f"tensor cores 67 TFLOP/s), {b_ms / kernel_ms:.2%} of it "
          f"reached; {1e3 * kernel_ms / (f['ns'] + f['outer']):.3f} us per "
          f"iteration; two launches bitwise equal: {same}; {smi}")
    if not same:
        fails.append("two K2 launches on the largest f64 bond differ")
    f64 = {"f64_ms": kernel_ms, "f64_plain_ms": dist[big]["plain_ms"],
           "f64_bound_ms": b_ms, "f64_bound_by": by,
           "f64_library_ms": gesvd_ms,
           "f64_shape": [*cur.shape, keep, cap],
           "f64_ms_per_rounding": total,
           "f64_bound_ms_per_rounding": bound}
    if fails:
        raise AssertionError("tt objects: " + "; ".join(fails))

    # 4. card against host() at d=12
    d, rank, target = TT_SMALL
    small = (bench_round_instance(d, ROUND_N, rank, SEED),
             target, qtt_poisson_instance(d, RANK, SEED), truth)
    card = _tt_objects_cases(xt, *small, lambda name, fn: fn())
    with xt.host():
        cpu = _tt_objects_cases(xt, *small, lambda name, fn: fn())
    worst, fails = _tt_card_vs_host(card, cpu)
    print(f"tt objects card vs host() at d={d} rank {rank}->{target}: "
          f"worst relative difference {worst:.3e} over {len(card)} results "
          f"(bar {TT_REL:g}); K2 launches on the card {card['K2 launches']};"
          f" phase {time.perf_counter() - t_phase:.1f} s")
    if fails:
        raise AssertionError("tt objects at d=12: " + "; ".join(fails))
    return launches, f64


# the algorithms layer through the public names (phase_algorithms), in
# float64 unless stated: the north-star solve through als_spd_fused, the
# float64 ALS at full width, the README's Quick start, the other solvers
# at d=8 on the card and under host(), completion, search and UQ-ADF on
# TTTensors
ALG_FUSED_HIST_REL = 1e-6      # als_spd_fused's f32 history vs phase_slice's
ALG_FUSED_RES_ABS = 1e-13      # its host-f64 residual vs phase_slice's
ALG_ALS64 = (32, 30, 1e-14)    # d, rank, convergence epsilon of ALS_SPD
ALG_QUICKSTART = (9, 3, 1e-6)  # d, rank, bar against numpy.linalg.solve
ALG_SMALL_D = 8                # the other solvers, card and host()
ALG_CARD_HOST = 1e-10          # their residuals, card vs host()
ALG_UQ_ERR = 1e-3              # UQ-ADF's prediction error on its samples


def _poisson_objects(xt, d, rank, dev):
    """The QTT Poisson instance of ``qtt_poisson_instance`` as objects:
    x (canonical at 0), A, b."""
    from xerus_tpu_torch.examples import qtt_poisson_instance
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    tt = xt.convert.tt_from_numpy
    return (tt(xs, canonicalized=True, device=dev),
            tt(A, operator=True, device=dev), tt(b, device=dev))


def _tt_residual(xt, A, x, b):
    """frob_norm(A x - b) / frob_norm(b) through the DSL in TT form."""
    i, j = xt.indices(2)
    return xt.frob_norm(A(i / 2, j / 2) * x(j & 0) - b(i & 0)) / b.frob_norm()


def _other_solvers(xt, d):
    """ALS (normal equations), ALS_SPD_CG, ASD_SPD, DMRG_SPD and
    als_spd_mixed on the d-site QTT Poisson system from one seed, on the
    current compute device: each solver's TT residual, ranks and wall."""
    import torch
    out = {}
    solvers = (("ALS", lambda A, x, b: (xt.ALS(A, x, b, 1e-12), x)[1]),
               ("ALS_SPD_CG", lambda A, x, b:
                (xt.ALS_SPD_CG(A, x, b, 1e-12), x)[1]),
               ("ASD_SPD", lambda A, x, b: (xt.ASD_SPD(A, x, b, 40), x)[1]),
               ("DMRG_SPD", lambda A, x, b:
                (xt.DMRG_SPD(A, x, b, 1e-12), x)[1]),
               ("als_spd_mixed", lambda A, x, b: xt.als_spd_mixed(A, x, b,
                                                                  4)))
    for name, solve in solvers:
        xt.set_seed(SEED)
        A = xt.examples.laplace_operator([2] * d)
        b = xt.TTTensor.ones([2] * d)
        b /= b.frob_norm()
        x = xt.TTTensor.random([2] * d, 4)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = solve(A, x, b)
        res = _tt_residual(xt, A, x, b)
        out[name] = (res, x.ranks(), time.perf_counter() - t0)
    return out


def _uq_case(xt):
    """UQ-ADF on a seeded instance (a [4, 3, 3] rank-2 truth, 120
    samples): the recovered TT on the host and its mean prediction error
    on the samples."""
    import numpy as np
    xt.set_seed(SEED)
    truth = xt.TTTensor.random([4, 3, 3], 2)
    truth /= truth.frob_norm()
    arr = truth.to_tensor().to_ndarray()
    rng = xt.misc.randomEngine
    rvs, sols = [], []
    for _ in range(120):
        rv = [float(rng.normal()), float(rng.normal())]
        w = [xt.algorithms.randvar_to_position(v, 3) for v in rv]
        rvs.append(rv)
        sols.append(xt.Tensor.from_ndarray(np.einsum("abc,b,c->a", arr, *w)))
    x = xt.TTTensor.random([4, 3, 3], 2)
    xt.uq_adf(x, rvs, sols)
    got = x.to_tensor().to_ndarray()
    err = float(np.mean([np.linalg.norm(np.einsum(
        "abc,b,c->a", got, *[xt.algorithms.randvar_to_position(v, 3)
                             for v in rv]) - s.to_ndarray())
        for rv, s in zip(rvs, sols)]))
    return got, err


def phase_algorithms(dev, smi, slice_run, slice_residual, completion,
                     iht_residual):
    """The algorithms layer on the card through the public names
    (``import xerus_tpu_torch as xt``): the north-star solve by
    ``xt.als_spd_fused`` (K1, counted) against phase_slice's core-level
    run, ``xt.ALS_SPD`` in float64 on the same d=32 rank-30 system, the
    README's Quick start against a dense solve, ALS / ALS_SPD_CG / ASD_SPD /
    DMRG_SPD / als_spd_mixed at d=8 on the card and under host(), then
    completion on TTTensors (the d=10 instance through ``xt.ADFVariant``
    with K3 counted, workload 5 through the host-bump loop, IHT), the
    largest entry of the d=10 truth against the argmax of its full grid,
    and UQ-ADF on the card and under host()."""
    import numpy as np
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.examples import (completion_instance,
                                          full_grid_positions,
                                          host_full_tensor,
                                          host_poisson_residual,
                                          workload5_instance)
    from xerus_tpu_torch.examples.completion import random_tt
    from xerus_tpu_torch.ops import round_kernels as rk
    from xerus_tpu_torch.ops import tt_eval as te
    from xerus_tpu_torch.ops.df_matvec import df_matvec
    from xerus_tpu_torch.tt import dsl as tt_dsl
    t_phase = time.perf_counter()
    fails = []

    def sync():
        torch.cuda.synchronize()

    # 1. the north-star solve through the public entry; the symmetry
    # check it pays first, timed alone on a copy of the operator
    x, A, b = _poisson_objects(xt, D, RANK, dev)
    A_copy = _poisson_objects(xt, D, RANK, dev)[1]
    sync()
    t0 = time.perf_counter()
    symmetric = A_copy.is_symmetric()
    sync()
    sym_wall = time.perf_counter() - t0
    df_matvec.launches = 0
    t0 = time.perf_counter()
    sol, hist = xt.als_spd_fused(A, x, b, MAX_F32_SWEEPS, DF_SWEEPS)
    sync()
    wall = time.perf_counter() - t0
    launches = df_matvec.launches
    from xerus_tpu_torch.examples import qtt_poisson_instance
    _xs, A64, b64 = qtt_poisson_instance(D, RANK, SEED)
    res = host_poisson_residual([c.to_ndarray() for c in sol.components],
                                A64, b64)
    ref = slice_run["hist"]
    hist_rel = max(abs(h - r) / r for h, r in zip(hist, ref)) \
        if len(hist) == len(ref) else float("inf")
    print(f"algorithms: xt.als_spd_fused d={D} rank {RANK}: host-f64 "
          f"residual {res:.3e} (bar {RESIDUAL_BAR:g}; core-level "
          f"{slice_residual:.3e}, bar {ALG_FUSED_RES_ABS:g} apart), f32 "
          f"half-sweeps {len(hist)} (core-level {len(ref)}), history within "
          f"{hist_rel:.3e} relative of the core-level run's (bar "
          f"{ALG_FUSED_HIST_REL:g}), K1 launches {launches}, wall "
          f"{wall:.3f} s (core-level {slice_run['wall']:.3f} s; the "
          f"operator's symmetry check alone {sym_wall:.3f} s, symmetric "
          f"{symmetric}); {smi}")
    if not (res <= RESIDUAL_BAR
            and abs(res - slice_residual) <= ALG_FUSED_RES_ABS):
        fails.append("als_spd_fused's residual")
    if not (len(hist) == len(ref) == 4 and hist_rel <= ALG_FUSED_HIST_REL):
        fails.append("als_spd_fused's f32 half-sweeps")
    if launches != EXPECTED_K1_LAUNCHES:
        fails.append(f"K1 launched {launches} times in als_spd_fused, "
                     f"expected {EXPECTED_K1_LAUNCHES}")

    # 2. the float64 ALS at full width
    d, rank, eps = ALG_ALS64
    x, A, b = _poisson_objects(xt, d, rank, dev)
    perf = xt.PerformanceData()
    fallbacks0 = tt_dsl.tt_assign.dense_fallbacks
    reads0 = rk.host_bool.reads
    sync()
    t0 = time.perf_counter()
    ret = xt.ALS_SPD(A, x, b, eps, perf)
    sync()
    wall = time.perf_counter() - t0
    reads = rk.host_bool.reads - reads0
    res = _tt_residual(xt, A, x, b)
    dense = tt_dsl.tt_assign.dense_fallbacks - fallbacks0
    on_card = x.components[0]._torch().device.type == dev.type
    print(f"algorithms: xt.ALS_SPD float64 d={d} rank {rank} eps {eps:g}: "
          f"residual in TT form {res:.3e} (bar {RESIDUAL_BAR:g}; returned "
          f"{ret:.3e}), half-sweeps {len(perf.data)}, host reads {reads}, "
          f"ranks max {max(x.ranks())}, dense fallbacks {dense}, cores on "
          f"the card {on_card}, wall {wall:.3f} s; {smi}")
    if not (res <= RESIDUAL_BAR and dense == 0 and on_card):
        fails.append("ALS_SPD in float64 at d=32")

    # 3. the README's Quick start, on xt
    d, rank, bar = ALG_QUICKSTART
    xt.set_seed(SEED)
    A = xt.examples.laplace_operator([2] * d)   # rank-2 MPO
    b = xt.TTTensor.ones([2] * d)
    x = xt.TTTensor.random([2] * d, rank)
    xt.ALS_SPD(A, x, b, 1e-12)
    i, j = xt.indices(2)
    residual = (A(i / 2, j / 2) * x(j & 0) - b(i & 0)).frob_norm()
    n = 2 ** d
    ref = np.linalg.solve(A.to_tensor().to_ndarray().reshape(n, n),
                          np.ones(n))
    got = x.to_tensor().to_ndarray().reshape(n)
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"algorithms: Quick start d={d}: residual {residual:.3e}, "
          f"against numpy.linalg.solve {err:.3e} (bar {bar:g})")
    if not err <= bar:
        fails.append("the Quick start")

    # 4. the other solvers at d=8, card against host()
    card = _other_solvers(xt, ALG_SMALL_D)
    with xt.host():
        cpu = _other_solvers(xt, ALG_SMALL_D)
    for name, (r_card, ranks, w) in card.items():
        r_cpu, ranks_cpu, w_cpu = cpu[name]
        print(f"algorithms: {name} d={ALG_SMALL_D}: residual card "
              f"{r_card:.3e}, host() {r_cpu:.3e}, ranks {ranks} / "
              f"{ranks_cpu}, wall card {w:.3f} s, host() {w_cpu:.3f} s")
        if not (abs(r_card - r_cpu) <= ALG_CARD_HOST and ranks == ranks_cpu
                and np.isfinite(r_card)):
            fails.append(f"{name}: card and host() disagree")

    # 5. completion on TTTensors
    inst = completion_instance()
    ms = inst.measurements
    tt = xt.convert.tt_from_numpy
    truth = tt(inst.truth, canonicalized=True, device=dev)
    x = tt(inst.start, canonicalized=True, device=dev)
    grid = xt.SinglePointMeasurementSet.from_arrays(
        full_grid_positions(truth.dimensions))
    sync()
    te.reset_counters()
    ms.measure(truth)
    t0 = time.perf_counter()
    res = xt.ADFVariant(2000, COMPLETION_TARGET, 0.9999)(
        x, ms, max_ranks=inst.max_ranks, check_every="device")
    sync()
    wall = time.perf_counter() - t0
    test = ms.test(x)
    grid.measure(truth)
    t_grid = grid.measuredValues
    grid_err = grid.test(x)
    sync()
    k3 = te.tt_eval_at_points.launches
    host_err = _rel(host_full_tensor([c.to_ndarray() for c in x.components]),
                    host_full_tensor(inst.truth))
    res_bar = max(COMPLETION_TARGET, 10 * JAX_D10_RESIDUAL)
    err_bar = max(COMPLETION_TARGET, 10 * JAX_D10_GRID_ERR)
    print(f"algorithms: xt.ADFVariant on a TTTensor, d=10 n=4 rank 8, 20000 "
          f"samples, check_every='device': residual {res:.3e} (bar "
          f"{res_bar:g}), test {test:.3e}, full-grid rel err {grid_err:.3e} "
          f"(host f64 {host_err:.3e}; bar {err_bar:g}), ranks {x.ranks()}, "
          f"wall {wall:.3f} s, K3 launches {k3} (at least "
          f"{EXPECTED_K3_LAUNCHES}); core-level run: residual "
          f"{completion['residual']:.3e}, {completion['iterations']} "
          f"iterations, ranks {completion['ranks']}, wall "
          f"{completion['wall']:.3f} s; {smi}")
    if not (res <= res_bar and test <= res_bar and grid_err <= err_bar
            and abs(grid_err - host_err) <= 1e-12 * max(host_err, 1e-300)
            + 1e-15 and x.ranks() == completion["ranks"]
            and np.all(np.isfinite(t_grid))):
        fails.append("completion on TTTensors")
    if k3 < EXPECTED_K3_LAUNCHES:
        fails.append(f"K3 launched {k3} times on the object path")

    # workload 5 drawn through the public names in the benchmark's order
    # (the same instance as workload5_instance), so that the host-bump
    # kicks that follow come from the engine state they have there
    inst5 = workload5_instance()
    xt.set_seed(SEED + 5)
    truth5 = xt.TTTensor.random([4] * 5, 3)
    truth5 /= truth5.frob_norm()
    ms5 = xt.SinglePointMeasurementSet.random(400, [4] * 5)
    ms5.measure(truth5)
    x5 = xt.TTTensor.random([4] * 5, 1)
    same = (np.array_equal(ms5.positions, inst5.measurements.positions)
            and _rel(x5.to_tensor().to_ndarray().reshape(-1),
                     host_full_tensor(inst5.start)) <= 1e-14)
    t0 = time.perf_counter()
    perf = xt.PerformanceData()
    res5 = xt.ADFVariant(400, COMPLETION_TARGET, 0.9999)(
        x5, ms5, max_ranks=[3] * 4, perf_data=perf)
    wall = time.perf_counter() - t0
    pos = xt.find_largest_entry(x5, accuracy=0.05)
    arr = np.abs(x5.to_tensor().to_ndarray()).reshape(-1)
    frac = float(arr[pos] / arr.max())
    bumps = len({tuple(p.ranks) for p in perf.data}) - 1
    print(f"algorithms: workload 5 through the host-bump loop "
          f"(check_every=1): residual {res5:.3e} (target "
          f"{COMPLETION_TARGET:g}), {len(perf.data)} iterations, {bumps} "
          f"rank bumps, ranks {x5.ranks()}, largest entry {pos}, "
          f"found_entry_frac_of_max {frac}, wall {wall:.3f} s; the "
          f"instance is workload5_instance's: {same}")
    if not (res5 < COMPLETION_TARGET and x5.ranks() == [3] * 4
            and frac == 1.0 and same):
        fails.append("workload 5 through the host-bump loop")

    start = random_tt([4] * 5, 3, np.random.default_rng(SEED))
    start[0] = start[0] / np.linalg.norm(start[0])
    xi = tt(start, canonicalized=True, device=dev)
    te.reset_counters()
    r_iht = xt.IHT(xi, inst5.measurements, max_iterations=IHT_ITERATIONS)
    k3_iht = te.tt_eval_at_points.launches
    print(f"algorithms: xt.IHT on a TTTensor, workload 5: residual "
          f"{r_iht:.9e} (core-level {iht_residual:.9e}), K3 launches "
          f"{k3_iht}")
    if not (abs(r_iht - iht_residual) <= 1e-8 * iht_residual
            and k3_iht == (8 * IHT_ITERATIONS if dev.type == "cuda" else 0)):
        fails.append("IHT on a TTTensor")

    # 6. search and UQ-ADF
    t0 = time.perf_counter()
    pos = xt.find_largest_entry(truth, accuracy=0.05)
    wall = time.perf_counter() - t0
    full = np.abs(t_grid)
    frac = float(full[pos] / full.max())
    print(f"algorithms: xt.find_largest_entry of the d=10 rank-8 truth "
          f"({full.size} entries, the squaring iteration, accuracy 0.05): "
          f"position {pos}, argmax of the full grid {int(full.argmax())}, "
          f"found_entry_frac_of_max {frac}, wall {wall:.3f} s")
    if not frac >= 1 - 0.05:
        fails.append("the largest entry of the d=10 truth")
    got_card, err_card = _uq_case(xt)
    with xt.host():
        got_cpu, err_cpu = _uq_case(xt)
    diff = _rel(got_card.reshape(-1), got_cpu.reshape(-1))
    print(f"algorithms: xt.uq_adf [4, 3, 3] rank 2, 120 samples: prediction "
          f"error card {err_card:.3e}, host() {err_cpu:.3e} (bar "
          f"{ALG_UQ_ERR:g}), card vs host() {diff:.3e} (bar "
          f"{ALG_CARD_HOST:g}); phase {time.perf_counter() - t_phase:.1f} s")
    if not (err_card <= ALG_UQ_ERR and diff <= ALG_CARD_HOST):
        fails.append("uq_adf")
    if fails:
        raise AssertionError("algorithms: " + "; ".join(fails))


# the eigensolver and the rest of the algorithms layer through the public
# names (phase_eigensolver), float64: workload 4 of
# benchmarks/all_workloads.py (the d=32 Heisenberg chain, max_rank 16, 6
# sweeps) by the dense local eigh and by the card's default Lanczos
# sweeps, the rank 16 / 32 / 64 cell, dmrg_solve on the north-star
# objects, the fused apply + round, the Riemannian kit and the cascade
EIG_D = 32                     # workload 4's chain length
EIG_E_EXACT = -13.99725789     # CPU f64 solver="exact", WORKLOADS.md:10
EIG_RES_EXACT = 1.055e-02      # its eig_residual ||H g - E g||
# the JAX package's own CPU float64 Lanczos run (shift 0) of the same
# instance: benchmarks/eigensolver_jax_reference.py
EIG_E_JAX_LANCZOS = -13.997257888144015
EIG_E_BAR = 1e-6               # absolute, on both energies
EIG_RES_REL = 0.05             # eig_residual of the exact run vs 1.055e-02
EIG_RANK_CELL = (16, 32, 64)   # Lanczos max ranks of the measurement cell
EIG_SOLVE = (30, 8)            # dmrg_solve: max_rank, half-sweeps
# dmrg_solve on test_als.py:146-165's instance (d=10, rank 2 -> 8, 12
# half-sweeps) with its bars, on the card and under host(): residual,
# max rank, error against the truth
EIG_SOLVE_SMALL = (10, 8, 12)
EIG_SOLVE_BAR = 1e-10
EIG_APPLY = (256, 128)         # slice 2's TT rank, the apply + round target
EIG_QUASI = 4.0                # test_kernels.py:451-453's bar
EIG_APPLY_EXACT = 1e-10        # relative, where the target holds the product
EIG_CARD_HOST = 1e-10          # the kit and the cascade, card vs host()
EIG_CASCADE = (10, 32, 10)     # proteins, copies per site, Euler steps
EIG_PHASE_S = 150.0
# PR 15's readings on the same card (PERF.md section 6): the replayed
# rank-16 Lanczos solve, K5's and K4's device time in one replayed
# half-sweep, the rank-64 cell's first run
EIG_PR15 = {"lanczos_s": (1.105, 1.356), "k5_ms": 24.60, "k4_ms": 8.79,
            "rank64_s": 6.092}
# ops.dmrg_kernels.dmrg_groundstate_scan by the dense local eigh (solver
# 'eigh', eager: cuSOLVER's info read forbids a capture) on the d=6
# Heisenberg chain at its full ranks, every half-sweep run (conv_eps 0)
# after the shift estimate's two: d, max_rank, half-sweeps; its energy is
# held to the dense 64 x 64 Hamiltonian's lowest eigenvalue
EIG_SCAN_EIGH = (6, 8, 4)
EIG_SCAN_BAR = 1e-10


def _workload4(xt, max_rank, count_syncs=False, **kw):
    """Workload 4 (benchmarks/all_workloads.py:243-285) through
    ``xt.smallest_eigenvalue``: energy, eig_residual in TT form, ranks,
    half-sweeps, host reads (energy reads, eigh/svd info checks, and with
    ``count_syncs`` the syncs torch's sync debug mode reports), wall, and
    the singular values at the middle bond."""
    import torch
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    from xerus_tpu_torch.ops import programs
    from xerus_tpu_torch.ops import round_kernels as rk
    from xerus_tpu_torch.ops import small_eig as se
    xt.set_seed(SEED + 4)
    H = xt.examples.heisenberg_mpo(EIG_D)
    g = xt.TTTensor.random([2] * EIG_D, 4)
    perf = xt.PerformanceData()
    reads0, checks0 = rk.host_bool.reads, dk.linalg_host_checks()
    fallbacks0 = dk._eigh.fallbacks
    P = programs.Program
    runs0 = (P.eager_runs, P.captures, P.replays)
    launches0 = (se.small_eigh_launch.launches, se.small_svd_launch.launches)
    se.last_health.clear()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            lam = xt.smallest_eigenvalue(H, g, sites=2, max_rank=max_rank,
                                         num_sweeps=6, perf_data=perf, **kw)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    reads = rk.host_bool.reads - reads0
    exact = kw.get("solver") == "exact"
    var = (xt.apply_operator(H, g) - lam * g).frob_norm()
    g.move_core(EIG_D // 2)
    core = g.components[EIG_D // 2]._torch()
    sv = torch.linalg.svdvals(core.reshape(core.shape[0], -1))
    runs = [b - a for a, b in zip(runs0, (P.eager_runs, P.captures,
                                          P.replays))]
    return {"E": lam, "res": var, "rank": max(g.ranks()),
            "half_sweeps": len(perf.data) if exact else reads,
            "reads": reads, "checks": dk.linalg_host_checks() - checks0,
            "fallbacks": dk._eigh.fallbacks - fallbacks0,
            "syncs": syncs if count_syncs else None, "wall": wall,
            "sv": [float(v) for v in sv[12:20]],
            "on_card": core.device.type == "cuda",
            "eager": runs[0], "captures": runs[1], "replays": runs[2],
            "k4": se.small_eigh_launch.launches - launches0[0],
            "k5": se.small_svd_launch.launches - launches0[1],
            "health": dict(se.last_health)}


def _w4_line(name, r):
    return (f"eigensolver: workload 4 {name}: E {r['E']!r} (gap to "
            f"{EIG_E_EXACT} {r['E'] - EIG_E_EXACT:+.3e}), eig_residual "
            f"{r['res']:.6e}, max rank {r['rank']}, half-sweeps "
            f"{r['half_sweeps']}, host reads {r['reads']} + "
            f"{r['checks']} eigh/svd info checks"
            + (f" ({r['syncs']} syncs by torch's sync debug mode)"
               if r["syncs"] is not None else "")
            + f", eigh retries {r['fallbacks']}, wall {r['wall']:.3f} s; "
            f"programs: {r['eager']} eager runs, {r['captures']} captures, "
            f"{r['replays']} replays; K4 {r['k4']}, K5 {r['k5']} launches"
            + (f", Jacobi sweeps at most {r['health']['max_sweeps']} "
               f"({r['health']['total_sweeps'] / r['health']['matrices']:.2f}"
               f" a matrix)" if r["health"].get("matrices") else "")
            + "; singular values 13.. at the middle bond "
            + ", ".join(f"{v:.6e}" for v in r["sv"]))


def _scan_eigh(xt):
    """``dmrg_groundstate_scan(solver="eigh")`` on ``EIG_SCAN_EIGH``'s
    chain on the current compute device: (energy, the exact ground energy,
    energy reads, eigh/svd info checks, K5 launches, wall)."""
    import numpy as np
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    from xerus_tpu_torch.ops import round_kernels as rk
    from xerus_tpu_torch.ops import small_eig as se
    d, rank, sweeps = EIG_SCAN_EIGH
    xt.set_seed(SEED + 6)
    H = xt.examples.heisenberg_mpo(d)
    g = xt.TTTensor.random([2] * d, rank)
    counts0 = (rk.host_bool.reads, dk.linalg_host_checks(),
               se.small_svd_launch.launches)
    e, wall = _timed(lambda: dk.dmrg_groundstate_scan(
        H, g, num_half_sweeps=sweeps, conv_eps=0.0, solver="eigh"))
    counts = [b - a for a, b in zip(counts0, (
        rk.host_bool.reads, dk.linalg_host_checks(),
        se.small_svd_launch.launches))]
    Hd = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact = float(np.linalg.eigvalsh((Hd + Hd.T) / 2)[0])
    return (e, exact, *counts, wall)


def _timed(fn):
    """(fn(), its wall in s), synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _dmrg_solve_case(xt, dev):
    """xt.dmrg_solve on the north-star objects (every one of its
    half-sweeps: conv_eps 0, so that it runs past programs.EAGER_CALLS and
    captures) and on test_als.py's d=10 instance, on the current compute
    device: (residual, ranks, wall) and (residual, ranks, error against
    the truth, wall)."""
    max_rank, half_sweeps = EIG_SOLVE
    x, A, b = _poisson_objects(xt, D, RANK, dev)
    res, wall = _timed(lambda: xt.dmrg_solve(A, x, b, max_rank=max_rank,
                                            num_half_sweeps=half_sweeps,
                                            conv_eps=0.0))
    _solve_counts.last = _solve_counts()
    d, max_rank, half_sweeps = EIG_SOLVE_SMALL
    xt.set_seed(SEED)
    L = xt.examples.laplace_operator([2] * d)
    truth = xt.TTTensor.random([2] * d, 4)
    b = xt.apply_operator(L, truth)
    b.round(max_rank)
    y = xt.TTTensor.random([2] * d, 2)
    res_s, wall_s = _timed(lambda: xt.dmrg_solve(
        L, y, b, max_rank=max_rank, num_half_sweeps=half_sweeps))
    err = (y - truth).frob_norm() / truth.frob_norm()
    return (res, x.ranks(), wall), (res_s, y.ranks(), err, wall_s)


def _solve_counts():
    """(eager runs, captures, replays, K5 launches, eigh/svd info checks)
    so far; ``_solve_counts.last`` holds them after the d=32 dmrg_solve."""
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    from xerus_tpu_torch.ops import programs
    from xerus_tpu_torch.ops import small_eig as se
    P = programs.Program
    return (P.eager_runs, P.captures, P.replays,
            se.small_svd_launch.launches, dk.linalg_host_checks())


def _replay_vs_eager(xt, rank):
    """The workload-4 half-sweep program at ``rank`` (captured by the
    solve) on a fresh normalized rank-``rank`` state: its replay against
    its function run eagerly on the same input.  Returns (bitwise equal,
    the program, its arguments)."""
    import torch
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    from xerus_tpu_torch.ops import programs
    xt.set_seed(SEED + 5)
    H = xt.examples.heisenberg_mpo(EIG_D)
    g = xt.TTTensor.random([2] * EIG_D, rank)
    g.move_core(0)
    g /= g.frob_norm()
    xs = dk.pad_cores([c._torch() for c in g.components])[0].contiguous()
    As = dk._pad_operator_stack([c._torch() for c in H.components],
                                xs.dtype)
    args = (xs, As, torch.zeros((), dtype=xs.dtype, device=xs.device))
    prog = dk.make_dmrg_step(programs.shapes_key(*args),
                             programs.dtype_str(xs), rank, "lanczos", 24,
                             False)
    replays = prog.replays
    got = prog(*args)
    want = prog.fn(*args)
    torch.cuda.synchronize()
    same = (prog.graph is not None and prog.replays == replays + 1
            and all(torch.equal(a, b) for a, b in zip(got, want)))
    return same, prog, args


def _kit_cases(xt, timer):
    """The Riemannian kit and the remaining algorithms on the current
    compute device, at the sizes of the JAX package's tests:
    SteepestDescent (test_riemannian.py:101-118), GeometricCG (:121-137),
    a tangent vector with HOSVDRetractionI and the vector transport,
    decomposition_als and randomTTSVD (test_other_algorithms.py:11-31,
    randomTTSVD at a representable rank), and the reference's cascade
    example (``cascade_operator(10, 32)``, 10 implicit-Euler steps).
    Returns {name: (values, ranks)}."""
    import numpy as np
    from xerus_tpu_torch.examples import cascade

    def dense(tt):
        return tt.to_tensor().to_ndarray().reshape(-1)

    def sd():
        dims = [2] * 4
        A = xt.TTOperator.identity(dims + dims)
        b = xt.TTTensor.random(dims, 2)
        b /= b.frob_norm()
        x = xt.TTTensor.random(dims, 2)
        r = xt.SteepestDescentVariant(30, 1e-10, True)(A, x, b, 30)
        return np.append(dense(x), r), x.ranks()

    def cg():
        A = xt.examples.laplace_operator([3] * 3)
        b = xt.TTTensor.ones([3] * 3)
        b /= b.frob_norm()
        x = xt.TTTensor.random([3] * 3, 3)
        r = xt.GeometricCGVariant(40, 1e-10, True)(A, x, b, 40)
        return np.append(dense(x), r), x.ranks()

    def retraction():
        base = xt.TTTensor.random([3] * 3, 2)
        tv = xt.TTTangentVector(base, xt.TTTensor.random([3] * 3, 2))
        stepped = base.copy()
        xt.HOSVDRetractionI(stepped, tv * 1e-3)
        xt.ProjectiveVectorTransport(stepped, tv)
        return (np.concatenate([dense(stepped), dense(tv.to_tttensor()),
                                [tv.frob_norm()]]), stepped.ranks())

    def decomposition():
        target = xt.Tensor.random([4, 4, 4])
        x = xt.TTTensor.random([4, 4, 4], 2)
        xt.decomposition_als(x, target)
        low = xt.TTTensor.random([3, 4, 4, 3], 2).to_tensor()
        y = xt.randomTTSVD(low, 2)
        return np.concatenate([dense(x), dense(y)]), x.ranks() + y.ranks()

    def casc():
        num, n, steps = EIG_CASCADE
        res = []
        A = cascade.cascade_operator(num, n)
        start = xt.TTTensor.dirac([n] * num, 0)
        start.use_dense_representations()
        start += 1e-14 * xt.TTTensor.random(list(start.dimensions),
                                            [2] * (num - 1))
        out = cascade.implicit_euler(A, start, 1.0, steps, residuals=res)
        table = cascade.mean_concentration_table(out)
        return np.concatenate([table.reshape(-1), res]), out[-1].ranks()

    out = {}
    for name, fn in (("SteepestDescent", sd), ("GeometricCG", cg),
                     ("HOSVDRetractionI + transport", retraction),
                     ("decomposition_als + randomTTSVD", decomposition),
                     ("cascade", casc)):
        xt.set_seed(SEED)
        out[name] = timer(name, fn)
    return out


def phase_eigensolver(dev, smi):
    """The eigensolver and the rest of the algorithms layer on the card
    through the public names, in float64: workload 4 by
    ``solver="exact"`` (one timed run) and by the card's default solver,
    Lanczos with shift 0 (a warm run that also counts the syncs, a timed
    run, then a run under torch.profiler that counts K4 and K5 on the
    device: the kernels line's launches), against the recorded CPU float64
    energy and residual and the JAX package's CPU float64 Lanczos energy;
    the rank 16 / 32 / 64 cell; the 4-start race; ``dmrg_groundstate_scan``
    by the dense local eigh on the card and under ``host()``; ``xt.dmrg_solve`` on the d=32 rank-30 Poisson objects on the
    card and under ``host()``; ``xt.ops.apply_operator_rounded`` of the
    north-star operator on slice 2's rank-256 TT against
    ``apply_operator`` and its svd rounding; the Riemannian kit,
    decomposition_als, randomTTSVD and the cascade on the card and under
    ``host()``."""
    import numpy as np
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.examples import bench_round_instance
    t_phase = time.perf_counter()
    fails = []
    laps = []          # (step, wall s): where the phase's time goes

    def lap(name):
        start = laps[-1][2] if laps else t_phase
        now = time.perf_counter()
        laps.append((name, now - start, now))
        print(f"eigensolver: step {name}: {now - start:.3f} s")

    from xerus_tpu_torch.ops import programs

    def on_kernels(c):
        # the Lanczos sweeps on K4/K5 in captured programs: no eigh/svd
        # info check, both kernels launched, no Jacobi failure
        return (c["checks"] == 0 and c["k4"] > 0 and c["k5"] > 0
                and c["health"].get("failures") == 0 and c["on_card"]
                and c["fallbacks"] == 0)

    # 1. workload 4, the dense local eigh
    r = _workload4(xt, 16, solver="exact")
    print(_w4_line("solver='exact'", r) + f"; {smi}")
    if not (abs(r["E"] - EIG_E_EXACT) <= EIG_E_BAR
            and abs(r["res"] - EIG_RES_EXACT) <= EIG_RES_REL * EIG_RES_EXACT
            and r["on_card"] and r["fallbacks"] == 0):
        fails.append(f"workload 4 by the exact local eigh: E {r['E']!r}, "
                     f"eig_residual {r['res']:.6e}")
    exact_wall = r["wall"]
    lap("workload 4 by the dense local eigh")

    # 2. the card's default solver (Lanczos), shift 0: the first run at
    # its shape key runs programs.EAGER_CALLS half-sweeps eagerly, captures
    # the third and replays the rest; the timed run replays every one
    warm = _workload4(xt, 16, count_syncs=True, shift=0.0)
    print(_w4_line("default solver, shift 0, first run", warm))
    lap("Lanczos rank 16, first run (eager, capture, replays)")
    r = _workload4(xt, 16, count_syncs=True, shift=0.0)
    lap("Lanczos rank 16, replayed")
    print(_w4_line("default solver, shift 0", r)
          + f"; JAX CPU f64 Lanczos {EIG_E_JAX_LANCZOS!r}, gap "
          f"{r['E'] - EIG_E_JAX_LANCZOS:+.3e}; wall {r['wall']:.3f} s "
          f"against the dense local eigh's {exact_wall:.3f} s in this run "
          f"(ROADMAP's bar: below it; no pass/fail); {smi}")
    n = r["half_sweeps"]
    if not (abs(r["E"] - EIG_E_JAX_LANCZOS) <= EIG_E_BAR
            and on_kernels(r) and on_kernels(warm)
            and warm["eager"] == programs.EAGER_CALLS
            and warm["captures"] == 1
            and warm["replays"] == warm["half_sweeps"] - 1 - warm["eager"]
            and r["replays"] == n and r["eager"] == r["captures"] == 0
            and r["k4"] == r["k5"] == n * (EIG_D - 1)):
        fails.append(f"workload 4 by Lanczos: E {r['E']!r}, info checks "
                     f"{r['checks']} / {warm['checks']}, programs "
                     f"{r['eager']} / {r['captures']} / {r['replays']}")
    # the kernels line's K4/K5 launches: the replayed solve once more under
    # torch.profiler, its kernels counted by name on the device (a replay
    # calls no wrapper)
    pr, jac_launches = _kernel_counts(
        lambda: _workload4(xt, 16, shift=0.0), (K4_KERNEL, K5_KERNEL))
    jac_launches = tuple(jac_launches)
    lap("Lanczos rank 16 under torch.profiler")
    print(f"eigensolver: the replayed Lanczos solve under torch.profiler "
          f"ran {jac_launches[0]} {K4_KERNEL} and {jac_launches[1]} "
          f"{K5_KERNEL} kernels on the device in {pr['half_sweeps']} "
          f"half-sweeps of {EIG_D - 1} sites ({pr['replays']} replays; the "
          f"counters through replays: {pr['k4']} and {pr['k5']})")
    if not (pr["replays"] == pr["half_sweeps"] == n
            and jac_launches == (n * (EIG_D - 1),) * 2
            and abs(pr["E"] - EIG_E_JAX_LANCZOS) <= EIG_E_BAR):
        fails.append(f"the replayed Lanczos solve ran {jac_launches} K4 / "
                     f"K5 kernels on the device in {pr['half_sweeps']} "
                     f"half-sweeps, expected {n * (EIG_D - 1)} each")
    same, prog, args = _replay_vs_eager(xt, 16)
    print(f"eigensolver: workload 4's half-sweep program (rank 16): replay "
          f"bitwise equal to its eager run on a fresh state: {same}; "
          f"{prog.nodes} graph nodes, pool {prog.pool_bytes / 2**20:.1f} "
          f"MiB, capture {prog.capture_s:.3f} s, {prog.eager_runs} eager "
          f"runs, {prog.captures} capture, {prog.replays} replays")
    if not same:
        fails.append("a replayed half-sweep differs from its eager run")
    # one replayed half-sweep: its wall alone, then under torch.profiler
    # its device busy time and every kernel name's device time (K4's and
    # K5's summed over their names)
    one = statistics.median(_timed(lambda: prog(*args))[1]
                            for _ in range(3))
    pw, busy, kernels, ranked = _device_busy(lambda: prog(*args), top=-1)
    (k4_s, k4_n), (k5_s, k5_n) = (
        (sum(t for name, t, _ in ranked if k in name),
         sum(c for name, _, c in ranked if k in name))
        for k in (K4_KERNEL, K5_KERNEL))
    print(f"eigensolver: one replayed rank-16 half-sweep under "
          f"torch.profiler: K5 {k5_s * 1e3:.3f} ms of device time over "
          f"{k5_n} launches, K4 {k4_s * 1e3:.3f} ms over {k4_n} (PR 15: "
          f"K5 {EIG_PR15['k5_ms']} ms, K4 {EIG_PR15['k4_ms']} ms); the "
          f"replayed rank-16 solve {r['wall']:.3f} s (PR 15: "
          f"{EIG_PR15['lanczos_s'][0]}-{EIG_PR15['lanczos_s'][1]} s); {smi}")
    # where the replayed solve's wall goes: the half-sweep against the
    # solve's
    print(f"eigensolver: one replayed half-sweep {one * 1e3:.2f} ms (median "
          f"of 3); under torch.profiler {pw * 1e3:.2f} ms, device busy "
          + (f"{busy * 1e3:.2f} ms, idle {1 - busy / pw:.3f}"
             if busy is not None else "not measured")
          + f", {kernels} kernels, by device time "
          + ", ".join(f"{name[:40]} {t * 1e3:.2f} ms x{k}"
                      for name, t, k in ranked[:4])
          + f"; the replayed solve's {n} half-sweeps take about "
          f"{n * one:.3f} s of its {r['wall']:.3f} s, the rest is the "
          f"object layer around them (rank bump, canonicalization) and its "
          f"syncs")
    lap("the half-sweep program: replay vs eager, profiled")

    # 3. the measurement cell: is 1.055e-02 the rank-16 floor?
    for rank in EIG_RANK_CELL:
        c = r if rank == 16 else _workload4(xt, rank, count_syncs=True,
                                             solver="lanczos", shift=0.0)
        print(_w4_line(f"cell, Lanczos max_rank {rank}", c)
              + (f"; PR 15's first run {EIG_PR15['rank64_s']} s"
                 if rank == 64 else ""))
        if not on_kernels(c):
            fails.append(f"the rank-{rank} cell is not on K4/K5")
        if rank != 16:
            lap(f"cell rank {rank}, first run")

    # the 4-start race: one batch per half-sweep, the first start x itself
    m = _workload4(xt, 16, count_syncs=True, shift=0.0, num_starts=4)
    print(_w4_line("multistart, 4 starts, max_rank 16", m)
          + f"; against one start {m['E'] - r['E']:+.3e}")
    if not (on_kernels(m) and m["E"] <= r["E"] + EIG_E_BAR
            and m["captures"] == 1):
        fails.append(f"the 4-start race: E {m['E']!r}")
    lap("4-start race, first run")

    # the dense local eigh's scan runs eagerly past the third half-sweep
    # at one shape key (where a program would capture)
    d, rank, sweeps = EIG_SCAN_EIGH
    sc = _scan_eigh(xt)
    with xt.host():
        sh = _scan_eigh(xt)
    print(f"eigensolver: ops.dmrg_kernels.dmrg_groundstate_scan(solver="
          f"'eigh') d={d} rank {rank}, shift estimated, {sweeps} "
          f"half-sweeps: E card {sc[0]!r}, host() {sh[0]!r}, exact "
          f"{sc[1]!r} (gaps {sc[0] - sc[1]:+.3e} / {sh[0] - sh[1]:+.3e}, "
          f"bar {EIG_SCAN_BAR:g}), energy reads {sc[2]} / {sh[2]}, card "
          f"eigh/svd info checks {sc[3]}, K5 launches {sc[4]}, wall card "
          f"{sc[5]:.3f} s, host() {sh[5]:.3f} s")
    if not (abs(sc[0] - sc[1]) <= EIG_SCAN_BAR
            and abs(sh[0] - sh[1]) <= EIG_SCAN_BAR
            and sc[2] == sh[2] == 2 + sweeps and sc[3] > 0 and sc[4] > 0):
        fails.append(f"dmrg_groundstate_scan(solver='eigh'): E {sc[0]!r} "
                     f"/ {sh[0]!r}, {sc[2]} energy reads")
    lap("dense-eigh scan, card and host()")

    # 4. dmrg_solve, card and host(): on the north-star objects the
    # reference's fixed 32 CG steps a site meet local systems of condition
    # about 1e19, and the split's SVD routine decides where the solve lands
    # (gesvd on the card converges, gesdd under host() does not; ROADMAP
    # Queue 3 fault 11), so the two residuals are printed and held to no
    # bar; test_als.py's instance is held to its bars on both
    counts0 = _solve_counts()
    card, small_c = _dmrg_solve_case(xt, dev)
    big = [b - a for a, b in zip(counts0, _solve_counts.last)]
    small = [b - a for a, b in zip(_solve_counts.last, _solve_counts())]
    with xt.host():
        cpu, small_h = _dmrg_solve_case(xt, torch.device("cpu"))
    print(f"eigensolver: xt.dmrg_solve d={D} rank {RANK} Poisson objects, "
          f"max_rank {EIG_SOLVE[0]}, {EIG_SOLVE[1]} half-sweeps: residual "
          f"card {card[0]!r} (splits on K5's Jacobi SVD), host() {cpu[0]!r} "
          f"(LAPACK gesdd; no bar: ROADMAP Queue 3 fault 11), max ranks "
          f"{max(card[1])} / {max(cpu[1])}, wall card {card[2]:.3f} s, "
          f"host() {cpu[2]:.3f} s; programs {big[0]} eager runs, {big[1]} "
          f"captures, {big[2]} replays, K5 {big[3]} launches, {big[4]} "
          f"eigh/svd info checks")
    for c in (big, small):
        if not (c[3] > 0 and c[4] == 0 and c[1] >= 1):
            fails.append(f"dmrg_solve not on K5 through programs: {c}")
    d, max_rank, half_sweeps = EIG_SOLVE_SMALL
    print(f"eigensolver: xt.dmrg_solve test_als.py's d={d} instance, rank 2 "
          f"-> {max_rank}, {half_sweeps} half-sweeps: residual card "
          f"{small_c[0]:.3e}, host() {small_h[0]:.3e}, error against the "
          f"truth {small_c[2]:.3e} / {small_h[2]:.3e} (bar "
          f"{EIG_SOLVE_BAR:g}), ranks {small_c[1]} / {small_h[1]}, wall "
          f"card {small_c[3]:.3f} s, host() {small_h[3]:.3f} s; programs "
          f"{small[0]} eager runs, {small[1]} captures, {small[2]} replays, "
          f"K5 {small[3]} launches, {small[4]} eigh/svd info checks")
    for r in (small_c, small_h):
        if not (r[0] < EIG_SOLVE_BAR and r[2] < EIG_SOLVE_BAR
                and max(r[1]) == max_rank and r[1] == small_h[1]):
            fails.append("dmrg_solve on test_als.py's instance")
    lap("dmrg_solve, card and host()")

    # 5. the fused apply + round: quasi-optimal against apply_operator and
    # its svd rounding (a loose bar here, where the svd rounding itself
    # leaves half of ||Ax||), the same TT on the card and under host()
    # from the same sketches, and exact where the product's rank fits the
    # target (A times the rank-30 start: rank <= 30 a < 128)
    rank, target = EIG_APPLY
    x30, A = _poisson_objects(xt, D, RANK, dev)[:2]
    x_np = bench_round_instance(D, 2, rank, SEED)
    x = xt.convert.tt_from_numpy(x_np, device=dev)

    y, w_fused = _timed(lambda: xt.ops.apply_operator_rounded(A, x, target))
    Ax, w_apply = _timed(lambda: xt.apply_operator(A, x))
    z = Ax.copy()
    _, w_round = _timed(lambda: z.round_fast(target, method="svd"))
    inner = xt.tt.inner
    nAx2 = inner(Ax, Ax)

    def err(t):
        # ||t - Ax|| from inner products in TT form (the errors are far
        # above the cancellation floor sqrt(eps) ||Ax||)
        return max(inner(t, t) - 2 * inner(t, Ax) + nAx2, 0.0) ** 0.5

    e_fused, e_svd = err(y), err(z)
    nAx = nAx2 ** 0.5
    bar = EIG_QUASI * e_svd + 1e-12 * nAx
    print(f"eigensolver: xt.ops.apply_operator_rounded(A, x, {target}), A "
          f"the d={D} Poisson operator, x slice 2's rank-{rank} TT: error "
          f"{e_fused:.6e} against apply_operator(A, x) (||Ax|| {nAx:.6e}), "
          f"round_fast({target}, 'svd') of the product {e_svd:.6e}, bar "
          f"{bar:.6e}; max rank {max(y.ranks())}; wall fused "
          f"{w_fused:.3f} s, apply_operator {w_apply:.3f} s + round_fast "
          f"{w_round:.3f} s")
    if not (e_fused <= bar and max(y.ranks()) <= target
            and e_svd > 1e-6 * nAx):
        fails.append("apply_operator_rounded's quasi-optimality")
    Ax30 = xt.apply_operator(A, x30)
    e_exact = ((xt.ops.apply_operator_rounded(A, x30, target) - Ax30)
               .frob_norm() / Ax30.frob_norm())
    rng = np.random.default_rng(SEED)
    l = target + 8                         # apply_operator_rounded's l
    sketches = [torch.from_numpy(rng.standard_normal((l, 2, l)))
                for _ in range(D - 1)]
    y = xt.ops.apply_operator_rounded(A, x, target,
                                      sketches=[t.to(dev) for t in sketches])
    cpu_dev = torch.device("cpu")
    with xt.host():
        A_h = _poisson_objects(xt, D, RANK, cpu_dev)[1]
        x_h = xt.convert.tt_from_numpy(x_np, device=cpu_dev)
        y_h, w_host = _timed(lambda: xt.ops.apply_operator_rounded(
            A_h, x_h, target, sketches=sketches))
        y_c = xt.convert.tt_from_numpy(
            [c._torch().cpu().numpy() for c in y.components], device=cpu_dev)
        d_host = (y_c - y_h).frob_norm() / y_h.frob_norm()
    print(f"eigensolver: apply_operator_rounded card vs host() on the same "
          f"sketches {d_host:.3e} (bar {EIG_CARD_HOST:g}), ranks "
          f"{max(y.ranks())} / {max(y_h.ranks())}, wall host() "
          f"{w_host:.3f} s; A times the rank-{RANK} start at target "
          f"{target}, max product rank {max(Ax30.ranks())}: error "
          f"{e_exact:.3e} relative (bar {EIG_APPLY_EXACT:g})")
    if not (d_host <= EIG_CARD_HOST and y.ranks() == y_h.ranks()):
        fails.append("apply_operator_rounded: card and host() disagree")
    if not (e_exact <= EIG_APPLY_EXACT and max(Ax30.ranks()) <= target):
        fails.append("apply_operator_rounded is not exact at a "
                     "representable rank")
    lap("apply_operator_rounded, card and host()")

    # 6. the Riemannian kit, decomposition_als, randomTTSVD, the cascade
    walls = {}

    def timer(name, fn):
        out, wall = _timed(fn)
        walls.setdefault(name, []).append(wall)
        return out

    card = _kit_cases(xt, timer)
    with xt.host():
        cpu = _kit_cases(xt, timer)
    for name, (v_card, ranks) in card.items():
        v_cpu, ranks_cpu = cpu[name]
        diff = _rel(v_card, v_cpu)
        print(f"eigensolver: {name}: card vs host() {diff:.3e} (bar "
              f"{EIG_CARD_HOST:g}), ranks {ranks} / {ranks_cpu}, wall card "
              f"{walls[name][0]:.3f} s, host() {walls[name][1]:.3f} s")
        if not (diff <= EIG_CARD_HOST and ranks == ranks_cpu
                and np.all(np.isfinite(v_card))):
            fails.append(f"{name}: card and host() disagree")
    lap("kit, decomposition_als, randomTTSVD, cascade, card and host()")
    wall = time.perf_counter() - t_phase
    print(f"eigensolver: phase {wall:.1f} s (bar {EIG_PHASE_S:g} s) by step: "
          + ", ".join(f"{name} {t:.1f} s" for name, t, _ in laps))
    if wall > EIG_PHASE_S:
        fails.append(f"the phase took {wall:.1f} s")
    if fails:
        raise AssertionError("eigensolver: " + "; ".join(fails))
    return jac_launches


# the sparse QR (phase_sparse_qr): benchmarks/sparseqr_scale.py's
# make_instance patterns at its largest size, m x n = 4096 x 2048: random
# scatter with 8 entries a row (mean row span far past the limit: the
# dense Heath route, its QR on the card) and banded with 2 (the native
# Givens route on the host); tests/test_sparse_qr.py's bars
SQR_SHAPE = (4096, 2048)
SQR_PATTERNS = (("random", 8), ("banded", 2))
SQR_REL = 1e-12            # ||QC - A|| / ||A|| and ||Q^T Q - I||_F


def _sqr_instance(rng, m, n, k, pattern):
    """benchmarks/sparseqr_scale.py's make_instance (unique positions)."""
    import numpy as np
    rows = np.repeat(np.arange(m), k)
    if pattern == "banded":
        base = (rows * n) // m
        cols = np.minimum(base + rng.integers(0, max(k, 2), size=rows.size),
                          n - 1)
    else:
        cols = rng.integers(0, n, size=rows.size)
    pos = np.unique(rows * n + cols)
    return pos, rng.standard_normal(pos.size)


def _flat_to_dense(flat, rows, cols, dev):
    """A {row * cols + col: value} dict as a dense float64 card matrix."""
    import numpy as np
    import torch
    keys = np.fromiter(flat.keys(), np.int64, len(flat))
    vals = np.fromiter(flat.values(), np.float64, len(flat))
    out = torch.zeros(rows * cols, dtype=torch.float64, device=dev)
    out[torch.from_numpy(keys).to(dev)] = torch.from_numpy(vals).to(dev)
    return out.reshape(rows, cols)


def phase_sparse_qr(dev, smi):
    """The sparse QR of the object layer (``core/sparse_qr.py``) at full
    size: the native library must have built; each pattern takes its
    route, the card's dense route makes the host LAPACK route's rank
    decision (the JAX package's algorithm), and Q C reconstructs A with
    orthonormal Q.  Printed: each route's wall beside torch.linalg.qr in
    float64 on the dense copy, the dense route's bytes on the card against
    its memory (there is no size guard, as in the JAX package), and the
    split of the object call ``xt.calculate_qc`` on the sparse Tensor."""
    import numpy as np
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.core import sparse_qr as sq
    t_phase = time.perf_counter()
    if not sq.native_available():
        raise AssertionError("sparse qr: the native library did not build")
    print(f"sparse qr: native library {os.path.relpath(sq.library_path(), HERE)}")
    m, n = SQR_SHAPE
    tol = 16.0 * float(np.finfo(np.float64).eps)
    rng = np.random.default_rng(0xC0FFEE)
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    for pattern, k in SQR_PATTERNS:
        pos, vals = _sqr_instance(rng, m, n, k, pattern)
        span = sq.mean_row_span(pos, m, n)
        dense_route = span > sq.ROW_SPAN_NATIVE_LIMIT
        if dense_route != (pattern == "random"):
            raise AssertionError(f"sparse qr {pattern}: mean row span {span}"
                                 " sends it to the other route")
        sq.sparse_qc(pos, vals, m, n, tol)   # warm-up: first calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        q, c, rank = sq.sparse_qc(pos, vals, m, n, tol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        A = _flat_to_dense(dict(zip(pos.tolist(), vals.tolist())), m, n, dev)
        Q, C = _flat_to_dense(q, m, rank, dev), _flat_to_dense(c, rank, n, dev)
        rec = float(torch.linalg.norm(Q @ C - A) / torch.linalg.norm(A))
        orth = float(torch.linalg.norm(
            Q.T @ Q - torch.eye(rank, dtype=torch.float64, device=dev)))
        svd_rank = int(torch.linalg.matrix_rank(A))
        qr_ms = _wall_ms(lambda: torch.linalg.qr(A), 3)
        line = (f"sparse qr {pattern} {m}x{n} ({len(vals)} entries, mean row "
                f"span {span:.1f}, limit {sq.ROW_SPAN_NATIVE_LIMIT:g}): route "
                f"{'dense Heath (QR on the card)' if dense_route else 'native Givens (host)'}, "
                f"rank {rank} (SVD rank {svd_rank}), fill Q {len(q):,} C "
                f"{len(c):,}, ||QC - A||/||A|| {rec:.3e}, ||Q^T Q - I||_F "
                f"{orth:.3e} (bars {SQR_REL:g}); wall {wall * 1e3:.1f} ms "
                f"(after a warm-up) beside torch.linalg.qr f64 of the dense copy "
                f"{qr_ms:.3f} ms ({smi})")
        print(line)
        if not (rec <= SQR_REL and orth <= SQR_REL):
            raise AssertionError(f"sparse qr {pattern}: misses its bars")
        if dense_route:
            # the JAX package's dense route is LAPACK's QR + the cascade
            t0 = time.perf_counter()
            with xt.host():
                _, _, host_rank = sq.dense_heath_qc(pos, vals, m, n, tol)
            host_s = time.perf_counter() - t0
            held = 8 * (m * n + m * min(m, n) + min(m, n) * n)
            n_max = int((total_mem / 40) ** 0.5)
            print(f"sparse qr dense route: rank {rank} on the card, "
                  f"{host_rank} by LAPACK on the host ({host_s:.2f} s); "
                  f"card memory: A, Q and R in float64 {held / 1e6:.1f} MB, "
                  f"peak allocated {peak / 1e6:.1f} MB of "
                  f"{total_mem / 1e9:.1f} GB; no size guard (as in the JAX "
                  f"package): an m = 2n instance holds 40 n^2 bytes, so "
                  f"n <= {n_max:,} fits the card")
            if host_rank != rank:
                raise AssertionError("sparse qr: the card's dense route "
                                     "decides another rank than LAPACK's")
            # the object call on the sparse Tensor, and where it goes
            S = xt.Tensor([m, n], xt.Representation.Sparse)
            S._sparse = dict(zip(pos.tolist(), vals.tolist()))
            t0 = time.perf_counter()
            Qo, Co = xt.calculate_qc(S, 1)
            torch.cuda.synchronize()
            obj_s = time.perf_counter() - t0
            coo_ms = _wall_ms(S.sparse_coo, 3)
            print(f"sparse qr object call xt.calculate_qc: {obj_s:.3f} s "
                  f"(rank {Qo.dimensions[-1]}, Q {Qo.representation.name}, "
                  f"C {Co.representation.name}); of it the dict to sorted "
                  f"COO {coo_ms:.3f} ms and the route {wall:.3f} s, the rest "
                  "building and densifying the outputs")
            if Qo.dimensions[-1] != rank:
                raise AssertionError("sparse qr: the object call decides "
                                     "another rank")
        del A, Q, C
    print(f"sparse qr: phase {time.perf_counter() - t_phase:.1f} s")


# the rounding speed presets (phase_speed_presets): slice 2's instance and
# the JAX bf16 study's rank 1024 -> 512 (benchmarks/bf16_round_study.py),
# each with the study's geometric damping 0.99 per rank slot; the error is
# the relative truncation error ||X - Xr|| / ||X|| in float64 on the card,
# the mean over PRESET_SKETCHES sketches (the same ones for each speed)
PRESET_CASES = ((32, 256, 128), (32, 1024, 512))
PRESET_BAR = 1.1           # doc/performance.md's bar against 'exact'
PRESET_SKETCHES = 2
PRESET_DAMPING = 0.99


def _tt_log_norm_card(cores):
    """log ||X|| of a TT in float64 on the card (QR of each carry)."""
    import torch
    R = torch.ones((1, 1), dtype=torch.float64, device=cores[0].device)
    log_acc = torch.zeros((), dtype=torch.float64, device=R.device)
    for c in cores:
        cur = torch.tensordot(R, c.double(), dims=1)
        R = torch.linalg.qr(cur.reshape(-1, cur.shape[2]), mode="r")[1]
        nrm = torch.linalg.norm(R)
        R = R / nrm
        log_acc = log_acc + torch.log(nrm)
    return float(log_acc)


def _tt_distance_card(xs, ys):
    """||X - Y|| / ||X|| in float64 on the card: the difference TT's block
    cores contracted with a QR of every carry (examples/rounding.py's
    host_tt_distance on the device)."""
    import math
    import torch
    d = len(xs)
    blocks = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        x, y = x.double(), y.double()
        if i == 0:
            blocks.append(torch.cat([x, -y], dim=2))
        elif i == d - 1:
            blocks.append(torch.cat([x, y], dim=0))
        else:
            z = x.new_zeros((x.shape[0] + y.shape[0], x.shape[1],
                             x.shape[2] + y.shape[2]))
            z[:x.shape[0], :, :x.shape[2]] = x
            z[x.shape[0]:, :, x.shape[2]:] = y
            blocks.append(z)
    return math.exp(_tt_log_norm_card(blocks) - _tt_log_norm_card(xs))


def phase_speed_presets(dev, smi):
    """``round_fast(speed=...)``'s presets at full size: the randomized
    cholqr1 sweep at 'exact' and at 'bf16_frontier' (bulk GEMMs one bf16
    pass on cuBLAS, Gram at bf16x3), and the Gram at one pass as the
    control, on the decaying instances; the frontier's error within 1.1x
    of 'exact', its bf16 GEMMs counted, torch's TF32 and reduced-precision
    flags still off; walls and TFLOP/s by randomized_round_flops; the
    object entry TTTensor.round_fast on slice 2's instance."""
    import numpy as np
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.examples import bench_round_instance
    from xerus_tpu_torch.ops import round_kernels as rk
    t_phase = time.perf_counter()
    variants = (("exact", None, None), ("bf16_frontier", "default", "high"),
                ("gram_default", "default", "default"))
    for d, rank, target in PRESET_CASES:
        cores = _preset_cores(d, rank, dev)
        flops = rk.randomized_round_flops([tuple(c.shape) for c in cores],
                                          target, OVERSAMPLE)
        err = {}
        for name, p, g in variants:
            def run(seed=0, p=p, g=g):
                return rk._round_randomized(
                    cores, target, OVERSAMPLE, qr_method="cholqr1",
                    precision=p, gram_precision=g,
                    generator=torch.Generator(device=dev).manual_seed(seed))
            run()
            torch.cuda.synchronize()
            gemms0 = rk._bf16_pass.gemms
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            gemms = (rk._bf16_pass.gemms - gemms0) // 2
            errs = [_tt_distance_card(cores, run(seed))
                    for seed in range(PRESET_SKETCHES)]
            err[name] = float(np.mean(errs))
            wall = min(walls)
            print(f"speed presets d={d} rank {rank}->{target} {name} "
                  f"(precision {p}, gram {g}): wall {wall * 1e3:.3f} ms "
                  f"(best of 2 after a warm-up), "
                  f"{flops / wall / 1e12:.3f} TFLOP/s by "
                  f"randomized_round_flops, bf16 GEMMs {gemms} a rounding, "
                  f"relative truncation error {err[name]:.6e} (mean of "
                  f"{PRESET_SKETCHES} sketches: "
                  f"{', '.join(f'{e:.6e}' for e in errs)}) ({smi})")
            # where the time goes: one more rounding under torch.profiler
            pwall, busy, nk, top = _device_busy(run, top=4)
            idle = ("not measured (the profiler saw no device time)"
                    if busy is None else f"{1.0 - busy / pwall:.3f}")
            split = ", ".join(f"{t * 1e3:.3f} ms {k}x {nm[:60]}"
                              for nm, t, k in top)
            print(f"speed presets d={d} rank {rank}->{target} {name} under "
                  f"torch.profiler: wall {pwall * 1e3:.3f} ms, {nk} kernels, "
                  f"device busy {'-' if busy is None else f'{busy * 1e3:.3f}'}"
                  f" ms, idle share {idle}; largest: {split}")
            if name == "exact" and gemms:
                raise AssertionError("speed presets: 'exact' ran bf16 GEMMs")
            if name != "exact" and not gemms:
                raise AssertionError(f"speed presets: {name} ran no bf16 "
                                     "GEMM on the card")
        ratio = err["bf16_frontier"] / err["exact"]
        control = err["gram_default"] / err["exact"]
        print(f"speed presets d={d} rank {rank}->{target}: bf16_frontier "
              f"error {ratio:.4f}x 'exact' (bar {PRESET_BAR:g}); control "
              f"gram='default' {control:.4f}x, {control / PRESET_BAR:.3f}x "
              f"the bar (the JAX study measured 4.62x on a TPU)")
        if not ratio <= PRESET_BAR:
            raise AssertionError(f"speed presets: bf16_frontier error "
                                 f"{ratio:.4f}x 'exact' at rank {rank}")
        # one product at the sweep's largest Gram: its panels are at most
        # (target n, l), l = target + oversample
        y = torch.randn(target * ROUND_N, target + OVERSAMPLE, device=dev)
        gram = ", ".join(
            f"{p or 'float32'} {_time_ms(lambda p=p: rk.mm_precision(y.T, y, p), reps=20):.4f} ms"
            for p in (None, "default", "high"))
        print(f"speed presets: the largest Gram ({y.shape[1]} x {y.shape[0]})"
              f" @ ({y.shape[0]} x {y.shape[1]}) by mm_precision, CUDA "
              f"events, median of 20: {gram} ({smi})")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
             torch.get_float32_matmul_precision())
    print(f"speed presets: allow_tf32 {flags[0]}, bf16 reduced-precision "
          f"reduction {flags[1]}, float32 matmul precision {flags[2]}")
    if flags != (False, False, "highest"):
        raise AssertionError("speed presets: torch's precision flags moved")
    # the object entry on slice 2's instance (float64 TTTensor)
    x = xt.convert.tt_from_numpy(bench_round_instance(ROUND_D, ROUND_N,
                                                      ROUND_RANK, SEED),
                                 device=dev)
    for speed in ("exact", "bf16_frontier"):
        y = x.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y.round_fast(ROUND_TARGET, speed=speed)
        torch.cuda.synchronize()
        print(f"speed presets: TTTensor.round_fast({ROUND_TARGET}, "
              f"speed={speed!r}) on slice 2's float64 TT: "
              f"{time.perf_counter() - t0:.3f} s, ranks max {max(y.ranks())}")
        if max(y.ranks()) > ROUND_TARGET or not np.isfinite(y.frob_norm()):
            raise AssertionError(f"speed presets: round_fast {speed} failed")
    print(f"speed presets: phase {time.perf_counter() - t_phase:.1f} s")


# the randomized sweep, the fused apply + round and the batched SPD
# half-sweep as programs (ops/programs.py): the randomized cases are
# PRESET_CASES' damped instances, the apply + round EIG_APPLY's, and the
# batch BATCH_B instances of the Poisson system (the reference protocol's
# 10 solves a run, make_als_sweep_batched's docstring)
BATCH_B = 10
BATCH_BAR = 1e-12         # batched vs the loop of single sweeps, relative


def _preset_cores(d, rank, dev):
    """slice 2's instance at (d, rank) with every bond slot damped by
    PRESET_DAMPING (the bf16 study's decaying spectrum), float32 on
    ``dev``."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import bench_round_instance
    cores = []
    for c in bench_round_instance(d, ROUND_N, rank, SEED):
        rl, _, rr = c.shape
        dl = PRESET_DAMPING ** np.arange(rl)
        dr = PRESET_DAMPING ** np.arange(rr)
        cores.append(c * dl[:, None, None] * dr[None, None, :])
    return list(cores_to_torch(cores, dev, torch.float32))


def _flat(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _flat(sub)]


def _bitwise(a, b) -> bool:
    import torch
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(fa, fb))


def _programmed(name, run, eager_run, program, smi, top=0):
    """``run()`` five times through a program its factory made afresh: two
    eager calls, the capture (its eager warm-up is the result), two
    replays; ``eager_run()`` is the function run eagerly, the plain
    version.  Prints first-call, eager, capturing and replayed walls, the
    graph's nodes and pool, the idle share of an eager run and of a replay
    under torch.profiler; fails unless each replay is bitwise the plain
    run, the program ran 2 eager calls, 1 capture and the replays, and no
    host read happened in a replay; with ``top``, the replay's ``top``
    kernels by device time beside.  Returns (the replay's result, its
    best wall in s)."""
    import torch
    from xerus_tpu_torch.ops import round_kernels as rk
    walls, outs, reads = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        reads0 = rk.host_bool.reads
        t0 = time.perf_counter()
        outs.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        reads.append(rk.host_bool.reads - reads0)
    p = program()
    plain = eager_run()
    torch.cuda.synchronize()
    same = [_bitwise(o, plain) for o in outs]
    idle = []
    for fn in (eager_run, run):
        wall, busy, nk, *largest = _device_busy(fn, top)
        idle.append("not measured" if busy is None
                    else f"{1.0 - busy / wall:.3f} of {wall * 1e3:.3f} ms "
                         f"({nk} kernels, busy {busy * 1e3:.3f} ms)")
    if top:
        idle[1] += "; largest: " + ", ".join(
            f"{t * 1e3:.3f} ms {k}x {nm[:60]}" for nm, t, k in largest[0])
    replay = min(walls[3:])
    print(f"programs: {name}: first call {walls[0] * 1e3:.3f} ms, eager "
          f"{walls[1] * 1e3:.3f} ms, the capture {walls[2] * 1e3:.3f} ms, "
          f"replayed {walls[3] * 1e3:.3f} / {walls[4] * 1e3:.3f} ms; idle "
          f"share eager {idle[0]}, replayed {idle[1]}; {p.nodes} graph "
          f"nodes, pool {p.pool_bytes / 2 ** 20:.1f} MiB, capture and "
          f"instantiation {p.capture_s:.3f} s; each call bitwise the plain "
          f"run: {same}; host reads per call {reads} ({smi})")
    if (p.eager_runs, p.captures, p.replays) != (2, 1, 3):
        raise AssertionError(f"programs: {name}: {p.eager_runs} eager runs, "
                             f"{p.captures} captures, {p.replays} replays "
                             "(expected 2, 1 and 3 with the profiled one)")
    if not all(same):
        raise AssertionError(f"programs: {name}: calls bitwise the plain "
                             f"run: {same}")
    if any(reads):
        raise AssertionError(f"programs: {name}: host reads {reads}")
    return outs[-1], replay


def _randomized_programs(dev, smi):
    """The randomized rounding's programs at PRESET_CASES, 'exact' and
    'bf16_frontier' (cholqr1, make_randomized_round_unrolled), and
    Householder (make_randomized_round) at rank 256; the frontier's
    truncation error within PRESET_BAR x 'exact''s on the replays."""
    import torch
    from xerus_tpu_torch.ops import programs as pg
    from xerus_tpu_torch.ops import round_kernels as rk
    for d, rank, target in PRESET_CASES:
        cores = _preset_cores(d, rank, dev)
        err = {}
        for speed in ("exact", "bf16_frontier"):
            p, g = (rk.SPEED_PRESETS[speed][k]
                    for k in ("precision", "gram_precision"))
            args = rk.randomized_inputs(cores, target, OVERSAMPLE, p, g)
            rk.make_randomized_round_unrolled.cache_clear()
            gemms0 = rk._bf16_pass.gemms
            out, _ = _programmed(
                f"randomized cholqr1 d={d} rank {rank}->{target} {speed}",
                lambda p=p, g=g: rk.tt_round_randomized_unrolled(
                    cores, target, OVERSAMPLE, p, g),
                lambda p=p, g=g: rk.tt_round_randomized_unrolled(
                    cores, target, OVERSAMPLE, p, g, eager=True),
                lambda p=p, g=g, args=args: pg.program_for(
                    rk.make_randomized_round_unrolled, args, target,
                    OVERSAMPLE, p, g), smi)
            gemms = (rk._bf16_pass.gemms - gemms0) // 8
            err[speed] = _tt_distance_card(cores, out)
            print(f"programs: randomized d={d} rank {rank}->{target} "
                  f"{speed}: bf16 GEMMs {gemms} a rounding (counted through "
                  f"the replays), truncation error {err[speed]:.6e}")
            if (gemms > 0) != (speed != "exact"):
                raise AssertionError(f"programs: {speed} ran {gemms} bf16 "
                                     "GEMMs a rounding")
        ratio = err["bf16_frontier"] / err["exact"]
        print(f"programs: randomized d={d} rank {rank}->{target}: "
              f"bf16_frontier error {ratio:.4f}x 'exact' on the replays "
              f"(bar {PRESET_BAR:g})")
        if not ratio <= PRESET_BAR:
            raise AssertionError(f"programs: bf16_frontier error {ratio:.4f}"
                                 f"x 'exact' at rank {rank}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
             torch.get_float32_matmul_precision())
    print(f"programs: after the captures allow_tf32 {flags[0]}, bf16 "
          f"reduced-precision reduction {flags[1]}, float32 matmul "
          f"precision {flags[2]}")
    if flags != (False, False, "highest"):
        raise AssertionError("programs: torch's precision flags moved")
    d, rank, target = PRESET_CASES[0]
    cores = _preset_cores(d, rank, dev)
    args = rk.randomized_inputs(cores, target, OVERSAMPLE)
    rk.make_randomized_round.cache_clear()
    _programmed(f"randomized Householder d={d} rank {rank}->{target}",
                lambda: rk.tt_round_randomized(cores, target, OVERSAMPLE),
                lambda: rk.tt_round_randomized(cores, target, OVERSAMPLE,
                                               eager=True),
                lambda: pg.program_for(rk.make_randomized_round, args,
                                       target, OVERSAMPLE), smi)


def _apply_round_program(dev, smi):
    """The fused apply + round's program (make_apply_round) on slice 2's
    rank-256 TT and the d=32 Poisson operator, to EIG_APPLY's target."""
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          qtt_poisson_instance)
    from xerus_tpu_torch.ops import apply_kernels as ak
    from xerus_tpu_torch.ops import programs as pg
    from xerus_tpu_torch.ops.dmrg_kernels import _pad_operator_stack
    from xerus_tpu_torch.ops.stacking import pad_cores
    rank, target = EIG_APPLY
    A = list(cores_to_torch(qtt_poisson_instance(D, RANK, SEED)[1], dev,
                            torch.float64))
    x = list(cores_to_torch(bench_round_instance(D, ROUND_N, rank, SEED),
                            dev, torch.float64))
    x_stack = pad_cores(x)[0]
    A_stack = _pad_operator_stack(A, x_stack.dtype)
    sk = ak.draw_apply_sketches(D, A_stack.shape[2], target + OVERSAMPLE,
                                x_stack.dtype, dev)
    ak.make_apply_round.cache_clear()
    _programmed(
        f"apply + round, the d={D} Poisson operator on slice 2's rank-{rank}"
        f" TT to {target}, float64",
        lambda: ak.apply_operator_rounded_cores(A, x, target, OVERSAMPLE),
        lambda: ak.apply_operator_rounded_cores(A, x, target, OVERSAMPLE,
                                                eager=True),
        lambda: pg.program_for(ak.make_apply_round,
                               (A_stack, x_stack, tuple(sk)), target,
                               OVERSAMPLE, "householder"), smi)


def _batched_sweep_program(dev, smi):
    """BATCH_B instances of the d=32 rank-30 Poisson system in float64
    (x from seeds SEED + i, b scaled by i + 1), one SPD half-sweep each way
    through make_als_sweep_batched's program against the loop of the
    single sweep's program (make_als_sweep), BATCH_BAR relative on each
    instance's represented tensor."""
    import numpy as np
    import torch
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import qtt_poisson_instance
    from xerus_tpu_torch.ops import als_kernels as ak
    from xerus_tpu_torch.ops import programs as pg
    insts = [qtt_poisson_instance(D, RANK, SEED + i) for i in range(BATCH_B)]
    A = tuple(cores_to_torch(insts[0][1], dev, torch.float64))
    xb = tuple(torch.from_numpy(np.stack([inst[0][k] for inst in insts]))
               .to(dev) for k in range(D))
    bb = tuple(torch.from_numpy(np.stack([inst[2][k] * (i + 1)
                                          for i, inst in enumerate(insts)]))
               .to(dev) for k in range(D))
    ak.make_als_sweep_batched.cache_clear()
    ak.make_als_sweep.cache_clear()
    for direction in ("lr", "rl"):
        out, w_batch = _programmed(
            f"batched SPD half-sweep {direction}, B={BATCH_B} d={D} rank "
            f"{RANK} float64",
            lambda: ak.als_half_sweep_batched(xb, A, bb, direction),
            lambda: ak.als_half_sweep_batched(xb, A, bb, direction,
                                              eager=True),
            lambda: pg.program_for(ak.make_als_sweep_batched, (xb, A, bb),
                                   direction, "pos"), smi, top=3)

        def loop():
            return [pg.call(ak.make_als_sweep, (
                tuple(c[i] for c in xb), A, tuple(c[i] for c in bb)),
                direction) for i in range(BATCH_B)]
        loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles = loop()
        torch.cuda.synchronize()
        w_loop = time.perf_counter() - t0
        rel = max(_tt_distance_card(s, [c[i] for c in out])
                  for i, s in enumerate(singles))
        print(f"programs: batched SPD half-sweep {direction}: replayed "
              f"{w_batch * 1e3:.3f} ms against the loop of {BATCH_B} "
              f"replayed single sweeps {w_loop * 1e3:.3f} ms; largest "
              f"distance to the loop's {rel:.3e} relative (bar "
              f"{BATCH_BAR:g}) ({smi})")
        if not rel <= BATCH_BAR:
            raise AssertionError(f"programs: the batched {direction} sweep "
                                 f"is {rel:.3e} from the loop's")
        xb = tuple(out)


def phase_round_programs(dev, smi):
    """The JAX package's remaining compiled programs on the card: the
    randomized roundings, the fused apply + round and the batched SPD
    half-sweep, each through its factory afresh (``_programmed``), with
    the seconds each block took."""
    t_phase = time.perf_counter()
    for name, block in (("randomized roundings", _randomized_programs),
                        ("apply + round", _apply_round_program),
                        ("batched SPD half-sweep", _batched_sweep_program)):
        t0 = time.perf_counter()
        block(dev, smi)
        print(f"programs: {name} block {time.perf_counter() - t0:.1f} s")
    print(f"programs: phase {time.perf_counter() - t_phase:.1f} s")


def phase_parallel(dev, smi):
    """The parallel layer on the card: a one-rank NCCL group (no gloo
    fallback: a failed init fails the run), every parallel entry and both
    mesh= arguments against the port's serial path on the same inputs
    (examples/parallel_checks.py and its bars), the group destroyed at the
    end.  Printed: each entry's wall beside the serial call's, which is
    what the collectives and the sharding cost at one rank."""
    import socket
    import torch
    from xerus_tpu_torch.examples.parallel_checks import misses, run_checks
    from xerus_tpu_torch.parallel.mesh import process_group
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev.index or 0)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with process_group("nccl", f"tcp://localhost:{port}", 0, 1):
        import torch.distributed as dist
        backend = dist.get_backend()
        run_checks(dev, 1)                   # warm-up: first calls, NCCL comms
        res = run_checks(dev, 1)
    for name, r in res.items():
        if name.startswith("_"):
            continue
        nums = {k: v for k, v in r.items() if isinstance(v, float)
                and not k.endswith("_s") and not k.startswith("par_s")
                and not k.startswith("ser_s")}
        print(f"parallel {name}: wall {r['par_s'] * 1e3:.3f} ms beside the "
              f"serial {r['ser_s'] * 1e3:.3f} ms; "
              + ", ".join(f"{k} {v:.3e}" for k, v in sorted(nums.items()))
              + f" (one NCCL rank, {smi})")
    bad = misses(res)
    print(f"parallel: backend {backend}, default mesh "
          f"{res['_mesh']['default_shape']}, {len(res) - 1} entries, misses "
          f"{bad}; phase {time.perf_counter() - t_phase:.1f} s")
    if backend != "nccl":
        raise AssertionError(f"parallel: backend {backend}, not nccl")
    if bad:
        raise AssertionError(f"parallel: {bad}")


# phase_warmup's families: (d, rank) of the Poisson family, whose als and
# df_round kinds round to rank // 2; workload 4's d and max rank (dmrg)
WARM_POISSON = (D, RANK)
WARM_DMRG = (EIG_D, 16)
# the first replaying call after warmup over the steady calls' median
# wall; an entry that reaches no program (gram, svd) runs eagerly at every
# call, its wall spread by the host by more than the bar, so its ratio is
# printed, not held
WARM_BAR = 1.2
# steady calls, their median wall the yardstick; a short replay's wall
# (the ADF iteration's) spreads with the host's launches around the graph,
# so a first call inside the steady calls' own range passes too
WARM_STEADY = 5
# entries whose graphs' first launch after the capture phase_warmup times
# beside the next two (cheap ones: it captures them once more)
WARM_PROBE = ("round_randomized", "adf_iteration")


def _warm_families(dev):
    """phase_warmup's families: (label, warmup's positional and keyword
    arguments, the cores of the entries, their entries): the Poisson
    family's f32 half-sweeps and df rounding to rank // 2 (warmup's op
    rank 2, the rank of examples.laplace_operator's MPO), the rounding
    family at rank ROUND_RANK -> ROUND_TARGET (gram, svd, randomized), the
    Lanczos half-sweep at workload 4's shapes and the ADF iteration on
    the completion instance's truth and samples."""
    import torch
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.convert import cores_to_torch
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          completion_instance,
                                          qtt_poisson_instance)
    from xerus_tpu_torch.examples.warm_entries import kind_entries
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    from xerus_tpu_torch.ops.adf_kernels import build_onehots
    d, rank = WARM_POISSON
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    x, A, b = (cores_to_torch(t, dev) for t in (xs, A, b))
    yield (f"Poisson d={d} rank {rank}", ([2] * d, rank),
           dict(op_rank=2, kinds=("als", "df_round")), x,
           kind_entries(("als", "df_round"), x, rank // 2, A=A, b=b))
    x = cores_to_torch(bench_round_instance(ROUND_D, ROUND_N, ROUND_RANK),
                       dev)
    yield (f"rounding d={ROUND_D} rank {ROUND_RANK} -> {ROUND_TARGET}",
           ([ROUND_N] * ROUND_D, ROUND_RANK),
           dict(target_rank=ROUND_TARGET, kinds=("round", "randomized")), x,
           kind_entries(("round", "randomized"), x, ROUND_TARGET))
    d, rank = WARM_DMRG
    xt.set_seed(SEED + 4)
    H = [c._torch() for c in xt.examples.heisenberg_mpo(d).components]
    x = [c._torch() for c in xt.TTTensor.random([2] * d, rank).components]
    H = dk._pad_operator_stack(H, torch.float64)
    yield (f"workload 4 d={d} rank {rank}", ([2] * d, rank),
           dict(dtype="float64", op_rank=H.shape[1], kinds=("dmrg",)), x,
           kind_entries(("dmrg",), x, rank // 2, H=H))
    inst = completion_instance()
    ms = inst.measurements
    x = cores_to_torch(inst.truth, dev, torch.float64)
    dims = [c.shape[1] for c in x]
    adf = (build_onehots(torch.from_numpy(ms.positions).to(dev), dims,
                         torch.float64),
           torch.from_numpy(ms.measuredValues).to(dev))
    yield (f"completion d={len(dims)} rank {x[1].shape[2]}, "
           f"{len(ms.measuredValues)} samples", (dims, int(x[1].shape[2])),
           dict(dtype="float64", num_measurements=len(ms.measuredValues),
                kinds=()), x,
           kind_entries(("adf_iteration",), x, 1, adf=adf))


def _walled(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_warmup(dev, smi):
    """``xt.warmup`` on the families of ``_warm_families``: for each, after
    ``programs.clear()`` the cold first call of each entry, then
    ``clear()`` again, the warmup (its dict printed), the first call after
    it and WARM_STEADY steady calls; for the entries of WARM_PROBE, after
    ``clear()``, the calls up to the capture, then three timed replays.
    Fails unless, for every entry, the
    first call after warmup runs no program eagerly and captures none,
    replays where its cold call ran programs, builds no kernel and is
    bitwise the steady calls' result, and unless a replaying call takes
    at most WARM_BAR times their median wall or no longer than the
    slowest of them.  Runs after the phases the kernels line counts:
    warmup's own calls move the launch counters."""
    import xerus_tpu_torch as xt
    from xerus_tpu_torch import build
    from xerus_tpu_torch.ops import programs as pg
    from xerus_tpu_torch.warmup import _tt_shapes
    P = pg.Program

    def counts():
        return (P.eager_runs, P.captures, P.replays)

    t_phase = time.perf_counter()
    fails = []
    for label, args, kw, x, entries in _warm_families(dev):
        if [tuple(c.shape) for c in x] != _tt_shapes(*args):
            raise AssertionError(f"warmup: {label}: cores "
                                 f"{[tuple(c.shape) for c in x]} are not "
                                 "the family's shapes")
        t_family = time.perf_counter()
        pg.clear()
        cold = {}
        for name, entry in entries.items():
            c0, b0 = counts(), dict(build.build_log)
            _, cold[name] = _walled(lambda: entry(False))
            cold[name] = (cold[name], counts()[0] - c0[0], ", ".join(
                f"built {k} in {v['seconds']:.2f} s"
                for k, v in build.build_log.items() if k not in b0))
        pg.clear()
        times, wall = _walled(lambda: xt.warmup(*args, **kw))
        builds = dict(build.build_log)
        print(f"warmup: {label}: xt.warmup in {wall:.3f} s: "
              f"{json.dumps({k: round(v, 4) for k, v in times.items()})}; "
              f"programs hold {pg.held_bytes() / 2 ** 20:.1f} MiB ({smi})")
        for name, entry in entries.items():
            c0 = counts()
            out, warm = _walled(lambda: entry(False))
            dc = [b - a for a, b in zip(c0, counts())]
            steady = [_walled(lambda: entry(False))
                      for _ in range(WARM_STEADY)]
            walls = [w for _, w in steady]
            ref = statistics.median(walls)
            same = all(_bitwise(out, o) for o, _ in steady)
            cold_s, cold_eager, built = cold[name]
            print(f"warmup: {label}: {name}: cold first call "
                  f"{cold_s * 1e3:.3f} ms ({cold_eager} eager program runs"
                  f"{'; ' + built if built else ''}), "
                  f"first call after warmup {warm * 1e3:.3f} ms ({dc[0]} "
                  f"eager runs, {dc[1]} captures, {dc[2]} replays), steady "
                  f"{ref * 1e3:.3f} ms (median of {WARM_STEADY}, "
                  f"{min(walls) * 1e3:.3f}-{max(walls) * 1e3:.3f}), warm / "
                  f"steady {warm / ref:.3f}, cold / steady "
                  f"{cold_s / ref:.3f}; bitwise the steady calls: {same}; "
                  f"programs hold {pg.held_bytes() / 2 ** 20:.1f} MiB "
                  f"({smi})")
            if dc[0] or dc[1]:
                fails.append(f"{label}: {name}: {dc[0]} eager runs, {dc[1]} "
                             "captures after warmup")
            if cold_eager and not dc[2]:
                fails.append(f"{label}: {name}: no replay after warmup")
            if not same:
                fails.append(f"{label}: {name}: not bitwise the steady calls")
            if cold_eager and warm > max(WARM_BAR * ref, max(walls)):
                fails.append(f"{label}: {name}: {warm / ref:.3f}x the steady "
                             f"call (bar {WARM_BAR})")
        if build.build_log != builds:
            fails.append(f"{label}: built {set(build.build_log) - set(builds)}"
                         " after warmup")
        for name in (n for n in WARM_PROBE if n in entries):
            pg.clear()
            for _ in range(pg.EAGER_CALLS + 1):
                entries[name](False)
            walls = [_walled(lambda: entries[name](False))[1] * 1e3
                     for _ in range(3)]
            print(f"warmup: {label}: {name}: the graphs' first launch after "
                  f"the capture {walls[0]:.3f} ms, the next two "
                  f"{walls[1]:.3f} / {walls[2]:.3f} ms ({smi})")
        print(f"warmup: {label}: {time.perf_counter() - t_family:.1f} s "
              "for the family")
    pg.clear()
    print(f"warmup: phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    if fails:
        raise AssertionError("warmup: " + "; ".join(fails))


def _loop_entries(k1q_poisson, poisson_rows, poisson_abs, rest_rows,
                  rest_abs, rest_launches, gmem_rows):
    """The JSON entries of K1c and K1q.  K1q: launches in the solve and
    the df roundings, times at the solve's (60, 30) (44 of its 62 calls),
    its cluster route at the rounding's (512, 256) and its gmem route at
    GMEM_SHAPES' beside them.  K1c: launches in the df roundings and the
    df solve, times per launch weighted by the launches at each shape,
    the (64, 64) block, the largest panel and both gmem shapes beside
    them.  ``f64_library_ms``: the float64 library
    call on the same shapes (torch.linalg.qr / cholesky /
    solve_triangular), the fp64 yardstick; ``library_ms`` is null: no
    PyTorch call computes in double-word f32."""
    q = poisson_rows[(60, 30)]
    cl = rest_rows["df_qr"].get((2 * ROUND_RANK, ROUND_RANK))
    k1q = {"launches": k1q_poisson + rest_launches["df_qr"], "ms": q["ms"], "plain_ms": q["plain_ms"],
           "bound_ms": q["bound_ms"], "bound_by": q["bound_by"],
           "f64_library_ms": q["f64_ms"], "shape": [60, 30]}
    if cl is not None:
        k1q.update(cluster_shape=[2 * ROUND_RANK, ROUND_RANK],
                   cluster_ms=cl["ms"], cluster_plain_ms=cl["plain_ms"],
                   cluster_bound_ms=cl["bound_ms"],
                   cluster_f64_library_ms=cl["f64_ms"])
    both = {**{("block",) + k: v for k, v in
               rest_rows["df_chol_block"].items()},
            **{("panel",) + k: v for k, v in
               rest_rows["df_trsm_rlt"].items()}}
    k1c = _loop_summary(both)
    k1c["launches"] = (rest_launches["df_chol_block"]
                       + rest_launches["df_trsm_rlt"])
    k1c["f64_library_ms"] = k1c.pop("f64_ms")
    k1c["bound_by"] = max(both.values(), key=lambda r: r["launches"]
                          * r["bound_ms"])["bound_by"]
    blk = rest_rows["df_chol_block"].get((64, 64))
    if blk is not None:
        k1c.update(block_64_ms=blk["ms"], block_64_plain_ms=blk["plain_ms"],
                   block_64_bound_ms=blk["bound_ms"])
    big = max(rest_rows["df_trsm_rlt"], key=lambda s: s[0] * s[1] ** 2)
    p = rest_rows["df_trsm_rlt"][big]
    k1c.update(panel_shape=list(big), panel_ms=p["ms"],
               panel_plain_ms=p["plain_ms"], panel_bound_ms=p["bound_ms"])
    for key, entry, prefix in (("df_qr", k1q, "gmem_"),
                               ("df_chol_block", k1c, "block_gmem_"),
                               ("df_trsm_rlt", k1c, "panel_gmem_")):
        shape = GMEM_SHAPES[key]
        g = gmem_rows[key][shape]
        entry.update({prefix + "shape": list(shape), prefix + "ms": g["ms"],
                      prefix + "plain_ms": g["plain_ms"],
                      prefix + "bound_ms": g["bound_ms"],
                      prefix + "f64_library_ms": g["f64_ms"]})
    k1q.update(max_abs_err=max(poisson_abs, rest_abs["df_qr"]),
               library_ms=None)
    k1c.update(max_abs_err=max(rest_abs["df_chol_block"],
                               rest_abs["df_trsm_rlt"]), library_ms=None)
    return k1c, k1q


def _jacobi_entry(kernel, name):
    """K4's or K5's timing at the main path's shape (``JAC_MAIN``) and,
    beside it, every other shape of ``phase_jacobi``."""
    rows = kernel["rows"]
    main_row = rows[JAC_MAIN[name]]
    out = {k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
    out["shape"] = main_row["shape"]
    out["shapes"] = [{"case": case, **{k: v for k, v in row.items()
                                       if k != "max_abs_err"}}
                     for case, row in rows.items()]
    return out


def main():
    sys.path.insert(0, HERE)
    smi = phase_environment()
    import torch
    import xerus_tpu_torch
    dev = xerus_tpu_torch.cuda_device()
    phase_build()
    _loop_fns()
    k1_max_abs, k1_timing = phase_kernels(dev)
    k2_max_abs, k2_timing, k2g_timing = phase_k2(dev)
    k3_max_abs, k3_timing = phase_k3(dev)
    jacobi = phase_jacobi(dev, smi)
    phase_small_agreement(dev)
    phase_small_rounding(dev)
    phase_completion_small(dev)
    (k1_launches, k1q_poisson), solution, host_residual, slice_run = \
        phase_slice(dev)
    k2_launches, round_ref, ge_f32, slice_round = phase_round_slice(dev)
    k2g_launches = phase_round_grid(dev)
    rest_rows, rest_abs, rest_launches, gmem_rows, df_k4 = \
        phase_rounding_rest(dev, smi, slice_round)
    phase_round_programs(dev, smi)
    k3_launches, completion = phase_completion_slice(dev)
    iht_residual = phase_iht(dev)
    phase_objects(dev, smi)
    phase_pivoted_qr(dev, smi)
    k2_tt, k2_f64 = phase_tt_objects(dev, smi, solution, host_residual,
                                     round_ref, ge_f32)
    k2_launches += k2_tt
    k2_timing.update(k2_f64)
    phase_algorithms(dev, smi, slice_run, host_residual, completion,
                     iht_residual)
    k4_launches, k5_launches = phase_eigensolver(dev, smi)
    phase_sparse_qr(dev, smi)
    phase_speed_presets(dev, smi)
    phase_parallel(dev, smi)
    poisson_rows, poisson_abs = phase_breakdown(dev, smi)
    phase_round_breakdown(dev)
    k1c, k1q = _loop_entries(k1q_poisson, poisson_rows, poisson_abs,
                             rest_rows, rest_abs, rest_launches, gmem_rows)
    phase_warmup(dev, smi)

    def entry(name, source, replaces, launches, max_abs, timing):
        # beside the main shape's numbers: K2's in float64 on the object
        # rounding's largest bond; K1c's and K1q's shapes and routes
        extra = {k: v for k, v in timing.items()
                 if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "launches", "max_abs_err")}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs, "ms": timing["ms"],
                "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"],
                "bound_by": timing["bound_by"],
                "library_ms": timing["library_ms"], **extra}

    print(json.dumps({"kernels": [
        entry("df_matvec", "xerus_tpu_torch/csrc/df_matvec.cu",
              "xerus_tpu/ops/pallas_df.py:60", k1_launches, k1_max_abs,
              k1_timing),
        entry("gemm_exact", "xerus_tpu_torch/csrc/gemm_exact.cu",
              "xerus_tpu/ops/tt_kernels.py:1232", k2_launches, k2_max_abs,
              k2_timing),
        # K2's grid route (the same wrapper and kernel library): the
        # rank-512 rounding's launches, times at (512, 512) keep 256 and,
        # with the suffix _1024, at (1024, 1024) keep 512
        entry("gemm_exact_grid", "xerus_tpu_torch/csrc/gemm_exact_grid.cuh",
              "xerus_tpu/ops/tt_kernels.py:1232", k2g_launches,
              k2g_timing["max_abs_err"], k2g_timing),
        entry("tt_eval", "xerus_tpu_torch/csrc/tt_eval.cu",
              "xerus_tpu/ops/pallas_tt_eval.py:45", k3_launches, k3_max_abs,
              k3_timing),
        # K1's column loops (the JAX package's fori_loops at
        # xerus_tpu/ops/df_cholesky.py:38, :71 and mixed_precision.py:91)
        entry("df_chol", "xerus_tpu_torch/csrc/df_chol.cu",
              "xerus_tpu/ops/pallas_df.py:60", k1c["launches"],
              k1c["max_abs_err"], k1c),
        entry("df_qr", "xerus_tpu_torch/csrc/df_qr.cu",
              "xerus_tpu/ops/pallas_df.py:60", k1q["launches"],
              k1q["max_abs_err"], k1q),
        # K4 and K5 replace no Pallas kernel: the JAX package's
        # jnp.linalg.eigh / svd inside its half-sweep programs
        # K4 also seeds the df rounding's df_svd: its launches in a
        # replayed df rounding beside the eigensolver's
        entry("small_eigh", "xerus_tpu_torch/csrc/jacobi.cu",
              "xerus_tpu/ops/dmrg_kernels.py:305", k4_launches,
              jacobi["small_eigh"]["max_abs_err"],
              {**_jacobi_entry(jacobi["small_eigh"], "small_eigh"),
               "df_round_launches": df_k4}),
        entry("small_svd", "xerus_tpu_torch/csrc/jacobi.cu",
              "xerus_tpu/ops/dmrg_kernels.py:365", k5_launches,
              jacobi["small_svd"]["max_abs_err"],
              _jacobi_entry(jacobi["small_svd"], "small_svd"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
