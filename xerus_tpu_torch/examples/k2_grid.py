"""K2's grid route at the bond shapes of the rank-512 and rank-1024
roundings, timed on the card beside its bound and gesvd.

    python3 -m xerus_tpu_torch.examples.k2_grid [--rounding] [--fault7]
        [--stamps] [--certify N] [--before CSRC] [--interleave CSRC ...]
        [--out DIR]
    python3 -m xerus_tpu_torch.examples.k2_grid --products

From the root of a checkout on a machine with an NVIDIA card.  The bond
inputs are those of the d=32, n=2 rounding instances
(``bench_round_instance``) at rank 512 -> 256 and 1024 -> 512, captured
from the svd rounding on the card (the trunc-mode bonds, (512, 512) keep
256 and (1024, 1024) keep 512); the middle bond of each is timed:

- K2 (``gemm_exact_kernel``): CUDA events, the median of 20 launches
  queued back to back after 2 warm-up launches, with the flags of the
  launch (route, outer and Newton-Schulz steps, barriers);
- its bound: ``gemm_exact_flops`` from those flags, each symmetric Gram
  counted on and above its diagonal, over the card's rate for the type
  (67 TFLOP/s FP32 FFMA, 67 TFLOP/s FP64 tensor cores), or the bytes over
  3.35 TB/s if that is larger;
- ``torch.linalg.svd(driver="gesvd")`` on the same input, the same way.

The rank-512 middle bond is also timed in float64.  ``--rounding`` adds
the whole gemm_exact and svd roundings' walls of both instances (one
after a warm-up, synchronized) and K2's device time bond by bond;
``--fault7`` the bonds of both roundings that K2 does not certify or
certifies only after two-stage retries (``fault7``); ``--stamps`` where one launch's time goes, from a profiling build of K2
with the grid route's time stamps (``GRID_STAMPS``); ``--certify N`` the
certificates and two-stage retries under N orderings of each bond's
columns (``certify_rates``).  ``--products`` runs on the CPU alone: the
plain version on the bonds 0 and 14 of the rank-512 instance with torch's
float32 products and with exactly rounded ones (``exact_products``), and
on the small graded bond of the fault-7 tests (``graded_bond``).
``--before CSRC`` runs all of it a second time on K2 built from another
version's ``xerus_tpu_torch/csrc`` (a ``git archive`` of it unpacked in
the checkout) whose C interface is this one's; ``--interleave CSRC ...``
times the middle bonds on this K2 and on each such version in turns
(``interleave``).  Each line is printed and, with ``--out``, written as
JSON to ``DIR/k2_grid.json`` with the builds' compiler output.
``chip_smoke.py`` takes its K2 grid-route numbers from these functions.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import time

import torch
from torch.overrides import TorchFunctionMode

SEED = 0xBAADF00D
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# (rank, target) of the two rounding instances whose bonds are timed
INSTANCES = ((512, 256), (1024, 512))
# the roundings ``--rounding`` runs: the rank-256 one's bonds take the
# cluster route
ROUNDINGS = ((256, 128),) + INSTANCES
# the small bond of the fault-7 tests (``graded_bond``): (B, M), keep,
# kept singular values from 1 down to 1 / ratio, the gap after them, seed
GRADED_BOND = dict(B=128, M=128, keep=64, ratio=800.0, gap=10.0, seed=1)
# the grid route's time stamps (csrc/gemm_exact_grid.cuh Stamp): CTA 0's
# clock64 cycles in all, waiting at grid barriers, in products, in folds
# of tile values, filling each tile's first k slice, in the k loops, in
# the tiles' folds and epilogues, and the k slices it computed
GRID_STAMPS = ("cycles", "barrier_wait", "products", "folds", "item_fill",
               "k_loops", "fold_epilogue", "k_slices")


def bond_inputs(rank: int, target: int, dev, dtype=torch.float32,
                seed: int = SEED):
    """The trunc-mode bond inputs (cur, keep, keep_cap) of the d=32, n=2
    rank-``rank`` instance's svd rounding to ``target`` on ``dev``, in the
    order the sweep visits them (right to left)."""
    from ..convert import cores_to_torch
    from ..ops import round_kernels as rk
    from .rounding import bench_round_instance
    cores = list(cores_to_torch(bench_round_instance(32, 2, rank, seed),
                                dev, dtype))
    seen = []
    step = rk._trunc_step

    def capture(cur, keep, keep_cap, eps, method, mode="trunc"):
        if mode == "trunc":
            seen.append((cur.clone(), int(keep), int(keep_cap)))
        return step(cur, keep, keep_cap, eps, method, mode=mode)

    rk._trunc_step = capture
    try:
        rk.tt_round_sweep_segmented(cores, target, method="svd")
    finally:
        rk._trunc_step = step
    return seen


def graded_bond(B: int, M: int, keep: int, ratio: float, gap: float,
                seed: int):
    """A float64 (B, M) bond with seeded singular vectors whose ``keep``
    leading singular values fall geometrically from 1 to 1 / ratio, the
    rest from 1 / (ratio gap) to 1 / (ratio gap^2): a clear subspace whose
    power-step images W = Gn^2 V are graded past float32's reach, so that
    their one-stage Newton-Schulz orthonormalization ends at the cap of 48
    (ROADMAP fault 7), as at the rank-512 rounding's bonds 0 and 14."""
    import numpy as np
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((B, B)))
    V, _ = np.linalg.qr(rng.standard_normal((M, B)))
    head = np.geomspace(1.0, 1.0 / ratio, keep)
    tail = np.geomspace(head[-1] / gap, head[-1] / gap ** 2, B - keep)
    return (U * np.concatenate([head, tail])) @ V.T


def event_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times in ms, the calls queued back to
    back behind a device-side sleep so that each pair times device work."""
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


def k2_bound(B: int, M: int, cap: int, flags: dict, dtype):
    """(bound_ms, bound_by, flop) of one launch from its flags, each Gram
    counted on and above its diagonal."""
    from ..ops import gemm_exact as ge
    flop = ge.gemm_exact_flops(B, M, cap, flags["outer"], flags["ns"],
                               flags["ns_rows"],
                               ge._gemm_exact_tuning(dtype)[2],
                               flags["retries"], flags["retry_stops"])
    elt = torch.empty((), dtype=dtype).element_size()
    t_bytes = (B * M + 2 * cap * M) * elt / HBM_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", flop
    return t_ops, "operations", flop


def digest(outputs) -> str:
    """A short hash of a launch's outputs (vt0, vt_bal): equal digests are
    equal bits."""
    h = hashlib.sha256()
    for t in outputs[:2]:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_bond(cur, keep: int, cap: int, reps: int = 20) -> dict:
    """K2 and gesvd on one bond input: ms, flags, bound, gesvd ms, the
    outputs' digest."""
    from ..ops import gemm_exact as ge
    first = ge.gemm_exact_kernel(cur, keep, cap)
    f = dict(zip(ge.FLAGS, first[2].tolist()))
    ms = event_ms(lambda: ge.gemm_exact_kernel(cur, keep, cap), reps)
    gesvd = event_ms(lambda: torch.linalg.svd(cur, full_matrices=False,
                                              driver="gesvd"), reps)
    B, M = cur.shape
    bound, by, flop = k2_bound(B, M, cap, f, cur.dtype)
    return {"shape": [B, M], "keep": keep, "cap": cap,
            "dtype": str(cur.dtype).replace("torch.", ""), "ms": ms,
            "gesvd_ms": gesvd, "bound_ms": bound, "bound_by": by,
            "gflop": flop / 1e9, "reached": bound / ms, "flags": f,
            "digest": digest(first)}


def stamped_launch(cur, keep: int, cap: int) -> dict:
    """One grid-route launch of the profiling build of K2 (compiled with
    XERUS_GRID_STAMPS, the same arithmetic): its flags and CTA 0's
    cycles by part (``GRID_STAMPS``)."""
    from .. import build
    from ..ops import gemm_exact as ge
    lib = build.load_kernel_library("gemm_exact", ("XERUS_GRID_STAMPS",))
    fn = (lib.xerus_gemm_exact_grid_stamped_f32
          if cur.dtype == torch.float32
          else lib.xerus_gemm_exact_grid_stamped_f64)
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lib.xerus_gemm_exact_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.xerus_gemm_exact_workspace_bytes.restype = ctypes.c_size_t
    B, M = cur.shape
    elt = cur.element_size()
    ws = torch.empty((lib.xerus_gemm_exact_workspace_bytes(B, M, cap, elt)
                      // elt,), dtype=cur.dtype, device=cur.device)
    vt0 = torch.empty((cap, M), dtype=cur.dtype, device=cur.device)
    vt_bal = torch.empty_like(vt0)
    flags = torch.zeros((len(ge.FLAGS),), dtype=torch.int32,
                        device=cur.device)
    st = torch.zeros(len(GRID_STAMPS), dtype=torch.int64, device=cur.device)
    rc = fn(cur.data_ptr(), B, M, cap, int(keep),
            *ge._gemm_exact_tuning(cur.dtype), ws.data_ptr(),
            vt0.data_ptr(), vt_bal.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(cur.device).cuda_stream,
            st.data_ptr())
    if rc != 0:
        raise RuntimeError(f"stamped grid launch failed: cudaError {rc}")
    return {"flags": dict(zip(ge.FLAGS, flags.tolist())),
            "stamps": dict(zip(GRID_STAMPS, st.tolist())),
            "outputs": (vt0, vt_bal)}


def stamp_shares(stamps: dict) -> dict:
    """The grid route's stamps as shares of CTA 0's cycles, "other" the
    rest (elementwise passes, control), and cycles a k slice."""
    cyc = max(stamps["cycles"], 1)
    out = {k: stamps[k] / cyc for k in ("barrier_wait", "products", "folds",
                                        "item_fill", "k_loops",
                                        "fold_epilogue")}
    out["other"] = 1.0 - out["barrier_wait"] - out["products"] - out["folds"]
    out["cycles_per_slice"] = stamps["k_loops"] / max(stamps["k_slices"], 1)
    return out


def k2_calls(cores, target: int):
    """One gemm_exact rounding of ``cores`` to ``target`` with every K2
    launch recorded: (cur, keep, keep_cap, device ms, flags, outputs) a
    bond, the ms by CUDA events around the wrapper call (its output
    allocation and flag fill included, a few us)."""
    from ..ops import gemm_exact as ge
    from ..ops import round_kernels as rk
    calls = []
    kernel = ge.gemm_exact_kernel

    def timed(cur, keep, cap):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = kernel(cur, keep, cap)
        end.record()
        calls.append((cur.clone(), keep, cap, start, end, res))
        return res

    # the wrapper counts its launches on whatever the module's name holds
    timed.launches = kernel.launches
    torch.cuda.synchronize()
    ge.gemm_exact_kernel = timed
    try:
        rk.tt_round_sweep_segmented(cores, target, method="gemm_exact")
    finally:
        ge.gemm_exact_kernel = kernel
    torch.cuda.synchronize()
    return [(cur, keep, cap, start.elapsed_time(end),
             dict(zip(ge.FLAGS, res[2].tolist())), res)
            for cur, keep, cap, start, end, res in calls]


def rounding_wall(cores, target: int, method: str):
    """One ``method`` rounding of ``cores`` to ``target`` after a warm-up
    one, synchronized: (output, wall s, K2 launches, gemm_exact's
    counters) of the counted one."""
    from ..ops import gemm_exact as ge
    from ..ops import round_kernels as rk
    rk.tt_round_sweep_segmented(cores, target, method=method)
    torch.cuda.synchronize()
    ge.reset_counters()
    t0 = time.perf_counter()
    out = rk.tt_round_sweep_segmented(cores, target, method=method)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, ge.gemm_exact_kernel.launches,
            {k: getattr(ge.trunc_step_gemm_exact, k)
             for k in ge.TRUNC_COUNTERS})


def _instance(dev, rank: int):
    from ..convert import cores_to_torch
    from .rounding import bench_round_instance
    return list(cores_to_torch(bench_round_instance(32, 2, rank, SEED), dev))


def rounding_walls(dev, rank: int = 512, target: int = 256) -> dict:
    """The rank-``rank`` gemm_exact and svd roundings: wall of one after a
    warm-up, synchronized, and K2's device time, flags and outputs'
    digest bond by bond."""
    cores = _instance(dev, rank)
    out = {}
    for method in ("gemm_exact", "svd"):
        _o, wall, launches, cnt = rounding_wall(cores, target, method)
        out[method] = {"wall_s": wall, "k2_launches": launches,
                       "svd_fallbacks": cnt["svd_fallbacks"],
                       "retries": cnt["retries"],
                       "retry_stops": cnt["retry_stops"]}
    out["bonds"] = []
    for cur, _keep, cap, ms, f, res in k2_calls(cores, target):
        B, M = cur.shape
        bound, _by, _flop = k2_bound(B, M, cap, f, torch.float32)
        out["bonds"].append({"shape": [B, M], "cap": cap, "ms": ms,
                             "bound_ms": bound, "flags": f,
                             "digest": digest(res)})
    return out


def _flags_with(cur, keep, cap, max_outer, max_ns, polish):
    """K2's flags on one input with other iteration caps."""
    from ..ops import gemm_exact as ge
    tuning = ge._gemm_exact_tuning
    ge._gemm_exact_tuning = lambda dtype: (max_outer, max_ns, polish,
                                           tuning(dtype)[3])
    try:
        f = ge.gemm_exact_kernel(cur, keep, cap)[2]
    finally:
        ge._gemm_exact_tuning = tuning
    return dict(zip(ge.FLAGS, f.tolist()))


def fault7(dev, rank: int = 512, target: int = 256) -> list:
    """ROADMAP fault 7 on the rank-``rank`` gemm_exact rounding: for each
    bond K2 does not certify or certifies only with two-stage retries, the
    plain version's decision and retries on the card, the Newton-Schulz
    steps of each step's orthonormalizations (from launches with
    max_outer = t and no polish, t = 0, 1, ...: the growth of the column
    count; a retried step's count holds all three), and the outer steps
    with a Newton-Schulz cap of 64."""
    from ..ops import gemm_exact as ge
    out = []
    for n, (cur, keep, cap, _ms, f, _r) in enumerate(
            k2_calls(_instance(dev, rank), target)):
        if f["converged"] and not f["retries"]:
            continue
        max_outer, max_ns, polish, _stall = ge._gemm_exact_tuning(cur.dtype)
        mask = (torch.arange(cap, device=dev) < keep).to(cur.dtype)
        retries0 = ge._power_orth.retries
        plain = ge._gemm_exact_body(cur, mask,
                                    *ge._gemm_exact_tuning(cur.dtype))
        plain_retries = ge._power_orth.retries - retries0
        per_orth, prev = [], 0
        for t in range(24):
            ft = _flags_with(cur, keep, cap, t, max_ns, 0)
            per_orth.append(ft["ns"] - ft["ns_rows"] - prev)
            prev = ft["ns"] - ft["ns_rows"]
        f64 = _flags_with(cur, keep, cap, max_outer, 64, polish)
        out.append({"bond": n, "flags": f,
                    "plain_certifies": bool(plain[3]), "plain_outer":
                        int(plain[4]), "plain_retries": plain_retries,
                    "ns_per_orth": per_orth, "cap_64": f64})
    return out


def certify_rates(dev, rank: int, target: int, orders: int,
                  plain: bool = True) -> dict:
    """How far a bond's certificate is a property of the bond: each trunc
    bond input of the rank-``rank`` instance (``bond_inputs``, the same
    for every version of K2) under ``orders`` orderings of its columns
    (the identity, then seeded permutations), through K2 and (``plain``)
    the plain version on the card.  Reordering cur's columns leaves G = cur cur^T,
    and so every step's exact value, as it is, and changes only the order
    of G's sums: a bond whose certificate flips with it sits at the f32
    Newton-Schulz cap.  Returns per bond the certified count of each,
    the outer steps and the two-stage retries of each launch, and the
    plain version's retries in all."""
    from ..ops import gemm_exact as ge
    tuning = ge._gemm_exact_tuning(torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    out = {"orders": orders, "bonds": []}
    inputs = bond_inputs(rank, target, dev)
    perms = [None] + [torch.randperm(inputs[0][0].shape[1], generator=gen)
                      for _ in range(orders - 1)]
    for cur, keep, cap in inputs:
        row = {"kernel": 0, "plain": 0 if plain else None, "outer": [],
               "retries": [], "plain_retries": 0 if plain else None,
               "digest": digest(ge.gemm_exact_kernel(cur, keep, cap))}
        mask = (torch.arange(cap, device=dev) < keep).to(cur.dtype)
        for perm in perms:
            x = cur if perm is None else cur[:, perm.to(dev)].contiguous()
            f = dict(zip(ge.FLAGS, ge.gemm_exact_kernel(x, keep, cap)[2]
                         .tolist()))
            row["kernel"] += f["converged"]
            row["outer"].append(f["outer"])
            row["retries"].append(f["retries"])
            if plain:
                retries0 = ge._power_orth.retries
                row["plain"] += bool(ge._gemm_exact_body(x, mask,
                                                         *tuning)[3])
                row["plain_retries"] += ge._power_orth.retries - retries0
        out["bonds"].append(row)
    return out


class ExactProducts(TorchFunctionMode):
    """Every float32 matmul computed in float64 and rounded to float32
    once: the product no order of f32 sums can beat."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.Tensor.matmul, torch.Tensor.__matmul__,
                     torch.matmul) and not kwargs
                and args[0].dtype == torch.float32):
            return (args[0].double() @ args[1].double()).float()
        return func(*args, **(kwargs or {}))


def plain_run(cur, keep: int, cap: int, exact: bool = False) -> dict:
    """The plain version on one bond input, with torch's float32 products
    or with exactly rounded ones (``ExactProducts``): whether it
    certifies, its outer steps, the power steps taken again in two stages
    (``retries``; ``retry_stops`` of them stopped after their first
    stage), the column orthonormalizations that end at the
    Newton-Schulz cap without reaching the tolerance (each retry's first
    try among them), and the most Newton-Schulz steps of one."""
    from ..ops import gemm_exact as ge
    from ..ops import round_kernels as rk
    tuning = ge._gemm_exact_tuning(cur.dtype)
    mask = (torch.arange(cap, device=cur.device) < keep).to(cur.dtype)
    stepwise = ge._ns_orth_cols_stepwise
    done, failed = [], []

    def orth(X, max_it, colmask=None, tol_mult=64.0):
        n0 = rk._ns_orth_cols.iterations
        Q, ok = stepwise(X, max_it, colmask, tol_mult)
        (done if bool(ok) else failed).append(rk._ns_orth_cols.iterations
                                              - n0)
        return Q, ok

    retries0, stops0 = ge._power_orth.retries, ge._power_orth.stops
    ge._ns_orth_cols_stepwise = orth
    t0 = time.perf_counter()
    try:
        if exact:
            with ExactProducts():
                r = ge._gemm_exact_body(cur, mask, *tuning)
        else:
            r = ge._gemm_exact_body(cur, mask, *tuning)
    finally:
        ge._ns_orth_cols_stepwise = stepwise
    return {"certified": bool(r[3]), "outer": int(r[4]),
            "retries": ge._power_orth.retries - retries0,
            "retry_stops": ge._power_orth.stops - stops0,
            "orths_at_the_cap": len(failed),
            "ns_max_converged": max(done, default=0),
            "seconds": time.perf_counter() - t0}


def exact_products(bonds=(0, 14), rank: int = 512,
                   target: int = 256) -> list:
    """The plain version on the CPU on the rank-``rank`` instance's trunc
    bonds ``bonds`` (``bond_inputs``) and on ``graded_bond``, with torch's
    float32 products and with exactly rounded ones (``plain_run``)."""
    inputs = bond_inputs(rank, target, torch.device("cpu"))
    g = GRADED_BOND
    inputs = {n: inputs[n] for n in bonds}
    inputs["graded"] = (torch.tensor(graded_bond(**g), dtype=torch.float32),
                        g["keep"], g["keep"])
    out = []
    for n, (cur, keep, cap) in inputs.items():
        for name in ("torch", "exact"):
            out.append({"bond": n, "products": name,
                        **plain_run(cur, keep, cap, name == "exact")})
            print("k2_grid products:", json.dumps(out[-1]), flush=True)
    return out


def use_library(csrc: str):
    """Point ``ops/gemm_exact``'s wrapper at K2 built from ``csrc``, whose
    C interface must be this one's; returns the library function it
    replaced."""
    from .. import build
    from ..ops import gemm_exact as ge
    own = ge._library
    lib = ge._bind(build.load_kernel_library("gemm_exact",
                                             csrc=os.path.abspath(csrc)))
    ge._library = lambda: lib
    return own


def run(args, dev, plain: bool = True) -> dict:
    """Every measurement ``args`` asks for, on the library in use."""
    res = {"bonds": []}
    for rank, target in INSTANCES:
        bonds = bond_inputs(rank, target, dev)
        cur, keep, cap = bonds[len(bonds) // 2]
        dtypes = ((torch.float32, torch.float64) if rank == 512
                  else (torch.float32,))
        for dtype in dtypes:
            x = cur.to(dtype)
            r = time_bond(x, keep, cap)
            r["instance"] = f"rank {rank} -> {target}, bond "\
                            f"{len(bonds) // 2} of {len(bonds)}"
            if args.stamps:
                st = stamped_launch(x, keep, cap)
                del st["outputs"]
                r["stamps"], r["shares"] = (st["stamps"],
                                            stamp_shares(st["stamps"]))
            res["bonds"].append(r)
            print("k2_grid:", json.dumps(r), flush=True)
    if args.rounding:
        res["rounding"] = {}
        for rank, target in ROUNDINGS:
            res["rounding"][rank] = rounding_walls(dev, rank, target)
            print(f"k2_grid rounding rank {rank}:",
                  json.dumps(res["rounding"][rank]), flush=True)
    if args.fault7:
        res["fault7"] = [fault7(dev, r, t) for r, t in INSTANCES]
        print("k2_grid fault 7:", json.dumps(res["fault7"]), flush=True)
    if args.certify:
        res["certify"] = {}
        for rank, target in INSTANCES:
            t0 = time.perf_counter()
            c = certify_rates(dev, rank, target, args.certify, plain)
            c["seconds"] = time.perf_counter() - t0
            res["certify"][rank] = c
            print(f"k2_grid certify rank {rank}:", json.dumps(c), flush=True)
    return res


def interleave(dev, csrcs) -> list:
    """K2 on this version and on each of ``csrcs`` (other versions'
    ``xerus_tpu_torch/csrc`` with this C interface), timed in turns at the
    middle trunc bond of each rounding in ``ROUNDINGS`` (float32; the
    rank-512 one also in float64): libraries in order, then in reverse
    (A B C C B A), each time ``event_ms``.  Returns per bond each
    library's two times."""
    from .. import build
    from ..ops import gemm_exact as ge
    own = ge._library
    libs = [("this", own())] + [
        (c, ge._bind(build.load_kernel_library("gemm_exact",
                                               csrc=os.path.abspath(c))))
        for c in csrcs]
    out = []
    try:
        for rank, target in ROUNDINGS:
            bonds = bond_inputs(rank, target, dev)
            cur, keep, cap = bonds[len(bonds) // 2]
            for dtype in ((torch.float32, torch.float64) if rank == 512
                          else (torch.float32,)):
                x = cur.to(dtype)
                ms = {name: [] for name, _lib in libs}
                for name, lib in libs + libs[::-1]:
                    ge._library = lambda lib=lib: lib
                    ms[name].append(event_ms(
                        lambda: ge.gemm_exact_kernel(x, keep, cap)))
                out.append({"rank": rank, "dtype": str(dtype)[6:],
                            "ms": ms})
                print("k2_grid interleaved:", json.dumps(out[-1]),
                      flush=True)
    finally:
        ge._library = own
    return out


def bitwise(after: dict, before: dict) -> dict:
    """Which launches gave the same bits on both libraries: per timed
    bond (by instance and type) and per rounding's bond, the two digests'
    equality beside the retries of the launch on this library.  A
    rounding's bonds after the first that differs see other inputs; the
    certificate rows (``certify_rates``) hold every bond's input fixed."""
    out = {"bonds": [[a["instance"], a["dtype"], a["digest"] == b["digest"],
                      a["flags"]["retries"]]
                     for a, b in zip(after["bonds"], before["bonds"])]}
    for rank, r in after.get("rounding", {}).items():
        out[rank] = [[n, a["digest"] == b["digest"], a["flags"]["retries"]]
                     for n, (a, b) in enumerate(zip(
                         r["bonds"], before["rounding"][rank]["bonds"]))]
    for rank, c in after.get("certify", {}).items():
        out[f"certify {rank}"] = [
            [n, a["digest"] == b["digest"], a["retries"][0]]
            for n, (a, b) in enumerate(zip(
                c["bonds"], before["certify"][rank]["bonds"]))]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounding", action="store_true")
    p.add_argument("--fault7", action="store_true")
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--certify", type=int, default=0, metavar="N")
    p.add_argument("--before", default=None, metavar="CSRC")
    p.add_argument("--interleave", nargs="+", default=(), metavar="CSRC")
    p.add_argument("--products", action="store_true",
                   help="on the CPU, no card: exact_products alone")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.products:
        exact_products()
        return
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    from concurrent.futures import ThreadPoolExecutor
    from .. import build
    builds = [((), build.CSRC)]
    if args.stamps:
        builds.append((("XERUS_GRID_STAMPS",), build.CSRC))
    if args.before:
        builds.append(((), os.path.abspath(args.before)))
    builds += [((), os.path.abspath(c)) for c in args.interleave]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        list(pool.map(lambda b: build.load_kernel_library("gemm_exact", *b),
                      builds))
    print(f"k2_grid: {len(builds)} builds of K2 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {"card": smi, "after": run(args, dev)}
    if args.before:
        print(f"k2_grid: K2 from {args.before}", flush=True)
        from ..ops import gemm_exact as ge
        own = use_library(args.before)
        args.stamps = False
        try:
            res["before"] = run(args, dev, plain=False)
        finally:
            ge._library = own
        res["bitwise"] = bitwise(res["after"], res["before"])
        print("k2_grid bitwise:", json.dumps(res["bitwise"]), flush=True)
    if args.interleave:
        res["interleaved"] = interleave(dev, args.interleave)
    res["builds"] = build.build_log
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k2_grid.json"), "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
