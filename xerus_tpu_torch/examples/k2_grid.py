"""K2's grid route at the bond shapes of the rank-512 and rank-1024
roundings, timed on the card beside its bound and gesvd.

    python3 -m xerus_tpu_torch.examples.k2_grid [--rounding] [--fault7]
        [--stamps] [--certify N] [--before CSRC] [--out DIR]
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
the whole rank-512 -> 256 gemm_exact and svd roundings' walls (one after a
warm-up, synchronized) and K2's device time bond by bond; ``--fault7``
the bonds of both roundings that K2 does not certify (``fault7``);
``--stamps`` where one launch's time goes, from a profiling build of K2
with the grid route's time stamps (``GRID_STAMPS``); ``--certify N`` the
certificates under N orderings of each bond's columns (``certify_rates``).
``--products`` runs on the CPU alone: the plain version on the bonds
0 and 14 of the rank-512 instance with torch's float32 products and with
exactly rounded ones (``exact_products``).
``--before CSRC`` runs all of it a second time on K2 built from another
version's ``xerus_tpu_torch/csrc`` (a ``git archive`` of it unpacked in
the checkout) whose C interface is this one's.  Each line is printed and,
with ``--out``, written as JSON to ``DIR/k2_grid.json``.
``chip_smoke.py`` takes its K2 grid-route numbers from these functions.
"""

from __future__ import annotations

import argparse
import ctypes
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
                               ge._gemm_exact_tuning(dtype)[2])
    elt = torch.empty((), dtype=dtype).element_size()
    t_bytes = (B * M + 2 * cap * M) * elt / HBM_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", flop
    return t_ops, "operations", flop


def time_bond(cur, keep: int, cap: int, reps: int = 20) -> dict:
    """K2 and gesvd on one bond input: ms, flags, bound, gesvd ms."""
    from ..ops import gemm_exact as ge
    f = dict(zip(ge.FLAGS, ge.gemm_exact_kernel(cur, keep, cap)[2].tolist()))
    ms = event_ms(lambda: ge.gemm_exact_kernel(cur, keep, cap), reps)
    gesvd = event_ms(lambda: torch.linalg.svd(cur, full_matrices=False,
                                              driver="gesvd"), reps)
    B, M = cur.shape
    bound, by, flop = k2_bound(B, M, cap, f, cur.dtype)
    return {"shape": [B, M], "keep": keep, "cap": cap,
            "dtype": str(cur.dtype).replace("torch.", ""), "ms": ms,
            "gesvd_ms": gesvd, "bound_ms": bound, "bound_by": by,
            "gflop": flop / 1e9, "reached": bound / ms, "flags": f}


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
    warm-up, synchronized, and K2's device time bond by bond."""
    cores = _instance(dev, rank)
    out = {}
    for method in ("gemm_exact", "svd"):
        _o, wall, launches, cnt = rounding_wall(cores, target, method)
        out[method] = {"wall_s": wall, "k2_launches": launches,
                       "svd_fallbacks": cnt["svd_fallbacks"]}
    out["bonds"] = []
    for cur, _keep, cap, ms, f, _res in k2_calls(cores, target):
        B, M = cur.shape
        bound, _by, _flop = k2_bound(B, M, cap, f, torch.float32)
        out["bonds"].append({"shape": [B, M], "cap": cap, "ms": ms,
                             "bound_ms": bound, "flags": f})
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
    bond K2 does not certify, the plain version's decision on the card,
    the Newton-Schulz steps of each orthonormalization (from launches with
    max_outer = t and no polish, t = 0, 1, ...: the growth of the column
    count), and the outer steps with a Newton-Schulz cap of 64."""
    from ..ops import gemm_exact as ge
    out = []
    for n, (cur, keep, cap, _ms, f, _r) in enumerate(
            k2_calls(_instance(dev, rank), target)):
        if f["converged"]:
            continue
        max_outer, max_ns, polish, _stall = ge._gemm_exact_tuning(cur.dtype)
        mask = (torch.arange(cap, device=dev) < keep).to(cur.dtype)
        plain = ge._gemm_exact_body(cur, mask,
                                    *ge._gemm_exact_tuning(cur.dtype))
        per_orth, prev = [], 0
        for t in range(24):
            ft = _flags_with(cur, keep, cap, t, max_ns, 0)
            per_orth.append(ft["ns"] - ft["ns_rows"] - prev)
            prev = ft["ns"] - ft["ns_rows"]
        f64 = _flags_with(cur, keep, cap, max_outer, 64, polish)
        out.append({"bond": n, "flags": f,
                    "plain_certifies": bool(plain[3]), "plain_outer":
                        int(plain[4]), "ns_per_orth": per_orth,
                    "cap_64": f64})
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
    Newton-Schulz cap.  Returns per bond the certified count of each."""
    from ..ops import gemm_exact as ge
    tuning = ge._gemm_exact_tuning(torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    out = {"orders": orders, "bonds": []}
    inputs = bond_inputs(rank, target, dev)
    perms = [None] + [torch.randperm(inputs[0][0].shape[1], generator=gen)
                      for _ in range(orders - 1)]
    for cur, keep, cap in inputs:
        row = {"kernel": 0, "plain": 0 if plain else None, "outer": []}
        mask = (torch.arange(cap, device=dev) < keep).to(cur.dtype)
        for perm in perms:
            x = cur if perm is None else cur[:, perm.to(dev)].contiguous()
            f = dict(zip(ge.FLAGS, ge.gemm_exact_kernel(x, keep, cap)[2]
                         .tolist()))
            row["kernel"] += f["converged"]
            row["outer"].append(f["outer"])
            if plain:
                row["plain"] += bool(ge._gemm_exact_body(x, mask,
                                                         *tuning)[3])
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


def exact_products(bonds=(0, 14), rank: int = 512,
                   target: int = 256) -> list:
    """The plain version on the CPU on the rank-``rank`` instance's trunc
    bonds ``bonds`` (``bond_inputs``), with torch's float32 products and
    with exactly rounded ones (``ExactProducts``): whether each certifies,
    its outer steps, and the orthonormalizations that end at the
    Newton-Schulz cap (max_ns steps) without reaching the tolerance."""
    from ..ops import gemm_exact as ge
    from ..ops import round_kernels as rk
    inputs = bond_inputs(rank, target, torch.device("cpu"))
    tuning = ge._gemm_exact_tuning(torch.float32)
    stepwise = ge._ns_orth_cols_stepwise
    out = []
    for n in bonds:
        cur, keep, cap = inputs[n]
        mask = (torch.arange(cap) < keep).to(cur.dtype)
        for name in ("torch", "exact"):
            failed = []

            def orth(X, max_it, colmask=None, tol_mult=64.0):
                n0 = rk._ns_orth_cols.iterations
                Q, ok = stepwise(X, max_it, colmask, tol_mult)
                if not bool(ok):
                    failed.append(rk._ns_orth_cols.iterations - n0)
                return Q, ok

            ge._ns_orth_cols_stepwise = orth
            t0 = time.perf_counter()
            try:
                if name == "exact":
                    with ExactProducts():
                        r = ge._gemm_exact_body(cur, mask, *tuning)
                else:
                    r = ge._gemm_exact_body(cur, mask, *tuning)
            finally:
                ge._ns_orth_cols_stepwise = stepwise
            out.append({"bond": n, "products": name,
                        "certified": bool(r[3]), "outer": int(r[4]),
                        "orths_at_the_cap": len(failed),
                        "seconds": time.perf_counter() - t0})
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
        res["rounding"] = rounding_walls(dev)
        print("k2_grid rounding:", json.dumps(res["rounding"]), flush=True)
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounding", action="store_true")
    p.add_argument("--fault7", action="store_true")
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--certify", type=int, default=0, metavar="N")
    p.add_argument("--before", default=None, metavar="CSRC")
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
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k2_grid.json"), "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
