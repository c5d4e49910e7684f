"""K1q and K1c, the df column loops, timed on the card at the paths'
shapes, beside another version's kernels in the same process.

    python3 -m xerus_tpu_torch.examples.df_loops [--before CSRC] [--paths]
        [--stamps] [--out DIR]

From the root of a checkout on a machine with an NVIDIA card.  At each
shape of ``SHAPES`` (K1q's (60, 30) on route cta, (512, 256) on route
cluster, (1024, 512) on route gmem; K1c's blocks (64, 64) and (256, 256),
panels (512, 256) and (256, 1536)) every library is timed in turns, A B B
A: CUDA events, the median of 20 calls queued back to back behind a
device-side sleep after 2 warm-up calls (``k2_grid.event_ms``), beside
the bound (the bytes over 3.35 TB/s or K1's 21 FP32 operations a df
multiply-add term over 67 TFLOP/s, whichever is larger) and the float64
library call on the same shape (``torch.linalg.qr`` / ``cholesky`` /
``solve_triangular``, which computes in f64, not in df).

- ``--before CSRC``: the kernels built from another version's
  ``xerus_tpu_torch/csrc`` (a ``git archive`` of it unpacked in the
  checkout), whose C interface is this one's, as the second library; its
  K1q launches get the whole 227 KB of shared memory and a larger route
  gmem workspace, which cover any version's layout.
- ``--paths``: the launches of K1c per shape in the d=32 rank-256 df
  roundings (random to 128, the 1e-9 cliff to 256 with eps 1e-7) and the
  df solve (n = 1800, condition 1e10, 5 refinement steps), each shape
  timed on every library and the mean per launch weighted by the
  launches; then on each library in turns (A B A) the Poisson solve
  (d=32, rank 30, 4 f32 + 2 df half-sweeps) replayed, its df phase alone
  replayed, and the random df rounding replayed, each the wall of one
  synchronized call after the calls that capture its programs.
- ``--stamps``: where the time of a K1q column goes, from a build of
  ``csrc/df_qr.cu`` with ``-DXERUS_DFQR_STAMPS``
  (``xerus_df_qr_stamped``): thread 0 of CTA 0's clock cycles by kind
  (arithmetic, folds, block barriers, cluster barriers, the pulls over
  distributed shared memory, the rest) over all columns, at each K1q
  shape.

Each line is printed and, with ``--out``, written as JSON to
``DIR/df_loops.json`` with the builds' compiler output.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .k2_grid import event_ms

SEED = 0xBAADF00D
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
K1_OPS_PER_TERM = 21
SHAPES = (("df_qr", (60, 30)), ("df_qr", (512, 256)), ("df_qr", (1024, 512)),
          ("df_chol_block", (64, 64)), ("df_chol_block", (256, 256)),
          ("df_trsm_rlt", (512, 256)), ("df_trsm_rlt", (256, 1536)))
STAMP_KINDS = ("arithmetic", "folds", "block_barriers", "cluster_barriers",
               "pulls", "rest")
LIBS = ("df_qr", "df_chol")


def bound(entry: str, shape) -> tuple:
    """(bound_ms, bound_by): the bytes (each input read once, each output
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = K1_OPS_PER_TERM * terms / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def inputs(entry: str, shape, dev):
    """The launch function's df operands at ``shape``: a Gaussian matrix
    with three deficient columns (df_qr), an SPD block of condition 1e6
    (df_chol_block), a Gaussian panel and a lower-triangular factor
    (df_trsm_rlt)."""
    from ..ops.df32 import df_from_f64
    rng = np.random.Generator(np.random.PCG64(SEED + sum(shape)))
    if entry == "df_qr":
        m, r = shape
        a = rng.normal(size=(m, r))
        a[:, r // 3], a[:, r // 2] = 2.0 * a[:, 1], 0.0
        a[:, r - 1] = a[:, 0] - 3.0 * a[:, 2]
        return df_from_f64(a, dev)
    B = shape[1]
    if entry == "df_chol_block":
        q, _ = np.linalg.qr(rng.normal(size=(B, B)))
        return df_from_f64((q * np.logspace(0, -6, B)) @ q.T, dev)
    L = np.tril(rng.normal(size=(B, B)), -1) * 0.1 + np.diag(
        rng.uniform(0.5, 2.0, size=B))
    return (*df_from_f64(rng.normal(size=shape), dev), *df_from_f64(L, dev))


def library_call(entry: str, args):
    """The float64 library call on the same shape (not a df computation)."""
    from ..ops.df32 import df_to_f64
    A = torch.from_numpy(df_to_f64(*args[:2])).to(args[0].device)
    if entry == "df_qr":
        return lambda: torch.linalg.qr(A)
    if entry == "df_chol_block":
        return lambda: torch.linalg.cholesky(A)
    L = torch.from_numpy(df_to_f64(*args[2:4])).to(args[0].device)
    return lambda: torch.linalg.solve_triangular(L.T, A, upper=True,
                                                 left=False)


class Libraries:
    """Points ``ops/df_loops``'s launches at other builds of K1q and K1c
    while it stands: ``libs`` maps "df_qr" / "df_chol" to a loaded
    library; with ``spare``, K1q's launches get the whole 227 KB of shared
    memory and, on route gmem, a workspace of 32 more rows a band than
    the plan's (another version's layout may need more)."""

    def __init__(self, libs: dict, spare: bool = False):
        self.libs, self.spare = libs, spare

    def __enter__(self):
        from ..ops import df_loops as dl
        self.dl, self.own = dl, (dl._fn, dl.df_qr_plan)
        libs, plan = self.libs, dl.df_qr_plan

        def fn(lib, name):
            f = getattr(libs[lib], name)
            f.argtypes, f.restype = dl._ARGTYPES[name], ctypes.c_int
            return f
        dl._fn = fn
        if self.spare:
            def spare(m, r):
                p = plan(m, r)
                return p._replace(smem=dl.SMEM_MAX, work=p.work and (
                    2 * dl.CLUSTER_CTAS * (p.rows + 32) * r))
            dl.df_qr_plan = spare
        return self

    def __exit__(self, *exc):
        self.dl._fn, self.dl.df_qr_plan = self.own


def launch(entry: str, args):
    """One launch of ``entry`` on ``args`` by the (possibly patched)
    plan."""
    from ..ops import df_loops as dl
    if entry == "df_qr":
        return dl.df_qr_launch(*args, dl.df_qr_plan(*args[0].shape))
    if entry == "df_chol_block":
        return dl.df_chol_block_launch(
            *args, dl.df_chol_block_plan(args[0].shape[0]))
    return dl.df_trsm_rlt_launch(*args, dl.df_trsm_plan(*args[0].shape))


def kernel_times(entry: str, shape, libraries: list, dev) -> dict:
    """``entry`` at ``shape`` on each (name, Libraries) in turns, A B B A:
    both times per library, its median-of-20 each."""
    args = inputs(entry, shape, dev)
    ms = {name: [] for name, _ in libraries}
    for name, libs in libraries + libraries[::-1]:
        with libs:
            ms[name].append(event_ms(lambda: launch(entry, args)))
    b, by = bound(entry, shape)
    return {"entry": entry, "shape": list(shape), "ms": ms, "bound_ms": b,
            "bound_by": by, "f64_library_ms": event_ms(library_call(entry,
                                                                   args))}


def stamped(shape, dev, lib) -> dict:
    """One K1q launch at ``shape`` on the stamped build ``lib``: the
    cycles of thread 0 of CTA 0 by kind, summed over the columns, their
    shares, and per column on average."""
    from ..ops import df_loops as dl
    m, r = shape
    ah, al = inputs("df_qr", shape, dev)
    plan = dl.df_qr_plan(m, r)
    f = lib.xerus_df_qr_stamped
    f.argtypes = dl._ARGTYPES["xerus_df_qr"] + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = [ah.new_empty(s) for s in ((m, r), (m, r), (r, r), (r, r))]
    work = ah.new_empty((max(plan.work, 1),))
    stamps = torch.zeros((r, len(STAMP_KINDS)), dtype=torch.int64,
                         device=dev)
    for _ in range(2):      # the second launch is the one kept
        stamps.zero_()
        rc = f(ah.data_ptr(), al.data_ptr(), r, *(o.data_ptr() for o in out),
               None, work.data_ptr(), plan.work, m, r,
               {"cta": 0, "cluster": 1, "gmem": 2}[plan.route], plan.smem,
               torch.cuda.current_stream(dev).cuda_stream, stamps.data_ptr())
        if rc != 0:
            raise RuntimeError(f"xerus_df_qr_stamped: error {rc}")
    torch.cuda.synchronize()
    s = stamps.cpu().numpy()
    total = s.sum(0)
    return {"shape": list(shape), "route": plan.route,
            "cycles": dict(zip(STAMP_KINDS, total.tolist())),
            "shares": dict(zip(STAMP_KINDS,
                               (total / max(total.sum(), 1)).tolist())),
            "cycles_per_column": float(total.sum()) / r}


class _Recorder:
    """Counts K1c's launches per (entry, shape) while it stands."""

    def __enter__(self):
        from ..ops import df_loops as dl
        self.dl, self.calls = dl, {}
        self.own = (dl.df_chol_block_launch, dl.df_trsm_rlt_launch)
        for name, fn in zip(("df_chol_block", "df_trsm_rlt"), self.own):
            def rec(*args, fn=fn, name=name):
                key = (name, tuple(args[0].shape))
                self.calls[key] = self.calls.get(key, 0) + 1
                return fn(*args)
            rec.launches = 0    # the launch function counts on its name
            setattr(dl, name + "_launch", rec)
        return self

    def __exit__(self, *exc):
        self.dl.df_chol_block_launch, self.dl.df_trsm_rlt_launch = self.own


def _round_instances():
    from .rounding import bench_round_instance, cliff_instance
    host = [np.asarray(c, np.float64)
            for c in bench_round_instance(32, 2, 256, SEED)]
    return host, cliff_instance(host, 96, 1e-9)


def k1c_launches(dev) -> dict:
    """K1c's launches per (entry, shape) in the two d=32 rank-256 df
    roundings and the df solve."""
    from ..ops import df_rounding as dr
    from ..ops.df32 import df_from_f64
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    host, cliff = _round_instances()
    n = 1800
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (q * np.logspace(0, -10, n)) @ q.T
    b = A @ np.random.default_rng(3).normal(size=n)
    with _Recorder() as rec:
        dr.tt_round_df_from_f64(host, 128, 0.0, dev)
        dr.tt_round_df_from_f64(cliff, 256, 1e-7, dev)
        dc.df_solve_spd_chol(*df_from_f64(A, dev), *df_from_f64(b, dev),
                             refine_iters=5)
        torch.cuda.synchronize()
    return rec.calls


def weighted(calls: dict, libraries: list, dev) -> dict:
    """Each library's time at every recorded K1c shape (in turns, A B B
    A) and its mean per launch weighted by the launches."""
    rows = [kernel_times(e, s, libraries, dev) for e, s in sorted(calls)]
    n = sum(calls.values())
    mean = {name: sum(calls[r["entry"], tuple(r["shape"])]
                      * min(r["ms"][name]) for r in rows) / n
            for name, _ in libraries}
    bnd = sum(calls[r["entry"], tuple(r["shape"])] * r["bound_ms"]
              for r in rows) / n
    return {"launches": n, "shapes": len(rows), "ms_per_launch": mean,
            "bound_ms_per_launch": bnd, "rows": rows}


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def path_walls(dev, libraries: list) -> list:
    """On each library in turns (A B A): the Poisson solve, its df phase
    alone and the random df rounding, each replayed (the programs
    captured anew for the library, the wall of the call after)."""
    from ..convert import cores_to_df, cores_to_torch
    from ..ops import df_rounding as dr
    from ..ops import mixed_precision as mp
    from ..ops import programs as pg
    from .poisson import qtt_poisson_instance
    xs, A, b = qtt_poisson_instance(32, 30, SEED)
    args = (cores_to_torch(xs, dev), cores_to_torch(A, dev),
            cores_to_torch(b, dev), cores_to_df(A, dev), cores_to_df(b, dev))
    host, _ = _round_instances()
    out = []
    for name, libs in libraries + libraries[-2::-1]:
        pg.clear()
        with libs:
            solve = lambda: mp.als_f32_df_run(*args, 16, 2)
            f32 = lambda: mp.als_f32_df_run(*args, 16, 0)
            for _ in range(2):
                solve()
                f32()
            seed = f32()[0]
            df = lambda: mp.df_als_multi_sweep(seed, args[3], args[4], 2)
            df()
            df()
            rnd = lambda: dr.tt_round_df_from_f64(host, 128, 0.0, dev)
            for _ in range(3):
                rnd()
            row = {"library": name, "solve_s": _wall(solve),
                   "df_phase_s": _wall(df), "df_rounding_s": _wall(rnd)}
        out.append(row)
        print("df_loops path:", json.dumps(row), flush=True)
    pg.clear()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--before", default=None, metavar="CSRC")
    p.add_argument("--paths", action="store_true")
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from .. import build
    from ..ops import df_loops as dl
    builds = {("this", lib): (lib, (), build.CSRC) for lib in LIBS}
    if args.before:
        builds.update({("before", lib): (lib, (), os.path.abspath(
            args.before)) for lib in LIBS})
    if args.stamps:
        builds[("stamps", "df_qr")] = ("df_qr", ("XERUS_DFQR_STAMPS",),
                                       build.CSRC)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        loaded = dict(zip(builds, pool.map(
            lambda b: build.load_kernel_library(*b), builds.values())))
    print(f"df_loops: {len(builds)} builds in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    libraries = [("this", Libraries({lib: loaded["this", lib]
                                     for lib in LIBS}))]
    if args.before:
        libraries.append(("before", Libraries(
            {lib: loaded["before", lib] for lib in LIBS}, spare=True)))
    res = {"card": smi, "kernels": []}
    for entry, shape in SHAPES:
        row = kernel_times(entry, shape, libraries, dev)
        res["kernels"].append(row)
        print("df_loops kernel:", json.dumps(row), flush=True)
    if args.stamps:
        res["stamps"] = []
        for entry, shape in SHAPES:
            if entry == "df_qr":
                st = stamped(shape, dev, loaded["stamps", "df_qr"])
                res["stamps"].append(st)
                print("df_loops stamps:", json.dumps(st), flush=True)
    if args.paths:
        calls = k1c_launches(dev)
        res["k1c_weighted"] = weighted(calls, libraries, dev)
        w = {k: v for k, v in res["k1c_weighted"].items() if k != "rows"}
        print("df_loops K1c per launch:", json.dumps(w), flush=True)
        res["paths"] = path_walls(dev, libraries)
    res["builds"] = build.build_log
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "df_loops.json"), "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
