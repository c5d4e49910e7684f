"""K2: the certified GEMM-only truncation, hand-written in CUDA for Hopper.

Counterpart of ``xerus_tpu/ops/tt_kernels.py`` ``_gemm_exact_body``,
``_ns_polar_rows``, ``_finish_gemm_exact``, ``_gemm_exact_tuning`` and the
dispatcher ``_trunc_step_gemm_exact``; the TPU ran the body as the Pallas
kernel ``_gemm_exact_pallas_call``.  The kernel is ``csrc/gemm_exact.cu``;
its header says what bounds it on the card and how the design answers.

``trunc_step_gemm_exact`` takes the plain version ``_gemm_exact_body`` for
tensors on the CPU, and only there.  For CUDA tensors it launches the
kernel (``gemm_exact_kernel``) or raises; nothing falls back.  The
Householder-LQ finish and the SVD fallback stay outside the kernel, as on
the TPU: the host decides them from the kernel's flags, one read per bond.

The kernel has two routes, chosen from the shape before the launch
(``gemm_exact_route``): one 16-CTA thread-block cluster with the whole
state in shared memory where it fits (the rounding's (256, 256) and
(256, 512) bonds in the 128 bucket, in f32 and, with exchanges in slices
and products on the FP64 tensor cores, in f64), else the cooperative grid
kernel of ``csrc/gemm_exact_grid.cuh`` (the rank-512 and rank-1024
roundings' bonds), whose launch plan ``grid_plan`` and workspace layout
``grid_layout`` mirror on the host.  ``gemm_exact_flops``
is the operation count of one truncation from its iteration counts, for
the kernel's flags and the plain version's counters alike.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import build
from .round_kernels import (TINY, _eps, _ns_orth_cols, _ns_orth_cols_stepwise,
                            _trunc_step, host_bool)

# workspace of one launch: G and G/tr(G) (B, B), six (B, K) bases, the
# (K, K) Newton-Schulz factor, one (K, M) scratch; the wrapper refuses
# inputs whose workspace exceeds this many bytes
WORKSPACE_CAP = 1 << 30


def _gemm_exact_tuning(dtype):
    """(max_outer, max_ns, polish_steps, stall_need) per dtype: the f64
    oracle bar (rtol 1e-8 against the SVD chain) needs the long polish and
    a 3-deep certificate; f32 needs f32-floor quality."""
    if torch.finfo(dtype).eps > 1e-10:
        return 128, 48, 6, 2
    return 256, 64, 16, 3


def _ns_polar_rows(Y: torch.Tensor, max_it: int, rowmask=None,
                   tol_mult: float = 64.0):
    """Row-orthonormal polar factor of Y (k, M) by Newton-Schulz,
    Y <- (1.5 I - 0.5 Y Y^T) Y; the rowspace is preserved.  ``rowmask``
    marks live rows (dead rows are zero and stay zero).  One host read per
    iteration.  Returns (Q, ok) with ok a 0-d bool tensor;
    ``_ns_polar_rows.iterations`` counts the iterations of all calls."""
    dtype = Y.dtype
    tol = torch.tensor(tol_mult * _eps(dtype), dtype=dtype, device=Y.device)
    alpha = torch.linalg.vector_norm(Y) + TINY
    k = Y.shape[0]
    eye = torch.eye(k, dtype=dtype, device=Y.device)
    target = eye if rowmask is None else eye * rowmask[:, None]
    Y = Y / alpha
    S = Y @ Y.T
    err = (S - target).abs().max()
    it = 0
    while it < max_it and host_bool(err > tol):
        Y = (1.5 * eye - 0.5 * S) @ Y
        S = Y @ Y.T
        err = (S - target).abs().max()
        it += 1
    _ns_polar_rows.iterations += it
    return Y, err <= tol


_ns_polar_rows.iterations = 0


def _power_orth(orth, Gn: torch.Tensor, GV: torch.Tensor, retry: bool):
    """(Q, ok, retry): Q = orth(Gn GV), the orthonormalization of a power
    step's image, and its ok.  With ``retry`` (float32), an image whose
    Newton-Schulz ends at the cap without reaching the tolerance is taken
    again from the same V in two stages, Q1 = orth(GV) and then
    orth(Gn Q1): span(Gn Q1) = span(Gn^2 V), so the subspace is the
    one-stage step's, while each stage sees the conditioning of one product
    of Gn and not of two; ok is then the second stage's.  A first stage
    that ends at the cap too means the kept block is past float32 in one
    product already (a cliff inside the kept columns): the step keeps its
    one-stage Q (ok False) and no later step of the truncation retries
    (the returned retry is False).  ``_power_orth.retries`` counts the
    steps taken again, ``_power_orth.stops`` those whose first stage
    ended at the cap."""
    Q, ok = orth(Gn @ GV)
    if retry and not host_bool(ok):
        _power_orth.retries += 1
        Q1, ok1 = orth(GV)
        if host_bool(ok1):
            Q, ok = orth(Gn @ Q1)
        else:
            _power_orth.stops += 1
            retry = False
    return Q, ok, retry


_power_orth.retries = 0
_power_orth.stops = 0


def _gemm_exact_body(cur: torch.Tensor, col_mask: torch.Tensor,
                     max_outer: int, max_ns: int, polish_steps: int,
                     stall_need: int):
    """The plain version of K2: returns (vt0, vt_bal, okp, converged, it).
    vt0 is the Newton-Schulz polar extraction (valid iff okp), vt_bal the
    row-balanced projection it was built from.  Degree-2 power steps
    (even outers, the only ones that may certify) alternate with degree-2
    Chebyshev steps; every basis is column-balanced and re-orthonormalized
    by Newton-Schulz; a step that lowers tau = tr(V^T G V) is discarded.
    Certified when the Aitken deficit bound or the improvement sits at the
    f32/f64 noise floor, or the captured energy is within 16 eps of tr(G),
    on ``stall_need`` consecutive power steps.  Loop conditions are read to
    the host; the arithmetic mirrors the reference op for op, with one
    addition in float32: a power step (outer or polish) whose
    orthonormalization ends at the Newton-Schulz cap is taken again in two
    stages (``_power_orth``), where the reference keeps the failed one.

    Counters, as the kernel's flags count: ``_gemm_exact_body.ns_iters``
    adds every Newton-Schulz iteration (the orthonormalizations and the
    row polar), ``_gemm_exact_body.ns_row_iters`` those of the row polar,
    ``_power_orth.retries`` and ``.stops`` the power steps taken again and
    the retries that stopped after their first stage."""
    cols0, rows0 = _ns_orth_cols.iterations, _ns_polar_rows.iterations
    dtype = cur.dtype
    dev = cur.device
    B, _M = cur.shape
    keep_cap = col_mask.shape[0]
    eps = _eps(dtype)
    retry = dtype == torch.float32
    G = cur @ cur.T
    trG = torch.trace(G)
    stag_tol = 8 * eps
    noise_floor = 4 * eps

    # start basis: G's leading columns plus a fixed hash perturbation
    ii = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    jj = torch.arange(keep_cap, dtype=torch.int32, device=dev)[None, :]
    hsh = ((ii * 40503 + jj * 9973 + 12345) % 65536).to(dtype) / 65536.0 - 0.5
    gmax = G.abs().max() + TINY
    V0raw = (G[:, :keep_cap] + 1e-3 * gmax * hsh) * col_mask[None, :]

    def balance(W):
        nrm = torch.sqrt(torch.sum(W * W, dim=0))
        return W / torch.clamp_min(nrm, TINY)[None, :]

    def orth(W):
        # the per-step loop: the kernel's steps, no masked ones past the
        # stop (its count goes to _ns_orth_cols.iterations)
        Q, ok = _ns_orth_cols_stepwise(balance(W) * col_mask[None, :],
                                       max_ns, colmask=col_mask)
        return Q * col_mask[None, :], ok

    V, _ = orth(V0raw)
    gscale = trG + TINY
    Gn = G / gscale

    def tau_of(V):
        return torch.sum(V * (G @ V))

    live = torch.sum((torch.diagonal(G) > 0).to(dtype))
    keep_f = torch.clamp_min(torch.sum(col_mask), 1.0)

    tau = tau_of(V)
    big = torch.tensor(torch.finfo(dtype).max / 4, dtype=dtype, device=dev)
    I_prev, I_pprev = big, big
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < max_outer and host_bool(stall < stall_need):
        power = it % 2 == 0
        GV = Gn @ V
        if power:
            V2, ok, retry = _power_orth(orth, Gn, GV, retry)
        else:
            ray = torch.sum(V * GV, dim=0) * gscale
            ray = torch.where(col_mask > 0, ray, torch.inf)
            resid = torch.clamp_min(trG - tau, 0.0)
            b_floor = (0.5 * resid / torch.clamp_min(live - keep_f, 1.0)
                       + eps * trG + TINY)
            b = torch.maximum(0.9 * torch.min(ray), b_floor)
            y1 = (2.0 * gscale / b) * GV - V
            W = 2.0 * ((2.0 * gscale / b) * (Gn @ y1) - y1) - V
            V2, ok = orth(W)
        tau2 = tau_of(V2)
        better = tau2 >= tau
        V2 = torch.where(better, V2, V)
        tau2 = torch.where(better, tau2, tau)
        I_t = torch.clamp_min(tau2 - tau, 0.0)
        rho1 = I_t / torch.clamp_min(I_prev, TINY)
        rho2 = I_prev / torch.clamp_min(I_pprev, TINY)
        rho = torch.clamp(torch.maximum(rho1, rho2), 0.0, 1.0 - 1e-6)
        bound = I_t * rho / (1.0 - rho)
        tau_s = torch.clamp_min(tau2, TINY)
        certified = ok & ((I_t <= noise_floor * tau_s)
                          | (torch.maximum(bound, I_t) <= stag_tol * tau_s))
        certified = certified | (trG - tau2 <= 16.0 * eps * trG)
        if power:
            stall = torch.where(certified, stall + 1, 0)
            I_prev, I_pprev = I_t, I_prev
        V, tau = V2, tau2
        it += 1
    converged = stall >= stall_need

    # angle polish: fixed power steps under the monotone safeguard
    for _ in range(polish_steps):
        V2, ok2, retry = _power_orth(orth, Gn, Gn @ V, retry)
        tau2 = tau_of(V2)
        good = ok2 & (tau2 >= tau * (1.0 - stag_tol))
        V = torch.where(good, V2, V)
        tau = torch.where(good, tau2, tau)

    vt_raw = V.T @ cur
    rn = torch.sqrt(torch.sum(vt_raw * vt_raw, dim=1))
    vt_bal = vt_raw / torch.clamp_min(rn, TINY)[:, None]
    vt0, okp = _ns_polar_rows(vt_bal, max_ns, rowmask=col_mask)
    rows = _ns_polar_rows.iterations - rows0
    _gemm_exact_body.ns_iters += _ns_orth_cols.iterations - cols0 + rows
    _gemm_exact_body.ns_row_iters += rows
    return vt0, vt_bal, okp, converged, it


_gemm_exact_body.ns_iters = 0
_gemm_exact_body.ns_row_iters = 0


def gemm_exact_flops(B: int, M: int, K: int, outer: int, ns: int,
                     ns_rows: int, polish: int, retries: int = 0,
                     retry_stops: int = 0) -> int:
    """Floating-point operations (a multiply-add counts 2) of one certified
    truncation of a (B, M) bond in the column bucket K, after ``outer``
    outer steps, ``polish`` polish steps, ``retries`` power steps taken
    again in two stages (``retry_stops`` of them stopped after the first)
    and ``ns`` Newton-Schulz iterations of which ``ns_rows`` in the row
    polar (the kernel's flags outer, ns, ns_rows, retries, retry_stops;
    the plain version's counters).  Only the products count:
    G = cur cur^T; per step (1 + outer + polish) one tau = tr(V^T G V)
    product and per orthonormalization (the step's, two more a retry, one
    a stopped one) the first Newton-Schulz Gram; two Gn products per
    outer or polish step, one more a retry that reaches its second stage
    (Gn Q1); per column Newton-Schulz iteration an update and a Gram;
    V^T cur, the row polar's first Gram and per row iteration an update
    and a Gram.  Each Gram (G and the Newton-Schulz Grams, all
    symmetric) counts only its entries on and above the diagonal,
    n (n + 1) L for an (n, n) Gram over L: the least the function needs."""
    def gram(n, L):
        return n * (n + 1) * L
    steps = 1 + outer + polish
    return (gram(B, M)
            + steps * (2 * B * B * K + gram(K, B))
            + retries * (2 * B * B * K + 2 * gram(K, B))
            - retry_stops * (2 * B * B * K + gram(K, B))
            + 2 * (outer + polish) * 2 * B * B * K
            + (ns - ns_rows) * (2 * B * K * K + gram(K, B))
            + 2 * K * B * M + (1 + ns_rows) * gram(K, M)
            + ns_rows * 2 * K * K * M)


# the grid route's tiling (csrc/gemm_exact_grid.cuh): 32 x 32 output
# tiles, k staged 64 deep, every dimension padded to a multiple of 64;
# at most GRID_MAX_ITEMS split-K partial tiles and GRID_MAX_SPLIT slices
# a product; one CTA per SM up to GRID_MAX_CTAS
GRID_TILE, GRID_STAGE_K, GRID_PAD = 32, 64, 64
GRID_MAX_ITEMS, GRID_MAX_SPLIT, GRID_MAX_CTAS = 1024, 16, 1024


def _pad(n: int) -> int:
    return -(-n // GRID_PAD) * GRID_PAD


def grid_split(tiles: int, units: int, grid: int) -> int:
    """k slices the grid route splits a product of ``tiles`` output tiles
    and ``units`` 64-deep slices of k into on ``grid`` CTAs: the least
    rounds x (slices + 1) a CTA runs, in quarters, plus the fold's cost
    (the kernel's ``split_of``)."""
    best, best_cost = 1, None
    for s in range(1, min(units, GRID_MAX_SPLIT) + 1):
        if s > 1 and tiles * s > GRID_MAX_ITEMS:
            break
        rounds = -(-tiles * s // grid)
        cost = 4 * rounds * (-(-units // s) + 1) + s
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def grid_products(B: int, M: int, K: int):
    """The products one grid-route launch runs, at padded sizes:
    (name, m, n, k, symmetric)."""
    Bp, Kp, Mp = _pad(B), _pad(K), _pad(M)
    return [("G = cur cur^T", Bp, Bp, Mp, True),
            ("column Newton-Schulz Gram", Kp, Kp, Bp, True),
            ("column Newton-Schulz update", Bp, Kp, Kp, False),
            ("Gn V, G V (tau), Gn Y1", Bp, Kp, Bp, False),
            ("V^T cur", Kp, Mp, Bp, False),
            ("row Newton-Schulz Gram", Kp, Kp, Mp, True),
            ("row Newton-Schulz update", Kp, Mp, Kp, False)]


def grid_plan(B: int, M: int, K: int, grid: int):
    """The grid route's launch plan for a (B, M) input in the column
    bucket K on ``grid`` CTAs: per product its tiles (all, or those on and
    above the diagonal), k splits, and each work item's (tile row, tile
    column, k begin, k end) in the order item = tile * splits + slice;
    CTA c takes items c, c + grid, ..."""
    plan = []
    for name, m, n, k, sym in grid_products(B, M, K):
        mt, nt = m // GRID_TILE, n // GRID_TILE
        tiles = [(i, j) for i in range(mt) for j in range(nt)
                 if not sym or i <= j]
        units = k // GRID_STAGE_K
        s = grid_split(len(tiles), units, grid)
        items = [(i, j, r * units // s * GRID_STAGE_K,
                  (r + 1) * units // s * GRID_STAGE_K)
                 for (i, j) in tiles for r in range(s)]
        plan.append(dict(name=name, m=m, n=n, k=k, sym=sym,
                         tiles=len(tiles), units=units, splits=s,
                         items=items))
    return plan


def grid_layout(B: int, M: int, K: int):
    """The grid route's workspace, in elements: each buffer's offset
    (every one a multiple of 64) and ``total`` (the kernel's ``layout``)."""
    Bp, Kp, Mp = _pad(B), _pad(K), _pad(M)
    slot_n = max(Bp * Bp, Bp * Kp, Kp * Mp) // GRID_TILE ** 2
    sizes = [("curp", Bp * Mp), ("G", Bp * Bp), ("Gn", Bp * Bp)]
    sizes += [(name, Bp * Kp) for name in ("V", "X1", "X2", "GV", "W", "Y1")]
    sizes += [("P", Kp * Kp), ("Ya", Kp * Mp), ("Yb", Kp * Mp),
              ("part", GRID_MAX_ITEMS * GRID_TILE ** 2), ("slots", 2 * slot_n),
              ("colvec", max(Bp, Kp)), ("tickets", GRID_MAX_ITEMS)]
    out, o = {}, 0
    for name, n in sizes:
        out[name] = o
        o += -(-n // 64) * 64
    out["total"] = o
    return out


def _finish_gemm_exact(vt0, vt_bal, okp: bool, col_mask):
    """Completion of the certified truncation: when the Newton-Schulz
    polar failed (okp False), orthonormal rows by Householder LQ of
    vt_bal (QR of its transpose), zero-padded to vt_bal's row count."""
    if okp:
        vt = vt0
    else:
        q, _r = torch.linalg.qr(vt_bal.T)
        vt = q.T
        if vt.shape[0] < vt_bal.shape[0]:
            vt = torch.cat([vt, vt.new_zeros((vt_bal.shape[0] - vt.shape[0],
                                              vt.shape[1]))])
    return vt * col_mask[:, None]


@lru_cache(maxsize=1)
def _library():
    return _bind(build.load_kernel_library("gemm_exact"))


def _bind(lib):
    """Declare the C interface of a library built from csrc/gemm_exact.cu."""
    lib.xerus_gemm_exact_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.xerus_gemm_exact_workspace_bytes.restype = ctypes.c_size_t
    lib.xerus_gemm_exact_route.argtypes = [ctypes.c_int] * 4
    lib.xerus_gemm_exact_route.restype = ctypes.c_int
    lib.xerus_gemm_exact_unschedulable.argtypes = []
    lib.xerus_gemm_exact_unschedulable.restype = ctypes.c_int
    for name in ("xerus_gemm_exact_f32", "xerus_gemm_exact_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    return lib


# flags of one launch (csrc/gemm_exact_common.cuh): okp, converged, outer
# iterations, Newton-Schulz iterations in all, barriers (cluster or grid),
# CTAs per cluster (0: the grid route ran), row-polar Newton-Schulz
# iterations, power steps taken again in two stages (float32) and those
# of them that stopped after their first stage
FLAGS = ("okp", "converged", "outer", "ns", "barriers", "cluster_ctas",
         "ns_rows", "retries", "retry_stops")


def gemm_exact_route(B: int, M: int, keep_cap: int, dtype) -> int:
    """CTAs per cluster of the route K2 takes on the current card for a
    (B, M) input of ``dtype`` in the column bucket keep_cap: 16 for the
    cluster route, 0 for the grid route.  Builds the kernel library."""
    elt = torch.empty((), dtype=dtype).element_size()
    return int(_library().xerus_gemm_exact_route(B, M, keep_cap, elt))


def gemm_exact_kernel(cur: torch.Tensor, keep: int, keep_cap: int):
    """Launch K2 on a CUDA tensor ``cur`` (B, M), float32 or float64,
    contiguous, keep_cap <= B.  Returns (vt0, vt_bal, flags) on the card;
    flags is int32 in the order of ``FLAGS``.  ``gemm_exact_kernel.launches``
    counts the launches."""
    if cur.device.type != "cuda":
        raise RuntimeError(f"gemm_exact_kernel: no kernel for device "
                           f"{cur.device}")
    if cur.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gemm_exact_kernel: cur is {cur.dtype}, needs "
                        "float32 or float64")
    if cur.dim() != 2 or not cur.is_contiguous():
        raise ValueError("gemm_exact_kernel: cur must be a contiguous "
                         "2-d tensor")
    B, M = cur.shape
    if not 1 <= keep_cap <= B or M < 1:
        raise ValueError(f"gemm_exact_kernel: keep_cap {keep_cap} must lie "
                         f"in [1, {B}] and M >= 1 (cur {tuple(cur.shape)})")
    lib = _library()
    elt = cur.element_size()
    nbytes = lib.xerus_gemm_exact_workspace_bytes(B, M, keep_cap, elt)
    if nbytes > WORKSPACE_CAP or B * M >= 2 ** 31:
        raise ValueError(f"gemm_exact_kernel: cur {tuple(cur.shape)} with "
                         f"keep_cap {keep_cap} needs {nbytes} bytes of "
                         f"workspace, above the cap of {WORKSPACE_CAP}")
    ws = torch.empty((nbytes // elt,), dtype=cur.dtype, device=cur.device)
    vt0 = torch.empty((keep_cap, M), dtype=cur.dtype, device=cur.device)
    vt_bal = torch.empty_like(vt0)
    flags = torch.zeros((len(FLAGS),), dtype=torch.int32,
                        device=cur.device)
    fn = (lib.xerus_gemm_exact_f32 if cur.dtype == torch.float32
          else lib.xerus_gemm_exact_f64)
    tuning = _gemm_exact_tuning(cur.dtype)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        rc = fn(cur.data_ptr(), B, M, keep_cap, int(keep), *tuning,
                ws.data_ptr(), vt0.data_ptr(), vt_bal.data_ptr(),
                flags.data_ptr(), stream)
    if rc == lib.xerus_gemm_exact_unschedulable():
        raise RuntimeError("gemm_exact kernel: the card cannot schedule one "
                           "16-CTA cluster with this shared memory")
    if rc != 0:
        raise RuntimeError(f"gemm_exact kernel launch failed: cudaError {rc}")
    gemm_exact_kernel.launches += 1
    return vt0, vt_bal, flags


gemm_exact_kernel.launches = 0


def trunc_step_gemm_exact(cur: torch.Tensor, keep: int, keep_cap: int):
    """Exact-to-working-precision truncation with zero factorization calls
    when it certifies: returns (US (B, keep_cap), vt (keep_cap, M)).
    A bond that does not certify within max_outer steps takes the exact
    SVD truncation instead.  On the CPU the plain body runs; on the card
    K2 does.  Counters: ``calls``, ``svd_fallbacks`` (bonds that did not
    certify), ``lq_finishes`` (polar failed, Householder LQ), and the
    summed ``outer_iters``, ``retries`` (float32 power steps taken again
    in two stages) and ``retry_stops`` (retries that stopped after their
    first stage); on the card also the kernel's summed
    ``ns_iters``, ``ns_row_iters`` and ``barriers``, and ``cluster_bonds``,
    the bonds that took the cluster route."""
    trunc_step_gemm_exact.calls += 1
    dtype = cur.dtype
    col_mask = (torch.arange(keep_cap, device=cur.device) < keep).to(dtype)
    if cur.device.type == "cpu":
        retries0, stops0 = _power_orth.retries, _power_orth.stops
        vt0, vt_bal, okp_t, ok_t, it = _gemm_exact_body(
            cur, col_mask, *_gemm_exact_tuning(dtype))
        okp, ok = host_bool(okp_t), host_bool(ok_t)
        trunc_step_gemm_exact.retries += _power_orth.retries - retries0
        trunc_step_gemm_exact.retry_stops += _power_orth.stops - stops0
    elif cur.device.type == "cuda":
        vt0, vt_bal, flags = gemm_exact_kernel(cur.contiguous(), keep,
                                               keep_cap)
        f = dict(zip(FLAGS, (int(v) for v in flags.tolist())))
        okp, ok, it = f["okp"], f["converged"], f["outer"]
        trunc_step_gemm_exact.ns_iters += f["ns"]
        trunc_step_gemm_exact.ns_row_iters += f["ns_rows"]
        trunc_step_gemm_exact.barriers += f["barriers"]
        trunc_step_gemm_exact.cluster_bonds += f["cluster_ctas"] > 0
        trunc_step_gemm_exact.retries += f["retries"]
        trunc_step_gemm_exact.retry_stops += f["retry_stops"]
    else:
        raise RuntimeError(f"trunc_step_gemm_exact: no kernel for device "
                           f"{cur.device}")
    trunc_step_gemm_exact.outer_iters += it
    if not ok:
        trunc_step_gemm_exact.svd_fallbacks += 1
        return _trunc_step(cur, keep, keep_cap, 0.0, "svd")
    if not okp:
        trunc_step_gemm_exact.lq_finishes += 1
    vt = _finish_gemm_exact(vt0, vt_bal, okp, col_mask)
    US = (cur @ vt.T) * col_mask[None, :]
    return US, vt


def reset_counters() -> None:
    """Zero the launch count, the truncation counters and the plain
    version's Newton-Schulz counters."""
    gemm_exact_kernel.launches = 0
    for name in TRUNC_COUNTERS:
        setattr(trunc_step_gemm_exact, name, 0)
    _gemm_exact_body.ns_iters = 0
    _gemm_exact_body.ns_row_iters = 0
    _power_orth.retries = 0
    _power_orth.stops = 0


TRUNC_COUNTERS = ("calls", "svd_fallbacks", "retries", "retry_stops",
                  "lq_finishes", "outer_iters", "ns_iters", "ns_row_iters",
                  "barriers", "cluster_bonds")


reset_counters()
