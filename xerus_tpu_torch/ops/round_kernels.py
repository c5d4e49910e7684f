"""Deterministic and randomized TT rounding at core level.

The rounding half of ``xerus_tpu/ops/tt_kernels.py``: ``chol_orth_cols``,
``_cholqr2``, ``res_rank``, the segmented sweep (``_qr_sweep_segmented``,
the ``_trunc_step`` family, ``_round_sweep_segmented``,
``tt_round_sweep_segmented``), the randomized sweep ``_round_randomized``
and the analytic flop counts.  The JAX package
traced each sweep into one XLA program; here the same einsums,
factorizations and GEMMs run on whatever device the cores are on, and the
randomized sweep is a captured program on the card
(``make_randomized_round``, ``make_randomized_round_unrolled``; its
sketches are drawn outside the program and passed in).

The power-of-2 buckets and the static per-bond schedule of the reference
are kept exactly: they fix the padded shapes, the dead bond slots and the
per-bond modes that the certified truncation (``ops/gemm_exact.py``, hand
kernel K2) sees.  Where JAX decided inside the program (``while_loop``,
``lax.cond``), the port reads one boolean to the host (``host_bool``,
which counts its reads).  Cores are (left rank, n, right rank) tensors.
"""

from __future__ import annotations

import numbers
from functools import partial
from typing import List, Optional, Sequence, Tuple

import torch

from . import programs
from .programs import Program, call, factory

TINY = 1e-30


def host_bool(t: torch.Tensor) -> bool:
    """Read a 0-d bool tensor to the host: a device sync on the card.
    ``host_bool.reads`` counts every read, ``host_float``'s too."""
    host_bool.reads += 1
    return bool(t)


host_bool.reads = 0
programs.counter(host_bool, "reads", moves=False)


def host_float(t: torch.Tensor) -> float:
    """Read a 0-d tensor to the host as a float, counted in
    ``host_bool.reads``."""
    host_bool.reads += 1
    return float(t)


def host_ints(t: torch.Tensor) -> List[int]:
    """Read a 1-d integer tensor to the host as a list, one read counted
    in ``host_bool.reads``."""
    host_bool.reads += 1
    return [int(v) for v in t.tolist()]


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorization fails, as
    jnp.linalg.cholesky gives, and without a host check."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _eigh_sym(A: torch.Tensor):
    """torch.linalg.eigh of a (batch of) symmetric matrices.  A float32
    matrix on the card is solved in float64 and cast back: cuSOLVER's
    float32 eigh (torch 2.11, CUDA 12.8, NVIDIA H100) left ||V^T V - I||
    up to 1.9e-3 on the rank-256 rounding's bond Grams, where LAPACK's
    float32 eigh leaves 1.8e-5 (PERF.md)."""
    if A.is_cuda and A.dtype == torch.float32:
        w, v = torch.linalg.eigh(A.double())
        return w.float(), v.float()
    return torch.linalg.eigh(A)


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def chol_orth_cols(X: torch.Tensor, shift_rels=None, want_r: bool = False):
    """Shifted-CholQR column orthonormalization: one Gram + shifted
    Cholesky + triangular solve per entry of ``shift_rels`` (relative
    diagonal shifts; default one 10*eps pass).  want_r=True returns
    (Q, Rtot) with X = Q @ Rtot."""
    dtype = X.dtype
    eye = torch.eye(X.shape[1], dtype=dtype, device=X.device)
    if shift_rels is None:
        shift_rels = (10 * _eps(dtype),)
    Rtot = eye
    for rel in shift_rels:
        G = X.T @ X
        shift = torch.diagonal(G).max() * rel + TINY
        L = _cholesky(G + shift * eye)
        X = _solve_lower(L, X.T).T
        if want_r:
            Rtot = L.T @ Rtot
    return (X, Rtot) if want_r else X


def _cholqr2(cur: torch.Tensor, tiny: float = TINY) -> torch.Tensor:
    """Shifted CholeskyQR2 of a tall (m, r) matrix (``tt_kernels._cholqr2``):
    two shifted Gram + Cholesky + triangular-solve passes, the first shift
    10*m*eps, the second 10*eps, each relative to the Gram's largest
    diagonal entry.  For well-conditioned panels (randomized sketches);
    null directions map to near-zero columns, not junk."""
    m = cur.shape[0]
    eps = _eps(cur.dtype)
    eye = torch.eye(cur.shape[1], dtype=cur.dtype, device=cur.device)
    for rel in (10 * m * eps, 10 * eps):
        G = cur.T @ cur
        L = _cholesky(G + (rel * torch.diagonal(G).max() + tiny) * eye)
        cur = _solve_lower(L, cur.T).T
    return cur


def res_rank(bond: int, d: int, n: int, target: int) -> int:
    """The largest rank bond ``bond`` of a d-site TT with mode size n can
    have, capped at ``target`` (``tt_kernels.res_rank``)."""
    return min(target, n ** bond, n ** (d - bond))


def _qr_flops(m: int, n: int) -> float:
    """Householder QR + explicit Q formation (dgeqrf + dorgqr)."""
    k = min(m, n)
    return 2.0 * m * n * k - (2.0 / 3.0) * k ** 3 + 2.0 * m * k * k


def _svd_flops(m: int, n: int) -> float:
    """gesdd-style estimate: bidiagonalization + D&C + back-transform."""
    a, b = max(m, n), min(m, n)
    return 8.0 * a * b * b + (20.0 / 3.0) * b ** 3


def round_flops(shapes: Sequence[Tuple[int, int, int]],
                target_rank: int) -> float:
    """Analytic FLOP count of one QR + SVD rounding sweep over the given
    core shapes (the bench's useful-work count)."""
    total = 0.0
    cur = [tuple(s) for s in shapes]
    for i in range(len(cur) - 1):
        rl, n, rr = cur[i]
        k = min(rl * n, rr)
        total += _qr_flops(rl * n, rr)
        rl2, n2, rr2 = cur[i + 1]
        total += 2.0 * k * rl2 * n2 * rr2
        cur[i] = (rl, n, k)
        cur[i + 1] = (k, n2, rr2)
    for i in range(len(cur) - 1, 0, -1):
        rl, n, rr = cur[i]
        total += _svd_flops(rl, n * rr)
        k = min(target_rank, min(rl, n * rr))
        rl2, n2, rr2 = cur[i - 1]
        total += 2.0 * rl2 * n2 * rr2 * k
        cur[i] = (k, n, rr)
        cur[i - 1] = (rl2, n2, k)
    return total


def randomized_round_flops(shapes, target_rank: int, oversample: int
                           ) -> float:
    """Analytic FLOP count of one ``_round_randomized`` sweep."""
    l = target_rank + oversample
    shapes = [tuple(s) for s in shapes]
    d = len(shapes)
    total = 0.0
    w = 1
    for i in range(d - 2, -1, -1):
        rl, n, rr = shapes[i + 1]
        total += 2.0 * rl * n * rr * w
        total += 2.0 * rl * n * w * l
        w = l
    carry = None
    for i in range(d - 1):
        rl, n, rr = shapes[i]
        if carry is not None:
            total += 2.0 * carry * rl * n * rr
            rl = carry
        total += 2.0 * rl * n * rr * l
        total += _qr_flops(rl * n, l)
        k = min(target_rank, rl * n, l)
        total += 2.0 * k * rl * n * rr
        carry = k
    rl, n, rr = shapes[d - 1]
    total += 2.0 * carry * rl * n * rr
    return total


# ---------------------------------------------------------------------------
# segmented deterministic rounding: true shapes in power-of-2 buckets
# ---------------------------------------------------------------------------

def _p2(x: int, floor: int = 1) -> int:
    b = floor
    while b < x:
        b *= 2
    return b


def _pad_to(arr: torch.Tensor, shape) -> torch.Tensor:
    if tuple(arr.shape) == tuple(shape):
        return arr
    out = arr.new_zeros(shape)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


# Newton-Schulz steps between two host reads of _ns_orth_cols.  The QR
# sweep of the d=32 rank-256 rounding runs 31 calls of 6-59 steps, 12 of
# them 14, and its cliff variant 18 calls that reach the cap of 64 (the
# same counts on the CPU and on an H100); 16 divides the cap and takes the
# two roundings' reads from 636 to 88 and from 1,451 to 136 (chip_smoke's
# "Newton-Schulz QR sweep" lines, NVIDIA H100 80GB HBM3, 700 W).  The
# chunk is a captured program: run eagerly, its masked steps' launches
# cost more than the reads they save (0.387 s against the per-step loop's
# 0.295 s there; captured, 0.262 s against 0.313 s)
NS_CHUNK = 16


def _ns_start(X, colmask, tol_mult):
    dtype = X.dtype
    tol = torch.tensor(tol_mult * _eps(dtype), dtype=dtype, device=X.device)
    alpha = torch.linalg.vector_norm(X) + TINY
    k = X.shape[1]
    eye = torch.eye(k, dtype=dtype, device=X.device)
    target = eye if colmask is None else eye * colmask[None, :]
    X = X / alpha
    S = X.T @ X
    return X, S, (S - target).abs().max(), tol, eye, target


def _ns_chunk(X, S, err, it, tol, eye, target, max_it: int):
    """``NS_CHUNK`` masked Newton-Schulz steps: a step is active while
    (err > tol) and (it < max_it); ``torch.where`` keeps X, S and err of
    the last active one.  Returns (X, S, err, it, [go on, it])."""
    for _ in range(NS_CHUNK):
        active = (err > tol) & (it < max_it)
        Xn = X @ (1.5 * eye - 0.5 * S)
        Sn = Xn.T @ Xn
        X = torch.where(active, Xn, X)
        S = torch.where(active, Sn, S)
        err = torch.where(active, (Sn - target).abs().max(), err)
        it = it + active
    return X, S, err, it, torch.stack(
        [((err > tol) & (it < max_it)).to(torch.int64), it])


@factory(16)
def _make_ns_chunk(shapes_key, dtype_str: str, max_it: int) -> Program:
    """``_ns_chunk`` as a captured program (``ops/programs.py``)."""
    return Program(partial(_ns_chunk, max_it=max_it), "ns_chunk")


def _ns_orth_cols(X: torch.Tensor, max_it: int, colmask=None,
                  tol_mult: float = 64.0):
    """Column-orthonormalize by scaled Newton-Schulz polar iteration,
    X <- X (1.5 I - 0.5 X^T X), from the Frobenius prescale; same column
    space.  Stops when max|X^T X - diag(colmask)| <= tol_mult*eps or after
    ``max_it`` iterations.  Padded dead columns are exactly zero and stay
    zero.  Returns (Q, ok) with ok a 0-d bool tensor: False flags a
    rank-deficient or too ill-conditioned live block.  The Gram of one
    iteration's check is the next iteration's S, as in the reference's
    loop (the same product of the same matrix).

    The counterpart of the JAX package's ``lax.while_loop``: chunks of
    ``NS_CHUNK`` masked steps (``_ns_chunk``, a captured program replayed
    on the card), with one host read per chunk (the flag and the count).
    The result and the count equal ``_ns_orth_cols_stepwise``'s bit for
    bit."""
    X, S, err, tol, eye, target = _ns_start(X, colmask, tol_mult)
    it = torch.zeros((), dtype=torch.int64, device=X.device)
    more = True
    while more:
        X, S, err, it, state = call(_make_ns_chunk,
                                    (X, S, err, it, tol, eye, target), max_it)
        more, count = host_ints(state)
    _ns_orth_cols.iterations += count
    return X, err <= tol


def _ns_orth_cols_stepwise(X: torch.Tensor, max_it: int, colmask=None,
                           tol_mult: float = 64.0):
    """The plain version of ``_ns_orth_cols``: one host read per step."""
    X, S, err, tol, eye, target = _ns_start(X, colmask, tol_mult)
    it = 0
    while it < max_it and host_bool(err > tol):
        X = X @ (1.5 * eye - 0.5 * S)
        S = X.T @ X
        err = (S - target).abs().max()
        it += 1
    _ns_orth_cols.iterations += it
    return X, err <= tol


# Newton-Schulz iterations run by _ns_orth_cols, all calls (its plain
# version's too)
_ns_orth_cols.iterations = 0
programs.counter(_ns_orth_cols, "iterations")


def _qr_sweep_segmented(cores: Sequence[torch.Tensor], min_run: int = 3,
                        orth: str = "cholqr", min_bucket: int = 32):
    """Left-to-right orthogonalization; returns (qs, true_k, logs) with
    qs[i] padded to its site's bucket shape (exactly-zero bond slots
    beyond the true rank) and the true (left, right) ranks per site.

    Site shapes are rounded up to power-of-2 buckets; maximal runs of at
    least ``min_run`` equal-bucket sites are the reference's lax.scan
    runs and run here at the padded shape, the others at their true
    shape.  orth='cholqr' is shifted CholeskyQR3; orth='ns' a
    Newton-Schulz polar Q with R = Q^T X that falls back to CholQR3 when
    the iteration does not converge.  Rank-reducing sites take a
    Householder QR at true shape."""
    d = len(cores)
    dtype = cores[0].dtype
    dev = cores[0].device

    sched = []
    kprev = 1
    for i in range(d - 1):
        rl, n, rr = (int(s) for s in cores[i].shape)
        reduce_ = rr > kprev * n
        k_out = min(kprev * n, rr)
        B = max(_p2(max(kprev, rr)), min_bucket)
        sched.append(dict(i=i, kprev=kprev, rl=rl, n=n, rr=rr, k=k_out,
                          B=B, reduce=reduce_))
        kprev = k_out
    final_k = kprev

    out = [None] * d
    true_k = [None] * d
    logs = torch.zeros((), dtype=dtype, device=dev)
    R = torch.ones((1, 1), dtype=dtype, device=dev)

    def chol_qr(X):
        ueps = _eps(dtype)
        return chol_orth_cols(X, (10 * X.shape[0] * ueps, 10 * ueps,
                                  10 * ueps), want_r=True)

    def ns_qr(X, colmask):
        q0, ok = _ns_orth_cols(X, 64, colmask=colmask)
        if host_bool(ok):
            return q0, q0.T @ X
        return chol_qr(X)

    idx = 0
    while idx < d - 1:
        st = sched[idx]
        B, n = st["B"], st["n"]
        j = idx
        while (j < d - 1 and sched[j]["B"] == B and sched[j]["n"] == n
               and not sched[j]["reduce"] and orth in ("cholqr", "ns")):
            j += 1
        if j - idx >= min_run:
            Rc = _pad_to(R, (B, B))
            for t in range(idx, j):
                core = _pad_to(cores[t], (B, n, B))
                cur = torch.einsum("ka,anb->knb", Rc, core).reshape(B * n, B)
                if orth == "ns":
                    cm = (torch.arange(B, device=dev)
                          < sched[t]["rr"]).to(dtype)
                    q, R2 = ns_qr(cur, cm)
                else:
                    q, R2 = chol_qr(cur)
                nrm = torch.linalg.vector_norm(R2) + TINY
                logs = logs + torch.log(nrm)
                Rc = R2 / nrm
                out[t] = q.reshape(B, n, B)
                true_k[t] = (sched[t]["kprev"], sched[t]["k"])
            # true carry leaving the run: (k_{j-1}, rr_{j-1})
            R = Rc[:sched[j - 1]["k"], :sched[j - 1]["rr"]]
            idx = j
        else:
            kprev, rr, k = st["kprev"], st["rr"], st["k"]
            cur = torch.einsum("ka,anb->knb", R, cores[idx]
                               ).reshape(kprev * n, rr)
            if st["reduce"] or orth not in ("cholqr", "ns"):
                q, R2 = torch.linalg.qr(cur)
            elif orth == "ns":
                q, R2 = ns_qr(cur, None)
            else:
                q, R2 = chol_qr(cur)
            out[idx] = _pad_to(q.reshape(kprev, n, k), (st["B"], n, st["B"]))
            true_k[idx] = (kprev, k)
            nrm = torch.linalg.vector_norm(R2) + TINY
            logs = logs + torch.log(nrm)
            R = R2[:k] / nrm
            idx += 1
    out[d - 1] = torch.einsum("ka,anb->knb", R, cores[d - 1])
    true_k[d - 1] = (final_k, int(cores[d - 1].shape[2]))
    return out, true_k, logs


def _trunc_step_subspace(cur: torch.Tensor, keep: int, keep_cap: int,
                         power_iters: int = 3):
    """GEMM-only truncation: subspace iteration on G = cur cur^T from the
    start G[:, :k], CholQR re-orthonormalization, then a Cholesky LQ
    split.  Near-optimal, not certified; no singular values."""
    dtype = cur.dtype
    G = cur @ cur.T
    col_mask = (torch.arange(keep_cap, device=cur.device) < keep).to(dtype)
    eye_k = torch.eye(keep_cap, dtype=dtype, device=cur.device)
    V = chol_orth_cols(G[:, :keep_cap] * col_mask[None, :])
    for _ in range(power_iters):
        V = chol_orth_cols((G @ V) * col_mask[None, :])
    V = chol_orth_cols(V) * col_mask[None, :]
    vt_raw = V.T @ cur
    Gr = vt_raw @ vt_raw.T
    shift = torch.diagonal(Gr).max() * (10 * _eps(dtype)) + TINY
    L = _cholesky(Gr + shift * eye_k)
    Q = _solve_lower(L, vt_raw) * col_mask[:, None]
    US = (V @ L) * col_mask[None, :]
    return US, Q


def _trunc_step_full_cols(cur: torch.Tensor, keep: int, keep_cap: int):
    """Non-truncating bond with keep == #live columns (prefix layout):
    vt = I, US = the matching column slice of cur."""
    M = cur.shape[1]
    mask = (torch.arange(keep_cap, device=cur.device) < keep).to(cur.dtype)
    vt = torch.eye(keep_cap, M, dtype=cur.dtype, device=cur.device
                   ) * mask[:, None]
    US = cur[:, :keep_cap] * mask[None, :]
    return US, vt


def _trunc_step_full_rows(cur: torch.Tensor, keep: int, keep_cap: int):
    """Non-truncating bond with keep == #live rows: exact CholQR-LQ split
    cur = L (L^{-1} cur); a rank-deficient live block (a diag(L) pivot at
    the shift floor, one host read) takes a Householder LQ instead."""
    dtype = cur.dtype
    Bl, M = cur.shape
    mask = (torch.arange(Bl, device=cur.device) < keep).to(dtype)
    G = cur @ cur.T
    gmax = torch.diagonal(G).max()
    shift = gmax * (10 * _eps(dtype)) + TINY
    L0 = _cholesky(G + shift * torch.eye(Bl, dtype=dtype, device=cur.device))
    vt0 = _solve_lower(L0, cur)
    live_diag = torch.where(mask > 0, torch.diagonal(L0) ** 2, gmax + shift)
    if host_bool(live_diag.min() < 16.0 * shift):
        q, r = torch.linalg.qr(cur.T)
        US = _pad_to(r.T, (Bl, Bl))
        vt = _pad_to(q.T, (Bl, M))
    else:
        US, vt = L0, vt0
    vt = vt * mask[:, None]
    US = US * mask[None, :]
    if Bl >= keep_cap:
        return US[:, :keep_cap], vt[:keep_cap]
    return _pad_to(US, (Bl, keep_cap)), _pad_to(vt, (keep_cap, M))


def _trunc_step(cur: torch.Tensor, keep: int, keep_cap: int, eps: float,
                method: str, mode: str = "trunc"):
    """One truncation step on the (Bl, M) padded matricization; returns
    (US (Bl, keep_cap), vt (keep_cap, M)) with entries beyond ``keep``
    exactly zero.  ``mode`` (static, from the sweep schedule):
    "full_cols"/"full_rows" mark bonds where the reference SVD keeps the
    full rank; exact gauge-equivalent splits replace it there."""
    if mode == "full_cols":
        return _trunc_step_full_cols(cur, keep, keep_cap)
    if mode == "full_rows":
        return _trunc_step_full_rows(cur, keep, keep_cap)
    if method == "gemm_exact":
        from .gemm_exact import trunc_step_gemm_exact
        return trunc_step_gemm_exact(cur, keep, keep_cap)
    if method == "subspace":
        return _trunc_step_subspace(cur, keep, keep_cap)
    dtype = cur.dtype
    if method == "gram":
        G = cur @ cur.T
        lam, V = _eigh_sym(G)                          # ascending
        lam = torch.flip(lam, (0,))
        V = torch.flip(V, (1,))
        s = torch.sqrt(torch.clamp_min(lam, 0.0))
    elif method == "svd":
        # on the card, cuSOLVER's QR-iteration gesvd: torch's default there,
        # Jacobi gesvdj, rounds the d=32 rank-256 instance to a log-norm
        # 140x further from the f64 chain (NVIDIA H100, PERF.md)
        driver = "gesvd" if cur.is_cuda else None
        u, s, vt_full = torch.linalg.svd(cur, full_matrices=False,
                                         driver=driver)
    else:
        raise ValueError(f"unknown truncation method {method!r}")
    W = s.shape[0]
    mask = (torch.arange(W, device=cur.device) < keep).to(dtype)
    if eps > 0.0:
        mask = mask * (s > s[0] * eps).to(dtype)
    s = s * mask
    if method == "gram":
        inv_s = torch.where(s > TINY, 1.0 / torch.clamp_min(s, TINY),
                            torch.zeros_like(s))
        vt = (V.T @ cur) * inv_s[:, None] * mask[:, None]
        US = V * s[None, :]
    else:
        vt = vt_full * mask[:, None]
        US = u * s[None, :]
    if W >= keep_cap:
        return US[:, :keep_cap], vt[:keep_cap]
    return (_pad_to(US, (US.shape[0], keep_cap)),
            _pad_to(vt, (keep_cap, vt.shape[1])))


def _round_schedule(true_k, n_of, k_right: int, max_ranks, eps: float,
                    min_bucket: int):
    """Static per-bond schedule of the right-to-left truncation sweep:
    true ranks, kept rank, mode and the power-of-2 buckets of each site."""
    d = len(n_of)
    sched = []
    k_in = k_right
    for i in range(d - 1, 0, -1):
        rl, rb = true_k[i]
        n = n_of[i]
        keep = min(int(max_ranks[i - 1]), rl, n * k_in)
        Bk = max(_p2(k_in), min_bucket)
        # "full_cols" also needs the live columns of the padded
        # (Bl, n*Bk) matricization to be a prefix, i.e. Bk == k_in
        if eps == 0.0 and keep == n * k_in and Bk == k_in:
            mode = "full_cols"
        elif eps == 0.0 and keep == rl:
            mode = "full_rows"
        else:
            mode = "trunc"
        sched.append(dict(i=i, rl=rl, rb=rb, n=n, k_in=k_in, keep=keep,
                          mode=mode, Bl=max(_p2(rl), min_bucket),
                          Bb=max(_p2(rb), min_bucket), Bk=Bk,
                          Bkeep=max(_p2(keep), min_bucket)))
        k_in = keep
    return sched


def _round_sweep_segmented(cores: Sequence[torch.Tensor], max_ranks,
                           eps: float = 0.0, method: str = "svd",
                           min_run: int = 3, orth: str = "cholqr",
                           min_bucket: int = 32) -> List[torch.Tensor]:
    """Deterministic rounding (reference round(vector<maxRanks>, eps))
    with power-of-2 bucketed shapes.  Orthogonalization is shifted
    CholeskyQR3 (or Newton-Schulz for method='gemm_exact'); truncation per
    bond is 'svd', 'gram' (eigh), 'subspace' or 'gemm_exact' (certified,
    hand kernel K2 on the card).  Runs of at least ``min_run`` equal-bucket
    bonds (the reference's scan runs) truncate at the padded bucket shape.
    Returns PADDED cores; ``tt_round_sweep_segmented`` slices them."""
    d = len(cores)
    dtype = cores[0].dtype
    if d == 1:
        return list(cores)
    if method == "gemm_exact" and orth == "cholqr":
        orth = "ns"
    qs, true_k, logs = _qr_sweep_segmented(cores, min_run, orth, min_bucket)
    n_of = [int(c.shape[1]) for c in cores]
    sched = _round_schedule(true_k, n_of, int(cores[d - 1].shape[2]),
                            max_ranks, eps, min_bucket)

    out = [None] * d

    def site_core(i, Bl, Bb):
        rl, rb = true_k[i]
        c = qs[i][:rl, :, :rb]
        return _pad_to(c, (Bl, n_of[i], Bb))

    # between segments the carry US holds its TRUE shape
    US = torch.eye(int(cores[d - 1].shape[2]), dtype=dtype,
                   device=cores[0].device)
    pos = 0
    while pos < d - 1:
        st = sched[pos]
        n = st["n"]
        scannable = st["Bl"] == st["Bb"] and st["Bk"] == st["Bkeep"]
        j = pos
        if scannable:
            while (j < d - 1 and sched[j]["n"] == n
                   and sched[j]["Bl"] == st["Bl"]
                   and sched[j]["Bb"] == st["Bl"]
                   and sched[j]["Bk"] == st["Bk"]
                   and sched[j]["Bkeep"] == st["Bk"]
                   and sched[j]["mode"] == st["mode"]):
                j += 1
        if scannable and j - pos >= min_run:
            B, Bk = st["Bl"], st["Bk"]
            run = sched[pos:j]
            USc = _pad_to(US, (B, Bk))
            for s in run:
                cur = torch.einsum("anb,bk->ank", site_core(s["i"], B, B),
                                   USc).reshape(B, n * Bk)
                US2, vt = _trunc_step(cur, s["keep"], Bk, eps, method,
                                      mode=st["mode"])
                nrm = torch.linalg.vector_norm(US2) + TINY
                logs = logs + torch.log(nrm)
                USc = US2 / nrm
                out[s["i"]] = vt.reshape(Bk, n, Bk)
            last = run[-1]
            US = USc[:last["rl"], :last["keep"]]
            pos = j
        else:
            s = st
            cur = torch.einsum("anb,bk->ank",
                               site_core(s["i"], s["rl"], s["rb"]), US
                               ).reshape(s["rl"], n * s["k_in"])
            # unrolled sites run at TRUE shapes: the full_cols prefix
            # condition holds without column padding
            umode = s["mode"]
            if eps == 0.0 and s["keep"] == n * s["k_in"]:
                umode = "full_cols"
            US2, vt = _trunc_step(cur, s["keep"], s["keep"], eps, method,
                                  mode=umode)
            out[s["i"]] = vt.reshape(s["keep"], n, s["k_in"])
            nrm = torch.linalg.vector_norm(US2) + TINY
            logs = logs + torch.log(nrm)
            US = US2 / nrm
            pos += 1
    rl0, rb0 = true_k[0]
    out[0] = torch.einsum("anb,bk->ank", site_core(0, rl0, rb0), US)
    per_core = torch.exp(logs / d)
    return [c * per_core for c in out]


def _segmented_out_shapes(shapes, max_ranks) -> List[Tuple[int, int, int]]:
    """Static true-shape schedule of ``_round_sweep_segmented``'s output."""
    d = len(shapes)
    if d == 1:
        return [tuple(int(s) for s in shapes[0])]
    kprev = 1
    true_lr = []
    for i in range(d - 1):
        _rl, n, rr = shapes[i]
        k = min(kprev * n, rr)
        true_lr.append((kprev, k))
        kprev = k
    true_lr.append((kprev, shapes[d - 1][2]))
    out = [None] * d
    k_in = shapes[d - 1][2]
    for i in range(d - 1, 0, -1):
        rl, _rb = true_lr[i]
        n = shapes[i][1]
        keep = min(int(max_ranks[i - 1]), rl, n * k_in)
        out[i] = (keep, n, k_in)
        k_in = keep
    out[0] = (true_lr[0][0], shapes[0][1], k_in)
    return out


def tt_round_sweep_segmented(cores: Sequence[torch.Tensor], max_ranks,
                             eps: float = 0.0, method: str = "svd"
                             ) -> List[torch.Tensor]:
    """Deterministic rounding at true shapes with a per-edge rank vector.
    ``max_ranks``: int (uniform) or length-(d-1) sequence.  Returns cores
    at their truncated TRUE shapes; with eps > 0 the eps-dropped
    directions are exactly zero and trimmed (one host read per bond)."""
    d = len(cores)
    if isinstance(max_ranks, numbers.Integral):
        max_ranks = [max_ranks] * (d - 1)
    max_ranks = tuple(int(r) for r in max_ranks)
    if method in ("subspace", "gemm_exact") and eps > 0.0:
        raise ValueError(f"method={method!r} has no singular values to "
                         "apply eps to; use method='svd' for eps rounding")
    shapes = [tuple(int(s) for s in c.shape) for c in cores]
    padded = _round_sweep_segmented(list(cores), max_ranks, float(eps), method)
    out_shapes = _segmented_out_shapes(shapes, max_ranks)
    out = [c[:s[0], :s[1], :s[2]] for c, s in zip(padded, out_shapes)]
    if eps > 0.0:
        for j in range(d - 1):
            live = torch.any(out[j + 1] != 0.0, dim=(1, 2))
            nz = torch.nonzero(live).flatten()
            k = int(nz[-1]) + 1 if nz.numel() else 1
            if k < out[j + 1].shape[0]:
                out[j + 1] = out[j + 1][:k]
                out[j] = out[j][:, :, :k]
    return out


# ---------------------------------------------------------------------------
# randomized rounding (randomize-then-orthogonalize)
# ---------------------------------------------------------------------------

def sketch_shapes(shapes, target_rank: int, oversample: int):
    """Shapes of the random sketch cores R_0 .. R_{d-2} that
    ``_round_randomized`` draws: R_i is (l, n_{i+1}, l), and (l, n, 1) for
    the last."""
    l = target_rank + oversample
    d = len(shapes)
    return [(l, int(shapes[i + 1][1]), 1 if i == d - 2 else l)
            for i in range(d - 1)]


# Public speed presets of the randomized rounding sweep, exposed through
# TTNetwork.round_fast(speed=...): the JAX package's table
# (xerus_tpu/ops/tt_kernels.py:2703).  Guardrail: gram_precision stays
# >= 'high' whenever the bulk precision is lowered; cholqr1 panel
# orthogonality degrades as u_gram * kappa^2 and the loss compounds along
# the chain (the JAX package measured a 4.6x truncation-error blowup at
# gram='default' on the decaying-spectrum instance).
SPEED_PRESETS = {
    "exact": {"precision": None, "gram_precision": None},
    "bf16_frontier": {"precision": "default", "gram_precision": "high"},
}
PRECISIONS = (None, "highest", "high", "default")


def _bf16_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 GEMM of two bf16 matrices, accumulated and returned in
    float32: cuBLAS's bf16 GEMM with float32 output on the card (counted
    in ``_bf16_pass.gemms``), and on the CPU the plain version, a float32
    product of the bf16 values (their products are exact in float32)."""
    if a.device.type == "cuda":
        _bf16_pass.gemms += 1
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


_bf16_pass.gemms = 0
programs.counter(_bf16_pass, "gemms")


def mm_precision(a: torch.Tensor, b: torch.Tensor, precision) -> torch.Tensor:
    """a @ b of two matrices at one of the JAX package's matmul precisions,
    per call (torch's global flags stay as ``config`` pins them): None or
    'highest' multiply in the operands' dtype; 'default' is one bf16 pass
    (operands rounded to bf16); 'high' is bf16x3, the products hi*hi,
    hi*lo and lo*hi of the bf16 splits x = hi + lo, each with float32
    output, summed in float32 (the small terms first).  The result takes
    a's dtype."""
    if precision in (None, "highest"):
        return a @ b
    if precision not in ("default", "high"):
        raise ValueError(f"unknown matmul precision {precision!r}")
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = _bf16_pass(ah, bh)
    if precision == "high":
        al = (a - ah.to(a.dtype)).to(torch.bfloat16)
        bl = (b - bh.to(b.dtype)).to(torch.bfloat16)
        out = (_bf16_pass(al, bh) + _bf16_pass(ah, bl)) + out
    return out.to(a.dtype)


def _contract(eq: str, x: torch.Tensor, y: torch.Tensor, precision
              ) -> torch.Tensor:
    """The randomized sweep's three-index contractions at ``precision``:
    torch.einsum at full precision, else the same contraction as one 2-D
    GEMM through ``mm_precision``."""
    if precision in (None, "highest"):
        return torch.einsum(eq, x, y)
    if eq == "anb,bq->anq":
        a, n, b = x.shape
        return mm_precision(x.reshape(a * n, b), y, precision).reshape(
            a, n, -1)
    if eq == "anq,pnq->ap":
        return mm_precision(x.reshape(x.shape[0], -1),
                            y.reshape(y.shape[0], -1).T, precision)
    if eq == "ka,anb->knb":
        a, n, b = y.shape
        return mm_precision(x, y.reshape(a, n * b), precision).reshape(
            x.shape[0], n, b)
    if eq == "ank,anb->kb":
        return mm_precision(x.reshape(-1, x.shape[2]).T,
                            y.reshape(-1, y.shape[2]), precision)
    raise ValueError(f"no GEMM form for {eq!r}")


def _round_randomized(cores: Sequence[torch.Tensor], target_rank: int,
                      oversample: int, qr_method: str = "householder",
                      precision=None, gram_precision=None,
                      sketches: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None,
                      max_ranks: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Randomized rounding to a fixed target rank: right-to-left sketch
    build W_i = G_i (x) R_i against a random rank-l TT (l = target +
    oversample), then a left-to-right QR of the panels (M_i W_i).

    ``sketches``: the standard-normal sketch cores R_0 .. R_{d-2}
    (``sketch_shapes``), before the 1/sqrt(l) scale; the tests pass the
    ones jax.random draws, so both packages round with one sketch.  Without
    them R_i is drawn from ``generator`` (a torch.Generator on the cores'
    device; default seed 0), in the reference's order i = d-2 .. 0.
    ``qr_method``: 'householder', 'cholqr1' (one shifted Gram + Cholesky +
    triangular solve on tall panels), 'cholqr1_invl' (the same with
    L^{-T} formed against the (l, l) identity and applied as a GEMM) or
    'cholqr' (shifted CholeskyQR2 on tall panels, the padded scan's form).
    ``max_ranks``: a cap on each bond's rank below ``target_rank`` (the
    logical ranks ``tt_round_randomized_uniform`` returns).

    ``precision`` sets the matmul precision (``mm_precision``) of the bulk
    GEMMs: sketch build, panel build Y = G W and the projection / carry
    updates; ``gram_precision`` that of the cholqr1 Gram and of the
    L^{-T} apply, as in the JAX package (``SPEED_PRESETS``).  A lowered
    precision runs the sweep in float32, as the JAX package's presets run
    (its f32 kernel; float64 cores are cast down on the TPU): the
    Cholesky shift is then set by float32's epsilon, which covers the
    Gram's bf16x3 error.  The result takes the cores' dtype."""
    if qr_method not in ("householder", "cholqr", "cholqr1", "cholqr1_invl"):
        raise ValueError(f"unknown qr_method {qr_method!r}")
    if precision not in PRECISIONS or gram_precision not in PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r} / "
                         f"{gram_precision!r}")
    pP, pG = precision, gram_precision
    if (cores[0].dtype == torch.float64
            and not {pP, pG} <= {None, "highest"}):
        out = _round_randomized(
            [c.float() for c in cores], target_rank, oversample, qr_method,
            pP, pG, None if sketches is None else
            [r.float() for r in sketches], generator, max_ranks)
        return tuple(c.double() for c in out)
    d = len(cores)
    l = target_rank + oversample
    dtype = cores[0].dtype
    dev = cores[0].device
    if sketches is None:
        sketches = draw_sketches([tuple(c.shape) for c in cores],
                                 target_rank, oversample, dtype, dev,
                                 generator)
    # l filled on the device (torch.tensor(l, device=...) is a host-to-
    # device copy, which a captured region refuses), then torch.sqrt as
    # before; math.sqrt(l) would differ in the last bit from torch's CPU
    # sqrt at some l (2 in float64, 267 in float32)
    sqrt_l = torch.sqrt(torch.full((), float(l), dtype=dtype, device=dev))

    W = [None] * d
    W[d - 1] = torch.ones((int(cores[d - 1].shape[2]), 1), dtype=dtype,
                          device=dev)
    for i in range(d - 2, -1, -1):
        R = sketches[i].to(dtype) / sqrt_l
        GW = _contract("anb,bq->anq", cores[i + 1], W[i + 1], pP)
        Wi = _contract("anq,pnq->ap", GW, R, pP)
        # only the column span of W matters: safe to renormalize
        W[i] = Wi / (torch.linalg.vector_norm(Wi) + TINY)

    out = list(cores)
    log_scale = torch.zeros((), dtype=dtype, device=dev)
    carry = None
    for i in range(d - 1):
        G = (out[i] if carry is None
             else _contract("ka,anb->knb", carry, out[i], pP))
        rl, n, rr = G.shape
        Y = _contract("anb,bq->anq", G, W[i], pP).reshape(rl * n, -1)
        if qr_method == "cholqr" and rl * n >= Y.shape[1]:
            q = _cholqr2(Y, TINY)
        elif qr_method != "householder" and rl * n >= Y.shape[1]:
            lc = Y.shape[1]
            Gm = mm_precision(Y.T, Y, pG)
            shift = (torch.diagonal(Gm).max() * (10 * Y.shape[0] * _eps(dtype))
                     + TINY)
            eye = torch.eye(lc, dtype=dtype, device=dev)
            Lc = _cholesky(Gm + shift * eye)
            if qr_method == "cholqr1_invl":
                q = mm_precision(Y, _solve_lower(Lc, eye).T, pG)
            else:
                q = _solve_lower(Lc, Y.T).T
        else:
            q = torch.linalg.qr(Y)[0]
        k = min(target_rank if max_ranks is None else max_ranks[i],
                q.shape[1])
        q = q[:, :k]
        out[i] = q.reshape(rl, n, k)
        carry = _contract("ank,anb->kb", out[i], G, pP)
        nrm = torch.linalg.vector_norm(carry) + TINY
        log_scale = log_scale + torch.log(nrm)
        carry = carry / nrm
    final = _contract("ka,anb->knb", carry, out[d - 1], pP)
    per_core = torch.exp(log_scale / d)
    return tuple(c * per_core for c in out[:d - 1]) + (final * per_core,)


def draw_sketches(shapes, target_rank: int, oversample: int, dtype,
                  device, generator: Optional[torch.Generator] = None
                  ) -> List[torch.Tensor]:
    """The standard-normal sketch cores R_0 .. R_{d-2} (``sketch_shapes``)
    of a randomized rounding, drawn from ``generator`` (default: a
    torch.Generator seeded 0 on ``device``) in the reference's order
    i = d-2 .. 0.  The programs take them as inputs: a generator inside a
    captured region would be state the graph hides."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sizes = sketch_shapes(shapes, target_rank, oversample)
    out = [None] * len(sizes)
    for i in range(len(sizes) - 1, -1, -1):
        out[i] = torch.randn(sizes[i], generator=generator, dtype=dtype,
                             device=device)
    return out


def _randomized_program(cores, sketches, **kw):
    return _round_randomized(cores, sketches=sketches, **kw)


@factory(64)
def make_randomized_round(shapes_key, dtype_str: str, target_rank: int,
                          oversample: int, qr_method: str = "householder",
                          max_ranks: Optional[Tuple[int, ...]] = None
                          ) -> Program:
    """``_round_randomized`` at full precision as a program for inputs of
    ``shapes_key`` (``programs.shapes_key(cores, sketches)``): (cores,
    sketches) -> cores.  The JAX package's ``make_randomized_round``
    (xerus_tpu/ops/tt_kernels.py:2090) with Householder panels, behind
    ``tt_round_randomized``; ``qr_method`` and the bond caps
    ``max_ranks`` serve ``tt_round_randomized_uniform``."""
    return Program(partial(_randomized_program, target_rank=target_rank,
                           oversample=oversample, qr_method=qr_method,
                           max_ranks=max_ranks),
                   f"randomized_round[{qr_method}]")


@factory(32)
def make_randomized_round_unrolled(shapes_key, dtype_str: str,
                                   target_rank: int, oversample: int,
                                   precision=None, gram_precision=None
                                   ) -> Program:
    """The cholqr1 sweep at ``precision`` / ``gram_precision`` as a
    program: (cores, sketches) -> cores (the JAX package's
    ``make_randomized_round_unrolled``, xerus_tpu/ops/tt_kernels.py:2709,
    the bench's headline sweep and the speed presets' path).  A lowered
    precision's float64 -> float32 cast runs inside it."""
    return Program(partial(_randomized_program, target_rank=target_rank,
                           oversample=oversample, qr_method="cholqr1",
                           precision=precision,
                           gram_precision=gram_precision),
                   f"randomized_round_unrolled[{precision}, "
                   f"{gram_precision}]")


def randomized_inputs(cores: Sequence[torch.Tensor], target_rank: int,
                      oversample: int, precision=None, gram_precision=None,
                      generator: Optional[torch.Generator] = None):
    """(cores, sketches), the inputs of the randomized programs: the
    sketches drawn outside the region, in the dtype the sweep runs in
    (float32 where a lowered precision casts float64 cores down), so the
    program rounds with the numbers ``_round_randomized`` would draw."""
    dtype = cores[0].dtype
    if (dtype == torch.float64
            and not {precision, gram_precision} <= {None, "highest"}):
        dtype = torch.float32
    return tuple(cores), tuple(draw_sketches(
        [tuple(c.shape) for c in cores], target_rank, oversample, dtype,
        cores[0].device, generator))


def tt_round_randomized(cores: Sequence[torch.Tensor], target_rank: int,
                        oversample: int = 8, eager: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """Randomized rounding with Householder panels at full precision (the
    JAX package's ``tt_round_randomized``, xerus_tpu/ops/tt_kernels.py:
    2097): ``make_randomized_round``'s program, or with ``eager`` its
    function run eagerly."""
    t, o = int(target_rank), int(oversample)
    return call(make_randomized_round, randomized_inputs(cores, t, o), t, o,
                eager=eager)


def tt_round_randomized_unrolled(cores: Sequence[torch.Tensor],
                                 target_rank: int, oversample: int = 8,
                                 precision=None, gram_precision=None,
                                 generator: Optional[torch.Generator] = None,
                                 eager: bool = False
                                 ) -> Tuple[torch.Tensor, ...]:
    """The randomized rounding with cholqr1 panels at the matmul
    precisions of a ``SPEED_PRESETS`` entry, through
    ``make_randomized_round_unrolled``'s program (``round_fast(method=
    "randomized_unrolled")`` and ``speed=``); ``generator`` draws the
    sketches (default seed 0), ``eager`` runs the function eagerly."""
    t, o = int(target_rank), int(oversample)
    return call(make_randomized_round_unrolled,
                randomized_inputs(cores, t, o, precision, gram_precision,
                                  generator),
                t, o, precision, gram_precision, eager=eager)
