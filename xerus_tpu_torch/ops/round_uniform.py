"""The uniform-rank, parallel and streaming TT roundings.

The rest of the rounding half of ``xerus_tpu/ops/tt_kernels.py``:
``tt_round_sweep`` (the unrolled QR + SVD sweep), ``_cholqr3`` and the
CholeskyQR3 + Gram-eigh sweep, ``_round_gram_parallel`` and
``_round_subspace_parallel`` (every bond truncated at once from the
interface Gram matrices), ``_round_streaming_scan`` (two-sided sketches,
generalized Nystrom), their entries ``tt_round_sweep_uniform`` and
``tt_round_streaming_uniform``, ``tt_round_randomized_uniform`` (the
randomized sweep at logical ranks) and ``tt_round_eps_fast``.

The JAX package ran each form as ``lax.scan``s over a (d, r, n, r)
zero-padded stack; here each scan is a loop over sites at the padded
shape, and each ``vmap`` over the d-1 bonds a leading batch axis of
batched Cholesky / eigh / triangular solves.  Zero padding changes
nothing: the padded bond slots stay exactly zero or are masked, and the
entries slice the result back to ``res_rank`` as the JAX package does.
``tt_round_sweep_uniform``'s 'svd' and 'gram' route to the segmented sweep
of ``round_kernels``, the same truncation at true shapes.  Cores are
(left rank, n, right rank) tensors on any device.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .dmrg_kernels import _eigh, _svd
from .programs import call
from .round_kernels import (TINY, _eps, chol_orth_cols, host_bool,
                            make_randomized_round, randomized_inputs,
                            res_rank, tt_round_sweep_segmented)
from .stacking import pad_cores

UNIFORM_METHODS = ("svd", "gram", "cholqr", "gram_parallel",
                   "subspace_parallel")


# ---------------------------------------------------------------------------
# the unrolled QR + SVD sweep at true shapes
# ---------------------------------------------------------------------------

def tt_round_sweep(cores: Sequence[torch.Tensor], target_rank: int
                   ) -> Tuple[torch.Tensor, ...]:
    """Householder QR sweep left to right, truncated SVD sweep right to
    left (canonicalize_right + the round_edge chain of the reference), the
    carried factors renormalized with the log-scale redistributed evenly
    over the cores.  The SVD is the object layer's (gesvd on the card)."""
    d = len(cores)
    cores = list(cores)
    dtype = cores[0].dtype
    log_scale = torch.zeros((), dtype=dtype, device=cores[0].device)
    for i in range(d - 1):
        rl, n, rr = cores[i].shape
        q, r = torch.linalg.qr(cores[i].reshape(rl * n, rr))
        cores[i] = q.reshape(rl, n, q.shape[1])
        nrm = torch.linalg.vector_norm(r) + TINY
        log_scale = log_scale + torch.log(nrm)
        cores[i + 1] = torch.einsum("ab,bnc->anc", r / nrm, cores[i + 1])
    for i in range(d - 1, 0, -1):
        rl, n, rr = cores[i].shape
        u, s, vt = _svd(cores[i].reshape(rl, n * rr))
        k = min(int(target_rank), u.shape[1])
        u = u[:, :k] * s[None, :k]
        cores[i] = vt[:k, :].reshape(k, n, rr)
        nrm = torch.linalg.vector_norm(u) + TINY
        log_scale = log_scale + torch.log(nrm)
        cores[i - 1] = torch.einsum("anb,bk->ank", cores[i - 1], u / nrm)
    per_core = torch.exp(log_scale / d)
    return tuple(c * per_core for c in cores)


# ---------------------------------------------------------------------------
# CholeskyQR3 + Gram-eigh sweep on the padded stack
# ---------------------------------------------------------------------------

def _cholqr3(cur: torch.Tensor, tiny: float = TINY):
    """Shifted CholeskyQR3 of a tall (m, r) matrix (Fukaya et al. 2020):
    three Gram + Cholesky + triangular-solve passes, the first shift
    10*m*eps, the next two 10*eps, each relative to the Gram's largest
    diagonal entry.  Q R = cur holds for any invertible L, so the shifts
    only keep Cholesky alive on zero-padded bonds.  Returns (Q, R)."""
    m = cur.shape[0]
    eps = _eps(cur.dtype)
    Q, Ls = cur, []
    for rel in (10 * m * eps, 10 * eps, 10 * eps):
        Q, L = chol_orth_cols(Q, (rel,), want_r=True)
        Ls.append(L)
    # cur = Q3 L3^T L2^T L1^T (chol_orth_cols returns R = L^T)
    return Q, Ls[2] @ (Ls[1] @ Ls[0])


def _qr_scan(stacked: torch.Tensor, qr):
    """Left-to-right orthogonalization of the padded stack with
    ``qr(cur) -> (q, R)``, the carry renormalized; returns (qs, log
    scale), the trailing carry folded into the last core."""
    d, r, n, _ = stacked.shape
    R = torch.eye(r, dtype=stacked.dtype, device=stacked.device)
    logs = torch.zeros((), dtype=stacked.dtype, device=stacked.device)
    qs = []
    for k in range(d):
        cur = torch.einsum("ab,bnc->anc", R, stacked[k]).reshape(r * n, r)
        q, R2 = qr(cur)
        nrm = torch.linalg.vector_norm(R2) + TINY
        logs = logs + torch.log(nrm)
        R = R2 / nrm
        qs.append(q.reshape(r, n, r))
    qs[d - 1] = torch.einsum("anb,bc->anc", qs[d - 1], R)
    return qs, logs


def _gram_trunc_scan(qs, target_rank: int, logs):
    """Right-to-left truncation by the Gram eigh G = cur cur^T on the
    padded cores ``qs``; returns the rounded (d, r, n, r) stack."""
    d = len(qs)
    r, n = qs[0].shape[0], qs[0].shape[1]
    dtype, dev = qs[0].dtype, qs[0].device
    mask = (torch.arange(r, device=dev) < target_rank).to(dtype)
    US = torch.eye(r, dtype=dtype, device=dev)
    out = [None] * d
    for k in range(d - 1, 0, -1):
        cur = torch.einsum("anb,bc->anc", qs[k], US).reshape(r, n * r)
        lam, V = _eigh(cur @ cur.T)                      # ascending
        lam = torch.flip(lam, (0,))
        V = torch.flip(V, (1,))
        s = torch.sqrt(torch.clamp_min(lam, 0.0)) * mask
        inv_s = torch.where(s > TINY, 1.0 / torch.clamp_min(s, TINY),
                            torch.zeros_like(s))
        out[k] = ((V.T @ cur) * inv_s[:, None]).reshape(r, n, r)
        US2 = V * s[None, :]
        nrm = torch.linalg.vector_norm(US2) + TINY
        logs = logs + torch.log(nrm)
        US = US2 / nrm
    out[0] = torch.einsum("anb,bc->anc", qs[0], US)
    return torch.stack(out) * torch.exp(logs / d)


def _round_sweep_scan_cholqr(stacked: torch.Tensor, target_rank: int
                             ) -> torch.Tensor:
    """Gram-eigh rounding with the orthogonalization QR replaced by
    shifted CholeskyQR3: every heavy operation is a GEMM plus r x r
    Cholesky / eigh.  Accuracy matches the 'gram' method (the Gram pass
    squares the condition)."""
    qs, logs = _qr_scan(stacked, _cholqr3)
    return _gram_trunc_scan(qs, target_rank, logs)


# ---------------------------------------------------------------------------
# all bonds at once: interface Gram matrices
# ---------------------------------------------------------------------------

def _interface_grams(stacked: torch.Tensor):
    """Left Grams L_k = X_{<=k}^T X_{<=k} and right Grams
    R_k = X_{>k} X_{>k}^T for bonds 1..d-1, each renormalized, with the
    accumulated log-scales: (Ls, lam_logs, Rs, rho_logs), leading axis the
    d-1 bonds."""
    d, r, n, _ = stacked.shape
    dtype, dev = stacked.dtype, stacked.device
    eye = torch.eye(r, dtype=dtype, device=dev)

    def scan(cores, step):
        G = eye
        logs = torch.zeros((), dtype=dtype, device=dev)
        Gs, ls = [], []
        for core in cores:
            G2 = step(G, core)
            G2 = 0.5 * (G2 + G2.T)
            nrm = torch.linalg.vector_norm(G2) + TINY
            logs = logs + torch.log(nrm)
            G = G2 / nrm
            Gs.append(G)
            ls.append(logs)
        return Gs, ls

    Ls, lam = scan([stacked[k] for k in range(d - 1)],
                   lambda L, c: torch.einsum(
                       "anc,and->cd", torch.einsum("ab,bnc->anc", L, c), c))
    Rs, rho = scan([stacked[k] for k in range(d - 1, 0, -1)],
                   lambda R, c: torch.einsum(
                       "bnd,end->be", torch.einsum("bnc,cd->bnd", c, R), c))
    return (torch.stack(Ls), torch.stack(lam), torch.stack(Rs[::-1]),
            torch.stack(rho[::-1]))


def _apply_bond_maps(stacked, Ps, Pts, lam_logs, rho_logs):
    """C_k <- P~_k C_k P_{k+1} for every core (identity maps at the two
    boundaries), then the gauge-balanced per-core scale: the factors
    telescope to exactly 1 over the chain, so they only redistribute
    magnitude between cores."""
    d, r = stacked.shape[0], stacked.shape[1]
    dtype, dev = stacked.dtype, stacked.device
    eye = torch.eye(r, dtype=dtype, device=dev)[None]
    left = torch.cat([eye, Pts], dim=0)
    right = torch.cat([Ps, eye], dim=0)
    out = torch.einsum("kab,kbnc->kanc", left, stacked)
    out = torch.einsum("kanc,kcd->kand", out, right)
    z = torch.zeros((1,), dtype=dtype, device=dev)
    lam_full = torch.cat([z, lam_logs, z])
    rho_full = torch.cat([z, rho_logs, z])
    g = (lam_full[:-1] - lam_full[1:] + rho_full[1:] - rho_full[:-1]) / 4.0
    return out * torch.exp(g)[:, None, None, None]


def _round_gram_parallel(stacked: torch.Tensor, target_rank: int
                         ) -> torch.Tensor:
    """All-bonds-at-once deterministic rounding via interface Gram
    matrices (the Gram-SVD rounding of 'Parallel Algorithms for Tensor
    Train Arithmetic', arXiv 2011.06532).  With R = lamR lamR^T from
    eigh(R) (pinv-masked) and G = lamR^T L lamR = V sigma^2 V^T, the
    rank-t bond insertion pair is P = lamR V diag(mask/sqrt(sigma)) and
    P~ = diag(mask*sqrt(sigma)) V^T lamR^+.  Quasi-optimal (error <= the
    sum of per-bond optimal errors); the result is not canonicalized."""
    d, r = stacked.shape[0], stacked.shape[1]
    dtype, dev = stacked.dtype, stacked.device
    pinv_tol = 4.0 * r * _eps(dtype)
    Ls, lam_logs, Rs, rho_logs = _interface_grams(stacked)

    mu, VR = _eigh(Rs)                                   # ascending
    mu = torch.clamp_min(mu, 0.0)
    keep = (mu > pinv_tol * mu[:, -1:]).to(dtype)
    rt_mu = torch.sqrt(mu) * keep
    inv_mu = torch.where(rt_mu > TINY, 1.0 / torch.clamp_min(rt_mu, TINY),
                         torch.zeros_like(rt_mu))
    lamR = VR * rt_mu[:, None, :]                        # R = lamR lamR^T
    G = lamR.mT @ (Ls @ lamR)
    G = 0.5 * (G + G.mT)
    lam, V = _eigh(G)
    lam = torch.flip(lam, (-1,))
    V = torch.flip(V, (-1,))
    sig = torch.sqrt(torch.clamp_min(lam, 0.0))
    mask = (torch.arange(r, device=dev) < target_rank).to(dtype)[None, :]
    mask = mask * (sig > pinv_tol * sig[:, :1]).to(dtype)
    inv_rt = torch.where(sig > TINY,
                         1.0 / torch.sqrt(torch.clamp_min(sig, TINY)),
                         torch.zeros_like(sig)) * mask
    P = (lamR @ V) * inv_rt[:, None, :]
    rt = torch.sqrt(sig) * mask
    # P~ = diag(rt) V^T lamR^+, lamR^+ = diag(inv_mu) VR^T
    Pt = ((V * rt[:, None, :]).mT * inv_mu[:, None, :]) @ VR.mT
    return _apply_bond_maps(stacked, P, Pt, lam_logs, rho_logs)


def _cholesky_b(A: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky, NaN where a factorization fails (as
    jnp.linalg.cholesky gives), without a host check."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _chol_orth_cols_b(X: torch.Tensor) -> torch.Tensor:
    """``chol_orth_cols`` over a leading batch axis: one Gram + shifted
    Cholesky (10*eps of each Gram's largest diagonal entry) + triangular
    solve per matrix."""
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    G = X.mT @ X
    shift = (torch.diagonal(G, dim1=-2, dim2=-1).amax(-1) * (10 * _eps(X.dtype))
             + TINY)
    L = _cholesky_b(G + shift[:, None, None] * eye)
    return torch.linalg.solve_triangular(L, X.mT, upper=False).mT


def _round_subspace_parallel(stacked: torch.Tensor, target_rank: int,
                             power_iters: int = 3, eps: float = 0.0
                             ) -> torch.Tensor:
    """All-bonds-at-once deterministic rounding with no SVD or eigh:
    per bond C = chol(R + shift I), G = C^T L C, V from subspace power
    iteration on G from the start G[:, :t] with CholQR between steps, and
    P = C V diag(mask/sqrt(sig)), P~ = diag(mask*sqrt(sig)) V^T C^-1.  The
    represented tensor depends only on span(V), so the shift and the
    Rayleigh sigma estimates cost no representation error.  ``eps``: a
    relative mask on the Rayleigh sigma estimates."""
    d, r = stacked.shape[0], stacked.shape[1]
    dtype, dev = stacked.dtype, stacked.device
    t = min(int(target_rank), r)
    eye = torch.eye(r, dtype=dtype, device=dev)
    pinv_tol = 4.0 * r * _eps(dtype)
    Ls, lam_logs, Rs, rho_logs = _interface_grams(stacked)

    shift = (torch.diagonal(Rs, dim1=-2, dim2=-1).abs().amax(-1)
             * (10 * _eps(dtype)) + TINY)
    C = _cholesky_b(Rs + shift[:, None, None] * eye)
    G = C.mT @ (Ls @ C)
    G = 0.5 * (G + G.mT)
    V = _chol_orth_cols_b(G[:, :, :t])
    for _ in range(power_iters):
        V = _chol_orth_cols_b(G @ V)
    V = _chol_orth_cols_b(V)                 # tighten orthogonality
    s2 = torch.clamp_min(torch.sum(V * (G @ V), dim=-2), 0.0)   # Rayleigh
    sig = torch.sqrt(s2)
    smax = sig.amax(-1, keepdim=True)
    mask = (sig > pinv_tol * smax).to(dtype)
    if eps > 0.0:
        mask = mask * (sig > eps * smax).to(dtype)
    inv_rt = torch.where(sig > TINY,
                         1.0 / torch.sqrt(torch.clamp_min(sig, TINY)),
                         torch.zeros_like(sig)) * mask
    rt = torch.sqrt(sig) * mask
    P = (C @ V) * inv_rt[:, None, :]                         # (B, r, t)
    Z = torch.linalg.solve_triangular(C.mT, V, upper=True)   # C^-T V
    Pt = Z.mT * rt[:, :, None]                               # (B, t, r)
    if t < r:
        P = torch.cat([P, P.new_zeros(P.shape[0], r, r - t)], dim=2)
        Pt = torch.cat([Pt, Pt.new_zeros(Pt.shape[0], r - t, r)], dim=1)
    return _apply_bond_maps(stacked, P, Pt, lam_logs, rho_logs)


def tt_round_sweep_uniform(cores: Sequence[torch.Tensor], target_rank: int,
                           method: str = "svd", eps: float = 0.0
                           ) -> List[torch.Tensor]:
    """Uniform-rank deterministic rounding.  'svd' (exact truncation) and
    'gram' (eigh of the bond Gram) run the segmented sweep at true shapes
    (``round_kernels.tt_round_sweep_segmented``); 'cholqr' (CholeskyQR3 +
    Gram eigh), 'gram_parallel' (all bonds at once from the interface
    Grams, quasi-optimal, not canonicalized) and 'subspace_parallel'
    (the same structure with GEMM + batched Cholesky only; ``eps`` acts
    on its sigma estimates) pad the cores to one (d, r, n, r) stack and
    slice the result back to ranks min(target, n^i, n^(d-i)).  With eps > 0
    the padded forms' zeroed bond slots are read off on the host (one
    read) and trimmed."""
    if method in ("svd", "gram"):
        return tt_round_sweep_segmented(cores, int(target_rank), eps=eps,
                                        method=method)
    if method not in UNIFORM_METHODS:
        raise ValueError(f"unknown rounding method {method!r}; expected "
                         "'svd', 'gram', 'cholqr', 'gram_parallel' or "
                         "'subspace_parallel'")
    stacked, _r = pad_cores(list(cores))
    if method == "cholqr":
        out = _round_sweep_scan_cholqr(stacked, int(target_rank))
    elif method == "gram_parallel":
        out = _round_gram_parallel(stacked, int(target_rank))
    else:
        out = _round_subspace_parallel(stacked, int(target_rank),
                                       eps=float(eps))
    d, n = stacked.shape[0], stacked.shape[2]
    bond_rank = [res_rank(i, d, n, int(target_rank)) for i in range(1, d)]
    if eps > 0.0:
        host_bool.reads += 1
        live = torch.any(out != 0.0, dim=(2, 3)).cpu().numpy()
        for i in range(1, d):
            nz = np.flatnonzero(live[i])
            bond_rank[i - 1] = min(bond_rank[i - 1],
                                   int(nz[-1]) + 1 if nz.size else 1)
    res = []
    for i in range(d):
        rl = 1 if i == 0 else bond_rank[i - 1]
        rr = 1 if i == d - 1 else bond_rank[i]
        res.append(out[i][:rl, :cores[i].shape[1], :rr])
    return res


# ---------------------------------------------------------------------------
# streaming (two-sided sketch, generalized Nystrom) rounding
# ---------------------------------------------------------------------------

def _streaming_sketches(d, n, target_rank, psi_oversample, dtype, device,
                        generator=None):
    """Standard-normal sketches from ``generator`` (default a Generator
    seeded 0 on ``device``): first the d-1 right sketches Omega
    (l, n, l), the t-th for core d-1-t, then the d-1 left sketches Phi
    (l', n, l'), the k-th for core k; l = target, l' = l +
    psi_oversample."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    l, lp = target_rank, target_rank + psi_oversample

    def draw(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    return ([draw((l, n, l)) for _ in range(d - 1)],
            [draw((lp, n, lp)) for _ in range(d - 1)])


def _cholqr1_batched(X: torch.Tensor) -> torch.Tensor:
    """One shifted CholeskyQR pass (10*m*eps of each Gram's largest
    diagonal entry) over a leading batch axis."""
    mm, w = X.shape[1], X.shape[2]
    G = X.mT @ X
    shift = (10 * mm * _eps(X.dtype)
             * torch.diagonal(G, dim1=-2, dim2=-1).amax(-1) + TINY)
    Gs = G + shift[:, None, None] * torch.eye(w, dtype=X.dtype,
                                              device=X.device)
    Lc = _cholesky_b(Gs)
    return torch.linalg.solve_triangular(Lc, X.mT, upper=False).mT


def _round_streaming_scan(stacked: torch.Tensor, target_rank: int,
                          psi_oversample: int, sketches=None):
    """Streaming two-sided (generalized Nystrom) TT rounding ('Streaming
    Tensor Train Approximation', arXiv 2208.02600): right sketches
    W_j = X_{>j} Omega_j and left sketches L_j = Psi_j X_{<=j} from two
    pure-GEMM sweeps, every carry re-orthonormalized by one fused batched
    shifted CholeskyQR, then X ~= (X_0 W_1) Z_1^+ (L_1 X_1 W_2) ... with
    Z_j = L_j W_j and the pseudo-inverses as regularized normal
    equations, one batched Cholesky + solve over all bonds.  Exact on
    representable ranks; under truncation a single-digit multiple of the
    optimal error.  ``sketches``: (Omegas, Phis) as
    ``_streaming_sketches`` lays them out (the tests pass the ones
    jax.random draws); default ``_streaming_sketches``.
    Returns (first (r, n, l), mids (d-2, l, n, l), last (l, n, l))."""
    d, r, n, _ = stacked.shape
    dtype, dev = stacked.dtype, stacked.device
    l = int(target_rank)
    lp = l + int(psi_oversample)
    if sketches is None:
        sketches = _streaming_sketches(d, n, l, psi_oversample, dtype, dev)
    omegas, phis = sketches

    W = stacked.new_zeros((r, l))
    W[0, 0] = 1.0
    Ws = []
    for t, k in enumerate(range(d - 1, 0, -1)):
        GW = torch.einsum("anb,bq->anq", stacked[k], W)
        Wn = torch.einsum("anq,pnq->ap", GW, omegas[t].to(dtype))
        W = Wn / (torch.linalg.vector_norm(Wn) + TINY)
        Ws.append(W)
    Ws = torch.stack(Ws[::-1])                  # Ws[k] = W_{k+1}

    L = stacked.new_zeros((lp, r))
    L[0, 0] = 1.0
    Ls = []
    for k in range(d - 1):
        T = torch.einsum("pa,anb->pnb", L, stacked[k])
        Ln = torch.einsum("qnp,pnb->qb", phis[k].to(dtype), T)
        L = Ln / (torch.linalg.vector_norm(Ln) + TINY)
        Ls.append(L)
    Ls = torch.stack(Ls)                        # Ls[k] = L_{k+1}

    # one fused batched re-conditioning: W carries column-QR, L carries
    # row-QR (column-QR of L^T), width-padded into a single batch
    width = max(l, lp)
    Wp = torch.cat([Ws, Ws.new_zeros(d - 1, r, width - l)], dim=2)
    Lp = torch.cat([Ls.mT, Ls.new_zeros(d - 1, r, width - lp)], dim=2)
    allc = _cholqr1_batched(torch.cat([Wp, Lp], dim=0))
    Ws = allc[:d - 1, :, :l]
    Ls = allc[d - 1:, :, :lp].mT

    Zs = Ls @ Ws                                              # (d-1, l', l)
    Ms = torch.einsum("kpa,kanb->kpnb", Ls[:-1], stacked[1:-1])
    Ms = torch.einsum("kpnb,kbl->kpnl", Ms, Ws[1:])           # (d-2, l', n, l)
    Mlast = torch.einsum("pa,anb->pnb", Ls[-1], stacked[-1])  # (l', n, r)
    if r >= l:
        Mlast_l = Mlast[:, :, :l]
    else:
        Mlast_l = torch.cat([Mlast, Mlast.new_zeros(lp, n, l - r)], dim=2)
    rhs = torch.cat([Ms.reshape(d - 2, lp, n * l),
                     Mlast_l.reshape(1, lp, n * l)], dim=0)
    G = Zs.mT @ Zs                                            # (d-1, l, l)
    shift = (10.0 * lp * _eps(dtype)
             * torch.diagonal(G, dim1=-2, dim2=-1).amax(-1) + TINY)
    G = G + shift[:, None, None] * torch.eye(l, dtype=dtype, device=dev)
    Lc = _cholesky_b(G)
    sol = torch.linalg.solve_triangular(Lc, Zs.mT @ rhs, upper=False)
    Cs = torch.linalg.solve_triangular(Lc.mT, sol, upper=True)

    first = torch.einsum("anb,bl->anl", stacked[0], Ws[0])    # (r, n, l)
    mids = Cs[:-1].reshape(d - 2, l, n, l)
    last = Cs[-1].reshape(l, n, l)   # right leg: cols >= 1 are padding
    return first, mids, last


def tt_round_streaming_uniform(cores: Sequence[torch.Tensor],
                               target_rank: int, psi_oversample: int = 32,
                               sketches=None) -> List[torch.Tensor]:
    """Pad, run the streaming kernel, clip the boundary legs.  The Nystrom
    cores are dense across all ``target_rank`` coordinates, so every
    interior bond comes back at exactly ``target_rank``: a valid but
    non-minimal representation near the chain ends.  ``sketches``: see
    ``_round_streaming_scan``."""
    if len(cores) == 1:
        return [cores[0]]                 # no bonds to round
    stacked, _r = pad_cores(list(cores))
    d = stacked.shape[0]
    first, mids, last = _round_streaming_scan(
        stacked, int(target_rank), int(psi_oversample), sketches)
    res = [first[:1, :cores[0].shape[1], :]]
    for i in range(1, d - 1):
        res.append(mids[i - 1][:, :cores[i].shape[1], :])
    res.append(last[:, :cores[d - 1].shape[1], :1])
    return res


def tt_round_randomized_uniform(cores: Sequence[torch.Tensor],
                                target_rank: int, oversample: int = 8,
                                qr_method: str = "householder",
                                eager: bool = False) -> List[torch.Tensor]:
    """Randomized rounding to ``target_rank`` with every bond at its
    logical rank min(target, n_0 ... n_i, n_{i+1} ... n_{d-1}) (the JAX
    package's entry over ``_round_randomized_scan``).  The scan pads each
    bond to l = target + oversample, masks the columns past the target and
    slices back to the logical ranks; here the sweep runs at true shapes
    and caps each bond at its logical rank, which drops the same
    directions.  ``qr_method``: 'householder', 'cholqr' (shifted
    CholeskyQR2) or 'cholqr1' (one shifted pass).  The sweep is
    ``round_kernels.make_randomized_round``'s program (its sketches drawn
    outside it), or with ``eager`` its function run eagerly."""
    if qr_method not in ("householder", "cholqr", "cholqr1"):
        raise ValueError(f"unknown qr_method {qr_method!r}")
    d = len(cores)
    if d < 2:
        return list(cores)
    dims = [int(c.shape[1]) for c in cores]
    caps = [min(int(target_rank), math.prod(dims[:i + 1]),
                math.prod(dims[i + 1:])) for i in range(d - 1)]
    t, o = int(target_rank), int(oversample)
    return list(call(make_randomized_round, randomized_inputs(cores, t, o),
                     t, o, qr_method, tuple(caps), eager=eager))


def tt_round_eps_fast(cores: Sequence[torch.Tensor], max_rank: int,
                      eps: float, oversample: int = 8,
                      qr_method: str = "householder") -> List[torch.Tensor]:
    """eps-adaptive rounding (the reference's round(maxRanks, eps)):
    randomized preconditioning down to ``max_rank`` (the randomized sweep
    at true shapes), then the exact eps-truncating svd sweep on the now
    small cores.  Error: eps-optimal on the randomized stage's
    quasi-optimal rank-l image."""
    mid = tt_round_randomized_uniform(cores, int(max_rank), int(oversample),
                                      qr_method=qr_method)
    return tt_round_sweep_uniform(mid, int(max_rank), method="svd",
                                  eps=float(eps))
