"""Double-word symmetric eigendecomposition and SVD: an f32 eigh seed plus
Ogita-Aishima refinement with Ozaki GEMMs.

Counterpart of ``xerus_tpu/ops/df_eigh.py``.  Given a symmetric df
matrix, an f32 ``eigh`` seeds approximate eigenvectors; each refinement
iteration (Ogita & Aishima, JSIAM 2018) computes

    R = I - V^T V,   S = V^T A V        (df-accurate Ozaki GEMMs)
    lambda_i = S_ii / (V^T V)_ii        (refined Rayleigh quotients)
    E_ij = (S_ij + lambda_j R_ij) / (lambda_j - lambda_i),  E_ii = R_ii / 2
    V <- V + V E                        (Ozaki GEMM, df accumulate)

E is O(u) small, so computing it in f32 costs O(u^2) in the result.
Clustered eigenvalues cap the accuracy at ~u_df / gap.

The f32 seed comes on the card from kernel K4 (``small_eig.small_eigh``,
Jacobi in float64 on the f32 matrix, cast back to float32, as the
float32 eigh on the card runs in float64 everywhere:
``round_kernels._eigh_sym``), with no host read, so ``df_eigh`` and
``df_svd`` run inside captured programs (``make_df_eigh``;
``df_rounding``'s site programs); a matrix K4 fails gives NaN, as
jnp.linalg.eigh does, and counts in K4's device health record, which the
df rounding reads once a call.  On the CPU the seed is
LAPACK's syevd through scipy, the routine the JAX package's CPU eigh
calls (bit for bit; torch's MKL syevd gives other vectors inside
clusters, and the refinement's reach in a cluster depends on the seed).
Card and CPU seeds differ in sign and inside clusters, so compare
eigenvalues, singular values, reconstructions and projectors, never
vectors.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from . import small_eig
from .df32 import df_add, df_mul, df_sub
from .mixed_precision import df_div, df_sqrt
from .ozaki import ozaki_matmul
from .programs import Program, factory


def _seed_eigh(A: torch.Tensor):
    """The f32 eigh that seeds the refinement (see the module docstring):
    ascending eigenvalues, eigenvectors in the columns."""
    if A.is_cuda:
        return _k4_seed(A)
    from scipy.linalg import eigh as scipy_eigh
    w, V = scipy_eigh(A.detach().numpy(), driver="evd")
    return torch.from_numpy(w), torch.from_numpy(V)


def _k4_seed(A: torch.Tensor):
    """K4 on the (m, m) matrix as a batch of one (its plain version on a
    CPU tensor), NaN where it reports a failure."""
    w, V, status = small_eig.small_eigh(A[None])
    bad = status[0] <= 0
    return (torch.where(bad, torch.full_like(w[0], float("nan")), w[0]),
            torch.where(bad, torch.full_like(V[0], float("nan")), V[0]))


def df_eigh(Ah: torch.Tensor, Al: torch.Tensor, iters: int = 6):
    """Symmetric df eigendecomposition.  Returns (wh, wl, Vh, Vl) with
    eigenvalues ascending (f32-eigh order preserved)."""
    n = Ah.shape[0]
    dtype = Ah.dtype
    w0, V0 = _seed_eigh(Ah)
    Vh, Vl = V0, torch.zeros_like(V0)
    lam_h, lam_l = w0, torch.zeros_like(w0)
    eye = torch.eye(n, dtype=dtype, device=Ah.device)
    offdiag = 1.0 - eye

    for _ in range(iters):
        # Gram and Rayleigh matrices at df accuracy
        Gh, Gl = ozaki_matmul(Vh.T, Vl.T, Vh, Vl)
        AVh, AVl = ozaki_matmul(Ah, Al, Vh, Vl)
        Sh, Sl = ozaki_matmul(Vh.T, Vl.T, AVh, AVl)
        Rh, Rl = df_sub(eye, torch.zeros_like(eye), Gh, Gl)
        # refined Rayleigh quotients (df diagonal ratio; G_ii ~ 1)
        lam_h, lam_l = df_div(torch.diagonal(Sh), torch.diagonal(Sl),
                              torch.diagonal(Gh), torch.diagonal(Gl))
        # the correction E in f32: it is O(u)-small
        lam = lam_h + lam_l
        denom = lam[None, :] - lam[:, None]
        # degenerate pairs (gap at the df noise floor of the global scale)
        # take the orthogonality-only correction R/2; the full step is
        # trust-clipped so a marginal gap cannot blow the linearization up
        scale = lam.abs().max() + 1e-30
        tiny_gap = denom.abs() <= 1e-8 * scale
        safe = torch.where(tiny_gap, torch.ones_like(denom), denom)
        R = Rh + Rl
        E_full = (Sh + Sl + lam[None, :] * R) / safe
        E = torch.where(tiny_gap, R / 2.0, E_full)
        E = torch.clamp(E, -0.25, 0.25)
        # diagonal: exactly R_ii/2
        E = E * offdiag + torch.diag(torch.diagonal(R) / 2.0)
        # divergence gate per column: freeze only the columns an
        # out-of-contract cluster has pumped up
        rcol = torch.sqrt(torch.sum(R ** 2, dim=0))
        gate = (rcol < 0.1).to(dtype)[None, :]
        dVh, dVl = ozaki_matmul(Vh, Vl, E, torch.zeros_like(E))
        Vh, Vl = df_add(Vh, Vl, dVh * gate, dVl * gate)
    return lam_h, lam_l, Vh, Vl


@factory(16)
def make_df_eigh(n: int, dtype_str: str, iters: int = 6) -> Program:
    """``df_eigh`` as a program for (n, n) df matrices (the JAX package's
    ``make_df_eigh``, keyed by n, the dtype and the iterations): (Ah, Al)
    -> (wh, wl, Vh, Vl).  A program takes the strides of its first call's
    inputs on the card."""
    return Program(partial(df_eigh, iters=iters), f"df_eigh[{n}]")


def _unit_columns(h, l):
    """Renormalize columns whose norm is off 1 by more than 1e-4 (exact
    arithmetic gives unit columns; healthy columns stay exact df)."""
    cn = torch.sqrt(torch.sum((h + l) ** 2, dim=0))
    sick = (cn - 1.0).abs() > 1e-4
    cinv = torch.where(cn > 1e-30, 1.0 / torch.clamp_min(cn, 1e-30),
                       torch.zeros_like(cn))
    factor = torch.where(sick, cinv, torch.ones_like(cn))
    return h * factor[None, :], l * factor[None, :]


def df_svd(Ah: torch.Tensor, Al: torch.Tensor, iters: int = 6):
    """Thin df SVD of an (m, n) df matrix, m >= n, via the Gram route:
    G = A^T A (Ozaki GEMM) -> df_eigh -> sigma = sqrt(eigenvalues),
    U = A V / sigma.  Singular values below ~2^-24 * sigma_max come back
    at f32 quality; the dominant spectrum is df-accurate.  Returns
    (Uh, Ul, sh, sl, Vh, Vl) with singular values DESCENDING."""
    Gh, Gl = ozaki_matmul(Ah.T, Al.T, Ah, Al)
    wh, wl, Vh, Vl = df_eigh(Gh, Gl, iters=iters)
    order = torch.argsort(-wh, stable=True)
    wh, wl = wh[order], wl[order]
    Vh, Vl = Vh[:, order], Vl[:, order]
    zero = torch.zeros_like(wl)
    sh, sl = df_sqrt(torch.clamp_min(wh, 0.0), torch.where(wh > 0, wl, zero))
    AVh, AVl = ozaki_matmul(Ah, Al, Vh, Vl)
    # sigma below the Gram noise floor cannot be inverted: zero those
    # directions.  Divide directly: a reciprocal-then-multiply drops the
    # df accuracy to 2^-24
    tiny = 6e-8 * sh.max() + 1e-30
    dead = (sh <= tiny).to(Ah.dtype)
    Uh, Ul = df_div(AVh, AVl, torch.maximum(sh, tiny)[None, :],
                    torch.where(sh > tiny, sl, zero)[None, :])
    Uh = Uh * (1.0 - dead)[None, :]
    Ul = Ul * (1.0 - dead)[None, :]
    Uh, Ul = _unit_columns(Uh, Ul)
    return Uh, Ul, sh, sl, Vh, Vl


def df_svd_jw(Ah: torch.Tensor, Al: torch.Tensor, iters: int = 6):
    """df SVD via the Jordan-Wielandt embedding J = [[0, A], [A^T, 0]],
    whose eigenvalues are +-sigma_i (plus m - n zeros): the Ogita-Aishima
    refinement on J refines the singular triplets directly, never forming
    A^T A, so small singular values keep ~1e-8 * sigma_max absolute
    accuracy (the Gram route's floor is ~2e-5 * sigma_max).  Directions
    below 1e-8 * sigma_max are zeroed (the +-pair is unresolved there).
    Returns (Uh, Ul, sh, sl, Vh, Vl), singular values DESCENDING."""
    m, n = Ah.shape
    dtype = Ah.dtype
    Jh = Ah.new_zeros((m + n, m + n))
    Jl = Ah.new_zeros((m + n, m + n))
    Jh[:m, m:] = Ah
    Jh[m:, :m] = Ah.T
    Jl[:m, m:] = Al
    Jl[m:, :m] = Al.T
    wh, wl, Qh, Ql = df_eigh(Jh, Jl, iters=iters)
    order = torch.argsort(-wh, stable=True)[:n]     # +sigma, descending
    sh = torch.clamp_min(wh[order], 0.0)
    sl = torch.where(sh > 0, wl[order], torch.zeros_like(sh))
    Qh, Ql = Qh[:, order], Ql[:, order]
    rt2 = np.sqrt(np.float64(2.0))
    rt2_h = torch.tensor(np.float32(rt2), dtype=dtype, device=Ah.device)
    rt2_l = torch.tensor(np.float32(rt2 - np.float64(np.float32(rt2))),
                         dtype=dtype, device=Ah.device)
    Uh, Ul = df_mul(Qh[:m], Ql[:m], rt2_h, rt2_l)
    Vh, Vl = df_mul(Qh[m:], Ql[m:], rt2_h, rt2_l)
    live = (1.0 - (sh <= 1e-8 * sh.max()).to(dtype))[None, :]
    Uh, Ul, Vh, Vl = Uh * live, Ul * live, Vh * live, Vl * live
    # absorb block-norm error for columns in the near-zero cluster
    Uh, Ul = _unit_columns(Uh, Ul)
    Vh, Vl = _unit_columns(Vh, Vl)
    return Uh, Ul, sh, sl, Vh, Vl
