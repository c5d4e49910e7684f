"""Blocked double-word Cholesky: float64-quality SPD factorization.

Counterpart of ``xerus_tpu/ops/df_cholesky.py``.  The refined solve of
ops/df32.py (f32 Cholesky + df residual refinement) needs
kappa * 2^-24 < 1; past that the f32 factorization itself meets negative
pivots.  Here the factorization runs in double-word f32 end to end, so
positivity is judged at ~2^-48 and the usable condition reaches
kappa ~ 2^48:

- diagonal blocks and panel triangular solves: column-sequential df
  arithmetic (the JAX package's fori_loops), one launch each of kernel
  K1c on the card (``ops/df_loops.py``: ``df_chol_block``,
  ``df_trsm_rlt``); on the CPU the plain loops, one Python step per
  column whose row product is a df matvec;
- trailing updates (all the FLOPs): Ozaki split GEMMs (ops/ozaki.py).

The solve applies the df factor through f32 triangular substitutions
inside a df iterative refinement.
"""

from __future__ import annotations

from functools import partial

import torch

from . import df_loops, programs
from .df32 import df_add, df_sub
from .df_matvec import df_matvec, df_matvec_reference
from .mixed_precision import df_div, df_sqrt
from .ozaki import ozaki_matmul
from .programs import Program, factory


def _df_chol_unblocked(Ah, Al):
    """df Cholesky of a (B, B) df SPD block.  Returns lower-triangular
    (Lh, Ll).  On CPU tensors the plain version; on CUDA tensors one
    launch of K1c's ``df_chol_block`` (route cta or gmem by
    ``df_loops.df_chol_block_plan``).  A failed launch raises."""
    _df_chol_unblocked.calls += 1
    if Ah.device.type == "cpu":
        return _df_chol_unblocked_reference(Ah, Al)
    if Ah.device.type != "cuda":
        raise RuntimeError(f"_df_chol_unblocked: no kernel for device "
                           f"{Ah.device}")
    return df_loops.df_chol_block_launch(
        Ah, Al, df_loops.df_chol_block_plan(Ah.shape[0]))


def _df_trsm_rlt(Ah, Al, Lkh, Lkl):
    """Solve X Lkk^T = A for X, with Lkk (B, B) lower-triangular df and
    A (m, B) df.  On CPU tensors the plain version; on CUDA tensors one
    launch of K1c's ``df_trsm_rlt`` (route whole, tiles or gmem by
    ``df_loops.df_trsm_plan``).  A failed launch raises."""
    _df_trsm_rlt.calls += 1
    if Ah.device.type == "cpu":
        return _df_trsm_rlt_reference(Ah, Al, Lkh, Lkl)
    if Ah.device.type != "cuda":
        raise RuntimeError(f"_df_trsm_rlt: no kernel for device {Ah.device}")
    return df_loops.df_trsm_rlt_launch(Ah, Al, Lkh, Lkl,
                                       df_loops.df_trsm_plan(*Ah.shape))


_df_chol_unblocked.calls = 0
_df_trsm_rlt.calls = 0
programs.counter(_df_chol_unblocked, "calls")
programs.counter(_df_trsm_rlt, "calls")


def _df_chol_unblocked_reference(Ah, Al):
    """The plain version: column-sequential df Cholesky of a (B, B) df SPD
    block, masked to the lower triangle as the reference's loop body is;
    each step's row product is the plain broadcast df matvec
    (``df_matvec_reference``, torch on any device: the plain version runs
    no kernel).  Returns lower-triangular (Lh, Ll)."""
    B = Ah.shape[0]
    dtype = Ah.dtype
    idx = torch.arange(B, device=Ah.device)
    Lh = Ah.new_zeros((B, B))
    Ll = Ah.new_zeros((B, B))
    for j in range(B):
        sh, sl = df_matvec_reference(Lh, Ll, Lh[j], Ll[j])  # L @ L[j, :]
        sh, sl = df_sub(Ah[:, j], Al[:, j], sh, sl)
        dh, dl = df_sqrt(torch.clamp_min(sh[j], 1e-30), sl[j])
        ch, cl = df_div(sh, sl, dh, dl)
        below = (idx > j).to(dtype)
        diag = (idx == j).to(dtype)
        Lh[:, j] = ch * below + dh * diag
        Ll[:, j] = cl * below + dl * diag
    return Lh, Ll


def _df_trsm_rlt_reference(Ah, Al, Lkh, Lkl):
    """The plain version of ``_df_trsm_rlt``: column-sequential df
    substitution, each step's row product ``df_matvec_reference``."""
    Xh = Ah.new_zeros(Ah.shape)
    Xl = Ah.new_zeros(Ah.shape)
    for j in range(Ah.shape[1]):
        # s = A[:, j] - X @ Lkk[j, :]^T (columns >= j of X are still zero)
        sh, sl = df_matvec_reference(Xh, Xl, Lkh[j], Lkl[j])
        sh, sl = df_sub(Ah[:, j], Al[:, j], sh, sl)
        ch, cl = df_div(sh, sl, Lkh[j, j], Lkl[j, j])
        Xh[:, j] = ch
        Xl[:, j] = cl
    return Xh, Xl


def df_cholesky(Ah, Al, block: int = 64):
    """Blocked right-looking df Cholesky of an (n, n) SPD df matrix; an n
    that is not a multiple of ``block`` gets an identity tail.  Returns
    lower-triangular (Lh, Ll).  The inputs are not modified."""
    n = Ah.shape[0]
    B = min(block, n)
    require_pad = n % B
    if require_pad:
        pad = B - require_pad
        Ah2 = Ah.new_zeros((n + pad, n + pad))
        Al2 = Al.new_zeros((n + pad, n + pad))
        Ah2[:n, :n] = Ah
        Al2[:n, :n] = Al
        Ah2[n:, n:] = torch.eye(pad, dtype=Ah.dtype, device=Ah.device)
        Ah, Al = Ah2, Al2
        n = n + pad
    else:
        Ah, Al = Ah.clone(), Al.clone()
    Lh = torch.zeros_like(Ah)
    Ll = torch.zeros_like(Al)
    for k in range(0, n, B):
        e = k + B
        Lkh, Lkl = _df_chol_unblocked(Ah[k:e, k:e], Al[k:e, k:e])
        Lh[k:e, k:e] = Lkh
        Ll[k:e, k:e] = Lkl
        if e < n:
            X21h, X21l = _df_trsm_rlt(Ah[e:, k:e], Al[e:, k:e], Lkh, Lkl)
            Lh[e:, k:e] = X21h
            Ll[e:, k:e] = X21l
            # trailing update: A22 -= L21 L21^T (Ozaki GEMM)
            Uh, Ul = ozaki_matmul(X21h, X21l, X21h.T, X21l.T)
            th, tl = df_sub(Ah[e:, e:], Al[e:, e:], Uh, Ul)
            Ah[e:, e:] = th
            Al[e:, e:] = tl
    if require_pad:
        m = n - (B - require_pad)
        return Lh[:m, :m], Ll[:m, :m]
    return Lh, Ll


def df_solve_spd_chol(Ah, Al, bh, bl, block: int = 64,
                      refine_iters: int = 3):
    """Solve SPD A x = b at df precision through the blocked df Cholesky.

    The factor is applied in f32 (two triangular substitutions) inside a
    df residual refinement; valid for kappa(A) up to ~2^48, far past the
    2^24 wall of ``df32.df_solve_spd_refined``.  Returns (xh, xl)."""
    Lh, _Ll = df_cholesky(Ah, Al, block)
    Ah, Al = Ah.contiguous(), Al.contiguous()

    def apply_inv(r):
        y = torch.linalg.solve_triangular(Lh, r[:, None], upper=False)
        return torch.linalg.solve_triangular(Lh.T, y, upper=True)[:, 0]

    xh = apply_inv(bh + bl)
    xl = torch.zeros_like(xh)
    for _ in range(refine_iters):
        Axh, Axl = df_matvec(Ah, Al, xh.contiguous(), xl.contiguous())
        rh, rl = df_sub(bh, bl, Axh, Axl)
        d = apply_inv(rh + rl)
        xh, xl = df_add(xh, xl, d, torch.zeros_like(d))
    return xh, xl


@factory(16)
def make_df_solve_spd_chol(n: int, dtype_str: str, block: int = 64,
                           refine_iters: int = 3) -> Program:
    """``df_solve_spd_chol`` as a program for an (n, n) system (the JAX
    package's ``make_df_solve_spd_chol``, keyed by n, the dtype, the block
    and the refinement steps): (Ah, Al, bh, bl) -> (xh, xl).  A program
    takes the strides of its first call's inputs on the card."""
    return Program(partial(df_solve_spd_chol, block=block,
                           refine_iters=refine_iters),
                   f"df_solve_spd_chol[{n}]")
