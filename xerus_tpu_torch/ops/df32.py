"""Double-word float32 ("double-float", df) arithmetic on torch tensors.

Counterpart of ``xerus_tpu/ops/df32.py``.  A df number is an unevaluated
sum hi + lo of two float32 tensors with |lo| <= ulp(hi)/2, about 49
significant bits: enough for 1e-12-level linear-algebra residuals without
float64 compute.

The primitives are error-free transformations that need only IEEE
round-to-nearest adds and multiplies.  PyTorch runs each operator as its
own kernel, so no compiler can contract a multiply and an add into an FMA
here; the mantissa split is nevertheless done by bit masking (``_split``),
as in the JAX package, so the code stays exact under any compiler:
  two_sum   -- Knuth 2Sum (adds only)
  two_prod  -- masked-split product (no FMA needed, FMA-tolerant)
Reductions are pairwise trees of df_add, so the accumulated error grows
with log K in df precision.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DF = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


# hi keeps 12 of f32's 24 significant bits; 26 of f64's 53 (27 cleared:
# hi*hi needs 52 bits and hi*lo at most 53, both exact)
_MASK32 = ~((1 << 12) - 1)
_MASK64 = ~((1 << 27) - 1)


def _split(a: torch.Tensor):
    """Exact high/low mantissa split by bit masking.

    Not the arithmetic Veltkamp split (c = a*(2^12+1); hi = c - (c - a)),
    which a compiler that contracts `c - a` into fma(a, SPLITTER, -a)
    silently breaks.  Masking the low half of the mantissa is exact by
    construction, and lo = a - hi is exact."""
    if a.dtype == torch.float64:
        hi = (a.view(torch.int64) & _MASK64).view(torch.float64)
    else:
        hi = (a.view(torch.int32) & _MASK32).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """Compensated product: p + err = a*b exactly (up to underflow).

    Both factors are split by masking and the four half-products, each
    exact, are summed by 2Sum; p is an add result, never a bare multiply."""
    ah, al = _split(a)
    bh, bl = _split(b)
    q1 = ah * bh
    q2 = ah * bl
    q3 = al * bh
    q4 = al * bl
    s, e1 = two_sum(q2, q3)
    p, e2 = two_sum(q1, s)
    err = e1 + e2 + q4
    return p, err


# ---------------------------------------------------------------------------
# df numbers: pairs (hi, lo) of equal-shape f32 tensors
# ---------------------------------------------------------------------------

def df_from_f64(x, device) -> DF:
    """Split host float64 data into a (hi, lo) float32 pair on ``device``."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def df_to_f64(hi, lo) -> np.ndarray:
    """hi + lo as a host float64 array."""
    return (hi.detach().cpu().numpy().astype(np.float64)
            + lo.detach().cpu().numpy().astype(np.float64))


def df_add(xh, xl, yh, yl):
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    return fast_two_sum(sh, te)


def df_neg(xh, xl):
    return -xh, -xl


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_mul(xh, xl, yh, yl):
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_scale(xh, xl, s):
    """Multiply by an exact f32 scalar."""
    ph, pe = two_prod(xh, s)
    pe = pe + xl * s
    return fast_two_sum(ph, pe)


def df_reduce_sum(xh, xl, axis: int):
    """Pairwise-tree sum along one axis in df precision."""
    axis = axis % xh.dim()
    n = xh.shape[axis]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad_shape = list(xh.shape)
        pad_shape[axis] = p - n
        zeros = xh.new_zeros(pad_shape)
        xh = torch.cat([xh, zeros], dim=axis)
        xl = torch.cat([xl, zeros], dim=axis)
    while xh.shape[axis] > 1:
        m = xh.shape[axis] // 2
        xh, xl = df_add(xh.narrow(axis, 0, m), xl.narrow(axis, 0, m),
                        xh.narrow(axis, m, m), xl.narrow(axis, m, m))
    return xh.squeeze(axis), xl.squeeze(axis)


def df_matvec(Ah, Al, xh, xl):
    """df matrix (m,k) @ df vector (k,) -> df (m,)."""
    ph, pl = df_mul(Ah, Al, xh[None, :], xl[None, :])
    return df_reduce_sum(ph, pl, axis=1)


# above this broadcast size (m*k*n elements), with k >= 128, df_matmul
# switches to the Ozaki split GEMM (ops/ozaki.py), as the JAX package does
OZAKI_MATMUL_THRESHOLD = 1 << 21


def df_matmul(Ah, Al, Bh, Bl):
    """df (m,k) @ df (k,n) -> df (m,n).

    Small problems: broadcast products + pairwise tree sum (O(m*k*n)
    memory, best accuracy).  GEMM-shaped f32 problems past the gate: the
    Ozaki split GEMM; for skinny k its fixed cost (splits, 14-21 GEMMs)
    loses to the broadcast tree."""
    m, k = Ah.shape
    n = Bh.shape[1]
    if (m * k * n >= OZAKI_MATMUL_THRESHOLD and k >= 128
            and Ah.dtype == torch.float32):
        from .ozaki import ozaki_matmul
        return ozaki_matmul(Ah, Al, Bh, Bl)
    ph, pl = df_mul(Ah[:, :, None], Al[:, :, None], Bh[None, :, :],
                    Bl[None, :, :])
    return df_reduce_sum(ph, pl, axis=1)


def df_contract_last_first(Ah, Al, Bh, Bl):
    """Contract the last axis of A with the first axis of B."""
    ash = tuple(Ah.shape)
    bsh = tuple(Bh.shape)
    k = ash[-1]
    oh, ol = df_matmul(Ah.reshape(-1, k), Al.reshape(-1, k),
                       Bh.reshape(k, -1), Bl.reshape(k, -1))
    out_shape = ash[:-1] + bsh[1:]
    return oh.reshape(out_shape), ol.reshape(out_shape)


# ---------------------------------------------------------------------------
# Refined linear solve: f32 Cholesky + df iterative refinement
# ---------------------------------------------------------------------------

# at and above this size (m*k) the refinement residual goes through the
# one-pass df matvec kernel (ops/df_matvec.py) instead of the log2(k)-pass
# broadcast reduction
PALLAS_MATVEC_THRESHOLD = 1 << 20


def df_solve_spd_refined(Ah, Al, bh, bl, iterations: int = 3):
    """Solve A x = b (SPD) to ~df accuracy: factorize hi in f32, then refine
    with df residuals.  Converges when kappa(A) * 2^-24 < 1.

    The Cholesky factor is only a preconditioner: the df refinement
    corrects its error, so its accuracy does not limit the residual.
    ``cholesky_ex`` skips the host-side check (no device sync)."""
    from .df_matvec import df_matvec as df_matvec_kernel   # imports df32

    L = torch.linalg.cholesky_ex(Ah)[0]
    matvec = (df_matvec_kernel
              if Ah.shape[0] * Ah.shape[1] >= PALLAS_MATVEC_THRESHOLD
              else df_matvec)

    def cho_solve(r):
        return torch.cholesky_solve(r[:, None], L)[:, 0].contiguous()

    xh = cho_solve(bh)
    xl = torch.zeros_like(xh)
    for _ in range(iterations):
        axh, axl = matvec(Ah, Al, xh, xl)          # r = b - A x in df
        rh, rl = df_sub(bh, bl, axh, axl)
        d = cho_solve(rh + rl)                     # f32 correction
        xh, xl = df_add(xh, xl, d, torch.zeros_like(d))
    return xh, xl
