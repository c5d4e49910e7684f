"""Ozaki-scheme split GEMM: float64-quality products from exact GEMMs.

Counterpart of ``xerus_tpu/ops/ozaki.py``.  Each factor is split into
slices with few enough mantissa bits that every pairwise slice product is
EXACT in ordinary float32 accumulation; the slice products are then summed
in double-word arithmetic (ops/df32.py), smallest terms first.

Error budget for df inputs (hi, lo) with slice width delta and s slices:
  - hi x hi slice products: exact (2*delta + ceil(log2 k) <= 24)
  - remainder/lo correction GEMMs in float32: relative error 2^-24 on
    terms of magnitude 2^(-s*delta) resp. 2^-24 -> ~2^-48 overall.

The slice products are library GEMMs.  On the card they run as bfloat16
inputs with a float32 result (a slice holds <= 8 mantissa bits, so the
bf16 cast is exact and the tensor cores' float32 accumulation sums
integers below 2^24 in the slice's units); on the CPU, whose torch has no
bf16 -> f32 product, as float32 inputs without TF32 (``config.py`` pins
that), which is exact for the same reason.  The corrections always run in
full float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .df32 import df_add


def _slice_width(k: int) -> int:
    """Mantissa bits per slice: exact pairwise f32 accumulation over k terms
    needs 2*delta + ceil(log2 k) <= 24; bf16 representability needs
    delta <= 8."""
    return max(1, min(8, (24 - int(np.ceil(np.log2(max(k, 2))))) // 2))


def ozaki_split(A: torch.Tensor, axis: int, delta: int, s: int
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Error-free split A = sum(slices) + remainder along the contraction
    axis.  Each slice keeps the top ``delta`` unconsumed mantissa bits
    relative to the per-row (axis=1) or per-column (axis=0) maximum;
    S = (R + sigma) - sigma is exact, as is the remainder R - S.  The
    exponent comes through log2/ceil/exp2: a log2 one ulp off at a power
    of two picks another, equally error-free split."""
    dtype = A.dtype
    tiny = torch.finfo(dtype).tiny
    slices = []
    R = A
    for _ in range(s):
        mu = R.abs().amax(dim=axis, keepdim=True)
        e = torch.ceil(torch.log2(torch.clamp_min(mu, tiny)))
        sigma = torch.exp2(e + (24 - delta)).to(dtype)
        S = (R + sigma) - sigma
        R = R - S
        slices.append(S)
    return slices, R


def _gemm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _gemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of two slice matrices (<= 8 mantissa bits each)."""
    if a.is_cuda:
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.float32)
    return a @ b


def ozaki_matmul(Ah: torch.Tensor, Al: torch.Tensor, Bh: torch.Tensor,
                 Bl: torch.Tensor, num_slices: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """df (m,k) @ df (k,n) -> df (m,n) via the Ozaki split scheme: s*s
    exact slice GEMMs, 5 float32 correction GEMMs and s*s + 5 df adds;
    O(m*n) memory."""
    k = Ah.shape[1]
    delta = _slice_width(k)
    s = num_slices or int(np.ceil(24 / delta))

    A_sl, Ra = ozaki_split(Ah, axis=1, delta=delta, s=s)
    B_sl, Rb = ozaki_split(Bh, axis=0, delta=delta, s=s)

    # smallest-magnitude terms first (corrections, then slice products by
    # descending i + j), so the df renormalization never swallows
    # low-order mass under a dominant partial sum
    ch = Ah.new_zeros((Ah.shape[0], Bh.shape[1]))
    cl = torch.zeros_like(ch)
    corrections = (
        _gemm_f32(Al, Bl),
        _gemm_f32(Ra, Bh),          # remainder of A times full B-hi
        _gemm_f32(Ah - Ra, Rb),     # consumed part of A times B remainder
        _gemm_f32(Al, Bh),
        _gemm_f32(Ah, Bl),
    )
    for t in corrections:
        ch, cl = df_add(ch, cl, t, torch.zeros_like(t))
    order = sorted(((i, j) for i in range(s) for j in range(s)),
                   key=lambda ij: -(ij[0] + ij[1]))
    for i, j in order:
        t = _gemm_exact(A_sl[i], B_sl[j])
        ch, cl = df_add(ch, cl, t, torch.zeros_like(t))
    return ch, cl


def ozaki_matmul_f32(A: torch.Tensor, B: torch.Tensor, num_slices: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-f32 inputs -> df-accurate product (hi, lo)."""
    return ozaki_matmul(A, torch.zeros_like(A), B, torch.zeros_like(B),
                        num_slices)
