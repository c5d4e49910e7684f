"""Householder QR with column pivoting (dgeqp3 semantics), as a program.

Counterpart of ``xerus_tpu/ops/pivoted_qr.py``.  The reference's
rank-revealing QC / CQ is LAPACK dgeqp3 plus the rank rule
|R[r,r]| < 16 eps |R[0,0]| (blasLapackWrapper.cpp:262-361); neither
torch nor XLA ships a pivoted QR (``torch.linalg.qr`` takes no pivoting),
so ``core/factorizations.py`` takes this route when
``XERUS_TPU_QC_METHOD=qrp`` and the SVD rank rule otherwise.

Design, step for step the JAX package's: classic column-pivoted
Householder with row / column masks standing in for the shrinking
trailing block (static shapes), the trailing column norms recomputed at
every step (no downdate drift), Q accumulated m x m and sliced at the
end.  The loop is unrolled in Python; every index and mask stays on the
device (the pivot is an ``argmax`` tensor and the swap a gathered index
vector), so the function reads nothing to the host and ``make_qrp``
captures it whole as one CUDA graph per shape (``ops/programs.py``).
``argmax`` takes the first maximal index on both packages, so the pivot
sequences agree up to ties in the rounding noise past the numerical
rank.
"""

from __future__ import annotations

import torch

from .programs import Program, dtype_str, factory


def householder_qrp(a: torch.Tensor):
    """A[:, perm] = Q @ R with R upper-triangular, |diag R| non-increasing
    (greedy column pivoting).

    Returns (q, r, perm): q (m, k) orthonormal columns, r (k, n) upper
    triangular, perm (n,) int32 with a[:, perm] = q @ r, k = min(m, n).
    Runs eagerly on ``a``'s device."""
    m, n = a.shape
    k = min(m, n)
    dtype, dev = a.dtype, a.device
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    A = a
    Q = torch.eye(m, dtype=dtype, device=dev)
    perm = torch.arange(n, device=dev)
    for j in range(k):
        rowmask = (rows >= j).to(dtype)                  # trailing rows
        # -- pivot: trailing column with the largest partial norm --------
        norms2 = torch.sum((A * rowmask[:, None]) ** 2, dim=0)
        p = torch.argmax(torch.where(cols >= j, norms2, -1.0))
        # -- swap columns j <-> p (gather by the swapped index vector) ---
        swap = torch.where(cols == j, p, torch.where(cols == p, j, cols))
        A = A.index_select(1, swap)
        perm = perm.index_select(0, swap)
        # -- Householder reflector on the trailing part of column j ------
        x = A[:, j] * rowmask
        sigma = torch.sqrt(torch.sum(x * x))
        xj = x[j]
        alpha = -torch.sign(torch.where(xj == 0, 1.0, xj)) * sigma
        v = x - alpha * (rows == j).to(dtype)
        vnorm2 = torch.sum(v * v)
        # the where selects 0 before an inf (float32 flushes the clamp's
        # 1e-300 to 0) can reach the update
        beta = torch.where(vnorm2 > 0,
                           2.0 / torch.clamp(vnorm2, min=1e-300), 0.0)
        A = A - beta * torch.outer(v, v @ A)
        # exact zeros below the diagonal of the finished column
        A = torch.where((rows[:, None] > j) & (cols == j), 0.0, A)
        Q = Q - beta * torch.outer(Q @ v, v)
    return Q[:, :k], A[:k], perm.to(torch.int32)


@factory(64)
def make_qrp(shape, dtype_str: str) -> Program:
    """``householder_qrp`` as a program for contiguous (m, n) inputs of
    one dtype (the JAX package's ``make_qrp``)."""
    return Program(householder_qrp, f"qrp[{shape[0]}x{shape[1]}]")


def qrp(a: torch.Tensor):
    """``householder_qrp`` through its program, cached per shape: replayed
    on the card, eager on the CPU."""
    a = a.contiguous()
    return make_qrp(tuple(a.shape), dtype_str(a))(a)
