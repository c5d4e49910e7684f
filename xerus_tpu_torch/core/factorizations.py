"""Matrix factorizations and solves on matricized tensors.

The port of ``xerus_tpu.core.factorizations`` (the reference's
src/xerus/tensor.cpp:1361-1704, src/xerus/blasLapackWrapper.cpp:218-651)
on top of ``torch.linalg``, on the compute device: the card unless the
caller entered ``host()``.  All factorizations split the tensor's modes at
``split_pos`` into an (lhsSize x rhsSize) matrix.

Truncation semantics match the reference exactly:
* SVD (tensor.cpp:1424-1475): hard cap ``max_rank`` (0 = none), then drop
  sigma_j <= eps * sigma_0; S carries |factor|, a negative factor flips Vt.
* QC/CQ rank rule (blasLapackWrapper.cpp:262-361): first r with
  |R[r,r]| < 16*eps_machine*R[0,0], applied to the singular values of a
  thin SVD.  The JAX package's optional pivoted-QR route makes the same
  rank decisions more slowly and is not ported.

On the card the SVD runs cuSOLVER's gesvd: torch's default CUDA driver
(gesvdj) left a rounding 140x less accurate.  Least squares is the
minimum-norm solution through that SVD with ``jnp.linalg.lstsq``'s cutoff
eps * max(m, n), since torch's CUDA lstsq (gels) assumes full rank.
Sparse QR/QC/CQ and the sparse one-right-hand-side solve take the sparse
QR of ``sparse_qr.py`` (native Givens QR on the host, or one dense QR on
the compute device for wide rows) and give sparse outputs, densified
where desirable, as in the JAX package; where it declines (no library, a
structurally deficient QR, a densifying solve) the dense route runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import config, require
from ..misc.performance import pa_section
from .tensor import Tensor, Representation, _prod
from .contract import contract
from . import sparse_qr


def _split_sizes(t: Tensor, split_pos: int) -> Tuple[int, int, int]:
    require(0 <= split_pos <= t.degree(), "split position out of range")
    lhs = _prod(t.dimensions[:split_pos])
    rhs = _prod(t.dimensions[split_pos:])
    return lhs, rhs, min(lhs, rhs)


def _matrix(t: Tensor, rows: int, cols: int) -> torch.Tensor:
    return t._torch(apply_factor=False).reshape(rows, cols)


def _svd(a: torch.Tensor):
    """One thin SVD: gesvd on the card, LAPACK gesdd on the CPU."""
    if a.device.type == "cuda":
        return torch.linalg.svd(a, full_matrices=False, driver="gesvd")
    return torch.linalg.svd(a, full_matrices=False)


def _svd_robust(a: torch.Tensor):
    """Thin SVD that survives a driver's non-convergence.

    LAPACK gesdd can fail on real matrices (the committed fixture
    tests/data/gesdd_failure_96x96.npy made XLA's CPU SVD return nan
    silently; CPU torch raises or returns nan).  On a nan spectrum or a
    convergence error, retry with a second driver on ``a``'s device:
    cuSOLVER's Jacobi SVD (gesvdj) on the card, scipy's gesvd (plain
    QR-iteration bidiagonal SVD, the slower-but-robust classic) on the
    CPU.  A nan spectrum from the retry raises, as the reference treats
    LAPACK's info > 0 as an error rather than an answer
    (blasLapackWrapper.cpp:218-270)."""
    try:
        u, s, vt = _svd(a)
        if not bool(torch.isnan(s).any()):
            return u, s, vt
    except torch.linalg.LinAlgError:
        pass
    if a.device.type == "cuda":
        u, s, vt = torch.linalg.svd(a, full_matrices=False, driver="gesvdj")
        require(not bool(torch.isnan(s).any()),
                "SVD failed to converge (gesvd AND gesvdj): input likely "
                "contains non-finite values")
        return u, s, vt
    a_np = a.detach().numpy()
    from scipy.linalg import svd as _scipy_svd
    u2, s2, vt2 = _scipy_svd(a_np, full_matrices=False,
                             lapack_driver="gesvd")
    require(not np.isnan(s2).any(),
            "SVD failed to converge (gesdd AND gesvd): input likely "
            "contains non-finite values")
    return tuple(torch.from_numpy(x) for x in (u2, s2, vt2))


def calculate_svd(t: Tensor, split_pos: int, max_rank: int = 0,
                  eps: float = 0.0) -> Tuple[Tensor, Tensor, Tensor]:
    """(U, S, Vt) with U: dims[:split]+[r], S: r x r sparse-diag, Vt: [r]+dims[split:]."""
    require(0.0 <= eps < 1.0, "epsilon must fulfill 0 <= eps < 1")
    lhs_size, rhs_size, rank = _split_sizes(t, split_pos)
    a = _matrix(t, lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "Singular Value Decomposition",
                    f"{lhs_size}x{rhs_size}"):
        u, s, vt = _svd_robust(a)
        s_host = s.cpu().numpy()

    if max_rank:
        rank = min(rank, int(max_rank))
    # eps-truncation relative to sigma_0 (tensor.cpp:1468-1473)
    for j in range(1, rank):
        if s_host[j] <= eps * s_host[0]:
            rank = j
            break
    rank = max(rank, 1)

    U = Tensor._wrap(u[:, :rank].reshape(t.dimensions[:split_pos] + [rank]))
    Vt = Tensor._wrap(vt[:rank, :].reshape([rank] + t.dimensions[split_pos:]))
    S = Tensor([rank, rank], Representation.Sparse)
    f = abs(t.factor)
    for i in range(rank):
        S._sparse[i * rank + i] = f * float(s_host[i])
    if t.factor < 0.0:
        Vt.factor = -1.0
    return U, S, Vt


def _sparse_factorization_output(t: Tensor, split_pos: int, rank: int,
                                 lhs_flat, rhs_flat,
                                 rhs_factor: float) -> Tuple[Tensor, Tensor]:
    """The (lhs, rhs) sparse tensors of a sparse factorization, each
    densified where desirable (tensor.cpp:1495-1570 output handling)."""
    lhs = Tensor(t.dimensions[:split_pos] + [rank], Representation.Sparse)
    lhs._sparse = lhs_flat
    rhs = Tensor([rank] + t.dimensions[split_pos:], Representation.Sparse)
    rhs._sparse = rhs_flat
    rhs.factor = rhs_factor
    lhs.use_dense_representation_if_desirable()
    rhs.use_dense_representation_if_desirable()
    return lhs, rhs


def calculate_qr(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    lhs_size, rhs_size, rank = _split_sizes(t, split_pos)
    if t.is_sparse():
        # the SPQR path of tensor.cpp:1495-1503; plain QR must come out
        # full-rank, structurally deficient inputs take the dense route
        pos, vals = t.sparse_coo()
        out = sparse_qr.sparse_qc(pos, vals, lhs_size, rhs_size, 0.0)
        if out is not None and out[2] == rank:
            return _sparse_factorization_output(t, split_pos, rank, out[0],
                                                out[1], t.factor)
    a = _matrix(t, lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "QR Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        q, r = torch.linalg.qr(a, mode="reduced")
    Q = Tensor._wrap(q.reshape(t.dimensions[:split_pos] + [rank]))
    R = Tensor._wrap(r.reshape([rank] + t.dimensions[split_pos:]))
    R.factor = t.factor
    return Q, R


def calculate_rq(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    """A = R @ Q with Q having orthonormal rows (blasLapackWrapper.cpp:473-489),
    through the QR of the row-reversed transpose: A[::-1].T = q0 r0, so
    A = (r0.T reversed both ways)(q0.T rows reversed)."""
    lhs_size, rhs_size, rank = _split_sizes(t, split_pos)
    a = _matrix(t, lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "RQ Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        q0, r0 = torch.linalg.qr(torch.flip(a, [0]).T, mode="reduced")
    R = torch.flip(r0.T, [0, 1])   # lhs_size x rank, upper-trapezoid
    Q = torch.flip(q0.T, [0])      # rank x rhs_size, orthonormal rows
    Rt = Tensor._wrap(R.reshape(t.dimensions[:split_pos] + [rank]))
    Qt = Tensor._wrap(Q.reshape([rank] + t.dimensions[split_pos:]))
    Rt.factor = t.factor
    return Rt, Qt


_QC_RANK_EPS_MULT = 16.0


def _qc_tol() -> float:
    """The Heath rank tolerance of the sparse QC / CQ: 16 eps."""
    return _QC_RANK_EPS_MULT * float(np.finfo(config.value_dtype).eps)


def _qc_dense_factor(a: torch.Tensor):
    """Rank-revealing split of a dense (lhs, rhs) matrix: returns
    (basis, coeff, rank) with a = basis[:, :rank] @ coeff[:rank] and
    basis having orthonormal columns."""
    u, s, vt = _svd_robust(a)
    rank = _revealed_rank(s.cpu().numpy())
    return u, s[:, None] * vt, rank


def _revealed_rank(s_host: np.ndarray) -> int:
    """Rank rule of blasLapackWrapper.cpp:268-273 applied to singular values."""
    if s_host.size == 0:
        return 1
    # a nan spectrum must never silently read as 'rank 1' (nan >= cutoff
    # is False for every entry)
    require(not np.isnan(s_host).any(),
            "rank-revealing factorization received nan singular values")
    cutoff = _QC_RANK_EPS_MULT * float(np.finfo(config.value_dtype).eps) * float(s_host[0])
    rank = int(np.sum(s_host >= cutoff)) if s_host[0] > 0 else 1
    return max(rank, 1)


def calculate_qc(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    """Rank-revealing A = Q C, Q with orthonormal columns (tensor.cpp:1528).
    Sparse inputs take the sparse QR with the Heath rank rule
    |R_jj| >= 16 eps max|R_ii| (tensor.cpp:1532-1539)."""
    lhs_size, rhs_size, _ = _split_sizes(t, split_pos)
    if t.is_sparse():
        pos, vals = t.sparse_coo()
        out = sparse_qr.sparse_qc(pos, vals, lhs_size, rhs_size, _qc_tol())
        if out is not None:
            return _sparse_factorization_output(t, split_pos, out[2], out[0],
                                                out[1], t.factor)
    a = _matrix(t, lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "QRP Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        basis, coeff, rank = _qc_dense_factor(a)
    Q = Tensor._wrap(basis[:, :rank].reshape(
        t.dimensions[:split_pos] + [rank]))
    C = Tensor._wrap(coeff[:rank, :].reshape(
        [rank] + t.dimensions[split_pos:]))
    C.factor = t.factor
    return Q, C


def calculate_cq(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    """Rank-revealing A = C Q, Q with orthonormal rows (tensor.cpp:1548)."""
    lhs_size, rhs_size, _ = _split_sizes(t, split_pos)
    if t.is_sparse():
        pos, vals = t.sparse_coo()
        out = sparse_qr.sparse_cq(pos, vals, lhs_size, rhs_size, _qc_tol())
        if out is not None:
            C, Q = _sparse_factorization_output(t, split_pos, out[2],
                                                out[0], out[1], 1.0)
            C.factor = t.factor
            return C, Q
    a = _matrix(t, lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "QRP Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        basis, coeff, rank = _qc_dense_factor(a.T)
    C = Tensor._wrap(coeff[:rank, :].T.reshape(
        t.dimensions[:split_pos] + [rank]))
    Q = Tensor._wrap(basis[:, :rank].T.reshape(
        [rank] + t.dimensions[split_pos:]))
    C.factor = t.factor
    return C, Q


def pseudo_inverse(t: Tensor, split_pos: int) -> Tensor:
    """Moore-Penrose inverse via SVD (tensor.cpp:1568-1580)."""
    U, S, Vt = calculate_svd(t, split_pos, 0, config.epsilon)
    S.modify_diagonal_entries(lambda a: 1.0 / a)
    inv = contract(Vt, S, 1, lhs_trans=True)
    return contract(inv, U, 1, rhs_trans=True)


# ---------------------------------------------------------------------------
# Linear solves (tensor.cpp:1583-1704, blasLapackWrapper.cpp:501-651)
# ---------------------------------------------------------------------------

def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, with jnp.linalg.lstsq's
    rule: singular values below eps * max(m, n) * sigma_0 count as zero."""
    u, s, vt = _svd_robust(a)
    rcond = float(torch.finfo(a.dtype).eps) * max(a.shape)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv[:, None] * (u.T @ b))


def _all_ok(info: torch.Tensor, x: torch.Tensor) -> bool:
    """One host read: the factorization's info is 0 and x is finite."""
    return bool((info == 0) & torch.isfinite(x).all())


def _solve_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve with the reference's structure detection: symmetric ->
    try Cholesky (SPD fast path), fall back to LU / least squares
    (blasLapackWrapper.cpp:538-651).  The decisions are the JAX package's:
    symmetric iff max |A - A^T| <= 1e-13 max |A|, a route is taken iff it
    returns finite values.  ``b`` is (m, p); the performance counters
    (misc/performance.py) name the route taken."""
    m, n = a.shape
    p = b.shape[1]
    if m == n:
        asym, amax = torch.stack([(a - a.T).abs().max(),
                                  a.abs().max()]).tolist()
        scale = amax or 1.0
        if asym <= 1e-13 * scale:
            with pa_section("Dense LAPACK", "Solve (Cholesky)",
                            f"{m}x{n}x{p}"):
                L, info = torch.linalg.cholesky_ex(a)
                x = torch.cholesky_solve(b, L)
                ok = _all_ok(info, x)
            if ok:
                return x
        with pa_section("Dense LAPACK", "Solve (PLU)", f"{m}x{n}x{p}"):
            LU, piv, info = torch.linalg.lu_factor_ex(a)
            x = torch.linalg.lu_solve(LU, piv, b)
            ok = _all_ok(info, x)
        if ok:
            return x
    with pa_section("Dense LAPACK", "Solve Least Squares", f"{m}x{n}"):
        return _lstsq(a, b)


def _try_sparse_solve(A: Tensor, B: Tensor, m: int, n: int, p: int,
                      out_dims) -> Optional[Tensor]:
    """A sparse A with one right-hand side: the reference's SuiteSparseQR
    solve (tensor.cpp:1608-1630, cholmod_wrapper.cpp:173-225) on the
    host.  None where the sparse QR declines (the dense solve runs)."""
    if not (A.is_sparse() and p == 1):
        return None
    pos, vals = A.sparse_coo()
    b = B._torch(apply_factor=False).cpu().numpy().reshape(m)
    x = sparse_qr.sparse_solve_ls(pos, vals, m, n, b, float(config.epsilon))
    if x is None:
        return None
    X = Tensor.from_ndarray(x.reshape(out_dims))
    X.factor = B.factor / A.factor
    return X


def _solve_dims(A: Tensor, B: Tensor, extra_degree: int, what: str):
    deg_m = B.degree() - extra_degree
    deg_n = A.degree() - deg_m
    require(deg_n >= 0 and A.degree() == deg_m + deg_n,
            f"{what}: inconsistent dims")
    m = _prod(A.dimensions[:deg_m])
    n = _prod(A.dimensions[deg_m:])
    p = _prod(B.dimensions[deg_m:])
    return m, n, p, A.dimensions[deg_m:] + B.dimensions[deg_m:]


def _solution(x: torch.Tensor, out_dims, A: Tensor, B: Tensor) -> Tensor:
    X = Tensor._wrap(x.reshape(out_dims))
    X.factor = B.factor / A.factor
    return X


def solve(A: Tensor, B: Tensor, extra_degree: int = 0) -> Tensor:
    """Solve A x = b (tensor.cpp:1654-1704).  ``extra_degree`` trailing modes
    of B are independent right-hand sides."""
    m, n, p, out_dims = _solve_dims(A, B, extra_degree, "solve")
    X = _try_sparse_solve(A, B, m, n, p, out_dims)
    if X is not None:
        return X
    x = _solve_matrix(_matrix(A, m, n), _matrix(B, m, p))
    return _solution(x, out_dims, A, B)


def solve_least_squares(A: Tensor, B: Tensor, extra_degree: int = 0) -> Tensor:
    """min ||A X - B||_F (tensor.cpp:1583-1652)."""
    m, n, p, out_dims = _solve_dims(A, B, extra_degree, "lstsq")
    X = _try_sparse_solve(A, B, m, n, p, out_dims)
    if X is not None:
        return X
    with pa_section("Dense LAPACK", "Solve Least Squares",
                    f"{m}x{n} * {p}"):
        x = _lstsq(_matrix(A, m, n), _matrix(B, m, p))
    return _solution(x, out_dims, A, B)
