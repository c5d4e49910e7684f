"""Sparse QR: ctypes bridge to the native Givens QR (``native/sparseqr.cpp``)
and the dense Heath route.

The port of ``xerus_tpu/core/sparse_qr.py`` (the reference's SPQR paths,
src/xerus/cholmod_wrapper.cpp:178-266, consumed by tensor.cpp:1495-1570):
sparse-in/sparse-out thin QR with Heath-style rank detection and a
fill-reducing column preorder.  The library is compiled from the JAX
package's source with g++ and the flags of ``native/Makefile`` into
``xerus_tpu_torch/_build/`` (``build.build_host_library``), so nothing
under ``native/`` is written.  Sparse tensors are host dicts in both
packages, so the native route runs on the host; the dense Heath route's
Householder QR runs on the compute device in float64 (the card unless the
caller entered ``host()``) and its rank cascade on the host.  When the
library cannot be built, ``native_available()`` is False and the native
entries return None, which sends callers to the dense route, as in the
JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import build
from ..config import compute_device

_LIB = None
_TRIED = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)

# Fill-reducing column preorder (native/sparseqr.cpp column_order):
# 0 natural, 1 ascending column count (George-Heath's recommendation),
# 2 greedy min-degree on the A^T A column-intersection graph; the JAX
# package's default and environment variable
DEFAULT_ORDERING = int(os.environ.get("XERUS_TPU_SPARSEQR_ORDERING", "1"))

# Mean row span above which a pattern of min(m, n) >= 64 takes the dense
# Heath route (the JAX package's measured boundary,
# benchmarks/sparseqr_scale.json and sparseqr_ordering.json): fill stays
# within the row profile, so wide rows densify R under every ordering
ROW_SPAN_NATIVE_LIMIT = float(os.environ.get(
    "XERUS_TPU_SPARSEQR_SPAN_LIMIT", "16"))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(build.build_host_library("sparseqr"))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.sqr_factor_ord.restype = ctypes.c_void_p
    lib.sqr_factor_ord.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, _I64P, _I64P, _F64P,
                                   ctypes.c_double, ctypes.c_int64]
    for name in ("sqr_rank", "sqr_q_nnz", "sqr_r_nnz"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name in ("sqr_get_q", "sqr_get_r"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, _I64P, _I64P, _F64P]
    lib.sqr_get_pivots.restype = None
    lib.sqr_get_pivots.argtypes = [ctypes.c_void_p, _I64P]
    lib.sqr_free.restype = None
    lib.sqr_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    return build.host_library_path("sparseqr")


def _factor_raw(pos: np.ndarray, vals: np.ndarray, m: int, n: int,
                rel_tol: float, ordering: Optional[int] = None):
    """Factor and extract raw COO arrays: (q_rows, q_cols, q_vals, r_rows,
    r_cols, r_vals, rank, pivots), or None without the library or for a
    numerically empty matrix.  ``pivots[k]`` is the original column of
    row k's pivot: under a fill-reducing ordering R is triangular in
    elimination order, not in column order."""
    lib = _load()
    if lib is None:
        return None
    if ordering is None:
        ordering = DEFAULT_ORDERING
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    rows = np.ascontiguousarray(pos // n)
    cols = np.ascontiguousarray(pos % n)
    h = lib.sqr_factor_ord(m, n, pos.size, rows.ctypes.data_as(_I64P),
                           cols.ctypes.data_as(_I64P),
                           vals.ctypes.data_as(_F64P), float(rel_tol),
                           int(ordering))
    if not h:
        return None
    try:
        rank = lib.sqr_rank(h)
        if rank == 0:
            return None
        qn, rn = lib.sqr_q_nnz(h), lib.sqr_r_nnz(h)
        q = [np.empty(qn, np.int64), np.empty(qn, np.int64),
             np.empty(qn, np.float64)]
        r = [np.empty(rn, np.int64), np.empty(rn, np.int64),
             np.empty(rn, np.float64)]
        piv = np.empty(rank, np.int64)
        lib.sqr_get_q(h, q[0].ctypes.data_as(_I64P),
                      q[1].ctypes.data_as(_I64P), q[2].ctypes.data_as(_F64P))
        lib.sqr_get_r(h, r[0].ctypes.data_as(_I64P),
                      r[1].ctypes.data_as(_I64P), r[2].ctypes.data_as(_F64P))
        lib.sqr_get_pivots(h, piv.ctypes.data_as(_I64P))
    finally:
        lib.sqr_free(h)
    return (*q, *r, int(rank), piv)


def mean_row_span(pos: np.ndarray, m: int, n: int) -> float:
    """Mean column span (max - min + 1) of the occupied rows: the fill
    predictor of the Givens elimination."""
    if not pos.size:
        return 0.0
    rows = pos // n
    cols = pos % n
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s = rows[order], cols[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(rows_s)) + 1])
    spans = (np.maximum.reduceat(cols_s, starts)
             - np.minimum.reduceat(cols_s, starts) + 1)
    return float(spans.mean())


def _takes_dense_route(pos: np.ndarray, m: int, n: int) -> bool:
    return (min(m, n) >= 64 and pos.size > 0
            and os.environ.get("XERUS_TPU_SPARSEQR_FORCE_NATIVE") != "1"
            and mean_row_span(pos, m, n) > ROW_SPAN_NATIVE_LIMIT)


def _flat_dict(mat: np.ndarray) -> Dict[int, float]:
    """{row * cols + col: value} over the nonzeros of a dense matrix."""
    nz = np.flatnonzero(mat)
    return dict(zip(nz.tolist(), mat.reshape(-1)[nz].tolist()))


def dense_heath_qc(pos: np.ndarray, vals: np.ndarray, m: int, n: int,
                   rel_tol: float
                   ) -> Tuple[Dict[int, float], Dict[int, float], int]:
    """QC through one dense Householder QR with the native path's rank
    semantics: the QR of the densified matrix in float64 on the compute
    device (the CPU inside ``host()``), then, on the host, the Heath cascade
    the Givens code runs (zero the tiny pivot, re-eliminate the row's
    remainder with its companion Q column by Givens rotations;
    |R_jj| < rel_tol * max diagonal, recomputed each pass).  The same
    steps as the JAX package's, with the slots held as rows of one (n, n)
    array and columns of one (m, n) array.

    Like the JAX package's, it densifies with no size guard: the card
    holds the (m, n) matrix and its Q and R."""
    dev = compute_device()
    pos = np.asarray(pos, dtype=np.int64)
    A = torch.zeros((m, n), dtype=torch.float64, device=dev)
    A.view(-1)[torch.from_numpy(pos).to(dev)] = torch.as_tensor(
        np.asarray(vals, np.float64)).to(dev)
    Qd, Rd = torch.linalg.qr(A)            # Q: (m, k), R: (k, n)
    Qd, Rd = Qd.cpu().numpy(), Rd.cpu().numpy()
    del A
    k = Rd.shape[0]
    R = np.zeros((n, n))
    Qc = np.zeros((m, n))
    R[:k] = Rd
    Qc[:, :k] = Qd
    live = np.zeros(n, dtype=bool)
    live[:k] = np.any(Rd != 0.0, axis=1)
    R[~live] = 0.0
    Qc[:, ~live] = 0.0
    idx = np.arange(n)
    if rel_tol > 0.0:
        while live.any():
            diag = np.abs(R[idx, idx])
            cut = rel_tol * diag[live].max()
            dead_all = np.flatnonzero(live & (diag < cut))
            if not dead_all.size:
                break
            dead = int(dead_all[0])
            row = R[dead].copy()
            v = Qc[:, dead].copy()
            live[dead] = False
            R[dead] = 0.0
            Qc[:, dead] = 0.0
            row[dead] = 0.0                  # drop the tiny pivot entry
            nz = np.flatnonzero(row)
            while nz.size:
                j = int(nz[0])
                if not live[j]:
                    R[j] = row
                    Qc[:, j] = v
                    live[j] = True
                    break
                r0, a0 = R[j, j], row[j]
                den = np.hypot(r0, a0)
                c, s = r0 / den, a0 / den
                rj = R[j].copy()
                R[j], row = c * rj + s * row, c * row - s * rj
                qj = Qc[:, j].copy()
                Qc[:, j], v = c * qj + s * v, c * v - s * qj
                row[j] = 0.0
                nz = np.flatnonzero(row)
    kept = np.flatnonzero(live)
    rank = int(kept.size)
    if rank == 0:
        return {}, {}, 0
    return (_flat_dict(np.ascontiguousarray(Qc[:, kept])),
            _flat_dict(np.ascontiguousarray(R[kept])), rank)


def sparse_qc(pos: np.ndarray, vals: np.ndarray, m: int, n: int,
              rel_tol: float, ordering: Optional[int] = None
              ) -> Optional[Tuple[Dict[int, float], Dict[int, float], int]]:
    """Factor the m x n matrix with flat-position COO data ``pos/vals`` as
    A = Q C (Q: m x r orthonormal columns, C: r x n), rank-revealed with
    ``rel_tol`` (|R_jj| >= rel_tol * max diagonal kept; 0 = structural
    only).  Returns (q_flat_dict, c_flat_dict, rank), or None when no
    route is available or the matrix is numerically empty.

    Narrow-profile patterns (banded, structured: the regime of TT sparse
    cores) run the native row-Givens kernel on the host; rows wider than
    ``ROW_SPAN_NATIVE_LIMIT`` on average take ``dense_heath_qc``, the same
    rank rule through one dense QR on the compute device."""
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    if _takes_dense_route(pos, m, n):
        q, c, rank = dense_heath_qc(pos, vals, m, n, rel_tol)
        return (q, c, rank) if rank else None
    out = _factor_raw(pos, vals, m, n, rel_tol, ordering)
    if out is None:
        return None
    qr_, qc_, qv, rr, rc, rv, rank, _piv = out
    q = dict(zip((qr_ * rank + qc_).tolist(), qv.tolist()))
    c = dict(zip((rr * n + rc).tolist(), rv.tolist()))
    return q, c, rank


def sparse_solve_ls(pos: np.ndarray, vals: np.ndarray, m: int, n: int,
                    b: np.ndarray, rel_tol: float,
                    ordering: Optional[int] = None) -> Optional[np.ndarray]:
    """Least-squares / basic solve of the sparse m x n system A x ~= b
    through the native QR (the reference's SuiteSparseQR solve,
    cholmod_wrapper.cpp:173-225): factor A = Q C, then back-substitute
    C x = Q^T b over the kept columns (dead columns get x = 0, SPQR's
    basic solution).  Returns None without the library, or when the
    row-span predictor says the pattern densifies (the caller's dense
    solve is the right class there)."""
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    if _takes_dense_route(pos, m, n):
        return None
    out = _factor_raw(pos, vals, m, n, rel_tol, ordering)
    if out is None:
        return None
    qr_, qc_, qv, rr, rc, rv, rank, piv = out
    b = np.asarray(b, dtype=np.float64).reshape(m)
    y = np.zeros(rank, np.float64)
    np.add.at(y, qc_, qv * b[qr_])                 # y = Q^T b
    crows: list = [[] for _ in range(rank)]
    for k, c, v in zip(rr.tolist(), rc.tolist(), rv.tolist()):
        crows[k].append((c, v))
    x = np.zeros(n, np.float64)
    # R is triangular in elimination order: row k's pivot column is
    # piv[k] and its tail touches only pivots of rows > k
    for k in range(rank - 1, -1, -1):
        pivot = int(piv[k])
        acc = y[k]
        lead_val = 0.0
        for col, v in crows[k]:
            if col == pivot:
                lead_val = v
            else:
                acc -= v * x[col]
        x[pivot] = acc / lead_val
    return x


def sparse_cq(pos: np.ndarray, vals: np.ndarray, m: int, n: int,
              rel_tol: float, ordering: Optional[int] = None
              ) -> Optional[Tuple[Dict[int, float], Dict[int, float], int]]:
    """A = C Q (C: m x r, Q: r x n orthonormal rows) via QC of the
    transpose (cholmod_wrapper.cpp:255-266)."""
    pos = np.asarray(pos, dtype=np.int64)
    t_pos = (pos % n) * m + pos // n           # transpose: (n x m)
    out = sparse_qc(t_pos, vals, n, m, rel_tol, ordering)
    if out is None:
        return None
    qt, ct, rank = out                 # A^T = Q' C'  ->  A = C'^T Q'^T
    c = {(p % m) * rank + (p // m): v for p, v in ct.items()}
    q = {(p % rank) * n + (p // rank): v for p, v in qt.items()}
    return c, q, rank
