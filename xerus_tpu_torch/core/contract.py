"""Pairwise tensor contraction.

The port of ``xerus_tpu.core.contract``, the reference's ``xerus::contract``
(src/xerus/tensor.cpp:1252-1352): matricize both operands and run one GEMM.
Dense x dense is one ``torch.matmul`` on the compute device.  Sparse x
dense is a COO gather with a segment sum on the compute device
(``ops/sparse_kernels.py``, the sparseTimesFullContraction analogue): on
the card always, under ``host()`` from
``ops.sparse_kernels.DEVICE_SPARSE_THRESHOLD`` up and through scipy.sparse
below it, as in the JAX package.  Sparse x sparse multiplies the host
dicts with scipy.sparse.  Without a card and outside ``host()`` every
contraction raises ``RuntimeError``.

The result representation follows the reference's sparsity expectation rule
(tensor.cpp:1275-1279): sparse result iff both operands sparse and the
expected density is low.
"""

from __future__ import annotations

import numpy as np

from ..config import compute_device, require
from ..misc.performance import pa_section
from .tensor import Tensor, Representation, _prod


def contract(lhs: Tensor, rhs: Tensor, num_modes: int,
             lhs_trans: bool = False, rhs_trans: bool = False) -> Tensor:
    """Contract the last ``num_modes`` modes of lhs (first if ``lhs_trans``)
    with the first ``num_modes`` of rhs (last if ``rhs_trans``)."""
    num_modes = int(num_modes)
    lhs_open = lhs.degree() - num_modes
    rhs_open = rhs.degree() - num_modes
    require(lhs_open >= 0 and rhs_open >= 0, "contract: too many modes")

    if lhs_trans:
        lhs_open_dims = lhs.dimensions[num_modes:]
        lhs_con_dims = lhs.dimensions[:num_modes]
    else:
        lhs_open_dims = lhs.dimensions[:lhs_open]
        lhs_con_dims = lhs.dimensions[lhs_open:]
    if rhs_trans:
        rhs_open_dims = rhs.dimensions[:rhs_open]
        rhs_con_dims = rhs.dimensions[rhs_open:]
    else:
        rhs_open_dims = rhs.dimensions[num_modes:]
        rhs_con_dims = rhs.dimensions[:num_modes]
    require(list(lhs_con_dims) == list(rhs_con_dims),
            f"contract: contracted dims mismatch {lhs_con_dims} vs {rhs_con_dims}")

    out_dims = list(lhs_open_dims) + list(rhs_open_dims)
    m = _prod(lhs_open_dims)
    k = _prod(lhs_con_dims)
    n = _prod(rhs_open_dims)

    if lhs.is_sparse() or rhs.is_sparse():
        return _contract_sparse(lhs, rhs, lhs_trans, rhs_trans, m, k, n, out_dims)

    a = lhs._torch(apply_factor=False)
    b = rhs._torch(apply_factor=False)
    a2 = a.reshape(k, m).T if lhs_trans else a.reshape(m, k)
    b2 = b.reshape(n, k).T if rhs_trans else b.reshape(k, n)
    # host-side dispatch accounting (XERUS_PA_START/END around the GEMM,
    # blasLapackWrapper.cpp:177-193)
    with pa_section("Dense BLAS", "Matrix-Matrix-Multiplication",
                    f"{m}x{k} * {k}x{n}"):
        out = a2 @ b2
    result = Tensor._wrap(out.reshape(out_dims))
    result.factor = lhs.factor * rhs.factor
    return result


def _coo_matrix(t: Tensor, rows: int, cols: int, trans: bool):
    """A sparse tensor matricized to (rows, cols) as (linear row-major
    positions, values); a transposed view is stored as (cols, rows)."""
    pos, val = t.sparse_coo()
    if trans:
        pos = (pos % rows) * cols + pos // rows
    return pos, val


def _dense_matrix(t: Tensor, rows: int, cols: int, trans: bool):
    a = t._torch(apply_factor=False)
    return a.reshape(cols, rows).T if trans else a.reshape(rows, cols)


def _to_csr(t: Tensor, rows: int, cols: int, trans: bool):
    import scipy.sparse as sp
    pos, val = _coo_matrix(t, rows, cols, trans)
    return sp.csr_matrix((val, (pos // cols, pos % cols)), shape=(rows, cols))


def _contract_sparse(lhs: Tensor, rhs: Tensor, lhs_trans: bool, rhs_trans: bool,
                     m: int, k: int, n: int, out_dims) -> Tensor:
    import scipy.sparse as sp
    from ..ops.sparse_kernels import (DEVICE_SPARSE_THRESHOLD,
                                      sparse_times_dense, dense_times_sparse)
    dev = compute_device()
    factor = lhs.factor * rhs.factor
    both_sparse = lhs.is_sparse() and rhs.is_sparse()

    # Mixed sparse x dense runs on the compute device (gather + segment
    # sum, ops/sparse_kernels.py: the sparseTimesFullContraction
    # equivalent): on the card at every size, under host() from
    # DEVICE_SPARSE_THRESHOLD result entries up, scipy below it.
    if not both_sparse and (dev.type != "cpu"
                            or m * n >= DEVICE_SPARSE_THRESHOLD):
        with pa_section("Mixed BLAS", "Matrix-Matrix-Multiplication",
                        f"{m}x{k} * {k}x{n}"):
            if lhs.is_sparse():
                pos, val = _coo_matrix(lhs, m, k, lhs_trans)
                out = sparse_times_dense(pos, val, (m, k),
                                         _dense_matrix(rhs, k, n, rhs_trans))
            else:
                pos, val = _coo_matrix(rhs, k, n, rhs_trans)
                out = dense_times_sparse(_dense_matrix(lhs, m, k, lhs_trans),
                                         pos, val, (k, n))
        res = Tensor._wrap(out.reshape(out_dims))
        res.factor = factor
        return res

    # two sparse operands (host dicts), or a small mixed product under
    # host(): scipy on the host, as in the JAX package
    if lhs.is_sparse():
        a = _to_csr(lhs, m, k, lhs_trans)
    else:
        arr = lhs._dense_host().reshape((k, m) if lhs_trans else (m, k))
        a = arr.T if lhs_trans else arr
    if rhs.is_sparse():
        b = _to_csr(rhs, k, n, rhs_trans)
    else:
        arr = rhs._dense_host().reshape((n, k) if rhs_trans else (k, n))
        b = arr.T if rhs_trans else arr

    with pa_section("Mixed BLAS", "Matrix-Matrix-Multiplication",
                    f"{m}x{k} * {k}x{n}"):
        prod = a @ b  # scipy: sparse*dense, dense*sparse, sparse*sparse

    if both_sparse and sp.issparse(prod):
        # Result sparse iff expected density low (tensor.cpp:1275-1279):
        # keep sparse if nnz * sparsityFactor < size.
        coo = prod.tocoo()
        if coo.nnz * Tensor.sparsityFactor < m * n:
            out = Tensor(out_dims, Representation.Sparse)
            lin = coo.row.astype(np.int64) * n + coo.col.astype(np.int64)
            for p, v in zip(lin, coo.data):
                out._sparse[int(p)] = out._sparse.get(int(p), 0.0) + float(v)
            out.factor = factor
            return out
        prod = coo.toarray()
    elif sp.issparse(prod):
        prod = prod.toarray()
    out = Tensor(out_dims, Representation.Dense,
                 data=np.asarray(prod).reshape(out_dims))
    out.factor = factor
    return out
