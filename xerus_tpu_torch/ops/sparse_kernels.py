"""Device-side sparse x dense contraction.

The port of ``xerus_tpu.ops.sparse_kernels``, the counterpart of the
reference's hand-written mixed sparse/dense GEMMs
(src/xerus/sparseTimesFullContraction.cpp:66-224): a matricized sparse
operand becomes COO index/value tensors, the product is a gather of dense
rows scaled by the values and a segment sum over output rows
(``index_add_``).  On the card every sparse x dense contraction takes
this path; under ``host()`` the scipy path (core/contract.py) keeps the
products below ``DEVICE_SPARSE_THRESHOLD`` dense result entries.  In float64 on the card ``index_add_`` sums in no fixed
order, so results agree with the host path to rounding, not bitwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# switch to the device path when dense rows * cols reaches this
DEVICE_SPARSE_THRESHOLD = 1 << 22


def _coo(positions: np.ndarray, values: np.ndarray, cols: int,
         dense: torch.Tensor):
    pos = torch.from_numpy(np.ascontiguousarray(positions, dtype=np.int64)
                           ).to(dense.device)
    vals = torch.tensor(values, dtype=dense.dtype, device=dense.device)
    return pos // cols, pos % cols, vals


def sparse_times_dense(positions: np.ndarray, values: np.ndarray,
                       sparse_shape: Tuple[int, int],
                       dense: torch.Tensor) -> torch.Tensor:
    """(sparse [m x k]) @ (dense [k x n]) -> dense [m x n]; positions are
    linear row-major indices into ``sparse_shape``."""
    m, k = sparse_shape
    rows, cols, vals = _coo(positions, values, k, dense)
    gathered = dense[cols] * vals[:, None]                  # (nnz, n)
    out = torch.zeros((m, dense.shape[1]), dtype=dense.dtype,
                      device=dense.device)
    return out.index_add_(0, rows, gathered)


def dense_times_sparse(dense: torch.Tensor, positions: np.ndarray,
                       values: np.ndarray,
                       sparse_shape: Tuple[int, int]) -> torch.Tensor:
    """(dense [m x k]) @ (sparse [k x n]) -> dense [m x n]."""
    k, n = sparse_shape
    rows, cols, vals = _coo(positions, values, n, dense)
    gathered = dense[:, rows] * vals[None, :]               # (m, nnz)
    out = torch.zeros((dense.shape[0], n), dtype=dense.dtype,
                      device=dense.device)
    return out.index_add_(1, cols, gathered)
