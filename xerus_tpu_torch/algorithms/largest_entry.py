"""Largest-entry search in a TT.

Counterpart of ``xerus_tpu/algorithms/largest_entry.py``, the re-design of
include/xerus/algorithms/largestEntry.h:34-37,
src/xerus/algorithms/largestEntry.cpp:30-54: iterate entrywise squaring +
soft thresholding until the rank collapses, then take the per-core argmax
of the resulting (near) rank-one TT.  A TT of at most 65,536 entries is
contracted and its argmax taken instead.  ``find_largest_entry`` takes a
``TTTensor`` / ``TTOperator`` and computes where the TT objects compute
(the card unless the caller entered ``host()``); ``find_largest_entry_cores``
takes a list of (rl, n, rr) torch cores.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.tensor import Tensor
from ..tt.ttnetwork import TTNetwork, TTTensor, entrywise_product

EXACT_LIMIT = 65536


def full_tensor(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """The TT contracted to a dense tensor of its mode sizes."""
    t = cores[0].new_ones((1, 1))
    for c in cores:
        t = torch.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape([int(c.shape[1]) for c in cores])


def find_largest_entry(T: TTNetwork, accuracy: float = 0.0,
                       lower_bound: float = 0.0) -> int:
    """Linear (row-major) position of the entry of largest absolute value.

    Exact for at most 65,536 entries (``accuracy`` permits an approximate
    answer; the exact argmax always satisfies it); larger TTs run the
    squaring / soft-threshold iteration, which finds an entry within a
    factor (1 - accuracy) of the largest."""
    if (int(np.prod(T.dimensions, dtype=object)) <= EXACT_LIMIT
            and not T.is_operator):
        return int(torch.argmax(T.to_tensor()._torch().abs().reshape(-1)))
    return _find_largest_entry(T, accuracy, lower_bound)


def _find_largest_entry(T: TTNetwork, accuracy: float = 0.0,
                        lower_bound: float = 0.0) -> int:
    if sum(T.ranks()) >= T.degree() and T.degree() > 0:
        alpha = accuracy
        X = T.copy()
        X.round(1)
        Xn = max(T[_find_largest_entry(X, 0.0, 0.0)], lower_bound)
        tau = (1 - alpha) * alpha * Xn * Xn / (2.0 * max(T.degree() - 1, 1))

        X = T.copy()
        while sum(X.ranks()) >= T.degree():
            X = entrywise_product(X, X)
            X.soft_threshold(tau, True)

            Y = X.copy()
            Y.round(1)
            y_max_pos = _find_largest_entry(Y, 0.0, 0.0)
            Xn = max(X[list(Tensor.position_to_multiIndex(y_max_pos,
                                                          X.dimensions))],
                     (1 - (1 - alpha) * alpha / 2.0) * Xn * Xn)
            f_norm = X.frob_norm()
            Xn /= f_norm
            X /= f_norm
            tau = (1 - alpha) * alpha * Xn * Xn / (2.0 * max(T.degree() - 1, 1))
        return _find_largest_entry(X, 0.0, 0.0)

    # (near) rank one: per-core argmax (largestEntry.cpp:37-52)
    num = T.num_components()
    position = 0
    factor = int(np.prod(T.dimensions, dtype=object))
    for c in range(num):
        local_size = T.dimensions[c]
        if T.is_operator:
            local_size *= T.dimensions[num + c]
        factor //= local_size
        comp = T.components[c]._torch().abs().reshape(-1)
        position += int(torch.argmax(comp)) * factor
    return position


def find_largest_entry_cores(cores: Sequence[torch.Tensor],
                             accuracy: float = 0.0,
                             lower_bound: float = 0.0) -> int:
    """``find_largest_entry`` of the TT ``cores``: the exact argmax on the
    cores' device; a larger TT as a ``TTTensor`` of the cores."""
    dims = [int(c.shape[1]) for c in cores]
    if int(np.prod(dims, dtype=object)) <= EXACT_LIMIT:
        return int(torch.argmax(full_tensor(cores).abs().reshape(-1)))
    return _find_largest_entry(
        TTTensor._make([Tensor._wrap(c) for c in cores]), accuracy,
        lower_bound)
