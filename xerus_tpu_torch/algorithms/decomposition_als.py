"""ALS approximation of a dense tensor by a TT.

Counterpart of ``xerus_tpu/algorithms/decomposition_als.py``, the
re-design of src/xerus/algorithms/decompositionAls.cpp:28-66: per
position, project the dense target onto the orthogonal frame around the
core, on the objects' device.
"""

from __future__ import annotations

import torch

from ..config import config
from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor


def _project_position(x: TTTensor, b_arr: torch.Tensor, pos: int) -> None:
    """x.component(pos) = (left frame)^T b (right frame)."""
    x.move_core(pos)
    d = x.degree()
    # contract b with the (orthogonal) components left of pos, then right
    cur = b_arr.reshape((1,) + tuple(x.dimensions) + (1,))
    for i in range(pos):
        cur = torch.einsum("anb,an...->b...", x.components[i]._torch(), cur)
    for i in range(d - 1, pos, -1):
        cur = torch.einsum("...nb,anb->...a", cur, x.components[i]._torch())
    x.components[pos] = Tensor._wrap(cur)        # (rl, n_pos, rr)
    x.assume_core_position(pos)


def _distance(x: TTTensor, b_arr: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to_tensor()._torch() - b_arr))


def decomposition_als(x: TTTensor, b: Tensor, eps: float = 1e-6,
                      max_iterations: int = 100) -> None:
    b_arr = b._torch()
    last_residual = _distance(x, b_arr)
    for _ in range(max_iterations):
        for pos in range(x.degree()):
            _project_position(x, b_arr, pos)
        for pos in range(x.degree() - 2, 0, -1):
            _project_position(x, b_arr, pos)
        residual = _distance(x, b_arr)
        if residual < config.epsilon or \
                (last_residual - residual) / (residual or 1.0) < eps:
            return
        last_residual = residual
