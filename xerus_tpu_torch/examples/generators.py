"""Example problem generators: Laplace/Poisson MPO, low-rank test tensors.

The port's own copy of ``xerus_tpu/examples/generators.py``, which has no
JAX in it; random TTs draw from the library's random engine, so one
``set_seed`` gives the JAX package's tensors.

``peaking_diagonals`` mirrors src/xerus/examples/specificLowRankTensors.cpp:30-48;
the Laplace operator is the standard rank-2 MPO for sum_i I x..x L_i x..x I
(the d-dimensional Poisson problem of the quickstart,
doc/jekyll/_posts/1000-12-10-quickstart.md).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..config import config
from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor, TTOperator, dyadic_product


def _laplace_1d(n: int) -> np.ndarray:
    L = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    return L.astype(config.value_dtype)


def laplace_operator(dimensions: Sequence[int]) -> TTOperator:
    """Rank-2 MPO of the d-dimensional discrete Laplacian
    sum_i I x .. x L_i x .. x I with L = tridiag(-1, 2, -1)."""
    dims = [int(d) for d in dimensions]
    num = len(dims)
    comps: List[Tensor] = []
    for i, n in enumerate(dims):
        I = np.eye(n, dtype=config.value_dtype)
        L = _laplace_1d(n)
        if num == 1:
            core = L.reshape(1, n, n, 1)
        elif i == 0:
            core = np.zeros((1, n, n, 2), dtype=config.value_dtype)
            core[0, :, :, 0] = L
            core[0, :, :, 1] = I
        elif i == num - 1:
            core = np.zeros((2, n, n, 1), dtype=config.value_dtype)
            core[0, :, :, 0] = I
            core[1, :, :, 0] = L
        else:
            core = np.zeros((2, n, n, 2), dtype=config.value_dtype)
            core[0, :, :, 0] = I
            core[1, :, :, 0] = L
            core[1, :, :, 1] = I
        comps.append(Tensor.from_ndarray(core))
    return TTOperator._make(comps)


def poisson_rhs(dimensions: Sequence[int]) -> TTTensor:
    """Rank-1 all-ones right-hand side for the Poisson problem."""
    return TTTensor.ones(dimensions)


def random_low_rank(dimensions: Sequence[int], ranks, generator=None) -> TTTensor:
    """Random TT of given rank, normalized to unit frobenius norm."""
    t = TTTensor.random(dimensions, ranks, generator)
    nrm = t.frob_norm()
    if nrm > 0:
        t /= nrm
    return t


def heisenberg_mpo(d: int, Jx: float = 1.0, Jz: float = 1.0,
                   h: float = 0.0) -> TTOperator:
    """Rank-5 MPO of the spin-1/2 XXZ Heisenberg chain
    H = sum_i Jx/2 (S+_i S-_{i+1} + S-_i S+_{i+1}) + Jz Sz_i Sz_{i+1}
        - h sum_i Sz_i
    (BASELINE.json config 4's model; no reference counterpart)."""
    I = np.eye(2, dtype=config.value_dtype)
    Sp = np.array([[0, 1], [0, 0]], dtype=config.value_dtype)
    Sm = Sp.T.copy()
    Sz = 0.5 * np.array([[1, 0], [0, -1]], dtype=config.value_dtype)

    # W = [[I,          0,    0,    0,   0],
    #      [S+,         0,    0,    0,   0],
    #      [S-,         0,    0,    0,   0],
    #      [Sz,         0,    0,    0,   0],
    #      [-h Sz, Jx/2 S-, Jx/2 S+, Jz Sz, I]]
    W = np.zeros((5, 2, 2, 5), dtype=config.value_dtype)
    W[0, :, :, 0] = I
    W[1, :, :, 0] = Sp
    W[2, :, :, 0] = Sm
    W[3, :, :, 0] = Sz
    W[4, :, :, 0] = -h * Sz
    W[4, :, :, 1] = (Jx / 2.0) * Sm
    W[4, :, :, 2] = (Jx / 2.0) * Sp
    W[4, :, :, 3] = Jz * Sz
    W[4, :, :, 4] = I

    comps: List[Tensor] = []
    first = W[4:5, :, :, :]          # row vector: (1,2,2,5)
    last = W[:, :, :, 0:1]           # column vector: (5,2,2,1)
    for i in range(d):
        if d == 1:
            core = (-h * Sz).reshape(1, 2, 2, 1)
        elif i == 0:
            core = first
        elif i == d - 1:
            core = last
        else:
            core = W
        comps.append(Tensor.from_ndarray(core))
    return TTOperator._make(comps)


def peaking_diagonals(degree: int, n: int, alpha: float = 0.1) -> TTTensor:
    """Low-rank tensor with peaks along diagonals
    (specificLowRankTensors.cpp:30-48)."""
    assert degree >= 2 and n >= 2
    e1 = TTTensor(Tensor.ones([n]))
    cross_t = Tensor.from_function([n, n], lambda idx: (
        1.0 / (abs(idx[0] - idx[1]) + alpha)
        + 1.0 / (idx[0] + alpha) + 1.0 / (idx[1] + alpha)))
    cross = TTTensor(cross_t)
    result = cross.copy()
    buffer = e1.copy()
    while result.degree() < degree:
        result = dyadic_product(result, e1)
        tmp = dyadic_product(buffer, cross)
        result += tmp
        result.round(0.0)
        buffer = dyadic_product(buffer, e1)
    return result
