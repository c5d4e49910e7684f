"""Problem-family builders — the library's "model zoo".

xerus is a numerical tensor library, so its model families are canonical
problem instances rather than neural networks (SURVEY.md: the reference
ships them as examples/, src/xerus/examples/*):

* QTT Poisson:      ``poisson_problem(d)`` -> (A, b, x0)
* Heisenberg chain: ``heisenberg_groundstate_problem(d)`` -> (H, x0)
* Completion:       ``completion_problem(dims, rank, num_meas)``

The port's own copy of ``xerus_tpu/models/__init__.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..tt.ttnetwork import TTTensor, TTOperator
from ..examples import (laplace_operator, poisson_rhs, heisenberg_mpo,
                        peaking_diagonals, random_low_rank,
                        inverse_index_norm, inverse_index_ratio)
from ..algorithms.measurements import SinglePointMeasurementSet


def poisson_problem(d: int, n: int = 2, rank: int = 4
                    ) -> Tuple[TTOperator, TTTensor, TTTensor]:
    """d-dimensional (QTT) Poisson system: returns (A, b, x0)."""
    dims = [n] * d
    A = laplace_operator(dims)
    b = poisson_rhs(dims)
    x0 = TTTensor.random(dims, rank)
    return A, b, x0


def heisenberg_groundstate_problem(d: int, Jx: float = 1.0, Jz: float = 1.0,
                                   h: float = 0.0, rank: int = 8
                                   ) -> Tuple[TTOperator, TTTensor]:
    """1D XXZ Heisenberg ground-state problem: returns (H, x0)."""
    H = heisenberg_mpo(d, Jx, Jz, h)
    x0 = TTTensor.random([2] * d, rank)
    return H, x0


def completion_problem(dims: Sequence[int], rank: int, num_measurements: int
                       ) -> Tuple[TTTensor, SinglePointMeasurementSet, TTTensor]:
    """Low-rank completion instance: returns (truth, measurements, x0)."""
    truth = random_low_rank(dims, rank)
    ms = SinglePointMeasurementSet.random(num_measurements, list(dims))
    ms.measure(truth)
    x0 = TTTensor.random(list(dims), rank)
    return truth, ms, x0
