"""Riemannian steepest descent with pluggable retraction.

Counterpart of ``xerus_tpu/algorithms/steepest_descent.py``, the
re-design of include/xerus/algorithms/steepestDescent.h and
src/xerus/algorithms/steepestDescent.cpp:30-179 (with the shared
``line_search`` that GeometricCG uses).  Everything runs on the TT
objects' device through their arithmetic.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..tt.ttnetwork import TTTensor, TTOperator, apply_operator
from .performance_data import PerformanceData, NoPerfData
from .retractions import (TTTangentVector, SubmanifoldRetractionII,
                          _overwrite)


def line_search(x: TTTensor, alpha: float, direction: TTTangentVector,
                derivative: float, residual: float,
                retraction: Callable, calculate_residual: Callable,
                change_in_alpha: float = 0.5):
    """Expanding-then-Armijo line search (steepestDescent.cpp:37-80).
    Returns (new_alpha, new_residual); x is modified in place."""
    dir_norm = direction.frob_norm()
    curr_alpha = alpha / change_in_alpha
    old_x = x.copy()
    retraction(x, direction * (curr_alpha / dir_norm))
    best_residual = calculate_residual(x)
    best_alpha = curr_alpha
    best_x = x.copy()

    while True:
        curr_alpha *= change_in_alpha
        _overwrite(x, old_x.copy())
        retraction(x, direction * (curr_alpha / dir_norm))
        new_residual = calculate_residual(x)
        if new_residual < best_residual:
            best_residual = new_residual
            best_alpha = curr_alpha
            best_x = x.copy()
        else:
            break

    _overwrite(x, best_x)
    alpha = best_alpha

    # armijo backtracking
    min_decrease = 1e-4
    while (alpha > 1e-16 and best_residual
           > residual - min_decrease * alpha / dir_norm * derivative):
        alpha *= change_in_alpha
        _overwrite(x, old_x.copy())
        retraction(x, direction * (alpha / dir_norm))
        best_residual = calculate_residual(x)
    return alpha, best_residual


class SteepestDescentVariant:
    def __init__(self, num_steps: int = 0, convergence_epsilon: float = 1e-8,
                 assume_spd: bool = False,
                 retraction: Callable = SubmanifoldRetractionII):
        self.numSteps = num_steps
        self.convergenceEpsilon = convergence_epsilon
        self.assumeSymmetricPositiveDefiniteOperator = assume_spd
        self.preconditioner: Optional[TTOperator] = None
        self.retraction = retraction  # TTRetractionII: (x, TT change)

    def __call__(self, *args, **kwargs) -> float:
        args = list(args)
        A = args.pop(0) if isinstance(args[0], TTOperator) else None
        x = args.pop(0)
        b = args.pop(0)
        num_steps = self.numSteps
        eps = self.convergenceEpsilon
        perf = kwargs.get("perf_data", NoPerfData)
        for a in args:
            if isinstance(a, PerformanceData):
                perf = a
            elif isinstance(a, float):
                eps = a
            elif isinstance(a, int):
                num_steps = a
        return self.solve(A, x, b, num_steps, eps, perf)

    def solve(self, A: Optional[TTOperator], x: TTTensor, b: TTTensor,
              num_steps: int, eps: float,
              perf: PerformanceData = NoPerfData) -> float:
        perf.start()
        last_residual = 1e100

        def compute_residual_tt():
            if A is not None:
                return b - apply_operator(A, x)
            return b - x

        residual_tt = compute_residual_tt()
        curr_residual = residual_tt.frob_norm()
        perf.add(curr_residual, x)
        alpha = 1.0
        step = 0
        while ((num_steps == 0 or step < num_steps)
               and curr_residual > eps
               and abs(last_residual - curr_residual) > eps
               and abs(1 - curr_residual / (last_residual or 1.0)) > eps):
            step += 1
            if A is not None:
                if self.assumeSymmetricPositiveDefiniteOperator:
                    y = residual_tt
                else:
                    y = apply_operator(A.transposed(), residual_tt)
                if self.preconditioner is not None:
                    y = apply_operator(self.preconditioner, y)
            else:
                y = residual_tt
            old_x = x.copy()
            alpha *= 2
            self.retraction(x, y * alpha)
            last_residual = curr_residual
            residual_tt = compute_residual_tt()
            curr_residual = residual_tt.frob_norm()
            # armijo-style backtracking (steepestDescent.cpp:164-171)
            while alpha > 1e-30 and last_residual < curr_residual:
                alpha /= 2
                _overwrite(x, old_x.copy())
                self.retraction(x, y * alpha)
                residual_tt = compute_residual_tt()
                curr_residual = residual_tt.frob_norm()
            perf.add(curr_residual, x)
        return curr_residual


SteepestDescent = SteepestDescentVariant(0, 1e-8, False,
                                         SubmanifoldRetractionII)
