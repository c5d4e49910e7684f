"""Geometric (Riemannian) conjugate gradients on the TT manifold.

Counterpart of ``xerus_tpu/algorithms/cg.py``, the re-design of
include/xerus/algorithms/cg.h and src/xerus/algorithms/cg.cpp:30-130:
Fletcher-Reeves updates with a vector transport, falling back to a
steepest descent step when the transported direction is no longer a
descent direction.  Everything runs on the TT objects' device.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..tt.ttnetwork import TTTensor, TTOperator, apply_operator
from .performance_data import PerformanceData, NoPerfData
from .retractions import (TTTangentVector, SubmanifoldRetractionI,
                          ProjectiveVectorTransport)
from .steepest_descent import line_search


class GeometricCGVariant:
    def __init__(self, num_steps: int = 0, convergence_epsilon: float = 1e-8,
                 assume_spd: bool = False,
                 retraction: Callable = SubmanifoldRetractionI,
                 vector_transport: Callable = ProjectiveVectorTransport):
        self.numSteps = num_steps
        self.convergenceEpsilon = convergence_epsilon
        self.assumeSymmetricPositiveDefiniteOperator = assume_spd
        self.retraction = retraction            # TTRetractionI (tangent vec)
        self.vectorTransport = vector_transport

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
        norm_b = b.frob_norm() or 1.0
        last_residual = 1e100

        def calc_residual_tt():
            if A is not None:
                return b - apply_operator(A, x)
            return b - x

        def residual_of(x_val):
            if A is not None:
                return (b - apply_operator(A, x_val)).frob_norm()
            return (b - x_val).frob_norm()

        residual_tt = calc_residual_tt()
        curr_residual = residual_tt.frob_norm()
        perf.add(curr_residual, x)

        def update_gradient():
            if self.assumeSymmetricPositiveDefiniteOperator or A is None:
                return TTTangentVector(x, residual_tt)
            grad_tt = apply_operator(A.transposed(), residual_tt)
            return TTTangentVector(x, grad_tt)

        gradient = update_gradient()
        gradient_norm = gradient.frob_norm()
        direction = gradient.copy()
        alpha = 1.0
        step = 0
        while ((num_steps == 0 or step < num_steps)
               and curr_residual / norm_b > eps
               and abs(last_residual - curr_residual) / norm_b > eps
               and abs(1 - curr_residual / (last_residual or 1.0)) / norm_b
               > eps):
            step += 1
            derivative = (gradient.scalar_product(direction)
                          / direction.frob_norm())
            # fall back to steepest descent (cg.cpp:100-105)
            if derivative <= 0:
                direction = gradient.copy()
                derivative = gradient.frob_norm()
                alpha = 1.0
            last_residual = curr_residual
            alpha, curr_residual = line_search(
                x, alpha, direction, derivative, curr_residual,
                self.retraction, residual_of, 0.8)
            perf.add(curr_residual, x)
            old_direction = direction.copy()
            self.vectorTransport(x, old_direction)
            old_grad_norm = gradient_norm
            residual_tt = calc_residual_tt()
            gradient = update_gradient()
            gradient_norm = gradient.frob_norm()
            beta = (gradient_norm / old_grad_norm if old_grad_norm > 0
                    else 0.0)
            direction = gradient + old_direction * beta
        return curr_residual


GeometricCG = GeometricCGVariant(0, 1e-8, False, SubmanifoldRetractionI,
                                 ProjectiveVectorTransport)
