"""IHT — iterative hard thresholding for tensor completion.

Counterpart of ``xerus_tpu/algorithms/iht.py``: per iteration, build an
augmented TT ``largeX`` whose extra rank slots carry one rank-1 update per
measurement scaled by the scaled residual, project it back to the ranks
of x by one ALS-like sweep, and keep the step size that best reduces the
sampled residual.  The TT is evaluated at the measurement positions by
``ops.tt_eval.tt_eval_at_points`` (kernel K3 on the card): once per
iteration and once per step-size trial.  ``IHT`` takes a ``TTTensor``
and updates it, as in the JAX package; ``iht_cores`` is the core-level
loop underneath, on the cores' device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.tensor import Tensor
from ..ops.adf_kernels import canonicalize_left_cores
from ..ops.tt_eval import tt_eval_at_points
from ..tt.ttnetwork import TTTensor
from .measurements import SinglePointMeasurementSet
from .performance_data import NoPerfData, PerformanceData

_ALPHA_CHG = 1.1


def _build_large_x(cores: Sequence[torch.Tensor], positions: torch.Tensor,
                   scaled_residuals: torch.Tensor) -> List[torch.Tensor]:
    """x plus one rank-1 dirac update per measurement in extra rank slots;
    ``positions`` (M, d) int64 on the cores' device."""
    M = positions.shape[0]
    d = len(cores)
    m_range = torch.arange(M, device=positions.device)
    out = []
    for k, C in enumerate(cores):
        rl, n, rr = C.shape
        new_rl = 1 if k == 0 else rl + M
        new_rr = 1 if k == d - 1 else rr + M
        new = C.new_zeros((new_rl, n, new_rr))
        new[:rl, :, :rr] = C
        idx = positions[:, k]
        if k == 0:
            new[0, idx, rr + m_range] = scaled_residuals
        elif k != d - 1:
            new[rl + m_range, idx, rr + m_range] = 1.0
        else:
            new[rl + m_range, idx, 0] = 1.0
        out.append(new)
    return out


def _move_core_right(cores: List[torch.Tensor], i: int) -> None:
    """The core-level move_core(i + 1, keep_rank=True) from position i:
    QR of core i, R into core i + 1, in place on the list."""
    rl, n, rr = cores[i].shape
    q, r = torch.linalg.qr(cores[i].reshape(rl * n, rr))
    cores[i] = q.reshape(rl, n, q.shape[1])
    cores[i + 1] = torch.einsum("ab,bnc->anc", r, cores[i + 1])


def _project_to_x_ranks(cores: Sequence[torch.Tensor],
                        large: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ALS projection sweep of ``large`` onto the rank manifold of
    ``cores``; the result is canonical at its last component."""
    new_x = list(canonicalize_left_cores(cores))
    d = len(new_x)
    one = new_x[0].new_ones((1, 1))
    # right stack of overlaps <new_x_i, large_i>
    stack = [one]
    for i in range(d - 1, 0, -1):
        stack.append(torch.einsum("anb,cnd,bd->ac", new_x[i], large[i],
                                  stack[-1]))
    left = one
    for i in range(d):
        new_x[i] = torch.einsum("ab,bnc,dc->and", left, large[i], stack[-1])
        if i + 1 < d:
            _move_core_right(new_x, i)
            left = torch.einsum("ab,anc,bnd->cd", left, new_x[i], large[i])
            stack.pop()
    return new_x


def iht_cores(cores: Sequence[torch.Tensor],
              measurements: SinglePointMeasurementSet,
              max_iterations: int = 100,
              callback: Optional[Callable] = None
              ) -> Tuple[List[torch.Tensor], float]:
    """Returns (cores, residual): the last accepted iterate, canonical at
    its last component (the input cores if no trial was accepted), and
    the absolute l2 residual at the positions.  ``callback(iteration,
    residual, cores, accepted)`` runs after every iteration; ``accepted``
    says whether a step-size trial replaced the iterate.  One host read per
    step-size trial."""
    dims = [int(c.shape[1]) for c in cores]
    device, dtype = cores[0].device, cores[0].dtype
    positions = measurements.positions_on(device, dims)
    values = torch.from_numpy(measurements.measuredValues).to(device, dtype)
    x = list(cores)
    alpha = 1.0
    residual = 1.0
    for iteration in range(max_iterations):
        current = tt_eval_at_points(x, positions)
        best_residual = residual * 2
        new_alpha = alpha
        best_x = None
        beta = 1.0 / _ALPHA_CHG
        while beta < _ALPHA_CHG * 1.5:
            scaled = beta * alpha * (values - current)
            large = _build_large_x(x, positions, scaled)
            new_x = _project_to_x_ranks(x, large)
            new_vals = tt_eval_at_points(new_x, positions)
            res = float(torch.linalg.vector_norm(values - new_vals))
            if res <= best_residual:
                best_x = new_x
                best_residual = res
                new_alpha = alpha * beta
            beta *= _ALPHA_CHG
        if best_x is not None:
            x = best_x
        residual = best_residual
        alpha = new_alpha
        if callback is not None:
            callback(iteration, residual, x, best_x is not None)
        if residual < 1e-10 * (measurements.frob_norm() or 1.0):
            break
    return x, residual


def IHT(x: TTTensor, measurements: SinglePointMeasurementSet,
        perf_data: PerformanceData = NoPerfData,
        max_iterations: int = 100) -> float:
    """IHT on ``x`` in place; returns the absolute l2 residual at the
    positions.  ``perf_data`` records every iteration."""
    def update(iteration, residual, cores, accepted):
        if accepted:
            x.components = [Tensor._wrap(c) for c in cores]
            x.assume_core_position(x.num_components() - 1)
        perf_data.add(residual, x, 0, iteration=iteration)

    perf_data.start()
    return iht_cores([c._torch() for c in x.components], measurements,
                     max_iterations, update)[1]
