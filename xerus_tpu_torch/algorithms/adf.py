"""ADF — alternating directional fitting for tensor completion, at core
level.

Counterpart of ``xerus_tpu/algorithms/adf.py``: per sweep left to right,
per core the projected gradient with slice-wise optimal steps; stop on the
target residual or a stagnating residual decrease; grow the ranks by a
small random rank-1 kick and solve again, up to the maximal ranks.  A TT
is a list of (rl, n, rr) torch cores; the iterations run on the cores'
device (``ops/adf_kernels.py``).

``check_every`` chooses the driver, as in the JAX package: 1 reads the
residual after every iteration, K chains K iterations between reads, and
``"device"`` runs a whole fixed-rank solve (or, with ranks below
``max_ranks``, the whole rank-adaptive solve) with one stop-flag read per
iteration and no other host decision.  The host-bump adaptive loop of the
other drivers needs ``TTTensor.round`` and waits for the object layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import require
from ..ops import adf_kernels as ak
from .measurements import RankOneMeasurementSet

# iterations per dispatch of the "device" drivers: the JAX package's
# static compile bucket, kept because the adaptive run restarts its
# stagnation window at each dispatch
CAP = 512


def reduce_to_maximal_ranks(ranks: Sequence[int],
                            dimensions: Sequence[int]) -> List[int]:
    """Clamp each bond rank to min(product of the mode sizes left of it,
    product right of it)."""
    dims = [int(n) for n in dimensions]
    out = []
    for i, r in enumerate(ranks):
        left = int(np.prod(dims[:i + 1], dtype=object))
        right = int(np.prod(dims[i + 1:], dtype=object))
        out.append(min(int(r), left, right))
    return out


def tt_ranks(cores: Sequence[torch.Tensor]) -> List[int]:
    return [int(c.shape[2]) for c in cores[:-1]]


@dataclass
class ADFResult:
    """Recovered cores (canonical at component 0), the residual relative to
    the measured values' norm at the start of the last iteration, and the
    per-iteration residual history."""
    cores: List[torch.Tensor]
    residual: float
    history: List[float] = field(default_factory=list)

    @property
    def iterations(self) -> int:
        return len(self.history)

    @property
    def ranks(self) -> List[int]:
        return tt_ranks(self.cores)


class ADFVariant:
    def __init__(self, max_iterations: int, target_residual: float,
                 minimal_residual_decrease: float):
        self.maxIterations = max_iterations
        self.targetResidualNorm = target_residual
        self.minimalResidualNormDecrease = minimal_residual_decrease

    def __call__(self, cores: Sequence[torch.Tensor], measurements,
                 max_ranks: Optional[Sequence[int]] = None,
                 check_every: Union[int, str] = 1,
                 generator: Optional[torch.Generator] = None) -> ADFResult:
        """Complete the TT ``cores`` from ``measurements``.

        ``generator`` (a CPU ``torch.Generator``; seed 0 when None) draws
        the rank-bump vectors of the adaptive device run."""
        solver = _InternalSolver(
            self, cores,
            list(max_ranks) if max_ranks is not None else tt_ranks(cores),
            measurements,
            generator if generator is not None
            else torch.Generator().manual_seed(0))
        solver.check_every = ("device" if check_every == "device"
                              else max(1, int(check_every)))
        residual = solver.solve()
        return ADFResult(list(solver.cores), residual, solver.history)


class _InternalSolver:
    def __init__(self, variant: ADFVariant, cores, max_ranks: List[int],
                 measurements, generator: torch.Generator):
        self.v = variant
        self.cores = tuple(cores)
        self.dims = [int(c.shape[1]) for c in cores]
        self.max_ranks = reduce_to_maximal_ranks(max_ranks, self.dims)
        self.meas = measurements
        self.rank_one = isinstance(measurements, RankOneMeasurementSet)
        self.generator = generator
        self.M = measurements.size()
        self.d = len(cores)
        require(self.d == measurements.degree(),
                "measurement degree does not match the TT")
        require(self.M > 0, "no measurements given")
        self.device, self.dtype = cores[0].device, cores[0].dtype
        self.values = torch.from_numpy(measurements.measuredValues).to(
            self.device, self.dtype)
        self.norm_values = (float(np.linalg.norm(measurements.measuredValues))
                            or 1.0)
        self.iteration = 0
        self.residual_norm = 1.0
        self.last_residual = 1.0
        self.history: List[float] = []
        self.check_every: Union[int, str] = 1

    def _onehots(self):
        if self.rank_one:
            return tuple(self.meas.weights_on(self.device, self.dtype))
        pos = self.meas.positions_on(self.device, self.dims)
        return ak.build_onehots(pos, self.dims, self.dtype)

    def _record(self, rv: float) -> None:
        self.iteration += 1
        self.last_residual = self.residual_norm
        self.residual_norm = rv / self.norm_values
        self.history.append(self.residual_norm)

    def _scalar(self, x):
        return torch.tensor(x, dtype=self.dtype, device=self.device)

    def _stagnated(self, res_dec) -> bool:
        return (self.residual_norm < self.v.targetResidualNorm
                or np.prod(res_dec) > self.v.minimalResidualNormDecrease ** 4)

    def _solve_current_ranks(self) -> None:
        """The fixed-rank solve: one residual read per iteration (K=1),
        per K iterations, or, for "device", one stop flag per iteration
        in dispatches of at most CAP iterations with the stagnation window
        carried across them."""
        onehots = self._onehots()
        cores = ak.canonicalize_left_cores(self.cores)
        res_dec = [0.0, 0.0, 0.0, 0.0]
        K = self.check_every
        nv = self.norm_values
        while self.v.maxIterations == 0 or self.iteration < self.v.maxIterations:
            if K == "device":
                remaining = (self.v.maxIterations - self.iteration
                             if self.v.maxIterations else CAP)
                cores, hist, cnt = ak.adf_device_run(
                    cores, onehots, self.values,
                    self._scalar(self.v.targetResidualNorm * nv),
                    self._scalar(self.v.minimalResidualNormDecrease),
                    self._scalar(res_dec), self._scalar(self.residual_norm * nv),
                    remaining, CAP, self.rank_one)
                for rv in hist[:cnt].tolist():
                    self._record(rv)
                    ratio = min(self.residual_norm
                                / (self.last_residual or 1.0), 1.0)
                    res_dec = [ratio] + res_dec[:3]
                if cnt < remaining and cnt < CAP:
                    break      # the stop condition fired
                continue       # hit the dispatch cap: dispatch again
            if K > 1:
                cores, hist = ak.adf_multi_iteration(cores, onehots,
                                                     self.values, K,
                                                     self.rank_one)
                stop = False
                for rv in hist.tolist():
                    self._record(rv)
                    ratio = min(self.residual_norm
                                / (self.last_residual or 1.0), 1.0)
                    res_dec = [ratio] + res_dec[:3]
                    if (self._stagnated(res_dec)
                            or (self.v.maxIterations
                                and self.iteration >= self.v.maxIterations)):
                        stop = True
                        break
                if stop:
                    break
                continue
            base = (ak._adf_iteration_rankone if self.rank_one
                    else ak._adf_iteration)
            new_cores, resid0 = base(cores, onehots, self.values)
            self._record(float(resid0))
            ratio = min(self.residual_norm / (self.last_residual or 1.0), 1.0)
            res_dec = [ratio] + res_dec[:3]
            cores = ak.canonicalize_left_cores(new_cores)
            if self._stagnated(res_dec):
                break
        self.cores = cores

    def _solve_adaptive_device(self) -> float:
        """The whole rank-adaptive solve (ops/adf_kernels.adf_adaptive_run)
        on cores padded to max_ranks, in dispatches of at most CAP
        iterations; the stagnation window restarts at each dispatch, as in
        the JAX package."""
        cores = ak.canonicalize_left_cores(self.cores)
        d = self.d
        caps = list(self.max_ranks)
        onehots = self._onehots()
        padded = []
        for k, c in enumerate(cores):
            capL = 1 if k == 0 else caps[k - 1]
            capR = 1 if k == d - 1 else caps[k]
            buf = c.new_zeros((capL, self.dims[k], capR))
            buf[:c.shape[0], :, :c.shape[2]] = c
            padded.append(buf)
        ranks = tt_ranks(cores)
        # the reference's 1e-6, or 16x the rounding threshold (8 eps) of
        # the cores' dtype where that is larger
        bump = max(1e-6, 16.0 * 8.0 * torch.finfo(self.dtype).eps)
        nv = self.norm_values
        cores = tuple(padded)
        while self.v.maxIterations == 0 or self.iteration < self.v.maxIterations:
            remaining = (self.v.maxIterations - self.iteration
                         if self.v.maxIterations else CAP)
            cores, ranks, hist, cnt = ak.adf_adaptive_run(
                cores, onehots, self.values,
                self._scalar(self.v.targetResidualNorm * nv),
                self._scalar(self.v.minimalResidualNormDecrease), ranks,
                self._scalar(self.residual_norm * nv), remaining, CAP, caps,
                bump, self.generator, self.rank_one)
            for rv in hist[:cnt].tolist():
                self._record(rv)
            if cnt < remaining and cnt < CAP:
                break          # the done condition fired
        out = []
        for k, c in enumerate(cores):
            rl = 1 if k == 0 else ranks[k - 1]
            rr = 1 if k == d - 1 else ranks[k]
            out.append(c[:rl, :, :rr].contiguous())
        self.cores = tuple(out)
        return self.residual_norm

    def solve(self) -> float:
        if (self.check_every == "device"
                and tt_ranks(self.cores) != list(self.max_ranks)):
            return self._solve_adaptive_device()
        self._solve_current_ranks()
        if (self.residual_norm > self.v.targetResidualNorm
                and tt_ranks(self.cores) != list(self.max_ranks)
                and (self.v.maxIterations == 0
                     or self.iteration < self.v.maxIterations)):
            raise NotImplementedError(
                "ADF rank growth on the host needs TTTensor.round (ROADMAP "
                "Queue 1 item 4, the object layer); use check_every="
                "'device' for the rank-adaptive solve")
        return self.residual_norm
