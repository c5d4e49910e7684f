"""ADF — alternating directional fitting for tensor completion.

Counterpart of ``xerus_tpu/algorithms/adf.py``: per sweep left to right,
per core the projected gradient with slice-wise optimal steps; stop on the
target residual or a stagnating residual decrease; grow the ranks by a
small random rank-1 kick and solve again, up to the maximal ranks.

``ADFVariant(...)(x, measurements, ...)`` takes a ``TTTensor``, updates it
and returns the residual, as in the JAX package; its iterations run on the
tensors of x's components, on the device the TT objects compute on (the
card unless the caller entered ``host()``, ``ops/adf_kernels.py``).
``adf_cores`` is the core-level solver underneath: a TT is a list of
(rl, n, rr) torch cores and the result an ``ADFResult``.

``check_every`` chooses the driver, as in the JAX package: 1 reads the
residual after every iteration, K chains K iterations between reads, and
``"device"`` runs a whole fixed-rank solve (or, with ranks below
``max_ranks``, the whole rank-adaptive solve) with one stop-flag read per
iteration and no other host decision; on the card each of its iterations
is one replay of a captured CUDA graph (``ops/programs.py``), after
``programs.EAGER_CALLS`` eager iterations and the one that captures it.
With the other solvers the ranks
grow in the object layer: between fixed-rank solves, x gets a random
rank-1 kick and ``TTTensor.round`` to the maximal ranks.

``mesh`` (a ``torch.distributed`` DeviceMesh with a ``dp`` axis, the
parallel layer's SPMD contract: every rank calls with the same x and
measurements) shards the measurement axis of every iteration over dp
(``ops.adf_kernels.adf_iteration_sharded``); point measurements only, as
in the JAX package: rank-one sets run replicated, and a mesh takes the
fixed-rank drivers with the object-layer rank growth, as there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import config, require
from ..core.tensor import Tensor
from ..ops import adf_kernels as ak
from ..tt.ttnetwork import TTTensor
from .measurements import RankOneMeasurementSet
from .performance_data import NoPerfData, PerformanceData

# iterations per dispatch of the "device" drivers: the JAX package's
# static compile bucket, kept because the adaptive run restarts its
# stagnation window at each dispatch
CAP = 512


# each bond rank clamped to min(product of the mode sizes left of it,
# product right of it)
reduce_to_maximal_ranks = TTTensor.reduce_to_maximal_ranks


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

    def __call__(self, x: TTTensor, measurements,
                 max_ranks: Optional[Sequence[int]] = None,
                 perf_data: PerformanceData = NoPerfData,
                 mesh=None, check_every: Union[int, str] = 1) -> float:
        """Complete ``x`` in place from ``measurements``; returns the
        residual relative to the measured values' norm at the start of
        the last iteration.  ``perf_data`` records every iteration's
        residual.  The rank bumps of the adaptive device run draw from a
        CPU ``torch.Generator`` of seed 0 (the JAX package draws from
        jax.random); those of the other drivers from the library's
        random engine, as in the JAX package."""
        max_ranks = reduce_to_maximal_ranks(
            list(max_ranks) if max_ranks is not None else x.ranks(),
            x.dimensions)
        perf_data.start()

        def record(iteration, residual):
            perf_data.add(residual, x, 0, iteration=iteration)

        def write_back():
            x.components = [Tensor._wrap(c) for c in solver.cores]
            x.assume_core_position(0)

        adaptive = (check_every == "device" and mesh is None
                    and x.ranks() != max_ranks)
        if adaptive:
            x.move_core(0, keep_rank=True)
        else:
            # rank-revealing: a bond above the TT's true rank shrinks
            x.canonicalize_left()
        solver = _InternalSolver(
            self, [c._torch() for c in x.components], max_ranks,
            measurements, torch.Generator().manual_seed(0), record)
        solver.check_every = ("device" if check_every == "device"
                              else max(1, int(check_every)))
        solver.mesh = mesh
        if adaptive:
            residual = solver._solve_adaptive_device()
            write_back()
            return residual
        solver._solve_current_ranks()
        write_back()
        while (solver.residual_norm > self.targetResidualNorm
               and x.ranks() != max_ranks
               and (self.maxIterations == 0
                    or solver.iteration < self.maxIterations)):
            # the reference's 1e-6 kick (adf.cpp:594), or 16x the rounding
            # threshold of the value dtype where that is larger, so that
            # the round keeps every bond's +1 in float32 too
            x.move_core(0, keep_rank=True)
            rnd = TTTensor.random(x.dimensions, [1] * (x.degree() - 1))
            bump = max(1e-6, 16.0 * config.epsilon)
            scale = bump * x.frob_norm() / (rnd.frob_norm() or 1.0)
            bumped = x + scale * rnd
            bumped.round(max_ranks)
            x.components = bumped.components
            x.canonicalized = bumped.canonicalized
            x.corePosition = bumped.corePosition
            solver.cores = tuple(c._torch() for c in x.components)
            solver._solve_current_ranks()
            write_back()
        return solver.residual_norm


def adf_cores(variant: ADFVariant, cores: Sequence[torch.Tensor],
              measurements, max_ranks: Optional[Sequence[int]] = None,
              check_every: Union[int, str] = 1,
              generator: Optional[torch.Generator] = None) -> ADFResult:
    """The core-level solve of ``variant`` on the TT ``cores``, on their
    device.  With ``check_every="device"`` and ranks below ``max_ranks``
    the whole rank-adaptive solve runs; otherwise the solve stays at the
    cores' ranks (rank growth with the other drivers is the object
    layer's, ``ADFVariant.__call__``).

    ``generator`` (a CPU ``torch.Generator``; seed 0 when None) draws
    the rank-bump vectors of the adaptive device run."""
    solver = _InternalSolver(
        variant, cores,
        list(max_ranks) if max_ranks is not None else tt_ranks(cores),
        measurements,
        generator if generator is not None
        else torch.Generator().manual_seed(0))
    solver.check_every = ("device" if check_every == "device"
                          else max(1, int(check_every)))
    if (solver.check_every == "device"
            and tt_ranks(solver.cores) != list(solver.max_ranks)):
        residual = solver._solve_adaptive_device()
    else:
        solver._solve_current_ranks()
        residual = solver.residual_norm
    return ADFResult(list(solver.cores), residual, solver.history)


class _InternalSolver:
    def __init__(self, variant: ADFVariant, cores, max_ranks: List[int],
                 measurements, generator: torch.Generator,
                 on_record: Optional[Callable[[int, float], None]] = None):
        self.v = variant
        self.cores = tuple(cores)
        self.dims = [int(c.shape[1]) for c in cores]
        self.max_ranks = reduce_to_maximal_ranks(max_ranks, self.dims)
        self.meas = measurements
        self.rank_one = isinstance(measurements, RankOneMeasurementSet)
        self.generator = generator
        self.on_record = on_record
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
        self.mesh = None

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
        if self.on_record is not None:
            self.on_record(self.iteration, self.residual_norm)

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
        mesh = None if self.rank_one else self.mesh
        while self.v.maxIterations == 0 or self.iteration < self.v.maxIterations:
            if K == "device":
                remaining = (self.v.maxIterations - self.iteration
                             if self.v.maxIterations else CAP)
                cores, hist, cnt = ak.adf_device_run(
                    cores, onehots, self.values,
                    self._scalar(self.v.targetResidualNorm * nv),
                    self._scalar(self.v.minimalResidualNormDecrease),
                    self._scalar(res_dec), self._scalar(self.residual_norm * nv),
                    remaining, CAP, self.rank_one, mesh)
                for rv in hist[:cnt].tolist():
                    self._record(rv)
                    ratio = min(self.residual_norm
                                / (self.last_residual or 1.0), 1.0)
                    res_dec = [ratio] + res_dec[:3]
                if cnt < remaining and cnt < CAP:
                    break      # the stop condition fired
                continue       # hit the dispatch cap: dispatch again
            if K > 1:
                if mesh is not None:
                    cores, hist = ak.adf_multi_iteration_sharded(
                        cores, onehots, self.values, K, mesh)
                else:
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
            if mesh is not None:
                new_cores, resid0 = ak.adf_iteration_sharded(
                    cores, onehots, self.values, mesh)
            else:
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


ADF = ADFVariant(0, 1e-8, 0.999)
