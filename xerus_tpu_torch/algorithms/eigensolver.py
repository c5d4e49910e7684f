"""ALS / DMRG ground-state eigensolver on the TT manifold.

Counterpart of ``xerus_tpu/algorithms/eigensolver.py``: min <x, A x> /
<x, x> for a symmetric TTOperator A, the DMRG workload of BASELINE.json
config 4 (the d=32 Heisenberg chain).  With x canonicalized around the
optimized sites the local metric is the identity, so each micro-step of
``EigenALSVariant`` is a dense symmetric eigenproblem (``torch.linalg.eigh``
on the objects' device, in their dtype); ``smallest_eigenvalue`` also
reaches the padded-stack Lanczos sweeps of ``ops/dmrg_kernels.py``.

The JAX package picked ``solver="lanczos"`` by default on a TPU; the port
reads that branch as "on the card": Lanczos when objects compute on CUDA
(and the structure allows it), the dense local eigh under ``host()``.
The JAX package's ``host()`` scope around the rank bump is not carried
over: the bump runs where the objects compute.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..config import compute_device, require, torch_dtype
from ..core import factorizations as fact
from ..core.contract import contract as core_contract
from ..core.tensor import Tensor
from ..ops import dmrg_kernels as dk
from ..tt.ttnetwork import TTOperator, TTTensor
from .performance_data import NoPerfData, PerformanceData


class EigenALSVariant:
    """sites=1: site-wise eigen-ALS; sites=2: two-site DMRG with adaptive
    rank (eps-truncated SVD splits capped by max_rank)."""

    def __init__(self, sites: int = 2, num_sweeps: int = 0,
                 convergence_epsilon: float = 1e-10, max_rank: int = 64,
                 eps: float = 1e-10):
        self.sites = sites
        self.numSweeps = num_sweeps
        self.convergenceEpsilon = convergence_epsilon
        self.maxRank = max_rank
        self.eps = eps

    def __call__(self, A: TTOperator, x: TTTensor,
                 perf_data: PerformanceData = NoPerfData) -> float:
        return self.solve(A, x, self.numSweeps, self.convergenceEpsilon,
                          perf_data)

    def solve(self, A: TTOperator, x: TTTensor, num_sweeps: int,
              conv_eps: float, perf: PerformanceData = NoPerfData) -> float:
        num = x.num_components()
        require(self.sites in (1, 2), "sites must be 1 or 2")
        require(num >= self.sites, "TT too short")
        x.move_core(0)
        x /= x.frob_norm() or 1.0
        A_cores = [c._torch() for c in A.components]

        # right environments (xl, al, xr)
        one3 = torch.ones((1, 1, 1), dtype=torch_dtype(),
                          device=compute_device())
        right: List = [one3]
        for k in range(num - 1, self.sites - 1, -1):
            xc = x.components[k]._torch()
            right.append(torch.einsum("umU,amnb,vnV,UbV->uav", xc,
                                      A_cores[k], xc, right[-1]))
        left: List = [one3]

        perf.start()
        energy = math.inf
        sweeps = 0
        curr = 0
        direction = +1
        while True:
            L, R = left[-1], right[-1]
            if self.sites == 1:
                Aloc = torch.einsum("uav,amnb,UbV->umUvnV", L, A_cores[curr],
                                    R)
                shape = (L.shape[0], A_cores[curr].shape[1], R.shape[0])
            else:
                Aloc = torch.einsum("uav,amnb,bMNc,UcV->umMUvnNV", L,
                                    A_cores[curr], A_cores[curr + 1], R)
                shape = (L.shape[0], A_cores[curr].shape[1],
                         A_cores[curr + 1].shape[1], R.shape[0])
            nn = math.prod(shape)
            w, v = dk._eigh(Aloc.reshape(nn, nn))
            lam = dk.host_float(w[0])
            ground = Tensor._wrap(v[:, 0].reshape(shape).contiguous())

            if self.sites == 1:
                x.components[curr] = ground
                x.assume_core_position(curr)
            else:
                U, S, Vt = fact.calculate_svd(ground, 2, self.maxRank,
                                              self.eps)
                if direction > 0:
                    x.components[curr] = U
                    x.components[curr + 1] = core_contract(S, Vt, 1)
                    x.assume_core_position(curr + 1)
                else:
                    x.components[curr] = core_contract(U, S, 1)
                    x.components[curr + 1] = Vt
                    x.assume_core_position(curr)

            at_right = direction > 0 and curr == num - self.sites
            at_left = direction < 0 and curr == 0
            if at_right or at_left:
                sweeps += 1
                last = energy
                energy = lam
                if perf:
                    perf.add(energy, x, 1)
                if ((num_sweeps and sweeps >= num_sweeps)
                        or abs(last - energy) < conv_eps
                        or num <= self.sites):
                    break
                direction = -direction
            elif direction > 0:
                # orthogonalize the current site, extend the left env
                x._transfer_core(curr, curr + 1, False)
                xc = x.components[curr]._torch()
                left.append(torch.einsum("uav,umU,amnb,vnV->UbV", left[-1],
                                         xc, A_cores[curr], xc))
                right.pop()
                curr += 1
            else:
                last_site = curr + self.sites - 1
                x._transfer_core(last_site, last_site - 1, False)
                xc = x.components[last_site]._torch()
                right.append(torch.einsum("umU,amnb,vnV,UbV->uav", xc,
                                          A_cores[last_site], xc, right[-1]))
                left.pop()
                curr -= 1
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
        return energy


DMRG_groundstate = EigenALSVariant(sites=2, num_sweeps=0,
                                   convergence_epsilon=1e-10)
ALS_groundstate = EigenALSVariant(sites=1, num_sweeps=0,
                                  convergence_epsilon=1e-10)


def smallest_eigenvalue(A: TTOperator, x: TTTensor, sites: int = 2,
                        num_sweeps: int = 0, eps: float = 1e-10,
                        max_rank: int = 64,
                        perf_data: PerformanceData = NoPerfData,
                        solver: Optional[str] = None,
                        num_starts: int = 1,
                        shift: Optional[float] = None) -> float:
    """solver="exact": adaptive-rank object-level sweeps with a dense local
    eigh (the reference's approach, ``EigenALSVariant``).
    solver="lanczos": the padded-stack sweeps with matrix-free Lanczos
    local solves (``ops/dmrg_kernels.dmrg_groundstate_scan``), sites=2 and
    uniform mode dimensions only; ranks are fixed at max_rank (x is
    rank-bumped if needed).  ``shift``: None estimates a spectral shift;
    0.0 promises a negative ground energy (skips the estimate and the
    projector carry); s > lambda_min is used as given.  ``num_starts`` > 1
    races that many starts as one batch per half-sweep.

    solver=None picks "lanczos" when the objects compute on the card and
    its structural requirements hold, "exact" otherwise (under ``host()``
    the CPU runs what the JAX package runs on a CPU)."""
    uniform = len(set(x.dimensions)) == 1
    if solver is None:
        on_card = compute_device().type == "cuda"
        solver = "lanczos" if on_card and sites == 2 and uniform else "exact"
    require(solver in ("exact", "lanczos"),
            f"unknown solver {solver!r}; expected 'exact' or 'lanczos'")
    if solver == "exact":
        return EigenALSVariant(sites, num_sweeps, eps, max_rank)(A, x,
                                                                 perf_data)
    require(sites == 2, "solver='lanczos' is two-site only")
    require(uniform, "solver='lanczos' needs uniform mode dimensions")
    cap = TTTensor.reduce_to_maximal_ranks([max_rank] * (x.degree() - 1),
                                           x.dimensions)
    if list(x.ranks()) != cap:
        rnd = TTTensor.random(x.dimensions, max_rank)
        scale = 1e-3 * (x.frob_norm() or 1.0) / (rnd.frob_norm() or 1.0)
        bumped = x + scale * rnd
        bumped.round(max_rank)
        x.components = bumped.components
        x.canonicalized = bumped.canonicalized
        x.corePosition = bumped.corePosition
    half_sweeps = 2 * (num_sweeps or 8)
    if num_starts > 1:
        energy = dk.dmrg_groundstate_multistart(
            A, x, num_starts=int(num_starts), num_half_sweeps=half_sweeps,
            conv_eps=eps, solver="lanczos", shift=shift)
    else:
        energy = dk.dmrg_groundstate_scan(
            A, x, num_half_sweeps=half_sweeps, conv_eps=eps,
            solver="lanczos", shift=shift)
    if perf_data:
        perf_data.start()
        perf_data.add(energy, x, 1)
    return energy
