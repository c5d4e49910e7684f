"""ALS / DMRG / ASD sweep engine for min ||Ax-b|| (or ||x-b||) on the TT
manifold.

Counterpart of ``xerus_tpu/algorithms/als.py``, the re-design of the
reference's single configurable engine (include/xerus/algorithms/als.h:
37-223, src/xerus/algorithms/als.cpp):

* ``sites=1`` -> ALS, ``sites=2`` -> DMRG; ``local_solver='asd'`` replaces
  the local solve by one exact-step gradient step (als.cpp:73-92).
* ``assume_spd`` selects the <x,Ax> energy path; otherwise the engine works
  on the normal equations A^T A x = A^T b (choose_energy_functional,
  als.cpp:255-300).
* Single-site solves with an operator take the whole-sweep drivers of
  ``ops/als_kernels.py`` on the components' tensors (``_solve_fast``),
  which replay one captured half-sweep program per half-sweep on the
  card (``ops/programs.py``);
  the rest runs the generic engine, whose left/right environment caches
  (localOperatorCache / rhsCache, als.cpp:217-253, 340-380) are torch
  tensors updated per step.

Everything runs on the device the TT objects compute on (the card unless
the caller entered ``host()``), in the objects' own dtype: float64 sweeps
run in float64 on the card.

Not ported: prepare_x_for_als' full-rank node elision (als.cpp:105-182) — a
work-skipping gauge choice (full-rank boundary nodes set to reshape-identity
and excluded from the sweep).  Formalized divergence: see PARITY.md §2.4 and
tests/test_als.py::test_full_rank_boundary_node_elision_is_gauge_neutral,
which pins that both gauges converge to the same solution.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..config import config, compute_device, require, torch_dtype
from ..core import factorizations as fact
from ..core.contract import contract as core_contract
from ..core.tensor import Tensor
from ..misc.profiling import guard_finite
from ..ops import als_kernels as ak
from ..tt.ttnetwork import TTOperator, TTTensor, apply_operator
from .performance_data import NoPerfData, PerformanceData

FLAG_FINISHED_HALFSWEEP = 1
FLAG_FINISHED_FULLSWEEP = 3

# half-sweeps per call of the whole-solve drivers (the JAX package's
# static compile bucket); the carry continues across calls
CAP = 32


def _wrap_cores(cores) -> List[Tensor]:
    return [Tensor._wrap(c.contiguous()) for c in cores]


class ALSVariant:
    """Configurable sweep solver (als.h:37-208)."""

    def __init__(self, sites: int, num_half_sweeps: int, local_solver: str,
                 assume_spd: bool, use_residual: bool = False):
        require(sites > 0, "sites must be positive")
        self.sites = sites
        self.numHalfSweeps = num_half_sweeps
        self.convergenceEpsilon = 1e-6
        self.useResidualForEndCriterion = use_residual
        self.preserveCorePosition = True
        self.assumeSPD = assume_spd
        self.local_solver = local_solver  # 'lapack' | 'asd' | 'cg'

    # the reference's LocalSolver binding surface (leastSquares.cpp:133-135;
    # als.h:43-48): class attrs naming the solvers + a localSolver member
    lapack_solver = "lapack"
    ASD_solver = "asd"
    LocalSolver = str

    @property
    def localSolver(self) -> str:
        return self.local_solver

    @localSolver.setter
    def localSolver(self, value: str) -> None:
        self.local_solver = value

    # -- call styles (als.h:152-208) -----------------------------------
    def __call__(self, *args, **kwargs) -> float:
        """(A, x, b, [eps|num_half_sweeps], [perf_data]) or (x, b, ...)."""
        args = list(args)
        A = None
        if isinstance(args[0], TTOperator):
            A = args.pop(0)
        x = args.pop(0)
        b = args.pop(0)
        eps = self.convergenceEpsilon
        num_half_sweeps = self.numHalfSweeps
        perf = kwargs.get("perf_data", NoPerfData)
        for a in args:
            if isinstance(a, PerformanceData):
                perf = a
            elif isinstance(a, float):
                eps = a
            elif isinstance(a, int):
                num_half_sweeps = a
        return self.solve(A, x, b, num_half_sweeps, eps, perf)

    # ------------------------------------------------------------------
    def solve(self, A: Optional[TTOperator], x: TTTensor, b: TTTensor,
              num_half_sweeps: int, conv_eps: float,
              perf: PerformanceData = NoPerfData) -> float:
        if (self.sites == 1 and A is not None
                and (self.local_solver == "lapack"
                     or (self.local_solver in ("asd", "cg")
                         and self.assumeSPD))):
            return self._solve_fast(A, x, b, num_half_sweeps, conv_eps, perf)
        data = _ALSData(self, A, x, b)
        perf.start()
        while True:
            if self.local_solver == "asd":
                _asd_step(data)
            else:
                _local_solve(data)
            if _check_end_of_sweep(data, num_half_sweeps, conv_eps, perf):
                break
            data.move_to_next_index()
        if data.canonicalize_at_end and self.preserveCorePosition:
            x.move_core(data.core_pos_at_end, keep_rank=True)
        return data.residual()

    def _solve_fast(self, A: TTOperator, x: TTTensor, b: TTTensor,
                    num_half_sweeps: int, conv_eps: float,
                    perf: PerformanceData) -> float:
        """Single-site solve on the components' tensors through the
        whole-sweep drivers of ``ops/als_kernels.py``.  Uninstrumented, the
        whole solve runs in ``als_run`` / ``als_run_rev`` calls of at most
        CAP half-sweeps (one boolean read per half-sweep); with an error
        function or a checkpoint path in ``perf`` each half-sweep runs
        alone so that x can be materialized for the callback.

        The reference's local solver detects symmetry and falls back to
        PLU (blasLapackWrapper.cpp:542-585); here the choice is made once
        per operator.  "assumeSPD" selects the energy functional, not the
        local factorization.  A symmetric operator that is indefinite
        passes the symmetry check, and its Cholesky solves give NaNs: the
        solve then restarts from the initial cores with LU local solves
        (the reference's LDL^T fallback, blasLapackWrapper.cpp:586-651)."""
        initial_canon = x.canonicalized
        initial_core = x.corePosition if x.canonicalized else 0
        x.move_core(0)
        local_assume = "pos" if (self.assumeSPD
                                 and A.is_symmetric()) else "gen"
        A_cores = tuple(c._torch() for c in A.components)
        b_cores = tuple(c._torch() for c in b.components)
        cores0 = tuple(c._torch() for c in x.components)
        last_site = x.num_components() - 1

        perf.start()
        spd = self.assumeSPD
        asd = self.local_solver in ("asd", "cg")
        # a Cholesky NaN restarts the solve with the general local solver
        restartable = spd and not asd
        instrumented = bool(perf) and (perf.error_function
                                       or perf.checkpoint_path)
        if not instrumented:
            while True:
                cores = cores0
                total = parity = 0
                energy = last = last2 = math.inf
                chol_nan = False
                # num_half_sweeps == 0 runs until stagnation
                while num_half_sweeps == 0 or total < num_half_sweeps:
                    remaining = (num_half_sweeps - total if num_half_sweeps
                                 else CAP)
                    carry = (conv_eps, parity, remaining, energy, last, CAP)
                    if restartable:
                        cores, hist, cnt = ak.als_run(
                            cores, A_cores, b_cores, *carry,
                            local_assume=local_assume)
                    else:
                        cores, hist, cnt = ak.als_run_rev(
                            cores, A_cores, b_cores, *carry,
                            solver=self.local_solver if asd else "nonspd")
                    for j, rv in enumerate(hist[:cnt].tolist()):
                        last2, last = last, energy
                        energy = rv
                        if not math.isfinite(energy):
                            if local_assume == "pos" and restartable:
                                chol_nan = True
                                break
                            guard_finite(cores[0], "ALS half-sweep "
                                         f"{total + j + 1}")
                        if perf:
                            perf.add(energy, x,
                                     FLAG_FINISHED_HALFSWEEP
                                     if (parity + j) % 2 == 0
                                     else FLAG_FINISHED_FULLSWEEP)
                    if chol_nan:
                        break
                    total += max(cnt, 1)
                    parity = total % 2
                    if cnt < min(remaining, CAP):
                        break          # the stagnation test or the limit
                if chol_nan:
                    local_assume = "gen"
                    continue
                break
            x.components = _wrap_cores(cores)
            x.assume_core_position(last_site if (total - 1) % 2 == 0 else 0)
            if initial_canon and self.preserveCorePosition:
                x.move_core(initial_core, keep_rank=True)
            return energy

        cores = cores0
        energy = last = last2 = math.inf
        half_sweeps = 0
        direction = "lr"
        reversed_state = False
        while True:
            if asd or not spd:
                # lr half-sweeps only: odd half-sweeps run on the
                # site-reversed system
                if (direction == "rl") != reversed_state:
                    cores = ak.reverse_tt(cores)
                    A_cores = ak.reverse_op(A_cores)
                    b_cores = ak.reverse_tt(b_cores)
                    reversed_state = not reversed_state
                cores, res = ak.als_sweep_res(
                    cores, A_cores, b_cores, "lr", spd=asd,
                    solver=self.local_solver if asd else "lapack")
            else:
                cores, res = ak.als_sweep_res(cores, A_cores, b_cores,
                                              direction,
                                              local_assume=local_assume)
            half_sweeps += 1
            last2, last = last, energy
            energy = float(res)
            if not math.isfinite(energy):
                if local_assume == "pos" and restartable:
                    local_assume = "gen"
                    cores = cores0
                    energy = last = last2 = math.inf
                    half_sweeps = 0
                    direction = "lr"
                    continue
                guard_finite(cores[0], f"ALS half-sweep {half_sweeps}")
            if perf:
                x.components = _wrap_cores(ak.reverse_tt(cores)
                                           if reversed_state else cores)
                perf.add(energy, x, FLAG_FINISHED_HALFSWEEP
                         if direction == "lr" else FLAG_FINISHED_FULLSWEEP)
            if (half_sweeps == num_half_sweeps
                    or abs(last - energy) < conv_eps
                    or abs(last2 - energy) < conv_eps):
                break
            direction = "rl" if direction == "lr" else "lr"
        if reversed_state:
            cores = ak.reverse_tt(cores)
        x.components = _wrap_cores(cores)
        if spd and not asd:
            x.assume_core_position(last_site if direction == "lr" else 0)
        else:
            # reversal-style sweeps end at site d-1 of the possibly
            # reversed system
            x.assume_core_position(0 if reversed_state else last_site)
        if initial_canon and self.preserveCorePosition:
            x.move_core(initial_core, keep_rank=True)
        return energy


class _ALSData:
    """Environment caches + sweep state (ALSAlgorithmicData, als.h:44-107)."""

    def __init__(self, variant: ALSVariant, A: Optional[TTOperator],
                 x: TTTensor, b: TTTensor):
        require(x.dimensions == b.dimensions, "x and b dimensions must match")
        if A is not None:
            num = A.num_components()
            require(A.dimensions[:num] == x.dimensions
                    and A.dimensions[num:] == x.dimensions,
                    "operator dimensions must match x")
        self.v = variant
        self.A = A
        self.x = x
        self.b = b
        self.num = x.num_components()
        self.sites = variant.sites
        require(self.num >= self.sites, "TT too short for chosen number of sites")
        self.target_rank = list(x.ranks())
        self.norm_b = b.frob_norm()
        self.canonicalize_at_end = x.canonicalized
        self.core_pos_at_end = x.corePosition if x.canonicalized else 0

        x.move_core(0)
        self.curr = 0
        self.direction = +1
        self.half_sweeps = 0
        self.energy = math.inf
        self.last_energy = math.inf
        self.last_energy2 = math.inf

        # SPD: op env (xl, al, xl'); else (xl, a1, a2, xl').
        # rhs env SPD/none: (xl, bl); else (bl, al, xl).
        self.spd = (A is None) or variant.assumeSPD
        dev, dt = compute_device(), torch_dtype()
        one = (torch.ones((1,) * (3 if self.spd else 4), dtype=dt, device=dev)
               if A is not None else None)
        self.op_left: List = [one]
        self.op_right: List = [one]
        rb1 = torch.ones((1,) * (2 if self.spd else 3), dtype=dt, device=dev)
        self.rhs_left: List = [rb1]
        self.rhs_right: List = [rb1]
        for pos in range(self.num - 1, self.sites - 1, -1):
            self._push_right(pos)

    # -- core tensors ----------------------------------------------------
    def _xc(self, i):
        return self.x.components[i]._torch()

    def _bc(self, i):
        return self.b.components[i]._torch()

    def _Ac(self, i):
        return self.A.components[i]._torch()

    # -- environment pushes (als.cpp:184-253, 340-380) ------------------
    def _push_right(self, pos: int) -> None:
        xc = self._xc(pos)
        if self.A is not None:
            Ac = self._Ac(pos)
            if self.spd:
                env = torch.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                   self.op_right[-1])
            else:
                env = torch.einsum("umU,pzmq,rznt,vnV,UqtV->uprv", xc, Ac,
                                   Ac, xc, self.op_right[-1])
            self.op_right.append(env)
        bc = self._bc(pos)
        if self.spd:
            renv = torch.einsum("umU,bmB,UB->ub", xc, bc, self.rhs_right[-1])
        else:
            renv = torch.einsum("bzB,azmq,umU,BqU->bau", bc, self._Ac(pos),
                                xc, self.rhs_right[-1])
        self.rhs_right.append(renv)

    def _push_left(self, pos: int) -> None:
        xc = self._xc(pos)
        if self.A is not None:
            Ac = self._Ac(pos)
            if self.spd:
                env = torch.einsum("uav,umU,amnb,vnV->UbV", self.op_left[-1],
                                   xc, Ac, xc)
            else:
                env = torch.einsum("uprv,umU,pzmq,rznt,vnV->UqtV",
                                   self.op_left[-1], xc, Ac, Ac, xc)
            self.op_left.append(env)
        bc = self._bc(pos)
        if self.spd:
            renv = torch.einsum("ub,umU,bmB->UB", self.rhs_left[-1], xc, bc)
        else:
            renv = torch.einsum("bau,bzB,azmq,umU->BqU", self.rhs_left[-1],
                                bc, self._Ac(pos), xc)
        self.rhs_left.append(renv)

    def move_to_next_index(self) -> None:
        if self.direction > 0:
            # left-orthogonalize the current site, push the env left
            self.x._transfer_core(self.curr, self.curr + 1, False)
            self._push_left(self.curr)
            if self.A is not None:
                self.op_right.pop()
            self.rhs_right.pop()
            self.curr += 1
        else:
            last = self.curr + self.sites - 1
            self.x._transfer_core(last, last - 1, False)
            self._push_right(last)
            if self.A is not None:
                self.op_left.pop()
            self.rhs_left.pop()
            self.curr -= 1
        self.x.assume_core_position(self.curr)

    # -- local system assembly (als.cpp:383-423) ------------------------
    def local_operator(self):
        """Matrix over (row = u m.. U) x (col = v n.. V)."""
        L = self.op_left[-1]
        R = self.op_right[-1]
        if self.spd:
            if self.sites == 1:
                return torch.einsum("uav,amnb,UbV->umUvnV", L,
                                    self._Ac(self.curr), R)
            A1, A2 = self._Ac(self.curr), self._Ac(self.curr + 1)
            return torch.einsum("uav,amnb,bMNc,UcV->umMUvnNV", L, A1, A2, R)
        if self.sites == 1:
            Ac = self._Ac(self.curr)
            return torch.einsum("uprv,pzmq,rznt,UqtV->umUvnV", L, Ac, Ac, R)
        A1, A2 = self._Ac(self.curr), self._Ac(self.curr + 1)
        return torch.einsum("uprv,pzmq,rznt,qZMs,tZNw,UswV->umMUvnNV",
                            L, A1, A1, A2, A2, R)

    def local_rhs(self):
        Lb = self.rhs_left[-1]
        Rb = self.rhs_right[-1]
        if self.spd:
            if self.sites == 1:
                return torch.einsum("ub,bmB,UB->umU", Lb,
                                    self._bc(self.curr), Rb)
            b1, b2 = self._bc(self.curr), self._bc(self.curr + 1)
            return torch.einsum("ub,bmB,BMC,UC->umMU", Lb, b1, b2, Rb)
        if self.sites == 1:
            return torch.einsum("bau,bzB,azmq,BqU->umU", Lb,
                                self._bc(self.curr), self._Ac(self.curr), Rb)
        b1, b2 = self._bc(self.curr), self._bc(self.curr + 1)
        A1, A2 = self._Ac(self.curr), self._Ac(self.curr + 1)
        return torch.einsum("bau,bzB,azmq,BZC,qZMs,CsU->umMU",
                            Lb, b1, A1, b2, A2, Rb)

    # -- energy / residual (als.cpp:255-300) ----------------------------
    def residual(self) -> float:
        norm = self.norm_b if self.norm_b > 0 else 1.0
        if self.A is not None:
            return (apply_operator(self.A, self.x) - self.b).frob_norm() / norm
        return (self.x - self.b).frob_norm() / norm

    def energy_value(self) -> float:
        if self.A is None or not self.spd or self.v.useResidualForEndCriterion:
            return self.residual()
        # 0.5 <x,Ax> - <x,b> from the local system at the current sites
        row = self._local_x().reshape(-1)
        n = row.shape[0]
        Amat = self.local_operator().reshape(n, n)
        return float(0.5 * row @ (Amat @ row)
                     - row @ self.local_rhs().reshape(-1))

    def _local_x(self):
        xl = self._xc(self.curr)
        for p in range(1, self.sites):
            xl = torch.tensordot(xl, self._xc(self.curr + p),
                                 dims=([xl.dim() - 1], [0]))
        return xl


def _local_solve(data: _ALSData) -> None:
    """LAPACK-equivalent local solve + SVD split for sites>1 (als.cpp:43-71)."""
    bloc = data.local_rhs()
    shape = bloc.shape
    n = bloc.numel()
    if data.A is not None:
        Aloc = data.local_operator().reshape(n, n)
        sol = fact._solve_matrix(Aloc, bloc.reshape(n, 1)).reshape(shape)
    else:
        sol = bloc
    _write_back(data, sol)


def _asd_step(data: _ALSData) -> None:
    """One exact-stepsize gradient step (als.cpp:73-92)."""
    require(data.sites == 1, "ASD only defined for single-site")
    bloc = data.local_rhs()
    xl = data._local_x()
    if data.A is not None:
        n = xl.numel()
        Amat = data.local_operator().reshape(n, n)
        grad = bloc.reshape(-1) - Amat @ xl.reshape(-1)
        gg = float(grad @ grad)
        gAg = float(grad @ (Amat @ grad))
        alpha = gg / gAg if gAg > 0 else 0.0
        sol = (xl.reshape(-1) + alpha * grad).reshape(xl.shape)
    else:
        sol = bloc
    _write_back(data, sol)


def _write_back(data: _ALSData, sol) -> None:
    """Store the local solution into x's components; SVD-split for sites>1."""
    if data.sites == 1:
        data.x.components[data.curr] = Tensor._wrap(sol)
        data.x.assume_core_position(data.curr)
        return
    # (u, m, M, U) for sites=2
    U, S, Vt = fact.calculate_svd(Tensor._wrap(sol), 2,
                                  data.target_rank[data.curr],
                                  config.epsilon)
    if data.direction > 0:
        data.x.components[data.curr] = U
        data.x.components[data.curr + 1] = core_contract(S, Vt, 1)
        data.x.assume_core_position(data.curr + 1)
    else:
        data.x.components[data.curr] = core_contract(U, S, 1)
        data.x.components[data.curr + 1] = Vt
        data.x.assume_core_position(data.curr)


def _check_end_of_sweep(data: _ALSData, num_half_sweeps: int, conv_eps: float,
                        perf: PerformanceData) -> bool:
    """(als.cpp:426-475)"""
    at_right_end = data.direction > 0 and data.curr == data.num - data.sites
    at_left_end = data.direction < 0 and data.curr == 0
    if at_right_end or at_left_end:
        data.half_sweeps += 1
        data.last_energy2 = data.last_energy
        data.last_energy = data.energy
        data.energy = data.energy_value()
        if perf:
            flags = FLAG_FINISHED_HALFSWEEP if data.direction > 0 \
                else FLAG_FINISHED_FULLSWEEP
            perf.stop_timer()
            residual = data.residual()
            perf.continue_timer()
            perf.add(residual, data.x, flags)
        if (data.half_sweeps == num_half_sweeps
                or abs(data.last_energy - data.energy) < conv_eps
                or abs(data.last_energy2 - data.energy) < conv_eps
                or data.num <= data.sites):
            return True
        data.direction = -data.direction
    elif perf:
        perf.stop_timer()
        residual = data.residual()
        perf.continue_timer()
        perf.add(residual, data.x, 0)
    return False


# preset variants (als.cpp:556-563)
ALS = ALSVariant(1, 0, "lapack", assume_spd=False)
ALS_SPD = ALSVariant(1, 0, "lapack", assume_spd=True)
# matrix-free CG local solves: never forms the (r*n*r)^2 local operator
ALS_SPD_CG = ALSVariant(1, 0, "cg", assume_spd=True)
DMRG = ALSVariant(2, 0, "lapack", assume_spd=False)
DMRG_SPD = ALSVariant(2, 0, "lapack", assume_spd=True)
ASD = ALSVariant(1, 0, "asd", assume_spd=False)
ASD_SPD = ALSVariant(1, 0, "asd", assume_spd=True)
