"""UQ-ADF: reconstruct a solution TT over stochastic (Hermite) modes from
samples.

Counterpart of ``xerus_tpu/algorithms/uq_adf.py``, the re-design of
src/xerus/algorithms/uqAdf.cpp:30-477.  Mode 0 is the physical mode; modes
1..d-1 carry Hermite-polynomial embeddings of the random variables
(randVar_to_position, uqAdf.cpp:39-50).  The reference's per-sample loops
are batched (N, ...) einsums; one iteration (stacks + sweep), which the
JAX package compiled into one program, runs eagerly on the device the TT
objects compute on, with one residual read to the host per iteration.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import misc as _misc
from ..config import compute_device, config, require, torch_dtype
from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor


def randvar_to_position(v: float, poly_degree: int) -> np.ndarray:
    """Probabilists' Hermite embedding He_i(v) = H_i(v/sqrt2)/2^(i/2)
    (uqAdf.cpp:39-50): He_0 = 1, He_1 = v, He_{n+1} = v He_n - n He_{n-1}."""
    p = np.zeros(poly_degree, dtype=config.value_dtype)
    for i in range(poly_degree):
        if i == 0:
            p[i] = 1.0
        elif i == 1:
            p[i] = v
        else:
            p[i] = v * p[i - 1] - (i - 1) * p[i - 2]
    return p


class UQMeasurementSet:
    """(uqAdf.h:35-50)"""

    def __init__(self):
        self.randomVectors: List[List[float]] = []
        self.solutions: List[Tensor] = []
        self.initialRandomVectors: List[List[float]] = []
        self.initialSolutions: List[Tensor] = []

    def add(self, rndvec: Sequence[float], solution: Tensor) -> None:
        self.randomVectors.append(list(rndvec))
        self.solutions.append(solution.copy() if isinstance(solution, Tensor)
                              else Tensor.from_ndarray(solution))

    def add_initial(self, rndvec: Sequence[float], solution: Tensor) -> None:
        self.initialRandomVectors.append(list(rndvec))
        self.initialSolutions.append(solution.copy())


def _uq_iteration(cores: List[torch.Tensor], pos: Sequence[torch.Tensor],
                  sols: torch.Tensor, reduce=None):
    """One UQ-ADF iteration: canonicalize to site 0, right stacks, then a
    left-to-right sweep of projected-gradient steps with the optimal step
    size.  Returns (cores, residual norm as a 0-d tensor).  With
    ``reduce``, ``pos`` and ``sols`` hold this rank's block of the samples
    and ``reduce`` sums each sum over samples across ranks (the mesh
    path of ``uq_adf``)."""
    red = (lambda t: t) if reduce is None else reduce
    d = len(cores)
    cores = list(cores)
    for k in range(d - 1, 0, -1):
        rl, n, rr = cores[k].shape
        q, r = torch.linalg.qr(cores[k].reshape(rl, n * rr).T)
        cores[k] = q.T.reshape(q.shape[1], n, rr)
        cores[k - 1] = torch.einsum("anb,bk->ank", cores[k - 1], r.T)
    right = [None] * d
    right[d - 1] = torch.einsum("mn,anb->ma", pos[d - 2], cores[d - 1])
    for k in range(d - 2, 0, -1):
        right[k] = torch.einsum("mn,anb,mb->ma", pos[k - 1], cores[k],
                                right[k + 1])
    X0 = cores[0].reshape(cores[0].shape[1], cores[0].shape[2])
    pred = torch.einsum("nb,mb->mn", X0, right[1])
    resid = (torch.linalg.norm(pred - sols) if reduce is None
             else torch.sqrt(reduce(torch.sum((pred - sols) ** 2))))

    left_is = [None] * d
    left_ought = [None] * d
    for k in range(d):
        C = cores[k]
        if k == 0:
            delta = red(torch.einsum("mn,mb->nb", pred - sols, right[1]
                                     )).reshape(C.shape)
            tmp = torch.einsum("anb,mb->mn", delta, right[1])
            norm2 = red(torch.sum(tmp * tmp))
        else:
            w = pos[k - 1]
            if k < d - 1:
                is_part = torch.einsum("mn,anb,mb->ma", w, C, right[k + 1])
            else:
                is_part = torch.einsum("mn,anb->ma", w, C)
            if k > 1:
                is_part = torch.einsum("mab,mb->ma", left_is[k - 1], is_part)
            diff = is_part - left_ought[k - 1]
            if k < d - 1:
                delta = red(torch.einsum("ma,mn,mb->anb", diff, w,
                                         right[k + 1]))
                rp = torch.einsum("mn,anb,mb->ma", w, delta, right[k + 1])
            else:
                delta = red(torch.einsum("ma,mn->an", diff, w))[:, :, None]
                rp = torch.einsum("mn,anb->ma", w, delta)
            if k > 1:
                val = torch.einsum("ma,mab,mb->m", rp, left_is[k - 1], rp)
            else:
                val = torch.einsum("ma,ma->m", rp, rp)
            norm2 = torch.clamp_min(red(torch.sum(val)), 0.0)
        pyr = torch.sum(delta * delta)
        step = torch.where(norm2 > 0, pyr / torch.clamp_min(norm2, 1e-300),
                           torch.zeros_like(pyr))
        new_core = cores[k] - step * delta
        if k + 1 < d:
            rl, n, rr = new_core.shape
            q, r = torch.linalg.qr(new_core.reshape(rl * n, rr))
            cores[k] = q.reshape(rl, n, q.shape[1])
            cores[k + 1] = torch.einsum("ab,bnc->anc", r, cores[k + 1])
            # left stacks with the updated (orthogonal) core
            C2 = cores[k]
            if k == 0:
                X0n = C2.reshape(C2.shape[1], C2.shape[2])
                left_ought[0] = torch.einsum("mn,nb->mb", sols, X0n)
            else:
                meas = torch.einsum("mn,anb->mab", pos[k - 1], C2)
                if k > 1:
                    left_is[k] = torch.einsum("mab,mac,mcd->mbd", meas,
                                              left_is[k - 1], meas)
                else:
                    left_is[k] = torch.einsum("mab,mac->mbc", meas, meas)
                left_ought[k] = torch.einsum("ma,mab->mb", left_ought[k - 1],
                                             meas)
        else:
            cores[k] = new_core
    return cores, resid


def _uq_solve(x: TTTensor, random_variables, solutions,
              max_iterations: int = 1000, mesh=None) -> None:
    """Iterate until the residual falls by less than 1% over 9 iterations
    (or ``max_iterations``); x ends canonicalized at site 0.  With
    ``mesh`` each rank sweeps its dp block of the samples."""
    require(len(random_variables) == len(solutions),
            "need one solution per random vector")
    dev, dt = compute_device(), torch_dtype()
    sols = torch.as_tensor(np.stack(
        [np.asarray(s.to_ndarray() if isinstance(s, Tensor) else s)
         for s in solutions]), dtype=dt, device=dev)          # (N, n0)
    sol_norm = float(torch.linalg.norm(sols)) or 1.0
    # Hermite embeddings (N, n_k) of modes 1..d-1
    pos = [torch.as_tensor(np.stack(
        [randvar_to_position(rv[k - 1], x.dimensions[k])
         for rv in random_variables]), dtype=dt, device=dev)
        for k in range(1, x.degree())]
    cores = [c._torch() for c in x.components]
    reduce = None
    if mesh is not None:
        from ..parallel.mesh import Axis
        dp = Axis(mesh, "dp")
        require(mesh.device_type == dev.type,
                f"uq_adf: a {mesh.device_type} mesh for tensors on {dev}")
        pos = [dp.block(p) for p in pos]
        sols = dp.block(sols)
        reduce = dp.psum
    residuals = [1000.0] * 10
    for _ in range(max_iterations):
        cores, resid = _uq_iteration(cores, pos, sols, reduce)
        residuals.append(float(resid) / sol_norm)
        if residuals[-1] / residuals[-10] > 0.99:
            break
    x.components = [Tensor._wrap(c) for c in cores]
    x.canonicalized = False
    x.move_core(0, keep_rank=True)


def uq_adf(arg1, arg2, solutions=None, max_iterations: int = 1000,
           mesh=None):
    """uq_adf(x, random_variables, solutions) or
    uq_adf(measurement_set, guess) (uqAdf.h:54-56).  ``mesh`` (a
    DeviceMesh with a ``dp`` axis; every rank calls with the same
    arguments) shards the sample axis over dp: every sum over samples is
    summed across the ranks and the cores stay replicated."""
    if isinstance(arg1, UQMeasurementSet):
        ms, guess = arg1, arg2
        if ms.initialRandomVectors:
            x = _initial_guess_from_special_samples(ms, guess)
            rvs = list(ms.randomVectors) + list(ms.initialRandomVectors)
            sols = list(ms.solutions) + list(ms.initialSolutions)
        else:
            x = guess.copy()
            rvs, sols = list(ms.randomVectors), list(ms.solutions)
        _uq_solve(x, rvs, sols, max_iterations, mesh)
        return x
    _uq_solve(arg1, arg2, solutions, max_iterations, mesh)
    return None


def _initial_guess_from_special_samples(ms: UQMeasurementSet,
                                        guess: TTTensor) -> TTTensor:
    """Mean + per-direction linear terms from axis-aligned initial samples
    (uqAdf.cpp:334-407)."""
    dims = list(guess.dimensions)
    sols = [s.to_ndarray() if isinstance(s, Tensor) else np.asarray(s)
            for s in ms.solutions]
    mean = np.mean(np.stack(sols), axis=0)

    def term(first_vec, active: int = -1) -> TTTensor:
        comps = [Tensor.from_ndarray(first_vec.reshape(1, dims[0], 1))]
        for k in range(1, len(dims)):
            pos = 0 if (active < 0 or k - 1 == active) else 1
            comps.append(Tensor.dirac([1, dims[k], 1], [0, pos, 0]))
        out = TTTensor._make(comps)
        out.assume_core_position(0)
        return out

    new_x = term(mean)
    for m in range(len(ms.initialRandomVectors)):
        init = ms.initialSolutions[m]
        init_sol = (init.to_ndarray() if isinstance(init, Tensor)
                    else np.asarray(init))
        new_x += term(init_sol - mean, active=m)
    new_x.round(0.00025)
    return new_x


def uq_mc(x: TTTensor, N: int, num_special: int = 0
          ) -> Tuple[List[List[float]], List[Tensor]]:
    """Monte-Carlo sample (random vectors, solutions) from a UQ TT
    (uqAdf.cpp:425-448); the random variables come from the library's
    random engine."""
    rng = _misc.randomEngine
    dev, dt = compute_device(), torch_dtype()
    cores = [c._torch() for c in x.components]
    random_variables = []
    solutions = []
    for _ in range(N):
        rv = []
        p = torch.ones((1,), dtype=dt, device=dev)
        for k in range(x.degree() - 1, 0, -1):
            v = (0.3 if k <= num_special else 1.0) * float(rng.normal())
            rv.insert(0, v)
            w = torch.as_tensor(randvar_to_position(v, x.dimensions[k]),
                                dtype=dt, device=dev)
            p = torch.einsum("anb,b,n->a", cores[k], p, w)
        solutions.append(Tensor._wrap(torch.einsum("anb,b->n", cores[0], p)))
        random_variables.append(rv)
    return random_variables, solutions


def uq_avg(x: TTTensor, N: int, num_special: int = 0) -> Tensor:
    """Monte-Carlo average of the physical mode (uqAdf.cpp:451-477)."""
    _, sols = uq_mc(x, N, num_special)
    acc = sols[0]._torch()
    for s in sols[1:]:
        acc = acc + s._torch()
    return Tensor._wrap(acc / N)
