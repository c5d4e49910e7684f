"""Single-site ALS half-sweeps, the cancellation-free TT residual and the
whole-solve drivers.

The ALS half of ``xerus_tpu/ops/tt_kernels.py`` (``:2138-2710``): the SPD
half-sweeps ``_als_half_sweep`` / ``_als_half_sweep_rl`` (Cholesky or LU
local solves), the matrix-free CG half-sweep, the ASD half-sweep, the
normal-equations half-sweep for general operators, ``_tt_log_norm_qr`` and
``tt_residual_rel``; the plain loops ``als_sweep``, ``als_sweep_res``,
``als_multi_sweep_res`` and ``als_sweep_flops``; the factories
``make_als_sweep``, ``make_als_sweep_res``, ``make_als_multi_sweep_res``
and ``make_als_sweep_batched`` (the sweep vmapped over a batch of
systems, behind ``als_half_sweep_batched``), which return the same
functions as captured programs (``ops/programs.py``: a CUDA graph per
shape key on the card, eager on the CPU); and the whole solves
``als_run`` / ``als_run_rev``, which replay one sweep-and-residual program
per half-sweep and read the stop flag between them.  Cores are (left
rank, n, right rank) tensors; operator cores are (left rank, m, n, right
rank).
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Sequence, Tuple

import torch

from .programs import Program, call, factory
from .round_kernels import host_bool

Cores = Tuple[torch.Tensor, ...]

_TINY = 1e-30


def _local_solve(A: torch.Tensor, b: torch.Tensor, assume: str):
    """"pos": Cholesky (symmetric operators); "gen": LU.

    The ``_ex`` forms do not check the factorization on the host, so a
    solve costs no device sync.  A failed factorization gives NaNs, as
    jax.scipy.linalg.solve does: LAPACK's and cuSOLVER's factorizations
    stop at the failing pivot and leave finite values behind, so the
    factorization's ``info`` selects NaNs on the device."""
    if assume == "pos":
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
    elif assume == "gen":
        x, info = torch.linalg.solve_ex(A, b)
    else:
        raise ValueError(f"assume must be 'pos' or 'gen', got {assume!r}")
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


def _right_envs(x_cores, A_cores, b_cores):
    """Right environments of the SPD sweeps: op_right[k] and rhs_right[k]
    hold sites k..d-1 (op_right[d], rhs_right[d] are ones)."""
    d = len(x_cores)
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = x_cores[0].new_ones((1, 1, 1))
    rhs_right[d] = x_cores[0].new_ones((1, 1))
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = torch.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                   op_right[k + 1])
        rhs_right[k] = torch.einsum("umU,bmB,UB->ub", xc, bc,
                                    rhs_right[k + 1])
    return op_right, rhs_right


def _move_right(x_cores: List[torch.Tensor], k: int, core: torch.Tensor
                ) -> None:
    """Core ``core`` at site k becomes its Q; R goes into site k + 1."""
    rl, n, rr = core.shape
    q, r = torch.linalg.qr(core.reshape(rl * n, rr))
    x_cores[k] = q.reshape(rl, n, q.shape[1])
    x_cores[k + 1] = torch.einsum("ab,bnc->anc", r, x_cores[k + 1])


def _als_half_sweep(x_cores: Sequence[torch.Tensor],
                    A_cores: Sequence[torch.Tensor],
                    b_cores: Sequence[torch.Tensor], assume: str = "pos"
                    ) -> Cores:
    """Left-to-right single-site ALS half-sweep (energy-functional local
    problems); x canonicalized at site 0.  Returns the cores with the core
    at site d-1.  ``assume`` picks the local solver: "pos" Cholesky
    (symmetric operators), "gen" LU; the caller decides once per operator,
    as the JAX package does."""
    d = len(x_cores)
    op_right, rhs_right = _right_envs(x_cores, A_cores, b_cores)
    x_cores = list(x_cores)
    op_left, rhs_left = op_right[d], rhs_right[d]
    for k in range(d):
        Ac, bc = A_cores[k], b_cores[k]
        Aloc = torch.einsum("uav,amnb,UbV->umUvnV", op_left, Ac,
                            op_right[k + 1])
        bloc = torch.einsum("ub,bmB,UB->umU", rhs_left, bc, rhs_right[k + 1])
        shape = bloc.shape
        nn = shape[0] * shape[1] * shape[2]
        core = _local_solve(Aloc.reshape(nn, nn), bloc.reshape(nn),
                            assume).reshape(shape)
        if k < d - 1:
            _move_right(x_cores, k, core)
            op_left = torch.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                   x_cores[k], Ac, x_cores[k])
            rhs_left = torch.einsum("ub,umU,bmB->UB", rhs_left, x_cores[k], bc)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _als_half_sweep_rl(x_cores: Sequence[torch.Tensor],
                       A_cores: Sequence[torch.Tensor],
                       b_cores: Sequence[torch.Tensor], assume: str = "pos"
                       ) -> Cores:
    """Right-to-left mirror of ``_als_half_sweep``; x canonicalized at site
    d-1.  Returns the cores with the core at site 0."""
    d = len(x_cores)
    one3 = x_cores[0].new_ones((1, 1, 1))
    one2 = x_cores[0].new_ones((1, 1))
    op_left = [None] * d
    rhs_left = [None] * d
    op_left[0] = one3
    rhs_left[0] = one2
    for k in range(0, d - 1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_left[k + 1] = torch.einsum("uav,umU,amnb,vnV->UbV", op_left[k],
                                      xc, Ac, xc)
        rhs_left[k + 1] = torch.einsum("ub,umU,bmB->UB", rhs_left[k], xc, bc)

    x_cores = list(x_cores)
    op_right, rhs_right = one3, one2
    for k in range(d - 1, -1, -1):
        Ac, bc = A_cores[k], b_cores[k]
        Aloc = torch.einsum("uav,amnb,UbV->umUvnV", op_left[k], Ac, op_right)
        bloc = torch.einsum("ub,bmB,UB->umU", rhs_left[k], bc, rhs_right)
        shape = bloc.shape
        nn = shape[0] * shape[1] * shape[2]
        core = _local_solve(Aloc.reshape(nn, nn), bloc.reshape(nn),
                            assume).reshape(shape)
        if k > 0:
            rl, n, rr = core.shape
            # RQ via the QR of the transposed matricization: rows orthonormal
            q, r = torch.linalg.qr(core.reshape(rl, n * rr).T)
            kk = q.shape[1]
            x_cores[k] = q.T.reshape(kk, n, rr)
            x_cores[k - 1] = torch.einsum("anb,bc->anc", x_cores[k - 1], r.T)
            op_right = torch.einsum("umU,amnb,vnV,UbV->uav", x_cores[k],
                                    Ac, x_cores[k], op_right)
            rhs_right = torch.einsum("umU,bmB,UB->ub", x_cores[k], bc,
                                     rhs_right)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _matrix_free_half_sweep(x_cores, A_cores, b_cores, step) -> Cores:
    """Left-to-right SPD half-sweep whose local update never forms the
    local operator: ``step(x_k, b_loc, apply_loc)`` returns the new core,
    ``apply_loc`` applies the local operator through the environments
    (three small einsums).  x canonicalized at site 0."""
    d = len(x_cores)
    op_right, rhs_right = _right_envs(x_cores, A_cores, b_cores)
    x_cores = list(x_cores)
    op_left, rhs_left = op_right[d], rhs_right[d]
    for k in range(d):
        Ac, bc, xc = A_cores[k], b_cores[k], x_cores[k]
        opR = op_right[k + 1]

        def apply_loc(v, opL=op_left, Ak=Ac, opRk=opR):
            t = torch.einsum("uav,vnV->uanV", opL, v)
            t = torch.einsum("amnb,uanV->umbV", Ak, t)
            return torch.einsum("UbV,umbV->umU", opRk, t)

        bloc = torch.einsum("ub,bmB,UB->umU", rhs_left, bc, rhs_right[k + 1])
        core = step(xc, bloc, apply_loc)
        if k < d - 1:
            _move_right(x_cores, k, core)
            op_left = torch.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                   x_cores[k], Ac, x_cores[k])
            rhs_left = torch.einsum("ub,umU,bmB->UB", rhs_left, x_cores[k], bc)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _safe_ratio(num, den):
    """num / den where den > 1e-30, else 0 (on the device)."""
    return torch.where(den > _TINY, num / torch.clamp_min(den, _TINY),
                       torch.zeros_like(num))


def _als_half_sweep_cg(x_cores: Sequence[torch.Tensor],
                       A_cores: Sequence[torch.Tensor],
                       b_cores: Sequence[torch.Tensor], cg_iters: int = 24
                       ) -> Cores:
    """Single-site SPD half-sweep with matrix-free CG local solves: a fixed
    ``cg_iters`` CG steps from the current core (warm start) instead of
    forming and factoring the (r n r)^2 local operator, O(cg_iters r^3 n^2
    a) flops and O(r^2 n a) memory per site.  x canonicalized at site 0;
    left to right only (the drivers reverse the sites for the other
    direction)."""
    def step(xc, bloc, apply_loc):
        rv = bloc - apply_loc(xc)
        xv, pv, rs = xc, rv, torch.sum(rv * rv)
        for _ in range(cg_iters):
            Ap = apply_loc(pv)
            alpha = _safe_ratio(rs, torch.sum(pv * Ap))
            xv = xv + alpha * pv
            rv = rv - alpha * Ap
            rs2 = torch.sum(rv * rv)
            pv = rv + _safe_ratio(rs2, rs) * pv
            rs = rs2
        return xv

    return _matrix_free_half_sweep(x_cores, A_cores, b_cores, step)


def _asd_half_sweep(x_cores: Sequence[torch.Tensor],
                    A_cores: Sequence[torch.Tensor],
                    b_cores: Sequence[torch.Tensor]) -> Cores:
    """Single-site SPD ASD half-sweep (the reference's ASD_solver,
    als.cpp:73-92): one exact-stepsize gradient step per site,
    x_k += alpha (b_loc - A_loc x_k), alpha = <g,g> / <g, A_loc g>.
    x canonicalized at site 0; left to right only."""
    def step(xc, bloc, apply_loc):
        grad = bloc - apply_loc(xc)
        alpha = _safe_ratio(torch.sum(grad * grad),
                            torch.sum(grad * apply_loc(grad)))
        return xc + alpha * grad

    return _matrix_free_half_sweep(x_cores, A_cores, b_cores, step)


def _als_half_sweep_nonspd(x_cores: Sequence[torch.Tensor],
                           A_cores: Sequence[torch.Tensor],
                           b_cores: Sequence[torch.Tensor]) -> Cores:
    """Normal-equations (A^T A x = A^T b) left-to-right half-sweep for
    general operators (the reference's non-SPD energy functional), with
    Cholesky local solves; x canonicalized at site 0."""
    d = len(x_cores)
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = x_cores[0].new_ones((1, 1, 1, 1))
    rhs_right[d] = x_cores[0].new_ones((1, 1, 1))
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = torch.einsum("umU,pzmq,rznt,vnV,UqtV->uprv", xc, Ac,
                                   Ac, xc, op_right[k + 1])
        rhs_right[k] = torch.einsum("bzB,azmq,umU,BqU->bau", bc, Ac, xc,
                                    rhs_right[k + 1])

    x_cores = list(x_cores)
    op_left, rhs_left = op_right[d], rhs_right[d]
    for k in range(d):
        Ac, bc = A_cores[k], b_cores[k]
        Aloc = torch.einsum("uprv,pzmq,rznt,UqtV->umUvnV", op_left, Ac, Ac,
                            op_right[k + 1])
        bloc = torch.einsum("bau,bzB,azmq,BqU->umU", rhs_left, bc, Ac,
                            rhs_right[k + 1])
        shape = bloc.shape
        nn = shape[0] * shape[1] * shape[2]
        core = _local_solve(Aloc.reshape(nn, nn), bloc.reshape(nn),
                            "pos").reshape(shape)
        if k < d - 1:
            _move_right(x_cores, k, core)
            op_left = torch.einsum("uprv,umU,pzmq,rznt,vnV->UqtV", op_left,
                                   x_cores[k], Ac, Ac, x_cores[k])
            rhs_left = torch.einsum("bau,bzB,azmq,umU->BqU", rhs_left, bc,
                                    Ac, x_cores[k])
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _tt_log_norm_qr(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """log ||TT||_F by a log-scaled left-to-right QR sweep: no Gram
    quadratic form, so no cancellation; the norm is read off the final
    carry to O(eps) relative accuracy."""
    R = cores[0].new_ones((1, 1))
    logs = cores[0].new_zeros(())
    for core in cores[:-1]:
        _, n, rr = core.shape
        k = R.shape[0]
        cur = torch.einsum("ka,anb->knb", R, core).reshape(k * n, rr)
        R = torch.linalg.qr(cur, mode="r")[1]
        nrm = torch.linalg.norm(R) + 1e-30
        logs = logs + torch.log(nrm)
        R = R / nrm
    last = torch.einsum("ka,anb->knb", R, cores[-1])
    return logs + torch.log(torch.linalg.norm(last) + 1e-30)


def tt_residual_rel(x_cores: Sequence[torch.Tensor],
                    A_cores: Sequence[torch.Tensor],
                    b_cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Relative TT residual ||Ax-b||_F / ||b||_F as a 0-d tensor.

    z = Ax - b is built in TT block form per site (A x is never formed as
    a dense tensor) and its norm read by ``_tt_log_norm_qr``; this resolves
    residuals down to ~eps*||b||, where the <Ax,Ax> - 2<Ax,b> + <b,b>
    quadratic form floors at sqrt(eps)*||b||."""
    d = len(x_cores)
    z_cores = []
    for k in range(d):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        al, m, _n, ar = Ac.shape
        xl, _, xr = xc.shape
        bl, _, br = bc.shape
        ax = torch.einsum("amnb,unU->aumbU", Ac, xc).reshape(al * xl, m,
                                                             ar * xr)
        if d == 1:
            z_cores.append(ax - bc)
        elif k == 0:
            z_cores.append(torch.cat([ax, -bc], dim=2))
        elif k == d - 1:
            z_cores.append(torch.cat([ax, bc], dim=0))
        else:
            top = torch.cat([ax, ax.new_zeros((al * xl, m, br))], dim=2)
            bot = torch.cat([ax.new_zeros((bl, m, ar * xr)), bc], dim=2)
            z_cores.append(torch.cat([top, bot], dim=0))
    return torch.exp(_tt_log_norm_qr(z_cores) - _tt_log_norm_qr(b_cores))


# ---------------------------------------------------------------------------
# Drivers: the JAX package's make_* factories as plain functions
# ---------------------------------------------------------------------------

def reverse_tt(cores: Sequence[torch.Tensor]) -> Cores:
    """Site reversal of a TT (exact transposes)."""
    return tuple(c.permute(2, 1, 0) for c in reversed(cores))


def reverse_op(cores: Sequence[torch.Tensor]) -> Cores:
    """Site reversal of a TT operator (exact transposes)."""
    return tuple(c.permute(3, 1, 2, 0) for c in reversed(cores))


def _sweep_body(direction: str = "lr", spd: bool = True,
                solver: str = "lapack", local_assume: str = "pos"):
    """The half-sweep the JAX package's make_als_sweep(_res) picks: ASD
    and CG exist left to right only (callers reverse the sites), as does
    the normal-equations sweep of a general operator."""
    if solver == "asd":
        return _asd_half_sweep
    if solver == "cg":
        return _als_half_sweep_cg
    if not spd:
        return _als_half_sweep_nonspd
    raw = _als_half_sweep if direction == "lr" else _als_half_sweep_rl
    return lambda x, A, b: raw(x, A, b, assume=local_assume)


def als_sweep(x_cores, A_cores, b_cores, direction: str = "lr",
              spd: bool = True, solver: str = "lapack",
              local_assume: str = "pos") -> Cores:
    """One half-sweep (``make_als_sweep``)."""
    return _sweep_body(direction, spd, solver, local_assume)(
        x_cores, A_cores, b_cores)


def als_sweep_res(x_cores, A_cores, b_cores, direction: str = "lr",
                  spd: bool = True, solver: str = "lapack",
                  local_assume: str = "pos"):
    """One half-sweep and the relative residual after it, a 0-d tensor on
    the cores' device (``make_als_sweep_res``): nothing is read back."""
    out = als_sweep(x_cores, A_cores, b_cores, direction, spd, solver,
                    local_assume)
    return out, tt_residual_rel(out, A_cores, b_cores)


def als_multi_sweep_res(x_cores, A_cores, b_cores, n_half_sweeps: int,
                        spd: bool = True, local_assume: str = "pos"):
    """``n_half_sweeps`` alternating half-sweeps (lr first; general
    operators run the normal-equations sweep each time, as the JAX
    package does) with the relative residual after each.  Returns (cores,
    (n,) residuals); x enters canonicalized at site 0."""
    cores, hist = tuple(x_cores), []
    for s in range(n_half_sweeps):
        if spd:
            cores = als_sweep(cores, A_cores, b_cores,
                              "lr" if s % 2 == 0 else "rl",
                              local_assume=local_assume)
        else:
            cores = _als_half_sweep_nonspd(cores, A_cores, b_cores)
        hist.append(tt_residual_rel(cores, A_cores, b_cores))
    return cores, torch.stack(hist)


def _rev_sweep_res(x_cores, A_cores, b_cores, solver: str):
    """The left-to-right-only half-sweep of ``solver`` ("nonspd", "asd",
    "cg") run right to left on the site-reversed system, and the relative
    residual after it."""
    body = _sweep_body("lr", spd=(solver != "nonspd"),
                       solver=solver if solver in ("asd", "cg") else "lapack")
    out = reverse_tt(body(reverse_tt(x_cores), reverse_op(A_cores),
                          reverse_tt(b_cores)))
    return out, tt_residual_rel(out, A_cores, b_cores)


# ---------------------------------------------------------------------------
# The JAX package's factories: the same functions as captured programs
# ---------------------------------------------------------------------------

@factory(64)
def make_als_sweep(shapes_key, dtype_str: str, direction: str = "lr",
                   spd: bool = True, solver: str = "lapack",
                   local_assume: str = "pos") -> Program:
    """``als_sweep`` as a program for inputs of ``shapes_key``
    (``programs.shapes_key(x, A, b)``): (x, A, b) -> cores."""
    return Program(_sweep_body(direction, spd, solver, local_assume),
                   f"als_sweep[{direction}]")


@factory(64)
def make_als_sweep_res(shapes_key, dtype_str: str, direction: str = "lr",
                       spd: bool = True, solver: str = "lapack",
                       local_assume: str = "pos") -> Program:
    """``als_sweep_res`` as a program: one half-sweep and the relative
    residual after it, (x, A, b) -> (cores, 0-d residual), nothing read
    back."""
    return Program(partial(als_sweep_res, direction=direction, spd=spd,
                           solver=solver, local_assume=local_assume),
                   f"als_sweep_res[{direction}]")


@factory(16)
def make_als_multi_sweep_res(shapes_key, dtype_str: str, n_half_sweeps: int,
                             spd: bool = True, local_assume: str = "pos"
                             ) -> Program:
    """``als_multi_sweep_res`` as one program: (x, A, b) -> (cores, (n,)
    residuals)."""
    return Program(partial(als_multi_sweep_res, n_half_sweeps=n_half_sweeps,
                           spd=spd, local_assume=local_assume),
                   f"als_multi_sweep_res[{n_half_sweeps}]")


@factory(16)
def _make_rev_sweep_res(shapes_key, dtype_str: str, solver: str) -> Program:
    """``_rev_sweep_res`` as a program (``als_run_rev``'s odd
    half-sweeps)."""
    return Program(partial(_rev_sweep_res, solver=solver),
                   f"als_rev_sweep_res[{solver}]")


def _run_loop(x_cores, conv_eps, parity0: int, remaining: int, last0: float,
              last20: float, max_sweeps: int, step):
    """The carry protocol of ``make_als_run`` / ``make_als_run_rev``:
    half-sweep i is ``step(even, cores)`` with ``even`` true when
    (parity0 + i) is even, returning (cores, relative residual); the
    residual goes into hist[i] and the two-back stagnation test
    |last - res| < eps or |last2 - res| < eps decides the stop, at most
    min(max_sweeps, remaining) half-sweeps.  One boolean is read to the
    host per half-sweep (the JAX package's lax.while_loop kept it on the
    device)."""
    cores = tuple(x_cores)
    ref = cores[0]
    hist = torch.full((max_sweeps,), math.inf, dtype=ref.dtype,
                      device=ref.device)
    eps = torch.as_tensor(conv_eps, dtype=ref.dtype, device=ref.device)
    last = torch.as_tensor(last0, dtype=ref.dtype, device=ref.device)
    last2 = torch.as_tensor(last20, dtype=ref.dtype, device=ref.device)
    limit = min(int(max_sweeps), int(remaining))
    i = 0
    while i < limit:
        cores, res = step((int(parity0) + i) % 2 == 0, cores)
        hist[i] = res
        stop = ((last - res).abs() < eps) | ((last2 - res).abs() < eps)
        last2, last = last, res
        i += 1
        if host_bool(stop):
            break
    return cores, hist, i


def spd_step(A_cores, b_cores, local_assume: str = "pos",
             eager: bool = False):
    """``als_run``'s half-sweep: (even, cores) -> (cores, relative
    residual), lr when ``even``, a call of ``make_als_sweep_res``'s
    program in the form the solve makes (``warmup`` warms it so)."""
    def step(even, cs):
        return call(make_als_sweep_res, (cs, A_cores, b_cores),
                    "lr" if even else "rl", True, "lapack", local_assume,
                    eager=eager)
    return step


def rev_step(A_cores, b_cores, solver: str = "nonspd", eager: bool = False):
    """``als_run_rev``'s half-sweep, as ``spd_step``: the lr sweep when
    ``even``, else the lr sweep of the site-reversed system."""
    spd = solver != "nonspd"
    lr_solver = solver if solver in ("asd", "cg") else "lapack"

    def step(even, cs):
        args = (cs, A_cores, b_cores)
        if even:
            return call(make_als_sweep_res, args, "lr", spd, lr_solver,
                        eager=eager)
        return call(_make_rev_sweep_res, args, solver, eager=eager)
    return step


def als_run(x_cores, A_cores, b_cores, conv_eps, parity0: int,
            remaining: int, last0: float, last20: float, max_sweeps: int,
            local_assume: str = "pos", eager: bool = False):
    """The whole fixed-rank SPD ALS solve (``make_als_run``): lr and rl
    half-sweeps alternating by parity, the relative residual after each,
    stopped by the two-back stagnation test or after min(max_sweeps,
    remaining) half-sweeps.

    ``parity0`` continues the alternation and ``last0`` / ``last20`` the
    stagnation history across calls (pass inf on the first); the caller
    calls again while the count equals the bucket ``max_sweeps``.  Returns
    (cores, hist, count): hist is (max_sweeps,), hist[i] the residual after
    half-sweep i for i < count, inf past it.  Each half-sweep is a replay
    of ``make_als_sweep_res``'s program (on the card; ``eager`` runs its
    function eagerly instead); one boolean is read to the host per
    half-sweep."""
    return _run_loop(x_cores, conv_eps, parity0, remaining, last0, last20,
                     max_sweeps, spd_step(A_cores, b_cores, local_assume,
                                          eager))


def als_run_rev(x_cores, A_cores, b_cores, conv_eps, parity0: int,
                remaining: int, last0: float, last20: float,
                max_sweeps: int, solver: str = "nonspd", eager: bool = False):
    """``als_run`` for the half-sweeps that exist left to right only
    (``make_als_run_rev``): the normal equations (``solver="nonspd"``),
    ASD (``"asd"``) and matrix-free CG (``"cg"``).  Odd half-sweeps run
    the lr sweep on the site-reversed system (``_rev_sweep_res``).  Cores
    enter canonicalized at site 0 and leave with the core at d-1 after an
    even executed count (parity0 + count), at 0 after an odd one.  Same
    carry protocol, programs and host reads as ``als_run``."""
    return _run_loop(x_cores, conv_eps, parity0, remaining, last0, last20,
                     max_sweeps, rev_step(A_cores, b_cores, solver, eager))


def _batched_body(direction: str, local_assume: str):
    """The SPD half-sweep mapped over a leading batch axis of x and b
    (``torch.func.vmap``, in_dims (0, None, 0), the JAX package's
    ``jax.vmap``): every einsum, Cholesky / LU solve and QR of the sweep
    has a batching rule, so each runs once over the whole batch.  On the
    card its batched factorizations and solves run on cuSOLVER: torch's
    heuristics send a batched Cholesky solve to MAGMA, whose calls
    synchronize the stream, which a captured region refuses."""
    body = torch.func.vmap(_sweep_body(direction, True, "lapack",
                                       local_assume), in_dims=(0, None, 0))

    def run(x_batch, A_cores, b_batch):
        if not x_batch[0].is_cuda:
            return body(x_batch, A_cores, b_batch)
        backend = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            return body(x_batch, A_cores, b_batch)
        finally:
            torch.backends.cuda.preferred_linalg_library(backend)
    return run


@factory(16)
def make_als_sweep_batched(shapes_key, dtype_str: str, direction: str = "lr",
                           local_assume: str = "pos") -> Program:
    """One SPD half-sweep over a batch of systems that share the operator,
    as one program for inputs of ``shapes_key`` (``programs.shapes_key(
    x_batch, A, b_batch)``): (x_batch, A, b_batch) -> per-site batches (the
    JAX package's ``make_als_sweep_batched``, xerus_tpu/ops/tt_kernels.py:
    2646, which vmaps the sweep; the reference protocol solves 10 systems
    of one operator per run)."""
    return Program(_batched_body(direction, local_assume),
                   f"als_sweep_batched[{direction}]")


def als_half_sweep_batched(x_batch, A_cores, b_batch, direction: str = "lr",
                           local_assume: str = "pos", eager: bool = False):
    """One SPD half-sweep over a batch of systems that share the operator:
    ``x_batch`` / ``b_batch`` are per-site tensors with a leading batch
    axis, every instance of the same core shapes.  Returns the per-site
    batches.  The sweep runs once over the batch
    (``make_als_sweep_batched``'s program on the card, or with ``eager``
    its function run eagerly), as the JAX package's vmapped program
    does."""
    return call(make_als_sweep_batched,
                (tuple(x_batch), tuple(A_cores), tuple(b_batch)),
                direction, local_assume, eager=eager)


def als_sweep_flops(x_shapes, A_shapes) -> float:
    """Rough FLOP count of one half-sweep (environments and local
    solves)."""
    total = 0.0
    for (rl, n, rr), (al, _m, _m2, ar) in zip(x_shapes, A_shapes):
        total += 4.0 * rl * rr * al * ar * n * n
        loc = rl * n * rr
        total += 2.0 * loc * loc * max(al, ar) + (2.0 / 3.0) * loc ** 3
    return total
