"""Single-site SPD ALS half-sweeps and the cancellation-free TT residual.

The ALS half of ``xerus_tpu/ops/tt_kernels.py``: ``_als_half_sweep``,
``_als_half_sweep_rl``, ``_tt_log_norm_qr`` and ``tt_residual_rel``.  The
JAX package traced each half-sweep into one XLA program; here the same
einsums, local solves and QRs run eagerly on whatever device the cores are
on.  Cores are (left rank, n, right rank) tensors; operator cores are
(left rank, m, n, right rank).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Cores = Tuple[torch.Tensor, ...]


def _local_solve(A: torch.Tensor, b: torch.Tensor, assume: str):
    """"pos": Cholesky (symmetric operators); "gen": LU.

    The ``_ex`` forms do not check the factorization on the host, so a
    solve costs no device sync; a failed factorization gives NaNs, as
    jax.scipy.linalg.solve does."""
    if assume == "pos":
        L = torch.linalg.cholesky_ex(A)[0]
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    if assume == "gen":
        return torch.linalg.solve_ex(A, b)[0]
    raise ValueError(f"assume must be 'pos' or 'gen', got {assume!r}")


def _als_half_sweep(x_cores: Sequence[torch.Tensor],
                    A_cores: Sequence[torch.Tensor],
                    b_cores: Sequence[torch.Tensor], assume: str = "pos"
                    ) -> Cores:
    """Left-to-right single-site ALS half-sweep (energy-functional local
    problems); x canonicalized at site 0.  Returns the cores with the core
    at site d-1."""
    d = len(x_cores)
    one3 = x_cores[0].new_ones((1, 1, 1))
    one2 = x_cores[0].new_ones((1, 1))
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = one3
    rhs_right[d] = one2
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = torch.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                   op_right[k + 1])
        rhs_right[k] = torch.einsum("umU,bmB,UB->ub", xc, bc, rhs_right[k + 1])

    x_cores = list(x_cores)
    op_left, rhs_left = one3, one2
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
            rl, n, rr = core.shape
            q, r = torch.linalg.qr(core.reshape(rl * n, rr))
            x_cores[k] = q.reshape(rl, n, q.shape[1])
            x_cores[k + 1] = torch.einsum("ab,bnc->anc", r, x_cores[k + 1])
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
