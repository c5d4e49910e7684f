"""Two-site DMRG: ground-state half-sweeps, the SPD linear-solve half-sweep
and their drivers.

Counterpart of ``xerus_tpu/ops/dmrg_kernels.py``.  The JAX package traced
each half-sweep into one XLA program through ``make_*`` factories; here
each is a plain function whose site loop runs eagerly on the device the
stacks are on, in their own dtype (float64 runs in float64 on the card).
Each JAX name maps to one function here:

- ``_dmrg_eig_half_sweep`` / ``dmrg_groundstate_fast``: the unrolled
  dense-eigh half-sweep on true-shape cores and its driver;
- ``_dmrg_eig_half_sweep_scan`` (dense local eigh) and
  ``_dmrg_lobpcg_half_sweep_scan`` (matrix-free Lanczos or LOBPCG) over
  padded uniform stacks, with ``_right_prj_envs``, the projector carry of
  the spectral shift; ``make_dmrg_sweep_scan`` / ``make_dmrg_sweep_lobpcg``
  are these functions themselves;
- ``dmrg_run`` (``make_dmrg_run``), the whole ground-state solve as a host
  loop with one energy read per half-sweep, its body (half-sweep, the
  sweep's core normalized, site reversal) the program ``make_dmrg_step``;
- ``_cg_solve_local``, ``_dmrg_solve_half_sweep_scan`` and ``dmrg_solve``,
  the two-site SPD solver;
- ``dmrg_half_sweep_batched`` (``make_dmrg_sweep_batched``) and
  ``dmrg_groundstate_multistart``; ``dmrg_groundstate_scan``.

``jax.lax.scan`` is a Python loop over sites; ``jax.vmap`` is a leading
batch axis: every padded-stack function takes (d, r, n, r) stacks or
(B, d, r, n, r) batches, and runs the same einsums, ``torch.linalg.eigh``
and ``torch.linalg.svd`` with the batch axis in front.  The operator stack
(d, a, n, n, a) is shared by the batch.

Padding to a uniform rank zero-pads the boundary frames (bond k has true
rank <= n^k), so the padded local operators gain spurious zero
eigenvalues.  When the ground energy is negative these never win; for
ground energies >= 0 the drivers solve (A - s P) with P the carried
true-subspace projector and s > lambda_min, estimated by ``_estimate_shift``.

Programs and host reads.  On the card the Ritz problems of the Lanczos
and LOBPCG local solves run on K4 and the masked split on K5
(``ops/small_eig.py``, Jacobi in float64), which read nothing back, so a
ground-state half-sweep (single or batched) and the SPD solve's half-sweep
are captured programs (``ops/programs.py``): ``make_dmrg_step``,
``make_dmrg_sweep`` (the shift estimate's) and ``make_dmrg_solve_step``,
replayed after ``programs.EAGER_CALLS`` eager calls per shape key.  The
shift enters them as a 0-d device tensor.  The solves read one energy
(or residual) per half-sweep (``round_kernels.host_float``, counted in
``host_bool.reads``) and K4/K5's health record once per solve
(``small_eig.check_health``), which raises if a matrix failed.  On the
CPU the same calls are ``torch.linalg``'s (LAPACK, the routines the JAX
package's CPU run reaches).  The dense-eigh sweeps keep cuSOLVER's eigh,
whose ``info`` torch reads to the host (``linalg_host_checks`` counts
those calls), and stay eager.  The thresholds that decide (Lanczos' ``nb
> 1e-7``, the Ritz penalty ``1e4 (max|T| + 1)``, the 1e-30 guards) are the
JAX package's, bit for bit.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from ..core.factorizations import _svd as thin_svd
from . import programs, small_eig
from .programs import Program, factory
from .round_kernels import _eigh_sym, host_float, res_rank
from .stacking import pad_cores

_TINY = 1e-30
# half-sweeps per dmrg_run call (the JAX package's static compile bucket)
CAP = 64


def linalg_host_checks() -> int:
    """eigh and svd calls on CUDA tensors so far: torch reads each call's
    ``info`` back to the host."""
    return _info_check.reads


def _info_check(M: torch.Tensor) -> None:
    """Count one eigh or svd whose ``info`` torch reads to the host."""
    if M.is_cuda:
        _info_check.reads += 1


_info_check.reads = 0


def _eigh(A: torch.Tensor):
    """torch.linalg.eigh of a (batch of) symmetric matrices.  On the CPU,
    where it reports non-convergence, retry with scipy's LAPACK syevd (the
    routine the JAX package's CPU eigh reaches), counted in
    ``_eigh.fallbacks``: torch's CPU syevd fails on padded local operators
    with hundreds of zero rows (d=8 rank 16: 896 of 1024) that LAPACK's
    own syevd solves.  On the card the error is raised: nothing moves to
    the host; float32 is solved there in float64 (``_eigh_sym``)."""
    _info_check(A)
    try:
        return _eigh_sym(A)
    except torch.linalg.LinAlgError:
        if A.is_cuda:
            raise
        import numpy as np
        from scipy.linalg import eigh as scipy_eigh
        _eigh.fallbacks += 1
        host = A.detach().numpy().reshape((-1,) + tuple(A.shape[-2:]))
        pairs = [scipy_eigh(m, driver="evd") for m in host]
        w = np.stack([p[0] for p in pairs]).reshape(A.shape[:-1])
        v = np.stack([p[1] for p in pairs]).reshape(A.shape)
        return torch.from_numpy(w), torch.from_numpy(v)


_eigh.fallbacks = 0


def _svd(M: torch.Tensor):
    """The object layer's thin SVD (gesvd on the card), its info check
    counted."""
    _info_check(M)
    return thin_svd(M)


def _ritz_eigh(T: torch.Tensor):
    """Eigenpairs of the (B, m, m) Ritz problems: K4 on the card, LAPACK's
    syevd on the CPU."""
    if T.is_cuda:
        return small_eig.small_eigh_launch(T)[:2]
    return _eigh(T)


def _split_svd(M: torch.Tensor):
    """Thin SVD of the (B, r n, n r) two-site blocks: K5 on the card (an
    orthonormal U also where sigma is zero), LAPACK's gesdd on the CPU."""
    if M.is_cuda:
        return small_eig.small_svd_launch(M)[:3]
    return _svd(M)


def _check_kernels(t: torch.Tensor) -> None:
    """Read K4/K5's health record of ``t``'s card once (a solve's end) and
    raise if a matrix failed; nothing on the CPU."""
    if t.is_cuda:
        small_eig.check_health(t.device)


# ---------------------------------------------------------------------------
# the unrolled dense-eigh half-sweep on true-shape cores
# ---------------------------------------------------------------------------

def _dmrg_eig_half_sweep(x_cores, A_cores):
    """Two-site ground-state half-sweep (lr) on true-shape cores, x
    canonicalized at 0; the split keeps exactly the bond dimension of x.
    Returns (new cores, energy of the last local problem)."""
    d = len(x_cores)
    ref = x_cores[0]
    one = torch.ones((1, 1, 1), dtype=ref.dtype, device=ref.device)
    op_right = [one]
    for k in range(d - 1, 1, -1):
        xc, Ac = x_cores[k], A_cores[k]
        op_right.append(torch.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                     op_right[-1]))
    x_cores = list(x_cores)
    op_left = one
    energy = None
    for k in range(d - 1):
        A1, A2 = A_cores[k], A_cores[k + 1]
        R = op_right[d - 2 - k]
        Aloc = torch.einsum("uav,amnb,bMNc,UcV->umMUvnNV", op_left, A1, A2, R)
        u_, m_, M_, U_ = Aloc.shape[:4]
        nn = u_ * m_ * M_ * U_
        w, v = _eigh(Aloc.reshape(nn, nn))
        energy = w[0]
        ground = v[:, 0].reshape(u_ * m_, M_ * U_)
        r_bond = x_cores[k].shape[2]
        uu, ss, vt = _svd(ground)
        keep = min(r_bond, uu.shape[1])
        mask = (torch.arange(uu.shape[1], device=ref.device)
                < keep).to(ref.dtype)
        uu = uu * mask[None, :]
        sv = (ss * mask)[:, None] * vt
        if uu.shape[1] >= r_bond:
            uu, sv = uu[:, :r_bond], sv[:r_bond, :]
        else:
            uu = F.pad(uu, (0, r_bond - uu.shape[1]))
            sv = F.pad(sv, (0, 0, 0, r_bond - sv.shape[0]))
        x_cores[k] = uu.reshape(u_, m_, r_bond)
        x_cores[k + 1] = sv.reshape(r_bond, M_, U_)
        if k < d - 2:
            op_left = torch.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                   x_cores[k], A1, x_cores[k])
    return tuple(x_cores), energy


# ---------------------------------------------------------------------------
# padded-stack half-sweeps, batched on a leading axis
# ---------------------------------------------------------------------------

def _batched(x_stack):
    """(B, d, r, n, r) view of a stack or batch, and whether it was one
    stack."""
    single = x_stack.dim() == 4
    return (x_stack.unsqueeze(0) if single else x_stack), single


def _bsum(x):
    """Per-instance sum over every axis but the leading one."""
    return x.reshape(x.shape[0], -1).sum(1)


def _bc(s, like):
    """A (B,) vector shaped to broadcast against ``like``."""
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


def _normalize(x, zero_dead: bool):
    """x / ||x|| per instance; where ||x|| <= 1e-30 the instance stays x
    (LOBPCG) or becomes 0 (Lanczos, ``zero_dead``)."""
    n = torch.sqrt(_bsum(x * x))
    nb = _bc(n, x)
    dead = x * 0.0 if zero_dead else x
    return torch.where(nb > _TINY, x / torch.clamp(nb, min=_TINY), dead), n


def _unit_env(B, r, a, like):
    env = like.new_zeros((B, r, a, r))
    env[:, 0, 0, 0] = 1.0
    return env


def _right_op_envs(xb, A_stack):
    """Right operator environments of a two-site sweep: Renvs[k] (B, r, a,
    r) covers sites k+2..d-1, Renvs[d-2] the boundary."""
    B, d, r = xb.shape[:3]
    a = A_stack.shape[1]
    env0 = _unit_env(B, r, a, xb)
    out = [env0]
    env = env0
    for k in range(d - 1, 1, -1):
        env = torch.einsum("zumU,amnb,zvnV,zUbV->zuav", xb[:, k], A_stack[k],
                           xb[:, k], env)
        out.append(env)
    return out[::-1]


def _right_prj_envs(x_stack, shifted: bool):
    """Right identity/projector environments for the spectral shift:
    prj[u, v] at two-site step k is the frame Gram of sites k+2..d-1, the
    local representation of the identity on the true (non-padded)
    subspace for right-orthonormal padded frames.  Returns (prj0, Rprjs)
    with Rprjs a list of d-1 (B, r, r) tensors (the batched form: (B, d,
    r, n, r) in, a leading batch axis on each); Rprjs is None when not
    shifted."""
    xb, single = _batched(x_stack)
    B, d, r = xb.shape[:3]
    prj0 = xb.new_zeros((B, r, r))
    prj0[:, 0, 0] = 1.0
    if not shifted:
        return (prj0[0] if single else prj0), None
    out = [prj0]
    prj = prj0
    for k in range(d - 1, 1, -1):
        prj = torch.einsum("zumU,zvmV,zUV->zuv", xb[:, k], xb[:, k], prj)
        out.append(prj)
    Rprjs = out[::-1]
    if single:
        return prj0[0], [p[0] for p in Rprjs]
    return prj0, Rprjs


def _masked_split(ground, rank: int, r: int, n: int):
    """SVD split of the (B, r, n, n, r) two-site block keeping exactly
    ``rank`` singular directions, trimmed to the bond dimension r (the
    block has r*n >= r of them): (U, S Vt) as (B, r, n, r) cores."""
    B = ground.shape[0]
    uu, ss, vt = _split_svd(ground.reshape(B, r * n, n * r))
    K = uu.shape[-1]
    m2 = (torch.arange(K, device=ground.device) < min(rank, K)).to(
        ground.dtype)
    uu = uu * m2
    sv = (ss * m2)[..., None] * vt
    return uu[..., :r].reshape(B, r, n, r), sv[:, :r].reshape(B, r, n, r)


def _left_update(op_left, prj_left, U, A1, shifted: bool):
    op_left = torch.einsum("zuav,zumU,amnb,zvnV->zUbV", op_left, U, A1, U)
    if shifted:
        prj_left = torch.einsum("zuv,zumU,zvmV->zUV", prj_left, U, U)
    return op_left, prj_left


def _dmrg_eig_half_sweep_scan(x_stack, A_stack, shift=None, *, rank: int):
    """Two-site ground-state half-sweep over padded uniform stacks, x_stack
    (d, r, n, r) or (B, d, r, n, r), A_stack (d, a, n, n, a), with a dense
    eigh of each (r n n r)^2 local operator.

    Unshifted (shift=None) it is valid when the ground energy is negative.
    A scalar ``shift`` > lambda_min solves (A - shift P) with P the carried
    true-subspace projector; the reported energies are the shifted Ritz
    values (the driver adds the shift back).  Returns (x_stack_out,
    energy), the energy of the last local problem ((B,) for a batch)."""
    xb, single = _batched(x_stack)
    B, d, r, n, _ = xb.shape
    shifted = shift is not None
    Renvs = _right_op_envs(xb, A_stack)
    prj_left, Rprjs = _right_prj_envs(xb, shifted)
    op_left = _unit_env(B, r, A_stack.shape[1], xb)
    eyen = torch.eye(n, dtype=xb.dtype, device=xb.device)
    nn = r * n * n * r
    Us, energy = [], None
    for k in range(d - 1):
        A1, A2 = A_stack[k], A_stack[k + 1]
        Aloc = torch.einsum("zuav,amnb,bMNc,zUcV->zumMUvnNV", op_left, A1, A2,
                            Renvs[k])
        if shifted:
            Aloc = Aloc - shift * torch.einsum(
                "zuv,mn,MN,zUV->zumMUvnNV", prj_left, eyen, eyen, Rprjs[k])
        w, v = _eigh(Aloc.reshape(B, nn, nn))
        energy = w[:, 0]
        U, sv = _masked_split(v[:, :, 0].reshape(B, r, n, n, r), rank, r, n)
        Us.append(U)
        op_left, prj_left = _left_update(op_left, prj_left, U, A1, shifted)
    out = torch.stack(Us + [sv], dim=1)
    return (out[0], energy[0]) if single else (out, energy)


def _local_apply(L, A1, A2, R, v):
    """y[u,m,M,U] = sum L[u,a,v] A1[a,m,n,b] A2[b,M,N,c] R[U,c,V]
    v[v,n,N,V], with a leading batch axis on L, R, v and y."""
    t = torch.einsum("zuav,zvnNV->zuanNV", L, v)
    t = torch.einsum("amnb,zuanNV->zumbNV", A1, t)
    t = torch.einsum("bMNc,zumbNV->zumMcV", A2, t)
    return torch.einsum("zUcV,zumMcV->zumMU", R, t)


def _ritz_smallest(T, valid):
    """Lowest Ritz pair of the small symmetric (B, m, m) problems, invalid
    directions lifted by 1e4 (max|T| + 1) so they never win."""
    big = 1e4 * (T.abs().amax(dim=(1, 2)) + 1.0)
    T = T + torch.diag_embed((1.0 - valid) * big[:, None])
    evals, evecs = _ritz_eigh(T)
    return evals[:, 0], evecs[:, :, 0] * valid


def _lobpcg_smallest(apply, v0, iters: int):
    """k=1 LOBPCG without preconditioner on the matrix-free local operator
    ``apply`` (batched (B, ...) iterates).  Valid for ground energies < 0;
    the driver's spectral shift arranges this.  Returns (ground vectors,
    energies (B,))."""
    dt = v0.dtype
    x, _ = _normalize(v0, zero_dead=False)
    p = torch.zeros_like(x)
    lam = v0.new_zeros((v0.shape[0],))
    ones = v0.new_ones((v0.shape[0],))
    drop_x = v0.new_ones((3,))           # no host-to-device copy
    drop_x[0] = 0.0
    for _ in range(iters):
        Ax = apply(x)
        lam = _bsum(x * Ax)
        w = Ax - _bc(lam, x) * x
        w = w - _bc(_bsum(w * x), x) * x
        w, nw = _normalize(w, zero_dead=False)
        q = p - _bc(_bsum(p * x), x) * x
        q = q - _bc(_bsum(q * w), x) * w
        q, nq = _normalize(q, zero_dead=False)
        basis = torch.stack([x, w, q], dim=1)            # (B, 3, ...)
        Ab = torch.stack([Ax, apply(w), apply(q)], dim=1)
        Bn = basis.shape[0]
        T = basis.reshape(Bn, 3, -1) @ Ab.reshape(Bn, 3, -1).transpose(1, 2)
        T = 0.5 * (T + T.transpose(1, 2))
        valid = torch.stack([ones, (nw > _TINY).to(dt), (nq > _TINY).to(dt)],
                            dim=1)
        lam, c = _ritz_smallest(T, valid)
        xn = torch.einsum("zi,zi...->z...", c, basis)
        p = torch.einsum("zi,zi...->z...", c * drop_x, basis)
        x, _ = _normalize(xn, zero_dead=False)
    return x, lam


def _lanczos_smallest(apply, v0, m: int):
    """Fixed-m Lanczos with full reorthogonalization on the matrix-free
    local operator ``apply`` (batched (B, ...) iterates).  Degenerate steps
    (an invariant subspace reached, beta <= 1e-7) are masked and penalized
    out of the small eigh.  The Krylov basis is a new tensor, written row
    by row; nothing is written through the input.  Returns (ground
    vectors, energies (B,))."""
    dt = v0.dtype
    B = v0.shape[0]
    v, _ = _normalize(v0, zero_dead=True)
    V = v0.new_zeros((m,) + tuple(v0.shape))
    alphas = v0.new_zeros((B, m))
    valid = v0.new_zeros((B, m))
    betas = v0.new_zeros((B, m))          # betas[:, j] couples j-1 <-> j
    beta_prev = v0.new_zeros((B,))
    v_prev = torch.zeros_like(v)
    alive = v0.new_ones((B,))
    for j in range(m):
        V[j] = v * _bc(alive, v)
        valid[:, j] = alive
        w = apply(v)
        a_j = _bsum(w * v)
        alphas[:, j] = a_j * alive
        w = w - _bc(a_j, v) * v - _bc(beta_prev, v) * v_prev
        # full reorthogonalization (rows of V beyond j are zero)
        proj = (V.reshape(m, B, -1) * w.reshape(1, B, -1)).sum(-1)
        w = w - torch.einsum("kz,kz...->z...", proj, V)
        v_prev = v
        w, nb = _normalize(w, zero_dead=True)
        alive = alive * (nb > 1e-7).to(dt)
        if j + 1 < m:
            betas[:, j + 1] = nb * alive
        beta_prev = nb * alive
        v = w
    off = betas[:, 1:]
    T = (torch.diag_embed(alphas) + torch.diag_embed(off, 1)
         + torch.diag_embed(off, -1))
    lam, c = _ritz_smallest(T, valid)
    ground = torch.einsum("zk,kz...->z...", c, V)
    ground, _ = _normalize(ground, zero_dead=True)
    return ground, lam


def _dmrg_lobpcg_half_sweep_scan(x_stack, A_stack, shift=None, *,
                                 rank: int, lobpcg_iters: int = 24,
                                 solver: str = "lobpcg"):
    """Two-site half-sweep over padded stacks with matrix-free local solves
    (``solver`` "lanczos" or "lobpcg", warm-started from the current
    two-site block; ``lobpcg_iters`` applies or iterations) in place of the
    dense eigh.  Same padding, masked split and shift contract as
    ``_dmrg_eig_half_sweep_scan``: a scalar ``shift`` solves (A - shift P),
    so padded null directions keep eigenvalue 0 while every true one drops
    by ``shift``.  Returns (x_stack_out, energy)."""
    xb, single = _batched(x_stack)
    B, d, r, n, _ = xb.shape
    shifted = shift is not None
    Renvs = _right_op_envs(xb, A_stack)
    prj_left, Rprjs = _right_prj_envs(xb, shifted)
    op_left = _unit_env(B, r, A_stack.shape[1], xb)
    local = _lanczos_smallest if solver == "lanczos" else _lobpcg_smallest
    x1 = xb[:, 0]
    Us, energy = [], None
    for k in range(d - 1):
        A1, A2, R = A_stack[k], A_stack[k + 1], Renvs[k]
        v0 = torch.einsum("zumb,zbMU->zumMU", x1, xb[:, k + 1])

        def apply(v, L=op_left, P=prj_left, A1=A1, A2=A2, R=R, k=k):
            w = _local_apply(L, A1, A2, R, v)
            if shifted:
                w = w - shift * torch.einsum("zuw,zwmMW,zWU->zumMU", P, v,
                                             Rprjs[k])
            return w

        ground, energy = local(apply, v0, lobpcg_iters)
        U, x1 = _masked_split(ground, rank, r, n)
        Us.append(U)
        op_left, prj_left = _left_update(op_left, prj_left, U, A1, shifted)
    out = torch.stack(Us + [x1], dim=1)
    return (out[0], energy[0]) if single else (out, energy)


def _half_sweep(solver: str, rank: int, lobpcg_iters: int):
    if solver in ("lobpcg", "lanczos"):
        return lambda xs, As, s=None: _dmrg_lobpcg_half_sweep_scan(
            xs, As, s, rank=rank, lobpcg_iters=lobpcg_iters, solver=solver)
    if solver == "eigh":
        return lambda xs, As, s=None: _dmrg_eig_half_sweep_scan(
            xs, As, s, rank=rank)
    raise ValueError(f"unknown local solver {solver!r}; "
                     "expected 'eigh', 'lanczos' or 'lobpcg'")


def _normalize_last(xs):
    """The stack with its last core (the core of the sweep) scaled to unit
    norm per instance, as a new tensor."""
    d = xs.shape[-4]
    last = xs[..., d - 1, :, :, :]
    nl = torch.sqrt((last * last).sum(dim=(-3, -2, -1), keepdim=True))
    return torch.cat([xs[..., :d - 1, :, :, :],
                      (last / torch.clamp(nl, min=_TINY)).unsqueeze(-4)],
                     dim=-4)


def _row_major(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with row-major strides, size-1 dimensions included
    (``contiguous()`` keeps theirs), so a step's outputs have its inputs'
    shape key and one program serves every half-sweep of a solve."""
    out = t.new_empty(t.shape)
    out.copy_(t)
    return out


def _run_step(xs, As, shift, *, rank: int, solver: str, lobpcg_iters: int,
              shifted: bool):
    """``make_dmrg_run``'s loop body: one half-sweep (of A - shift P where
    ``shifted``; ``shift`` a 0-d tensor), the sweep's core normalized,
    both stacks site-reversed.  Returns (xs, As, energy) with the stacks
    row-major (``_row_major``)."""
    xs, e = _half_sweep(solver, rank, lobpcg_iters)(
        xs, As, shift if shifted else None)
    xs = _normalize_last(xs)
    return _row_major(_rev_x_stack(xs)), _row_major(_rev_A_stack(As)), e


@factory(16)
def make_dmrg_step(shapes_key, dtype_str: str, rank: int, solver: str,
                   lobpcg_iters: int, shifted: bool) -> Program:
    """``_run_step`` as a program for inputs of ``shapes_key``
    (``programs.shapes_key(xs, As, shift)``; a stack or a batch)."""
    return Program(partial(_run_step, rank=rank, solver=solver,
                           lobpcg_iters=lobpcg_iters, shifted=shifted),
                   f"dmrg_step[{solver}]")


@factory(16)
def make_dmrg_sweep(shapes_key, dtype_str: str, rank: int, solver: str,
                    lobpcg_iters: int) -> Program:
    """The unshifted half-sweep as a program: (xs, As) -> (xs, energy)."""
    return Program(_half_sweep(solver, rank, lobpcg_iters),
                   f"dmrg_sweep[{solver}]")


def _eager(solver: str) -> bool:
    """Whether ``solver``'s half-sweeps run eagerly: the dense local eigh
    ('eigh') calls cuSOLVER, whose ``info`` read forbids a capture."""
    return solver == "eigh"


def _sweep_program(rank: int, solver: str, lobpcg_iters: int):
    """``_estimate_shift``'s half-sweep through ``make_dmrg_sweep``."""
    return lambda xs, As: programs.call(make_dmrg_sweep, (xs, As), rank,
                                        solver, lobpcg_iters,
                                        eager=_eager(solver))


def dmrg_run(x_stack, A_stack, shift, conv_eps, remaining, energy0, *,
             rank: int, solver: str, lobpcg_iters: int, shifted: bool,
             max_sweeps: int = CAP):
    """The whole ground-state solve (``make_dmrg_run``) as a host loop of
    ``make_dmrg_step`` programs (run eagerly for solver 'eigh'):
    half-sweep, normalization of the sweep's core, site reversal, then the
    energy convergence test |e - energy| < conv_eps (one energy read per
    half-sweep); at most min(max_sweeps, remaining) half-sweeps.  The
    reversal follows every half-sweep, so the state is un-reversed at the
    end when the count is odd, as the JAX program does.  ``energy0`` carries the convergence reference across
    calls (inf on the first).  On the card K4/K5's health record is read
    at the end.  Returns (x_stack, energy, count)."""
    limit = min(int(max_sweeps), int(remaining))
    xs, As = _row_major(x_stack), _row_major(A_stack)
    shift_t = torch.full((), float(shift), dtype=xs.dtype, device=xs.device)
    energy = float(energy0)
    i, stop = 0, False
    while i < limit and not stop:
        xs, As, e = programs.call(make_dmrg_step, (xs, As, shift_t), rank,
                                  solver, lobpcg_iters, shifted,
                                  eager=_eager(solver))
        e = host_float(e + shift)
        stop = abs(e - energy) < conv_eps
        energy = e
        i += 1
    if i % 2 == 1:
        xs = _rev_x_stack(xs)
    _check_kernels(xs)
    return xs, energy, i


def _pad_operator_stack(A_cores, dtype=None):
    """Zero-pad MPO cores (al, m, n, ar) to a uniform (d, a, n, n, a) stack
    on their device (shared by the eigen / linear-solve / multistart
    drivers)."""
    d = len(A_cores)
    n = A_cores[0].shape[1]
    a = max(max(c.shape[0], c.shape[3]) for c in A_cores)
    out = A_cores[0].new_zeros((d, a, n, n, a), dtype=dtype)
    for k, c in enumerate(A_cores):
        out[k, :c.shape[0], :, :, :c.shape[3]] = c
    return out


def _rev_x_stack(s):
    """Site-reverse a (d, r, n, r) stack (or a (B, d, r, n, r) batch)."""
    if s.dim() == 5:
        return torch.flip(s, (1,)).permute(0, 1, 4, 3, 2)
    return torch.flip(s, (0,)).permute(0, 3, 2, 1)


def _rev_A_stack(s):
    return torch.flip(s, (0,)).permute(0, 4, 2, 3, 1)


def _estimate_shift(fn0, x0, A_stack, reduce_fn=host_float) -> float:
    """Auto spectral shift (the lambda_max phase): two unshifted
    half-sweeps ``fn0`` on -A, made by negating exactly one MPO core of a
    new stack (negating all d flips (-1)^d, a no-op for even d; the
    caller's stack is not touched), with a throwaway state.  -A's ground
    -lambda_max is negative exactly when a shift is needed.  Returns
    1.1 lam_hat, or 0.0 when the spectrum is non-positive."""
    xs = _row_major(x0)
    As = torch.cat([-A_stack[:1], A_stack[1:]])
    e_neg = math.inf
    for _ in range(2):
        xs, e = fn0(xs, As)
        e_neg = reduce_fn(e)
        # row-major, so both half-sweeps share one program's shape key
        xs, As = _row_major(_rev_x_stack(xs)), _row_major(_rev_A_stack(As))
    lam_hat = -e_neg
    return 1.1 * lam_hat if lam_hat > 0 else 0.0


def _unpad_to_components(stack, d: int, n: int, rank: int):
    """The padded stack's cores cut to the logical ranks capped at
    ``rank``, as Tensors."""
    from ..core.tensor import Tensor
    comps = []
    for i in range(d):
        rl = 1 if i == 0 else res_rank(i, d, n, int(rank))
        rr = 1 if i == d - 1 else res_rank(i + 1, d, n, int(rank))
        comps.append(Tensor._wrap(stack[i][:rl, :, :rr].contiguous()))
    return comps


def _set_components(x, stack, d: int, n: int, rank: int,
                    normalize: bool) -> None:
    x.components = _unpad_to_components(stack, d, n, rank)
    x.canonicalized = False
    x.move_core(0)
    if normalize:
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm


def _normalized_at_0(x):
    x.move_core(0)
    nrm = x.frob_norm()
    if nrm > 0:
        x /= nrm


# ---------------------------------------------------------------------------
# the two-site SPD linear solver
# ---------------------------------------------------------------------------

def _cg_solve_local(L, A1, A2, R, rhs, v0, iters: int):
    """Matrix-free CG on the SPD two-site local system (batched),
    warm-started from the current block, a fixed iteration count with
    the breakdown guards of the JAX package."""
    x = v0
    r = rhs - _local_apply(L, A1, A2, R, x)
    p = r
    rs = _bsum(r * r)
    for _ in range(iters):
        Ap = _local_apply(L, A1, A2, R, p)
        denom = _bsum(p * Ap)
        alpha = torch.where(denom > _TINY,
                            rs / torch.clamp(denom, min=_TINY),
                            torch.zeros_like(rs))
        x = x + _bc(alpha, p) * p
        r = r - _bc(alpha, p) * Ap
        rs2 = _bsum(r * r)
        beta = torch.where(rs > _TINY, rs2 / torch.clamp(rs, min=_TINY),
                           torch.zeros_like(rs))
        p = r + _bc(beta, p) * p
        rs = rs2
    return x


def _dmrg_solve_half_sweep_scan(x_stack, A_stack, b_stack, rank: int,
                                cg_iters: int = 32):
    """Two-site half-sweep for the SPD system A x = b (the reference's
    DMRG_SPD, als.h:219) over padded stacks: matrix-free CG local solves
    warm-started from the current block, the masked split of the
    ground-state sweeps.  Returns (new x_stack, squared local residual
    norm of the last site solve)."""
    xb, single = _batched(x_stack)
    bb, _ = _batched(b_stack)
    B, d, r, n, _ = xb.shape
    a = A_stack.shape[1]
    rb = bb.shape[2]
    op0 = _unit_env(B, r, a, xb)
    rhs0 = xb.new_zeros((B, r, rb))
    rhs0[:, 0, 0] = 1.0
    Rops, Rrhs = [op0], [rhs0]
    opE, rhsE = op0, rhs0
    for k in range(d - 1, 1, -1):
        xc = xb[:, k]
        opE = torch.einsum("zumU,amnb,zvnV,zUbV->zuav", xc, A_stack[k], xc,
                           opE)
        rhsE = torch.einsum("zumU,zbmB,zUB->zub", xc, bb[:, k], rhsE)
        Rops.append(opE)
        Rrhs.append(rhsE)
    Rops, Rrhs = Rops[::-1], Rrhs[::-1]

    op_left, rhs_left = op0, rhs0
    x1 = xb[:, 0]
    Us, res2 = [], None
    for k in range(d - 1):
        A1, A2 = A_stack[k], A_stack[k + 1]
        v0 = torch.einsum("zumb,zbMU->zumMU", x1, xb[:, k + 1])
        rhs = torch.einsum("zup,zpmq,zqMs,zUs->zumMU", rhs_left, bb[:, k],
                           bb[:, k + 1], Rrhs[k])
        y = _cg_solve_local(op_left, A1, A2, Rops[k], rhs, v0, cg_iters)
        res = rhs - _local_apply(op_left, A1, A2, Rops[k], y)
        res2 = _bsum(res * res)
        U, x1 = _masked_split(y, rank, r, n)
        Us.append(U)
        op_left = torch.einsum("zuav,zumU,amnb,zvnV->zUbV", op_left, U, A1, U)
        rhs_left = torch.einsum("zup,zumU,zpmq->zUq", rhs_left, U, bb[:, k])
    out = torch.stack(Us + [x1], dim=1)
    return (out[0], res2[0]) if single else (out, res2)


def _solve_step(x_stack, A_stack, b_stack, *, rank: int, cg_iters: int):
    """One SPD half-sweep and the site reversal of the three stacks
    (row-major): (x, A, b) -> (x, A, b, squared local residual)."""
    x, res2 = _dmrg_solve_half_sweep_scan(x_stack, A_stack, b_stack, rank,
                                          cg_iters)
    return (_row_major(_rev_x_stack(x)), _row_major(_rev_A_stack(A_stack)),
            _row_major(_rev_x_stack(b_stack)), res2)


@factory(16)
def make_dmrg_solve_step(shapes_key, dtype_str: str, rank: int,
                         cg_iters: int) -> Program:
    """``_solve_step`` as a program (``make_dmrg_solve_sweep`` and the
    reversal of ``dmrg_solve``'s loop)."""
    return Program(partial(_solve_step, rank=rank, cg_iters=cg_iters),
                   "dmrg_solve_step")


def dmrg_solve(A, x, b, max_rank: int = 0, num_half_sweeps: int = 8,
               conv_eps: float = 1e-10, cg_iters: int = 32) -> float:
    """Two-site SPD solver on TT objects (the reference's DMRG_SPD,
    als.h:219): pads to uniform stacks on the objects' device, alternates
    direction by stack reversal, truncates at ``max_rank`` (0 = the padded
    maximum; ranks may grow up to it).  x is updated.  Returns the final
    relative residual ||A x - b|| / ||b|| in TT form."""
    from ..tt.ttnetwork import apply_operator
    x.move_core(0)
    x_stack, r = pad_cores([c._torch() for c in x.components])
    A_cores = [c._torch() for c in A.components]
    b_cores = [c._torch() for c in b.components]
    rank = int(max_rank) or int(r)
    if rank > r:
        # ranks may grow past x's current ones: re-pad the stack
        pad = rank - int(r)
        x_stack = F.pad(x_stack, (0, pad, 0, 0, 0, pad))
        r = rank
    d = len(A_cores)
    n = A_cores[0].shape[1]
    A_stack = _row_major(_pad_operator_stack(A_cores, x_stack.dtype))
    b_stack = _row_major(pad_cores(b_cores)[0])
    x_stack = _row_major(x_stack)
    prev = math.inf
    reversed_state = False
    for _ in range(num_half_sweeps):
        # each step ends site-reversed, the stop half-sweep too
        x_stack, A_stack, b_stack, res2 = programs.call(
            make_dmrg_solve_step, (x_stack, A_stack, b_stack), rank,
            int(cg_iters))
        reversed_state = not reversed_state
        res2 = host_float(res2)
        if abs(prev - res2) < conv_eps * max(res2, 1e-30):
            break
        prev = res2
    if reversed_state:
        x_stack = _rev_x_stack(x_stack)
    _check_kernels(x_stack)
    _set_components(x, x_stack, d, n, rank, normalize=False)
    return float((apply_operator(A, x) - b).frob_norm()
                 / max(b.frob_norm(), 1e-300))


# ---------------------------------------------------------------------------
# batched half-sweeps and the ground-state drivers
# ---------------------------------------------------------------------------

def dmrg_half_sweep_batched(x_stacks, A_stack, rank: int,
                            solver: str = "lanczos", lobpcg_iters: int = 32):
    """One batched ground-state half-sweep (``make_dmrg_sweep_batched`` with
    a shared operator): x_stacks (B, d, r, n, r) padded instance stacks,
    A_stack (d, a, n, n, a).  On the card K4/K5's health record is read
    at the end.  Returns (new stacks, energies (B,))."""
    out = _half_sweep(solver, rank, lobpcg_iters)(x_stacks, A_stack)
    _check_kernels(out[0])
    return out


def dmrg_groundstate_multistart(A, x, num_starts: int = 4,
                                num_half_sweeps: int = 8,
                                conv_eps: float = 1e-10,
                                solver: str = "lanczos",
                                lobpcg_iters: int = 32,
                                shift=None) -> float:
    """Multi-start ground-state race: ``num_starts`` independent starts
    (the first is x itself, the others ``TTTensor.random`` at x's rank)
    run as one batch per half-sweep; the lowest-energy instance is
    written back into x.  Returns the best energy."""
    from ..tt.ttnetwork import TTTensor
    _normalized_at_0(x)
    stacks = [pad_cores([c._torch() for c in x.components])[0]]
    r = stacks[0].shape[1]
    dims = list(x.dimensions)
    for _ in range(num_starts - 1):
        g = TTTensor.random(dims, int(r))
        _normalized_at_0(g)
        stacks.append(pad_cores([c._torch() for c in g.components])[0])
    A_cores = [c._torch() for c in A.components]
    x_stacks = torch.stack(stacks)
    d = len(A_cores)
    n = A_cores[0].shape[1]
    A_stack = _row_major(_pad_operator_stack(A_cores, x_stacks.dtype))
    x_stacks = _row_major(x_stacks)
    if shift is None:
        shift = _estimate_shift(
            _sweep_program(int(r), solver, int(lobpcg_iters)), x_stacks,
            A_stack, reduce_fn=lambda es: host_float(es.min()))
    shift = float(shift)
    shifted = shift != 0.0
    shift_t = torch.full((), shift, dtype=x_stacks.dtype,
                         device=x_stacks.device)
    best_prev = math.inf
    reversed_state = False
    energies = x_stacks.new_full((num_starts,), math.inf)
    for _ in range(num_half_sweeps):
        # each step ends site-reversed, the stop half-sweep too
        x_stacks, A_stack, energies = programs.call(
            make_dmrg_step, (x_stacks, A_stack, shift_t), int(r), solver,
            int(lobpcg_iters), shifted, eager=_eager(solver))
        reversed_state = not reversed_state
        energies = energies + shift
        best = host_float(energies.min())
        if abs(best - best_prev) < conv_eps:
            best_prev = best
            break
        best_prev = best
    if reversed_state:
        x_stacks = _rev_x_stack(x_stacks)
    _check_kernels(x_stacks)
    winner = int(torch.argmin(energies))
    _set_components(x, x_stacks[winner], d, n, int(r), normalize=True)
    return best_prev


def dmrg_groundstate_scan(A, x, num_half_sweeps: int = 8,
                          conv_eps: float = 1e-10, solver: str = "eigh",
                          lobpcg_iters: int = 24, shift=None) -> float:
    """Ground state over padded stacks on the objects' device: pads x and
    A, runs ``dmrg_run`` (the JAX package's device loop) in calls of at
    most CAP half-sweeps, writes the state back into x.  ``solver``:
    'eigh' (dense local eigh) or 'lanczos' / 'lobpcg' (matrix-free).

    ``shift``: None estimates lambda_max on -A (``_estimate_shift``) and
    solves (A - 1.1 lambda_hat P) only when lambda_hat > 0; 0.0 is the
    caller's promise of a negative ground energy and skips the estimate;
    s > 0 is used as given.  Returns the energy."""
    _normalized_at_0(x)
    x_stack, r = pad_cores([c._torch() for c in x.components])
    A_cores = [c._torch() for c in A.components]
    d = len(A_cores)
    n = A_cores[0].shape[1]
    A_stack = _pad_operator_stack(A_cores, x_stack.dtype)
    if shift is None:
        # the estimate needs no shift itself: unshifted half-sweeps, so a
        # negative-ground problem never carries the projector
        shift = _estimate_shift(
            _sweep_program(int(r), solver, int(lobpcg_iters)), x_stack,
            A_stack)
    shift = float(shift)
    shifted = shift != 0.0
    energy = math.inf
    total = 0
    while total < num_half_sweeps:
        x_stack, energy, cnt = dmrg_run(
            x_stack, A_stack, shift, conv_eps, num_half_sweeps - total,
            energy, rank=int(r), solver=solver,
            lobpcg_iters=int(lobpcg_iters), shifted=shifted, max_sweeps=CAP)
        total += max(cnt, 1)
        if cnt < min(num_half_sweeps - (total - cnt), CAP):
            break   # the convergence test fired
        # the CAP bucket ran out unconverged; the orientation is restored
    _set_components(x, x_stack, d, n, int(r), normalize=True)
    return energy


def dmrg_groundstate_fast(A, x, num_half_sweeps: int = 8,
                          conv_eps: float = 1e-10) -> float:
    """Ground state by alternating unrolled half-sweeps
    (``_dmrg_eig_half_sweep``) on true-shape cores, the direction changed
    by site reversal; x is updated.  Returns the energy."""
    from ..core.tensor import Tensor
    from .als_kernels import reverse_op, reverse_tt
    _normalized_at_0(x)
    cores = tuple(c._torch() for c in x.components)
    A_cores = tuple(c._torch() for c in A.components)
    energy = math.inf
    reversed_state = False
    for _ in range(num_half_sweeps):
        cores, e = _dmrg_eig_half_sweep(cores, A_cores)
        e = host_float(e)
        last = cores[-1]
        cores = cores[:-1] + (last / torch.clamp(
            torch.linalg.vector_norm(last), min=_TINY),)
        if abs(e - energy) < conv_eps:
            energy = e
            break
        energy = e
        cores = reverse_tt(cores)
        A_cores = reverse_op(A_cores)
        reversed_state = not reversed_state
    if reversed_state:
        cores = reverse_tt(cores)
    x.components = [Tensor._wrap(c.contiguous()) for c in cores]
    x.canonicalized = False
    _normalized_at_0(x)
    return energy
