"""Tensor-parallel single-instance ALS half-sweep.

The port of ``xerus_tpu/parallel/tp_als.py``: the rank axis of the
per-site ALS GEMMs of ONE system split over a mesh axis, with the
``shard_map`` body's collectives written out (the same sweep math as the
serial ``ops.als_kernels._als_half_sweep``, als.cpp:483-564):

* each rank assembles only ITS row block of the local operator, from the
  left environment's u-block: (r n r / p, r n r);
* the local SPD solve is matrix-free CG on the sharded rows, one
  all_gather of the partial mat-vec per iteration, a fixed iteration
  count with guarded steps (no host read);
* environment pushes contract the sharded u axis: a partial product per
  rank, one all_reduce restores the replicated environment;
* x / A / b cores stay replicated (r n r each); the work is sharded.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.round_kernels import TINY
from ..ops.stacking import pad_cores
from .mesh import Axis, to_mesh_tensors


def _tp_als_half_sweep_local(x_stack, A_stack, b_stack, ax: Axis,
                             cg_iters: int, x_true) -> torch.Tensor:
    """x_stack: (d, r, n, r) replicated (zero-padded bonds); A_stack:
    (d, a, n, n, a); b_stack: (d, rb, n, rb); x_true: the true (rl, rr) of
    each input core.  Returns the updated x stack (replicated).

    Householder QR of a zero-padded matricization leaves junk orthonormal
    columns in the padded slots; Q columns beyond the statically known
    true bond rank are masked to zero after every QR, as in the JAX
    package (unmasked they leak into the environments)."""
    d, r, n, _ = x_stack.shape
    a = A_stack.shape[1]
    rb = b_stack.shape[1]
    dtype, dev = x_stack.dtype, x_stack.device
    rp = r // ax.size

    def urows(t):
        return t[ax.index * rp:(ax.index + 1) * rp]

    def unit(*shape):
        e = torch.zeros(shape, dtype=dtype, device=dev)
        e.view(-1)[0] = 1.0
        return e

    # ---- right environments (sequential site chain, sharded GEMMs) ----
    opR = [None] * (d + 1)
    rhsR = [None] * (d + 1)
    opR[d], rhsR[d] = unit(r, a, r), unit(r, rb)
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_stack[k], A_stack[k], b_stack[k]
        # each rank builds the u-rows of the environment from its block of
        # the bra core; the gather replicates it
        opR[k] = ax.all_gather(torch.einsum("umU,amnb,vnV,UbV->uav",
                                            urows(xc), Ac, xc, opR[k + 1]))
        rhsR[k] = ax.all_gather(torch.einsum("umU,bmB,UB->ub", urows(xc),
                                             bc, rhsR[k + 1]))

    # ---- left -> right sweep ----
    x_stack = x_stack.clone()
    x_out = [x_stack[k] for k in range(d)]
    opL, rhsL = unit(r, a, r), unit(r, rb)
    nn = r * n * r
    kprev = int(x_true[0][0])
    k_true = []
    for k in range(d - 1):
        kt = min(kprev * n, int(x_true[k][1]))
        k_true.append(kt)
        kprev = kt
    zero = torch.zeros((), dtype=dtype, device=dev)
    for k in range(d):
        Ac, bc = A_stack[k], b_stack[k]
        rows = torch.einsum("uav,amnb,UbV->umUvnV", urows(opL), Ac,
                            opR[k + 1]).reshape(rp * n * r, nn)
        bloc = torch.einsum("ub,bmB,UB->umU", rhsL, bc,
                            rhsR[k + 1]).reshape(nn)

        def matvec(v):
            return ax.all_gather(rows @ v)

        # matrix-free CG on the sharded rows; padded rows / columns are
        # exactly zero, so CG stays in the range of the operator
        xv = torch.zeros(nn, dtype=dtype, device=dev)
        rvec = bloc - matvec(xv)
        pvec = rvec
        rs = rvec @ rvec
        for _ in range(int(cg_iters)):
            Ap = matvec(pvec)
            denom = pvec @ Ap
            alpha = torch.where(denom > TINY, rs / torch.clamp_min(denom, TINY),
                                zero)
            xv = xv + alpha * pvec
            rvec = rvec - alpha * Ap
            rs_new = rvec @ rvec
            beta = torch.where(rs > TINY, rs_new / torch.clamp_min(rs, TINY),
                               zero)
            pvec = rvec + beta * pvec
            rs = rs_new
        core = xv.reshape(r, n, r)
        if k < d - 1:
            q, R2 = torch.linalg.qr(core.reshape(r * n, r))
            colmask = (torch.arange(r, device=dev) < k_true[k]).to(dtype)
            q = (q * colmask[None, :]).reshape(r, n, r)
            x_out[k] = q
            x_out[k + 1] = torch.einsum("ab,bnc->anc", R2, x_stack[k + 1])
            x_stack[k + 1] = x_out[k + 1]
            opL = ax.psum(torch.einsum("uav,umU,amnb,vnV->UbV", urows(opL),
                                       urows(q), Ac, q))
            rhsL = ax.psum(torch.einsum("ub,umU,bmB->UB", urows(rhsL),
                                        urows(q), bc))
        else:
            x_out[k] = core
    return torch.stack(x_out)


def _stack4(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Operator cores (al, n, m, ar) zero-padded to one (d, a, n, m, a)."""
    a = max(max(c.shape[0], c.shape[3]) for c in cores)
    out = cores[0].new_zeros((len(cores), a, cores[0].shape[1],
                              cores[0].shape[2], a))
    for k, c in enumerate(cores):
        out[k, :c.shape[0], :, :, :c.shape[3]] = c
    return out


def tp_als_half_sweep(x_cores: Sequence, A_cores: Sequence,
                      b_cores: Sequence, mesh, axis: str = "tp",
                      cg_iters: int = 64) -> List[torch.Tensor]:
    """One tensor-parallel SPD ALS half-sweep of a single system.

    x must be canonicalized at core 0 (the serial kernel's contract).
    Cores are zero-padded to the uniform max rank, rounded up to a
    multiple of the mesh axis size; returns cores unpadded to their input
    shapes, replicated."""
    ax = Axis(mesh, axis)
    x_cores = to_mesh_tensors(x_cores, mesh)
    A_cores = to_mesh_tensors(A_cores, mesh)
    b_cores = to_mesh_tensors(b_cores, mesh)
    x_stack, r = pad_cores(x_cores)
    if r % ax.size:
        pad = ax.size - r % ax.size
        x_stack = torch.nn.functional.pad(x_stack, (0, pad, 0, 0, 0, pad))
    b_stack, _ = pad_cores(b_cores)
    x_true = tuple((int(c.shape[0]), int(c.shape[2])) for c in x_cores)
    out = _tp_als_half_sweep_local(x_stack, _stack4(A_cores),
                                   b_stack.to(x_stack.dtype), ax,
                                   int(cg_iters), x_true)
    return [out[k][:c.shape[0], :c.shape[1], :c.shape[2]]
            for k, c in enumerate(x_cores)]


def _reverse_chain(cores: Sequence, operator: bool = False) -> List:
    """Read a TT chain backwards: reverse the site order and swap each
    core's bond legs.  A left-orthogonal chain up to its last site maps to
    one canonicalized at (new) site 0, the half-sweep's input contract."""
    perm = (3, 1, 2, 0) if operator else (2, 1, 0)
    return [torch.as_tensor(c).permute(perm) for c in reversed(list(cores))]


def tp_als_solve(x_cores: Sequence, A_cores: Sequence, b_cores: Sequence,
                 mesh, axis: str = "tp", num_half_sweeps: int = 8,
                 cg_iters: int = 64) -> List[torch.Tensor]:
    """Full tensor-parallel SPD ALS solve of one system: alternating-
    direction half-sweeps through the sharded kernel, direction
    alternation by chain reversal (``_reverse_chain``).  x must enter
    canonicalized at core 0.  Returns the solution cores in forward site
    order."""
    x, A, b = (to_mesh_tensors(c, mesh) for c in (x_cores, A_cores, b_cores))
    reversed_state = False
    for _ in range(int(num_half_sweeps)):
        x = tp_als_half_sweep(x, A, b, mesh, axis=axis, cg_iters=cg_iters)
        x = _reverse_chain(x)
        A = _reverse_chain(A, operator=True)
        b = _reverse_chain(b)
        reversed_state = not reversed_state
    if reversed_state:
        x = _reverse_chain(x)
    return x
