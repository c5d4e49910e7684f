"""Sharded building blocks: the multi-device compute paths.

The port of ``xerus_tpu/parallel/sharded_ops.py``.  ADF work shards the
measurement axis over ``dp``; ALS environments and TT inner products
shard a contracted axis over ``tp`` and sum the partial products with one
all_reduce per step (where the JAX package let GSPMD insert the psum);
the batched ALS / DMRG half-sweeps shard their instance axis over ``dp``
with no collective but the final gather.  Every rank passes the same
replicated inputs and gets the replicated result (``mesh.py``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F_nn

from ..config import config
from .mesh import Axis, local_shard, measurement_sharding, to_mesh_tensors


# ---------------------------------------------------------------------------
# ADF gradient step, dp-sharded over measurements
# ---------------------------------------------------------------------------

def _adf_gradient_core0(cores, P_idx, values, dp: Axis) -> torch.Tensor:
    """Projected gradient of core 0 from this rank's block of point
    measurements, summed over dp.  The segment sum over the measured
    index of core 0 is a one-hot GEMM (no float atomics on the card)."""
    d = len(cores)
    M = values.shape[0]
    B = cores[0].new_ones((M, 1))
    for k in range(d - 1, 0, -1):
        taken = cores[k][:, P_idx[:, k], :]                # (rl, M, rr)
        B = torch.einsum("amb,mb->ma", taken, B)
    pred = torch.einsum("amb,mb->m", cores[0][:, P_idx[:, 0], :], B)
    outer = (values - pred)[:, None] * B                    # (M, r0)
    onehot = F_nn.one_hot(P_idx[:, 0], cores[0].shape[1]).to(outer.dtype)
    return dp.psum(onehot.T @ outer)[None, :, :]            # (1, n0, r0)


def sharded_adf_gradient(cores: List, positions: np.ndarray,
                         values: np.ndarray, mesh) -> torch.Tensor:
    """The dp-sharded ADF gradient of core 0 on ``mesh``."""
    dp = Axis(mesh, "dp")
    cores = to_mesh_tensors(cores, mesh)
    P_idx, vals = to_mesh_tensors([positions, values], mesh)
    ms = measurement_sharding(mesh)
    return _adf_gradient_core0(cores, local_shard(P_idx.long(), mesh, ms),
                               local_shard(vals.to(cores[0].dtype), mesh,
                                           ms), dp)


# ---------------------------------------------------------------------------
# ALS local system, tp-sharded over the operator rank axis
# ---------------------------------------------------------------------------

def sharded_als_local_solve(x_cores, A_cores, b_cores, mesh) -> torch.Tensor:
    """One SPD ALS micro-step at site 0: right environments, local
    operator, solve.  Each contraction with an operator core sums over
    its right rank axis b; tp takes a block of b and one all_reduce sums
    the partial products."""
    tp = Axis(mesh, "tp")
    x_cores = to_mesh_tensors(x_cores, mesh)
    A_cores = to_mesh_tensors(A_cores, mesh)
    b_cores = to_mesh_tensors(b_cores, mesh)
    d = len(x_cores)
    op_env = x_cores[0].new_ones((1, 1, 1))
    rhs_env = x_cores[0].new_ones((1, 1))
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_env = tp.psum(torch.einsum(
            "umU,amnb,vnV,UbV->uav", xc, tp.block(Ac, 3), xc,
            tp.block(op_env, 1)))
        rhs_env = torch.einsum("umU,bmB,UB->ub", xc, bc, rhs_env)
    L = x_cores[0].new_ones((1, 1, 1))
    Lb = x_cores[0].new_ones((1, 1))
    Aloc = tp.psum(torch.einsum("uav,amnb,UbV->umUvnV", L,
                                tp.block(A_cores[0], 3),
                                tp.block(op_env, 1)))
    bloc = torch.einsum("ub,bmB,UB->umU", Lb, b_cores[0], rhs_env)
    n = bloc.numel()
    sol = torch.linalg.solve(Aloc.reshape(n, n), bloc.reshape(n))
    return sol.reshape(bloc.shape)


# ---------------------------------------------------------------------------
# TT inner product with phys-axis sharding
# ---------------------------------------------------------------------------

def sharded_tt_inner(a_cores, b_cores, mesh) -> torch.Tensor:
    """<a, b> with each site's physical axis split over tp: per site a
    partial environment over this rank's block of the mode, summed by
    one all_reduce."""
    tp = Axis(mesh, "tp")
    a_cores = to_mesh_tensors(a_cores, mesh)
    b_cores = to_mesh_tensors(b_cores, mesh)
    env = a_cores[0].new_ones((1, 1))
    for ca, cb in zip(a_cores, b_cores):
        env = tp.psum(torch.einsum("uv,unU,vnV->UV", env, tp.block(ca, 1),
                                   tp.block(cb, 1)))
    return env[0, 0]


# ---------------------------------------------------------------------------
# dp-sharded throughput-mode sweeps: each instance's sweep is independent,
# so dp takes a block of the instance axis and one gather assembles it
# ---------------------------------------------------------------------------

def sharded_als_half_sweep_batched(x_batch, A_cores, b_batch, mesh,
                                   direction: str = "lr"):
    """Batched SPD ALS half-sweep (``ops.als_kernels``) with the batch
    axis sharded over dp."""
    from ..ops.als_kernels import als_half_sweep_batched
    dp = Axis(mesh, "dp")
    x_batch = to_mesh_tensors(x_batch, mesh)
    b_batch = to_mesh_tensors(b_batch, mesh)
    A_cores = to_mesh_tensors(A_cores, mesh)
    B = x_batch[0].shape[0]
    xs = [dp.block(c) for c in x_batch]
    bs = [dp.block(c) for c in b_batch]
    if xs[0].shape[0]:
        out = als_half_sweep_batched(xs, A_cores, bs, direction)
    else:   # more dp ranks than instances: an empty block
        out = [c.new_zeros(c.shape) for c in xs]
    return tuple(dp.gather_uneven(c, B) for c in out)


def sharded_dmrg_half_sweep_batched(x_stacks, A_stack, rank: int, mesh,
                                    solver: str = "lanczos",
                                    lobpcg_iters: int = 32):
    """Batched DMRG ground-state half-sweep (``ops.dmrg_kernels``), the
    instance axis sharded over dp.  Returns (new_stacks, energies)."""
    from ..ops.dmrg_kernels import dmrg_half_sweep_batched
    dp = Axis(mesh, "dp")
    x_stacks, A_stack = to_mesh_tensors([x_stacks, A_stack], mesh)
    B = x_stacks.shape[0]
    mine = dp.block(x_stacks)
    if mine.shape[0]:
        out, energies = dmrg_half_sweep_batched(mine, A_stack, int(rank),
                                                solver, int(lobpcg_iters))
    else:
        out, energies = mine.clone(), mine.new_zeros((0,))
    return dp.gather_uneven(out, B), dp.gather_uneven(energies, B)


# ---------------------------------------------------------------------------
# Full multi-device training step
# ---------------------------------------------------------------------------

def multichip_training_step(mesh, d: int = 6, n: int = 2, rank: int = 3,
                            num_meas: int = 32):
    """One combined sharded step: the dp-sharded ADF gradient, the
    tp-sharded ALS local solve and the tp-sharded inner product, on
    cores drawn from the library's random engine (every rank must have
    set the same seed, so that all draw the same cores)."""
    from .. import misc as _misc
    rng = _misc.randomEngine
    dtype = np.dtype(config.value_dtype)

    def mk_tt():
        cores = []
        for i in range(d):
            rl = 1 if i == 0 else rank
            rr = 1 if i == d - 1 else rank
            cores.append(rng.normal(size=(rl, n, rr)).astype(dtype))
        return cores

    x_cores = mk_tt()
    b_cores = mk_tt()
    A_cores = []
    for i in range(d):
        rl = 1 if i == 0 else 2
        rr = 1 if i == d - 1 else 2
        A_cores.append(rng.normal(size=(rl, n, n, rr)).astype(dtype)
                       + np.eye(n, dtype=dtype)[None, :, :, None]
                       * (3.0 if rl == rr == 1 else 0.0))
    positions = rng.integers(0, n, size=(num_meas, d)).astype(np.int64)
    values = rng.normal(size=(num_meas,)).astype(dtype)

    grad = sharded_adf_gradient(x_cores, positions, values, mesh)
    sol = sharded_als_local_solve(x_cores, A_cores, b_cores, mesh)
    ip = sharded_tt_inner(x_cores, b_cores, mesh)
    return grad.cpu().numpy(), sol.cpu().numpy(), float(ip)
