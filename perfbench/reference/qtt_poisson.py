"""Inputs and plain reference of the QTT Poisson configurations.

The system: the d-dimensional Kronecker-sum Laplacian with 2 points per
axis, sum_k I x ... x L x ... x I with L = tridiag(-1, 2, -1) of size 2
(eigenvalues d to 3d, so a condition number of 3), as the rank-2 MPO of
the d-dimensional Laplacian (Kazeev & Khoromskij, SIMAX 33(3), 2012),
against the all-ones right-hand side, solved from TT starting points of a
fixed rank: the sizes of the repo's BASELINE north star and ``bench.py``.
It is not the 1-D Poisson system on 2^d points in QTT form, whose MPO has
rank 3 and whose condition number grows as 4^d.  The starting points are drawn from the seed on the given device
(one draw for the whole pool) and right-canonicalized in float64 there, as
``xerus_tpu_torch/examples/poisson.py`` draws them on the host.

The reference is the host-float64 relative residual ||Ax - b|| / ||b|| of
a solution TT against the benchmark's own A and b: the residual TT is
stacked in block form site by site and its norm read by a log-scaled QR
sweep, so it resolves residuals down to about 1e-16 without forming a
dense vector.  torch and numpy only: nothing of the port, nothing of the
JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def interface_ranks(d: int, n: int, rank: int) -> List[int]:
    """Bond ranks min(rank, n^i, n^(d-i)), with the two boundary 1s."""
    return [1] + [min(rank, n ** i, n ** (d - i)) for i in range(1, d)] + [1]


def laplace_mpo(d: int) -> List[np.ndarray]:
    """The rank-2 MPO of the d-dimensional Laplacian with 2 points per
    axis (the Kronecker sum of tridiag(-1, 2, -1) of size 2), cores
    (a, m, n, b) in float64."""
    L = 2.0 * np.eye(2) - np.eye(2, k=1) - np.eye(2, k=-1)
    eye = np.eye(2)
    cores = []
    for i in range(d):
        core = np.zeros((1 if i == 0 else 2, 2, 2, 1 if i == d - 1 else 2))
        if i == 0:
            core[0, :, :, 0] = L
            core[0, :, :, 1] = eye
        elif i == d - 1:
            core[0, :, :, 0] = eye
            core[1, :, :, 0] = L
        else:
            core[0, :, :, 0] = eye
            core[1, :, :, 0] = L
            core[1, :, :, 1] = eye
        cores.append(core)
    return cores


def ones_rhs(d: int, n: int) -> List[np.ndarray]:
    return [np.ones((1, n, 1)) for _ in range(d)]


def starting_points(cfg: Dict, seed: int, pool: int,
                    device: torch.device) -> List[List[torch.Tensor]]:
    """``pool`` random TTs of the configuration's ranks, N(0, 1/rank)
    entries in float64, right-canonicalized (core at site 0): one normal
    draw from a generator seeded ``seed`` on ``device``, then one batched
    QR a site."""
    d, n, rank = cfg["d"], cfg["n"], cfg["rank"]
    rk = interface_ranks(d, n, rank)
    shapes = [(rk[i], n, rk[i + 1]) for i in range(d)]
    sizes = [a * b * c for a, b, c in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    flat = torch.randn((pool, sum(sizes)), generator=gen, dtype=torch.float64,
                       device=device) / math.sqrt(rank)
    cores = [part.reshape(pool, *shape) for part, shape in
             zip(torch.split(flat, sizes, dim=1), shapes)]
    for i in range(d - 1, 0, -1):
        rl, m, rr = shapes[i]
        q, r = torch.linalg.qr(cores[i].reshape(pool, rl, m * rr)
                               .transpose(1, 2))
        cores[i] = q.transpose(1, 2).reshape(pool, q.shape[2], m, rr)
        cores[i - 1] = torch.einsum("panb,pkb->pank", cores[i - 1], r)
    return [[c[p].contiguous() for c in cores] for p in range(pool)]


def make_inputs(cfg: Dict, seed: int, pool: int, device: torch.device
                ) -> Dict:
    """The operator, the right-hand side (host float64 cores) and the pool
    of starting points (float64 cores on ``device``)."""
    if cfg["operator"] != "qtt_laplace" or cfg["rhs"] != "ones":
        raise ValueError(f"unknown Poisson system {cfg['operator']!r} / "
                         f"{cfg['rhs']!r}")
    return {"A": laplace_mpo(cfg["d"]), "b": ones_rhs(cfg["d"], cfg["n"]),
            "x0": starting_points(cfg, seed, pool, device)}


def _log_norm(cores: Sequence[np.ndarray]) -> float:
    """log ||TT||_F by a log-scaled QR sweep (no Gram cancellation)."""
    R = np.ones((1, 1))
    logs = 0.0
    for c in cores[:-1]:
        cur = np.einsum("ka,anb->knb", R, c).reshape(-1, c.shape[2])
        _, R = np.linalg.qr(cur)
        nrm = np.linalg.norm(R)
        logs += np.log(max(nrm, 1e-300))
        R = R / nrm
    last = np.einsum("ka,anb->knb", R, cores[-1])
    return logs + np.log(max(np.linalg.norm(last), 1e-300))


def residual(sol: Sequence[np.ndarray], A: Sequence[np.ndarray],
             b: Sequence[np.ndarray]) -> float:
    """Host-float64 ||Ax - b|| / ||b|| of the solution cores ``sol``."""
    z = []
    d = len(sol)
    for k in range(d):
        ax = np.einsum("amnb,unU->aumbU", A[k], sol[k]).reshape(
            A[k].shape[0] * sol[k].shape[0], A[k].shape[1], -1)
        bc = b[k]
        if k == 0:
            z.append(np.concatenate([ax, -bc], axis=2))
        elif k == d - 1:
            z.append(np.concatenate([ax, bc], axis=0))
        else:
            al, m, ar = ax.shape
            bl, _, br = bc.shape
            top = np.concatenate([ax, np.zeros((al, m, br))], axis=2)
            bot = np.concatenate([np.zeros((bl, m, ar)), bc], axis=2)
            z.append(np.concatenate([top, bot], axis=0))
    return float(np.exp(_log_norm(z) - _log_norm(b)))


def judge(cfg: Dict, inputs: Dict, checked, names, device) -> List[Dict]:
    """Per checked call (pool index, solution cores as torch tensors): the
    numbers ``names`` asks for.  ``residual``: the host-float64 relative
    residual against the benchmark's own A and b."""
    out = []
    for _k, cores in checked:
        host = [c.detach().to("cpu", torch.float64).numpy() for c in cores]
        row = {}
        for name in names:
            if name != "residual":
                raise KeyError(f"qtt_poisson has no number {name!r}")
            row[name] = residual(host, inputs["A"], inputs["b"])
        out.append(row)
    return out
