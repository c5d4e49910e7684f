"""The QTT Poisson instance of the north-star solve, and its host-f64 check.

numpy only: the instance is built on the host from a seed and handed to
the solver as f32 / df cores (``xerus_tpu_torch.convert``).  With d=32,
rank=30 and seed 0xBAADF00D it is the instance of ``bench.py``
(``_e2e_poisson_row``) number for number.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Cores = List[np.ndarray]


def qtt_poisson_instance(d: int, rank: int, seed: int
                         ) -> Tuple[Cores, Cores, Cores]:
    """(x0, A, b) as lists of f64 cores.

    x0 is a random TT of ranks min(rank, 2^i, 2^(d-i)), right-canonicalized
    by numpy QR (core at site 0); A is the rank-2 QTT Laplace MPO
    (a, m, n, b); b is the all-ones rank-1 TT."""
    rng = np.random.Generator(np.random.PCG64(seed))
    xs = []
    for i in range(d):
        rl = 1 if i == 0 else min(rank, 2 ** i, 2 ** (d - i))
        rr = 1 if i == d - 1 else min(rank, 2 ** (i + 1), 2 ** (d - i - 1))
        xs.append(rng.normal(size=(rl, 2, rr)) / np.sqrt(rank))
    for i in range(d - 1, 0, -1):
        rl, n, rr = xs[i].shape
        q, r = np.linalg.qr(xs[i].reshape(rl, n * rr).T)
        xs[i] = q.T.reshape(q.shape[1], n, rr)
        xs[i - 1] = np.einsum("anb,bk->ank", xs[i - 1], r.T)
    L = 2.0 * np.eye(2) - np.eye(2, k=1) - np.eye(2, k=-1)
    I = np.eye(2)
    A = []
    for i in range(d):
        core = np.zeros((1 if i == 0 else 2, 2, 2, 1 if i == d - 1 else 2))
        if i == 0:
            core[0, :, :, 0] = L
            core[0, :, :, 1] = I
        elif i == d - 1:
            core[0, :, :, 0] = I
            core[1, :, :, 0] = L
        else:
            core[0, :, :, 0] = I
            core[1, :, :, 0] = L
            core[1, :, :, 1] = I
        A.append(core)
    b = [np.ones((1, 2, 1)) for _ in range(d)]
    return xs, A, b


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


def host_poisson_residual(sol: Sequence[np.ndarray], A64: Sequence[np.ndarray],
                          b64: Sequence[np.ndarray]) -> float:
    """Host-f64 relative residual ||Ax-b||/||b|| of a TT solution.

    z = Ax - b is stacked in TT block form per site and its norm read by
    the log-scaled QR sweep, so the check resolves residuals down to
    ~1e-16 without forming a dense vector."""
    z = []
    d = len(sol)
    for k in range(d):
        ax = np.einsum("amnb,unU->aumbU", A64[k], sol[k]).reshape(
            A64[k].shape[0] * sol[k].shape[0], A64[k].shape[1], -1)
        bc = b64[k]
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
    return float(np.exp(_log_norm(z) - _log_norm(b64)))
