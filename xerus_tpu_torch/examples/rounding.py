"""The rounding instances of the benchmark, and host float64 checks.

numpy only.  ``bench_round_instance`` reproduces ``bench.py``'s workload-1
instance bit for bit (``_make_cores`` from ``PCG64(0xBAADF00D)``: d=32,
n=2, rank 256); ``cliff_instance`` its numerically rank-96 variant;
``cpu_round_sweep`` the float64 LAPACK QR + SVD rounding chain that the
reference runs; ``host_tt_log_norm`` and ``host_tt_distance`` read results
on the host in float64 (every contraction a BLAS product).  Cores cross to the port through
``convert.cores_to_torch``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def bench_round_instance(d: int = 32, n: int = 2, rank: int = 256,
                         seed: int = 0xBAADF00D) -> List[np.ndarray]:
    """Random TT with ranks min(rank, n^i, n^(d-i)) and N(0, 1/rank)
    entries, drawn as the benchmark draws it (float32 normals over
    sqrt(rank))."""
    rng = np.random.Generator(np.random.PCG64(seed))
    cores = []
    for i in range(d):
        rl = 1 if i == 0 else min(rank, n ** i, n ** (d - i))
        rr = 1 if i == d - 1 else min(rank, n ** (i + 1), n ** (d - i - 1))
        cores.append(rng.normal(size=(rl, n, rr)).astype(np.float32)
                     / np.sqrt(rank))
    return cores


def cliff_instance(cores: Sequence[np.ndarray], signal_rank: int = 96,
                   scale: float = 1e-6) -> List[np.ndarray]:
    """Numerically rank-``signal_rank`` TT carried at the full ranks: bond
    slots past ``signal_rank`` are scaled by ``scale`` on both sides (the
    result takes the cores' dtype; 1e-9 is below f32's resolution of the
    kept part, so pass float64 cores for it)."""
    out = []
    for c in cores:
        rl, _n, rr = c.shape
        dl = np.where(np.arange(rl) < signal_rank, 1.0, scale).astype(c.dtype)
        dr = np.where(np.arange(rr) < signal_rank, 1.0, scale).astype(c.dtype)
        out.append(c * dl[:, None, None] * dr[None, None, :])
    return out


def cpu_round_sweep(cores: Sequence[np.ndarray], target: int,
                    eps: float = 0.0) -> List[np.ndarray]:
    """float64 numpy/LAPACK rounding: QR sweep left to right, truncated
    SVD sweep right to left (the reference's kernel chain).  ``eps`` > 0
    also drops singular values at or below eps times the largest (at
    least one kept), as the reference's round(maxRanks, eps)."""
    cores = [np.asarray(c, np.float64) for c in cores]
    d = len(cores)
    for i in range(d - 1):
        rl, n, rr = cores[i].shape
        q, r = np.linalg.qr(cores[i].reshape(rl * n, rr))
        cores[i] = q.reshape(rl, n, q.shape[1])
        cores[i + 1] = np.tensordot(r, cores[i + 1], axes=1)
    for i in range(d - 1, 0, -1):
        rl, n, rr = cores[i].shape
        u, s, vt = np.linalg.svd(cores[i].reshape(rl, n * rr),
                                 full_matrices=False)
        k = min(target, u.shape[1])
        if eps > 0.0:
            k = min(k, max(1, int(np.sum(s > eps * s[0]))))
        cores[i] = vt[:k, :].reshape(k, n, rr)
        cores[i - 1] = np.tensordot(cores[i - 1], u[:, :k] * s[None, :k],
                                    axes=1)
    return cores


def host_tt_log_norm(cores: Sequence[np.ndarray]) -> float:
    """log of the Frobenius norm of a TT by a scaled environment sweep in
    float64 (overflow-safe)."""
    env = np.ones((1, 1))
    log_acc = 0.0
    for c in cores:
        c = np.asarray(c, np.float64)
        env = np.einsum("uv,unU,vnV->UV", env, c, c, optimize=True)
        nrm = np.linalg.norm(env)
        if nrm > 0:
            env = env / nrm
            log_acc += np.log(nrm)
    return 0.5 * log_acc


def host_tt_distance(xs: Sequence[np.ndarray], ys: Sequence[np.ndarray]
                     ) -> float:
    """||X - Y||_F of two TTs with the same mode sizes, in float64: the
    difference TT (block cores [X, -Y]) contracted left to right with a QR
    of every environment, so no Gram cancellation; the norm is read off the
    last carry."""
    d = len(xs)

    def block(i):
        x = np.asarray(xs[i], np.float64)
        y = np.asarray(ys[i], np.float64)
        if d == 1:
            return x - y
        if i == 0:
            return np.concatenate([x, -y], axis=2)
        if i == d - 1:
            return np.concatenate([x, y], axis=0)
        z = np.zeros((x.shape[0] + y.shape[0], x.shape[1],
                      x.shape[2] + y.shape[2]))
        z[:x.shape[0], :, :x.shape[2]] = x
        z[x.shape[0]:, :, x.shape[2]:] = y
        return z

    R = np.ones((1, 1))
    log_acc = 0.0
    for i in range(d - 1):
        cur = np.tensordot(R, block(i), axes=1)
        R = np.linalg.qr(cur.reshape(-1, cur.shape[2]), mode="r")
        nrm = np.linalg.norm(R)
        if nrm == 0.0:
            return 0.0
        R = R / nrm
        log_acc += np.log(nrm)
    last = np.tensordot(R, block(d - 1), axes=1)
    return float(np.exp(log_acc) * np.linalg.norm(last))
