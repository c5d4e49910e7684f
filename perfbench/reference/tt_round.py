"""Inputs and plain reference of the TT rounding configurations.

The input: a random TT with d sites of mode size n, bond ranks
min(rank, n^i, n^(d-i)) and N(0, 1/rank) entries in the configuration's
dtype (``bench.py`` workload 1's distribution), drawn from the seed on the
given device, one draw for the whole pool.  The rounding follows
Oseledets, SISC 33(5) 2011; the randomized one Al Daas et al.,
arXiv:2110.04393.

The reference works in float64 on the inputs the benchmark made, with
plain torch on the device it is given: the norm of a TT and the distance
of two TTs (block cores [X, -Y], a QR of every carry, so no Gram
cancellation), and the orthogonal projection of X onto a rounded TT's own
left or right frames.  The rounding chain (QR sweep left to right,
truncated SVD sweep right to left) in float64 is the optimum a result's
truncation error is held to; in the configuration's dtype it is the
control's, which ``Control`` puts in the program's place.
Nothing of the port, nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

F64 = torch.float64


def interface_ranks(d: int, n: int, rank: int) -> List[int]:
    """Bond ranks min(rank, n^i, n^(d-i)), with the two boundary 1s."""
    return [1] + [min(rank, n ** i, n ** (d - i)) for i in range(1, d)] + [1]


def random_tts(cfg: Dict, seed: int, pool: int, device: torch.device
               ) -> List[List[torch.Tensor]]:
    """``pool`` random TTs of the configuration, one normal draw from a
    generator seeded ``seed`` on ``device``."""
    d, n, rank = cfg["d"], cfg["n"], cfg["rank"]
    dtype = getattr(torch, cfg["dtype"])
    rk = interface_ranks(d, n, rank)
    shapes = [(rk[i], n, rk[i + 1]) for i in range(d)]
    sizes = [a * b * c for a, b, c in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    flat = torch.randn((pool, sum(sizes)), generator=gen, dtype=dtype,
                       device=device) / math.sqrt(rank)
    return [[part.reshape(shape).contiguous() for part, shape in
             zip(torch.split(row, sizes), shapes)] for row in flat]


def make_inputs(cfg: Dict, seed: int, pool: int, device: torch.device
                ) -> Dict:
    return {"X": random_tts(cfg, seed, pool, device)}


def _svd(a: torch.Tensor):
    # cuSOLVER's QR-iteration SVD on the card (its default, Jacobi, is
    # the less accurate one), LAPACK's on the CPU
    return torch.linalg.svd(a, full_matrices=False,
                            driver="gesvd" if a.is_cuda else None)


def rounding_chain(cores: Sequence[torch.Tensor], target: int,
                   skip: int = 0) -> List[torch.Tensor]:
    """The rounding chain in the cores' dtype: QR sweep left to right, then
    truncated SVDs right to left, each bond kept at min(target, its rank);
    the result is canonical at site 0.  ``skip`` > 0 plants a wrong
    subspace: a bond that truncates keeps its singular vectors skip + 1 to
    skip + target instead of the leading ones."""
    cores = list(cores)
    d = len(cores)
    for i in range(d - 1):
        rl, n, rr = cores[i].shape
        q, r = torch.linalg.qr(cores[i].reshape(rl * n, rr))
        cores[i] = q.reshape(rl, n, q.shape[1])
        cores[i + 1] = torch.tensordot(r, cores[i + 1], dims=1)
    for i in range(d - 1, 0, -1):
        rl, n, rr = cores[i].shape
        u, s, vt = _svd(cores[i].reshape(rl, n * rr))
        k = min(target, u.shape[1])
        a = skip if k + skip <= u.shape[1] and k < u.shape[1] else 0
        cores[i] = vt[a:a + k].reshape(k, n, rr)
        cores[i - 1] = torch.tensordot(
            cores[i - 1], u[:, a:a + k] * s[None, a:a + k], dims=1)
    return cores


def tt_log_norm(cores: Sequence[torch.Tensor]) -> float:
    """log ||TT||_F by a QR of every carry, scaled (no overflow, no Gram
    cancellation)."""
    R = torch.ones((1, 1), dtype=F64, device=cores[0].device)
    logs = 0.0
    for c in cores[:-1]:
        cur = torch.tensordot(R, c.to(F64), dims=1)
        R = torch.linalg.qr(cur.reshape(-1, cur.shape[2]), mode="r")[1]
        nrm = float(torch.linalg.norm(R))
        if nrm == 0.0:
            return -math.inf
        logs += math.log(nrm)
        R = R / nrm
    last = torch.tensordot(R, cores[-1].to(F64), dims=1)
    return logs + math.log(max(float(torch.linalg.norm(last)), 1e-300))


def tt_distance(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]
                ) -> float:
    """||X - Y||_F of two TTs with the same mode sizes, in float64."""
    d = len(xs)

    def block(i):
        x, y = xs[i].to(F64), ys[i].to(F64)
        if i == 0:
            return torch.cat([x, -y], dim=2)
        if i == d - 1:
            return torch.cat([x, y], dim=0)
        z = x.new_zeros((x.shape[0] + y.shape[0], x.shape[1],
                         x.shape[2] + y.shape[2]))
        z[:x.shape[0], :, :x.shape[2]] = x
        z[x.shape[0]:, :, x.shape[2]:] = y
        return z

    if d == 1:
        return float(torch.linalg.norm(xs[0].to(F64) - ys[0].to(F64)))
    return math.exp(tt_log_norm([block(i) for i in range(d)]))


def left_projection(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """P X in float64: X projected onto the span of Y's left unfoldings
    Y_{<=d-1}, the frames orthonormalized by a QR sweep of Y (a gauge-free
    quantity: any gauge of Y spans the same frames).  A rounding that
    keeps left-orthonormal frames and carries X through them returns
    exactly this."""
    d = len(ys)
    frames = []
    R = torch.ones((1, 1), dtype=F64, device=ys[0].device)
    E = torch.ones((1, 1), dtype=F64, device=ys[0].device)
    for i in range(d - 1):
        cur = torch.tensordot(R, ys[i].to(F64), dims=1)
        a, n, b = cur.shape
        q, R = torch.linalg.qr(cur.reshape(a * n, b))
        Q = q.reshape(a, n, q.shape[1])
        frames.append(Q)
        # E[q, x] <- sum Q[p, n, q] E[p, y] X[y, n, x]
        E = torch.einsum("pnq,py,ynx->qx", Q, E, xs[i].to(F64))
    return frames + [torch.tensordot(E, xs[d - 1].to(F64), dims=1)]


def _reversed(cores: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The same TT read from its last site to its first."""
    return [c.permute(2, 1, 0) for c in reversed(cores)]


def right_projection(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """X P in float64: X projected onto the span of Y's right unfoldings
    Y_{>=2}, ``left_projection`` of the reversed TTs.  A rounding that
    keeps right-orthonormal frames and carries X through them (the SVD
    chain's right-to-left sweep) returns exactly this."""
    return _reversed(left_projection(_reversed(xs), _reversed(ys)))


def rank_over(cfg: Dict, ys: Sequence[torch.Tensor]) -> float:
    """How far the largest bond rank of a rounded TT lies above the target
    (0 for a rounding that kept to its rank)."""
    return float(max(0, max(int(c.shape[2]) for c in ys[:-1])
                     - cfg["target_rank"]))


class Control:
    """The reference put in the program's place: the rounding chain in the
    configuration's dtype on the device, with whatever matmul precision
    torch is set to (the control runs it with TF32 products);
    ``skip_leading`` plants the wrong-subspace fault (``rounding_chain``'s
    ``skip``)."""

    def __init__(self, cfg: Dict, mix: Dict, inputs: Dict,
                 device: torch.device, skip_leading: int = 0):
        self.X, self.target = inputs["X"], int(cfg["target_rank"])
        self.skip = int(skip_leading)

    def call(self, k: int):
        return rounding_chain(self.X[k], self.target, self.skip)

    @staticmethod
    def cores(ys):
        return ys

    @staticmethod
    def counters():
        return {}


def judge(cfg: Dict, inputs: Dict, checked, names, device) -> List[Dict]:
    """Per checked call (pool index, rounded cores): the numbers ``names``
    asks for, in float64 on ``device``.  ``right_projection_gap``:
    ||Y - X P|| / ||Y||, P the projection onto Y's own right frames (the
    certified rounding's semantics); ``truncation_excess``: ||X - Y|| / ||X - Y64|| - 1, Y64
    the float64 rounding chain of the same input (how far the kept
    subspace falls short of the SVD's; a projection gap cannot see that);
    ``rank_over``: ``rank_over``."""
    target = int(cfg["target_rank"])
    best: Dict[int, float] = {}            # ||X - Y64|| by pool index
    out = []
    for k, cores in checked:
        ys = [c.detach().to(device, F64) for c in cores]
        xs = [c.to(device, F64) for c in inputs["X"][k]]
        row = {}
        for name in names:
            if name == "rank_over":
                row[name] = rank_over(cfg, ys)
            elif name == "right_projection_gap":
                row[name] = (tt_distance(ys, right_projection(xs, ys))
                             / math.exp(tt_log_norm(ys)))
            elif name == "truncation_excess":
                if k not in best:
                    best[k] = tt_distance(xs, rounding_chain(xs, target))
                row[name] = tt_distance(xs, ys) / best[k] - 1.0
            else:
                raise KeyError(f"tt_round has no number {name!r}")
        out.append(row)
    return out
