"""Fused MPO application + randomized rounding (zip-up).

Counterpart of ``xerus_tpu/ops/apply_kernels.py``.  The reference applies
an operator lazily and then rounds (src/xerus/ttStack.cpp:197 +
tensorNetwork.cpp:678), materializing the rank a*r product.  Here the two
fuse: the randomized rounding's sketch and projection sweeps contract the
A- and x-cores directly, so the (a r, n, a r) product cores are never
built, and every step is a GEMM-shaped einsum on the cores' device.

The math is the randomized sweep (``round_kernels._round_randomized``)
applied to the product cores Y_k[(al rl), m, (ar rr)] = sum_c A_k[al, m,
c, ar] x_k[rl, c, rr], each contraction factored through A and x.  It is
quasi-optimal under truncation and exact on representable ranks.

The JAX package drew its sketches from ``jax.random.PRNGKey(0)``; the
port takes them as ``sketches`` (the tests pass JAX's own) or draws them
from a ``torch.Generator`` seeded 0 on the cores' device, so a call is
reproducible.  The JAX package compiled the sweep
(``make_apply_round``); here it is a captured program on the card, its
stacks padded and its sketches drawn outside it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .dmrg_kernels import _pad_operator_stack
from .programs import Program, call, factory
from .round_kernels import TINY, _cholesky, _cholqr2, _eps, _solve_lower
from .round_kernels import res_rank
from .stacking import pad_cores

QR_METHODS = ("householder", "cholqr1", "cholqr")


def _apply_round_scan(A_stack: torch.Tensor, x_stack: torch.Tensor,
                      target_rank: int, oversample: int,
                      qr_method: str = "cholqr1",
                      sketches: Optional[Sequence[torch.Tensor]] = None):
    """A_stack: (d, a, n, n, a) padded MPO cores; x_stack: (d, r, n, r).
    Returns (Qs (d-1, l, n, l), final (l, n)): cores of the rounded
    product at bond dimension l, the log-scale spread evenly over the d
    cores.  ``sketches``: d-1 standard-normal (l, n, l) tensors, l =
    target + oversample, ``sketches[k]`` the one of site k + 1; without
    them they are drawn from a Generator seeded 0 on the stacks' device,
    from site d-1 down to site 1."""
    if qr_method not in QR_METHODS:
        raise ValueError(f"unknown qr_method {qr_method!r}")
    d, a, n = A_stack.shape[:3]
    r = x_stack.shape[1]
    dtype, dev = x_stack.dtype, x_stack.device
    l = target_rank + oversample
    if sketches is None:
        sketches = draw_apply_sketches(d, n, l, dtype, dev)

    # right-to-left sketches: Ws[k] (a, r, l) pairs with site k (bond k+1)
    # the unit entries are fills: assigning a Python float copies it from
    # the host, which a captured region refuses
    W = x_stack.new_zeros((a, r, l))
    W[0, 0, 0].fill_(1.0)
    Ws = [None] * (d - 1)
    for k in range(d - 2, -1, -1):
        Ak, xk = A_stack[k + 1], x_stack[k + 1]
        t1 = torch.einsum("rcs,bsq->rcbq", xk, W)          # (r, n_in, a, l)
        t2 = torch.einsum("amcb,rcbq->armq", Ak, t1)        # (a, r, n_out, l)
        W = torch.einsum("armq,pmq->arp", t2, sketches[k].to(dtype))
        W = W / (torch.linalg.vector_norm(W) + TINY)
        Ws[k] = W

    # left-to-right orthogonalization sweep
    col_mask = (torch.arange(l, device=dev) < target_rank).to(dtype)
    C = x_stack.new_zeros((l, a, r))
    C[0, 0, 0].fill_(1.0)
    logs = x_stack.new_zeros(())
    Qs = []
    for k in range(d - 1):
        u1 = torch.einsum("kas,scr->kacr", C, x_stack[k])   # (l, a, n_in, r)
        G = torch.einsum("amcb,kacr->kmbr", A_stack[k], u1)  # (l, n_out, a, r)
        Y = torch.einsum("kmbr,brq->kmq", G, Ws[k]).reshape(l * n, l)
        if qr_method == "cholqr1":
            Gm = Y.T @ Y
            rel = 10 * Y.shape[0] * _eps(dtype)
            shift = rel * torch.diagonal(Gm).max() + TINY
            Lc = _cholesky(Gm + shift * torch.eye(l, dtype=dtype,
                                                  device=dev))
            q = _solve_lower(Lc, Y.T).T
        elif qr_method == "cholqr":
            q = _cholqr2(Y, TINY)
        else:
            q = torch.linalg.qr(Y)[0]
        Q = (q * col_mask[None, :]).reshape(l, n, l)
        C2 = torch.einsum("kmp,kmbr->pbr", Q, G)            # (l, a, r)
        nrm = torch.linalg.vector_norm(C2) + TINY
        C, logs = C2 / nrm, logs + torch.log(nrm)
        Qs.append(Q)
    # last site: F = C . Y_d, right boundary rank 1 (slot 0 of (a, r))
    u1 = torch.einsum("kas,scr->kacr", C, x_stack[d - 1])
    Fin = torch.einsum("amcb,kacr->kmbr", A_stack[d - 1], u1)  # (l, n, a, r)
    scale = torch.exp(logs / d)
    return torch.stack(Qs) * scale, Fin[:, :, 0, 0] * scale


def draw_apply_sketches(d: int, n: int, l: int, dtype, device
                        ) -> List[torch.Tensor]:
    """``_apply_round_scan``'s d-1 standard-normal (l, n, l) sketches,
    drawn from a Generator seeded 0 on ``device`` from site d-1 down to
    site 1."""
    generator = torch.Generator(device=device).manual_seed(0)
    sketches = [None] * (d - 1)
    for k in range(d - 2, -1, -1):
        sketches[k] = torch.randn((l, n, l), generator=generator,
                                  dtype=dtype, device=device)
    return sketches


@factory(32)
def make_apply_round(shapes_key, dtype_str: str, target_rank: int,
                     oversample: int, qr_method: str) -> Program:
    """``_apply_round_scan`` as a program for inputs of ``shapes_key``
    (``programs.shapes_key(A_stack, x_stack, sketches)``): (A_stack,
    x_stack, sketches) -> (Qs, final) (the JAX package's
    ``make_apply_round``, xerus_tpu/ops/apply_kernels.py:108, keyed by
    both stacks' shapes, the target, the oversample, the dtype and the QR
    method)."""
    def fn(A_stack, x_stack, sketches):
        return _apply_round_scan(A_stack, x_stack, target_rank, oversample,
                                 qr_method, sketches)
    return Program(fn, f"apply_round[{qr_method}]")


def apply_operator_rounded_cores(A_cores: Sequence[torch.Tensor],
                                 x_cores: Sequence[torch.Tensor],
                                 target_rank: int, oversample: int = 8,
                                 qr_method: str = "auto", sketches=None,
                                 eager: bool = False) -> List[torch.Tensor]:
    """Fused apply + round at core level: A (list of (al, m, c, ar) MPO
    cores), x (list of (rl, c, rr) cores) on one device -> the rounded
    product's cores at bond dimension <= target_rank.  ``qr_method``
    "auto" is Householder: the JAX package measured cholqr1's u kappa^2
    floor unsafe on structured operators (Laplace apply panels at f32:
    0.26 relative error against 9.6e-7); "cholqr1" and "cholqr" are
    opt-in.  ``sketches`` as ``_apply_round_scan``'s, drawn here when not
    given.  The sweep is ``make_apply_round``'s program on the padded
    stacks, or with ``eager`` its function run eagerly."""
    if qr_method == "auto":
        qr_method = "householder"
    d = len(A_cores)
    n = A_cores[0].shape[1]
    t, o = int(target_rank), int(oversample)
    x_stack, _ = pad_cores(x_cores)
    A_stack = _pad_operator_stack(A_cores, x_stack.dtype)
    if sketches is None:
        sketches = draw_apply_sketches(d, A_stack.shape[2], t + o,
                                       x_stack.dtype, x_stack.device)
    Qs, final = call(make_apply_round, (A_stack, x_stack, tuple(sketches)),
                     t, o, qr_method, eager=eager)
    # logical bond caps: product rank a_k r_k, physical n^k / n^(d-k)
    t = int(target_rank)
    res = []
    for k in range(d):
        prod_l = A_cores[k].shape[0] * x_cores[k].shape[0]
        prod_r = A_cores[k].shape[3] * x_cores[k].shape[2]
        rl = 1 if k == 0 else min(t, prod_l, res_rank(k, d, n, t))
        rr = 1 if k == d - 1 else min(t, prod_r, res_rank(k + 1, d, n, t))
        if k < d - 1:
            res.append(Qs[k][:rl, :, :rr])
        else:
            res.append(final[:rl, :, None][:, :, :rr])
    return res


def apply_operator_rounded(op, x, target_rank: int, oversample: int = 8,
                           sketches=None):
    """Fused apply + round on TT objects: round(op x) at rank <=
    target_rank without materializing the rank a*r product (TTStack +
    round semantics, ttStack.cpp:197), on the objects' device in their
    dtype.  Returns a new TT of x's type."""
    from ..core.tensor import Tensor
    out = apply_operator_rounded_cores(
        [c._torch() for c in op.components],
        [c._torch() for c in x.components], target_rank, oversample,
        sketches=sketches)
    res = type(x)._make([Tensor._wrap(c.contiguous()) for c in out])
    res.canonicalized = False
    res.move_core(0)
    return res
