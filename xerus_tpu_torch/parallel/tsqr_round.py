"""Rank-sharded TT rounding (TSQR + Gram-eigh truncation).

The port of ``xerus_tpu/parallel/tsqr_round.py``: the rank axis of every
core is split over a mesh axis (Al Daas / Ballard-style parallel TT
arithmetic: parallel dense linear algebra per site, sequential over the
sites), with the JAX ``shard_map`` body's collectives written out:

- orthogonalization, left to right: each site's tall-skinny QR of the
  (r n, r) unfolding is a TSQR (local QR of this rank's row block,
  all_gather of the p small R factors, one replicated QR of the stacked
  R's, local Q update); the replicated carry R goes into the next
  (rank-sharded) core as a partial GEMM + reduce-scatter;
- one all_to_all reshards the stack from left- to right-rank-sharded;
- truncation, right to left: per site the Gram of the (r, n r) unfolding
  is a column-block GEMM + all_reduce, and the replicated (r, r) eigh
  ('gram') or GEMM-only subspace iteration with a Cholesky LQ
  ('subspace') picks the kept spectrum; the projection is local.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.round_kernels import (TINY, _eigh_sym, _solve_lower,
                                 chol_orth_cols, res_rank)
from ..ops.stacking import pad_cores
from .mesh import Axis, to_mesh_tensors


def _round_tsqr_local(stacked: torch.Tensor, target_rank: int, ax: Axis,
                      method: str) -> torch.Tensor:
    """This rank's part of the rounding.  ``stacked``: (d, r/p, n, r), its
    block of the left rank axis.  Returns (d, r, n, r/p), its block of the
    right rank axis."""
    d, rp, n, r = stacked.shape
    p, i = ax.size, ax.index
    dtype, dev = stacked.dtype, stacked.device

    # ---- pass 1: left -> right TSQR orthogonalization ----
    R = torch.eye(r, dtype=dtype, device=dev)
    logs = torch.zeros((), dtype=dtype, device=dev)
    qs = []
    for k in range(d):
        partial = torch.einsum("ab,bnc->anc", R[:, i * rp:(i + 1) * rp],
                               stacked[k])
        cur = ax.psum_scatter(partial, 0)                   # (r/p, n, r)
        q1, r1 = torch.linalg.qr(cur.reshape(rp * n, r))
        k1 = r1.shape[0]                                    # min(rp n, r)
        rs = ax.all_gather(r1[None], 0)                     # (p, k1, r)
        q2, R2 = torch.linalg.qr(rs.reshape(p * k1, r))
        q = q1 @ q2[i * k1:(i + 1) * k1]
        if q.shape[1] < r:                                  # wide blocks
            q = torch.nn.functional.pad(q, (0, r - q.shape[1]))
            R2 = torch.nn.functional.pad(R2, (0, 0, 0, r - R2.shape[0]))
        qs.append(q.reshape(rp, n, r))
        nrm = torch.linalg.vector_norm(R2) + TINY
        R = R2 / nrm
        logs = logs + torch.log(nrm)
    qs[d - 1] = torch.einsum("anb,bc->anc", qs[d - 1], R)

    # ---- reshard: left-rank-sharded -> right-rank-sharded ----
    qs = ax.all_to_all(torch.stack(qs), 3, 1)              # (d, r, n, r/p)

    # ---- pass 2: right -> left truncation ----
    mask = (torch.arange(r, device=dev) < target_rank).to(dtype)
    eye = torch.eye(r, dtype=dtype, device=dev)

    def truncate(curm):
        """curm: (r, n r/p) local column block -> (US2 (r, r), vt local)."""
        G = ax.psum(curm @ curm.T)
        if method == "subspace":
            eps_s = 10 * torch.finfo(dtype).eps
            V = chol_orth_cols(G * mask[None, :])
            for _ in range(3):
                V = chol_orth_cols((G @ V) * mask[None, :])
            V = chol_orth_cols(V) * mask[None, :]
            vt_loc = V.T @ curm
            Gr = ax.psum(vt_loc @ vt_loc.T)
            shift = eps_s * torch.diagonal(Gr).max() + TINY
            L = torch.linalg.cholesky(Gr + shift * eye)
            vt = _solve_lower(L, vt_loc) * mask[:, None]
            return (V @ L) * mask[None, :], vt
        lam, V = _eigh_sym(G)
        lam, V = lam.flip(0), V.flip(1)
        s = torch.sqrt(torch.clamp_min(lam, 0.0)) * mask
        inv_s = torch.where(s > TINY, 1.0 / torch.clamp_min(s, TINY),
                            torch.zeros_like(s))
        return V * s[None, :], (V.T @ curm) * inv_s[:, None]

    US = eye
    logs2 = torch.zeros((), dtype=dtype, device=dev)
    rest = []
    for k in range(d - 1, 0, -1):
        partial = torch.einsum("anb,bc->anc", qs[k],
                               US[i * rp:(i + 1) * rp])
        cur = ax.psum_scatter(partial, 2)                   # (r, n, r/p)
        US2, vt = truncate(cur.reshape(r, n * rp))
        nrm = torch.linalg.vector_norm(US2) + TINY
        US = US2 / nrm
        logs2 = logs2 + torch.log(nrm)
        rest.append(vt.reshape(r, n, rp))
    first = ax.psum_scatter(torch.einsum("anb,bc->anc", qs[0],
                                         US[i * rp:(i + 1) * rp]), 2)
    out = torch.stack([first] + rest[::-1])
    return out * torch.exp((logs + logs2) / d)


def tt_round_tsqr(cores: Sequence, target_rank: int, mesh,
                  axis: str = "tp", method: str = "gram") -> List:
    """Round a TT (list of (rl, n, rr) cores) to ``target_rank`` with the
    rank axis sharded over the mesh axis ``axis``.  Pads the uniform rank
    to a multiple of the axis size; returns unpadded cores, replicated.
    method: 'gram' (replicated per-bond eigh) or 'subspace' (GEMM-only
    truncation, no eigh)."""
    if method not in ("gram", "subspace"):
        raise ValueError(f"unknown tsqr rounding method {method!r}")
    ax = Axis(mesh, axis)
    cores = to_mesh_tensors(cores, mesh)
    stacked, r = pad_cores(cores)
    if r % ax.size:
        pad = ax.size - r % ax.size
        stacked = torch.nn.functional.pad(stacked, (0, pad, 0, 0, 0, pad))
        r += pad
    d, n = stacked.shape[0], stacked.shape[2]
    local = ax.block(stacked, 1)
    out = ax.all_gather(_round_tsqr_local(local, int(target_rank), ax,
                                          method), 3)
    res = []
    for k in range(d):
        rl = 1 if k == 0 else res_rank(k, d, n, target_rank)
        rr = 1 if k == d - 1 else res_rank(k + 1, d, n, target_rank)
        res.append(out[k][:rl, :cores[k].shape[1], :rr])
    return res
