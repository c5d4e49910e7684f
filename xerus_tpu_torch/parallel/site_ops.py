"""Site-sharded TT arithmetic: a block of sites per rank.

The port of ``xerus_tpu/parallel/site_ops.py``.  The reference runs the
TT entrywise product's per-component Kronecker loop and componentwise
arithmetic as OpenMP loops (ttNetwork.cpp:1288-1300), since every site's
work is independent.  Here the site axis of the padded (d_pad, r, n, r)
stack is split over a mesh axis: each rank transforms its block of sites
with no collective, and one all_gather assembles the replicated result.

Both ops return NON-canonicalized cores, as the reference's += and
entrywise_product do (ttNetwork.cpp:797, 1275).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .mesh import Axis, to_mesh_tensors


def _pad_stack(cores: Sequence[torch.Tensor], d_pad: int
               ) -> Tuple[torch.Tensor, int]:
    """Pad a core list to a uniform (d_pad, r, n, r) stack (rank
    pad-to-max, trailing zero sites up to d_pad)."""
    r = max(max(c.shape[0], c.shape[2]) for c in cores)
    out = cores[0].new_zeros((d_pad, r, cores[0].shape[1], r))
    for k, c in enumerate(cores):
        out[k, :c.shape[0], :, :c.shape[2]] = c
    return out, r


def _entrywise_local(a_blk, b_blk):
    """Per-site Kronecker of the rank axes (ttNetwork.cpp:1288-1300)."""
    prod = torch.einsum("kanb,kcnd->kacnbd", a_blk, b_blk)
    k, ra, rb, n = prod.shape[:4]
    return prod.reshape(k, ra * rb, n, ra * rb)


def _add_local(a_blk, b_blk, start: int, d: int, ra: int, rb: int):
    """Per-site block embedding of TT addition (ttNetwork.cpp:797-840):
    first site row-concat, last site column-concat, interior
    block-diagonal; ``start`` is the global index of the block's first
    site."""
    k, _, n, _ = a_blk.shape
    out = a_blk.new_zeros((k, ra + rb, n, ra + rb))
    out[:, :ra, :, :ra] = a_blk
    for s in range(k):
        g = start + s
        off_l = 0 if g == 0 else ra
        off_r = 0 if g == d - 1 else ra
        out[s, off_l:off_l + rb, :, off_r:off_r + rb] = b_blk[s]
    return out


def _prepare(a_cores, b_cores, mesh, axis: str):
    ax = Axis(mesh, axis)
    a_cores = to_mesh_tensors(a_cores, mesh)
    b_cores = to_mesh_tensors(b_cores, mesh)
    d = len(a_cores)
    d_pad = -(-d // ax.size) * ax.size
    a_stack, ra = _pad_stack(a_cores, d_pad)
    b_stack, rb = _pad_stack(b_cores, d_pad)
    return ax, a_cores, b_cores, a_stack, b_stack, ra, rb, d, d_pad


def tt_entrywise_product_sharded(a_cores: Sequence, b_cores: Sequence,
                                 mesh, axis: str = "dp") -> List:
    """Hadamard product of two TTs with the site axis sharded over the
    mesh axis ``axis``; ranks multiply per bond."""
    ax, a_cores, b_cores, a_stack, b_stack, ra, rb, d, _ = _prepare(
        a_cores, b_cores, mesh, axis)
    out = ax.all_gather(_entrywise_local(ax.block(a_stack),
                                         ax.block(b_stack)))
    res = []
    for k in range(d):
        la_l, la_r = a_cores[k].shape[0], a_cores[k].shape[2]
        lb_l, lb_r = b_cores[k].shape[0], b_cores[k].shape[2]
        # logical (a, b) rank pairs sit at a*rb + b in the padded kron axis
        rows = (torch.arange(la_l)[:, None] * rb
                + torch.arange(lb_l)).reshape(-1)
        cols = (torch.arange(la_r)[:, None] * rb
                + torch.arange(lb_r)).reshape(-1)
        dev = out.device
        res.append(out[k][rows.to(dev)][:, :, cols.to(dev)])
    return res


def tt_add_sharded(a_cores: Sequence, b_cores: Sequence, mesh,
                   axis: str = "dp") -> List:
    """TT addition (block-diagonal rank-sum embedding) with the site axis
    sharded; bond ranks add."""
    if len(a_cores) == 1:
        # single site: first == last, the embedding degenerates to a sum
        a, b = to_mesh_tensors([a_cores[0], b_cores[0]], mesh)
        return [a + b]
    ax, a_cores, b_cores, a_stack, b_stack, ra, rb, d, d_pad = _prepare(
        a_cores, b_cores, mesh, axis)
    m = d_pad // ax.size
    out = ax.all_gather(_add_local(ax.block(a_stack), ax.block(b_stack),
                                   ax.index * m, d, ra, rb))
    res = []
    for k in range(d):
        la_l, la_r = a_cores[k].shape[0], a_cores[k].shape[2]
        lb_l, lb_r = b_cores[k].shape[0], b_cores[k].shape[2]
        rows = (torch.arange(1) if k == 0 else
                torch.cat([torch.arange(la_l), ra + torch.arange(lb_l)]))
        cols = (torch.arange(1) if k == d - 1 else
                torch.cat([torch.arange(la_r), ra + torch.arange(lb_r)]))
        dev = out.device
        res.append(out[k][rows.to(dev)][:, :, cols.to(dev)])
    return res
