"""Largest-entry search in a TT, at core level.

Counterpart of ``xerus_tpu/algorithms/largest_entry.py``.  Two of its
three branches are ported: the exact one (at most 65,536 entries:
contract, then argmax) and the per-core argmax of a rank-one TT.  The
entrywise-squaring and soft-threshold iteration for larger TTs needs the
object layer's ``round``, ``soft_threshold`` and ``entrywise_product``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

EXACT_LIMIT = 65536


def full_tensor(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """The TT contracted to a dense tensor of its mode sizes."""
    t = cores[0].new_ones((1, 1))
    for c in cores:
        t = torch.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape([int(c.shape[1]) for c in cores])


def find_largest_entry(cores: Sequence[torch.Tensor], accuracy: float = 0.0,
                       lower_bound: float = 0.0) -> int:
    """Linear (row-major) position of the entry of largest absolute value.

    Exact for at most 65,536 entries (``accuracy`` permits an approximate
    answer; the exact argmax always satisfies it)."""
    dims = [int(c.shape[1]) for c in cores]
    if int(np.prod(dims, dtype=object)) <= EXACT_LIMIT:
        return int(torch.argmax(full_tensor(cores).abs().reshape(-1)))
    if sum(int(c.shape[2]) for c in cores[:-1]) >= len(cores):
        raise NotImplementedError(
            "largest entry of a TT above 65,536 entries and rank one needs "
            "the squaring / soft-threshold iteration, which waits for the "
            "object layer (ROADMAP Queue 1 item 4)")
    # rank one: per-core argmax
    position = 0
    factor = int(np.prod(dims, dtype=object))
    for c, n in zip(cores, dims):
        factor //= n
        position += int(torch.argmax(c.abs().reshape(-1))) * factor
    return position
