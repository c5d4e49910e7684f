"""Uniform stacks of TT cores.

``pad_cores`` is the counterpart of ``xerus_tpu/ops/pallas_tt_eval.py``
``pad_cores``, which lived beside the TPU kernel although most of its
callers are not kernels; here it has a neutral home.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def pad_cores(cores: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Stack TT cores (rl, n, rr) into one zero-padded (d, r, n, r) tensor
    on the cores' device, r the largest rank and n the largest mode size;
    returns (stack, r)."""
    d = len(cores)
    r = max(max(c.shape[0], c.shape[2]) for c in cores)
    n = max(c.shape[1] for c in cores)
    out = cores[0].new_zeros((d, r, n, r))
    for k, c in enumerate(cores):
        out[k, :c.shape[0], :c.shape[1], :c.shape[2]] = c
    return out, r
