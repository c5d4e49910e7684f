"""Carrying TT cores between numpy and the port's tensors.

Instances are built on the host with numpy (``examples/poisson.py``) and
the tests hand the JAX package's results to the port as numpy arrays;
these helpers are the only crossings.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .ops.df32 import DF, df_from_f64, df_to_f64


def cores_to_torch(np_cores: Sequence[np.ndarray], device,
                   dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """Host cores -> contiguous tensors of ``dtype`` on ``device`` (rounded
    on the host, as numpy's astype rounds)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return tuple(torch.from_numpy(np.array(c, dtype=np_dtype, order="C"))
                 .to(device) for c in np_cores)


def cores_to_df(np_cores_f64: Sequence[np.ndarray], device
                ) -> Tuple[DF, ...]:
    """Host f64 cores -> (hi, lo) f32 pairs on ``device``; the split of
    ``df32.df_from_f64``."""
    return tuple(df_from_f64(c, device) for c in np_cores_f64)


def df_to_numpy(df_cores: Sequence[DF]) -> List[np.ndarray]:
    """(hi, lo) pairs -> host f64 cores hi + lo."""
    return [df_to_f64(h, l) for (h, l) in df_cores]
