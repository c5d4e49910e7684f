"""Carrying TT cores and Tensors between numpy and the port's tensors.

Instances are built on the host with numpy (``examples/poisson.py``) and
the tests hand the JAX package's results to the port as numpy arrays or
plain fields; these helpers are the only crossings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.tensor import Representation, Tensor
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


def tensor_from_state(dimensions: Sequence[int], factor: float,
                      dense: Optional[np.ndarray] = None,
                      sparse: Optional[Dict[int, float]] = None,
                      device=None) -> Tensor:
    """The port's Tensor from a JAX-package tensor's plain fields: its
    dimension list, its ``factor`` and either its dense data (factor not
    applied) or its ``{position: value}`` dict.  Dense data is copied,
    onto ``device`` when one is given, else kept on the host until a
    computation moves it to the compute device."""
    if (dense is None) == (sparse is None):
        raise ValueError("tensor_from_state: give either dense or sparse")
    if sparse is not None:
        t = Tensor(dimensions, Representation.Sparse)
        t._sparse = {int(p): float(v) for p, v in sparse.items()}
    else:
        t = Tensor(dimensions, Representation.Dense,
                   data=np.array(dense, copy=True))
        if device is not None:
            t._dense = torch.tensor(t._dense, device=device)
    t.factor = float(factor)
    return t


def tt_from_numpy(cores: Sequence[np.ndarray], operator: bool = False,
                  canonicalized: bool = False, core_position: int = 0,
                  device=None):
    """The port's TTTensor (TTOperator with ``operator``) from host cores,
    for example a JAX TT's ``[c.to_ndarray() for c in tt.components]`` or
    the cores of a solve: each core is copied, onto ``device`` when one is
    given.  ``canonicalized`` / ``core_position`` carry the source's
    canonical flags across unchecked."""
    from .tt import TTOperator, TTTensor
    cls = TTOperator if operator else TTTensor
    comps = [tensor_from_state(list(np.shape(c)), 1.0, dense=c,
                               device=device) for c in cores]
    return cls._make(comps, bool(canonicalized), int(core_position))


def network_from_numpy(dimensions: Sequence[int],
                       external_links: Sequence[Sequence[int]],
                       nodes: Sequence, device=None):
    """The port's TensorNetwork from a network's plain fields: its
    dimension list, its external links as (node, position, dimension) and
    per node either None (an erased node) or (dense data, links as
    (other, position, dimension, external)); the data is copied, onto
    ``device`` when one is given."""
    from .network import Link, TensorNetwork, TensorNode
    net = TensorNetwork.__new__(TensorNetwork)
    net.dimensions = [int(d) for d in dimensions]
    net.external_links = [Link(int(o), int(p), int(d), False)
                          for o, p, d in external_links]
    net.nodes = []
    for node in nodes:
        if node is None:
            net.nodes.append(TensorNode(None))
            continue
        data, links = node
        net.nodes.append(TensorNode(
            tensor_from_state(list(np.shape(data)), 1.0, dense=data,
                              device=device),
            [Link(int(o), int(p), int(d), bool(e)) for o, p, d, e in links]))
    net.require_valid_network(check_erased=False)
    return net
