"""Tensor persistence: the port of ``xerus_tpu.core.serialization``
(reference: tensor stream_writer/stream_reader in src/xerus/tensor.cpp;
header discipline fileIO.h:83-140).  The same "Tensor" type tag and
arrays, so files cross between the packages both ways."""

from __future__ import annotations

import numpy as np

from ..misc.io import register_serializer
from .tensor import Tensor, Representation


def _write_tensor(t: Tensor):
    meta = {"dimensions": list(t.dimensions),
            "representation": t.representation.name}
    if t.is_sparse():
        pos, val = t.sparse_coo()
        return {"meta": meta, "arrays": {"positions": pos,
                                         "values": val * t.factor}}
    return {"meta": meta, "arrays": {"dense": t.to_ndarray()}}


def _read_tensor(payload) -> Tensor:
    meta = payload["meta"]
    dims = [int(d) for d in meta["dimensions"]]
    if meta["representation"] == "Sparse":
        t = Tensor(dims, Representation.Sparse)
        pos = payload["arrays"]["positions"]
        val = payload["arrays"]["values"]
        for p, v in zip(pos, val):
            t._sparse[int(p)] = float(v)
        return t
    t = Tensor(dims, Representation.Dense)
    t._dense = np.asarray(payload["arrays"]["dense"]).reshape(dims)
    return t


register_serializer("Tensor", Tensor, _write_tensor, _read_tensor)
