"""TT persistence: the port of ``xerus_tpu.tt.serialization``.  The loader
re-validates the format like the reference's stream_reader
(src/xerus/ttNetwork.cpp misc namespace).  The same "TTTensor" and
"TTOperator" type tags and payloads, so files cross between the packages
both ways."""

from __future__ import annotations


from ..misc.io import register_serializer
from .ttnetwork import TTNetwork, TTTensor, TTOperator
from ..core.tensor import Tensor


def _writer(tt: TTNetwork):
    meta = {"dimensions": list(tt.dimensions),
            "canonicalized": tt.canonicalized,
            "corePosition": tt.corePosition,
            "num_components": tt.num_components()}
    arrays = {f"component_{i}": c.to_ndarray()
              for i, c in enumerate(tt.components)}
    return {"meta": meta, "arrays": arrays}


def _reader_for(cls):
    def _read(payload):
        meta = payload["meta"]
        comps = [Tensor.from_ndarray(payload["arrays"][f"component_{i}"])
                 for i in range(int(meta["num_components"]))]
        out = cls._make(comps, bool(meta["canonicalized"]),
                        int(meta["corePosition"]))
        require_dims = [int(d) for d in meta["dimensions"]]
        if out.dimensions != require_dims:
            raise ValueError("TT datafile dimensions inconsistent with components")
        out.require_correct_format()
        return out
    return _read


register_serializer("TTTensor", TTTensor, _writer, _reader_for(TTTensor))
register_serializer("TTOperator", TTOperator, _writer, _reader_for(TTOperator))
