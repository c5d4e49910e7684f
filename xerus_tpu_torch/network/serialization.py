"""TensorNetwork persistence: the port of
``xerus_tpu.network.serialization`` (reference: tensorNetwork
stream_writer/reader, src/xerus/tensorNetwork.cpp misc namespace;
round-trip tested in unitTests/saveAndLoad.cxx).  The same
"TensorNetwork" type tag and payload, so files cross between the packages
both ways."""

from __future__ import annotations


from ..misc.io import register_serializer
from ..core.tensor import Tensor
from .network import TensorNetwork, TensorNode, Link


def _write_network(net: TensorNetwork):
    net.require_valid_network()
    meta = {
        "dimensions": list(net.dimensions),
        "external_links": [[l.other, l.index_position, l.dimension]
                           for l in net.external_links],
        "links": {},
        "num_nodes": len(net.nodes),
    }
    arrays = {}
    for nid, node in enumerate(net.nodes):
        if node.erased:
            continue
        arrays[f"node_{nid}"] = node.tensor.to_ndarray()
        meta["links"][str(nid)] = [[l.other, l.index_position, l.dimension,
                                    bool(l.external)] for l in node.neighbors]
    return {"meta": meta, "arrays": arrays}


def _read_network(payload) -> TensorNetwork:
    meta = payload["meta"]
    net = TensorNetwork.__new__(TensorNetwork)
    net.dimensions = [int(d) for d in meta["dimensions"]]
    net.external_links = [Link(int(o), int(p), int(d), False)
                          for o, p, d in meta["external_links"]]
    net.nodes = []
    for nid in range(int(meta["num_nodes"])):
        key = str(nid)
        if key not in meta["links"]:
            net.nodes.append(TensorNode(None))
            continue
        links = [Link(int(o), int(p), int(d), bool(e))
                 for o, p, d, e in meta["links"][key]]
        net.nodes.append(TensorNode(
            Tensor.from_ndarray(payload["arrays"][f"node_{nid}"]), links))
    net.require_valid_network(check_erased=False)
    return net


register_serializer("TensorNetwork", TensorNetwork, _write_network, _read_network)
