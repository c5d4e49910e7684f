"""DSL integration for TensorNetwork: lazy graph-building assignment.

The port of ``xerus_tpu.network.dsl`` (a copy).

Reference behavior: assigning an indexed product to a TensorNetwork target
keeps the merged node graph uncontracted
(TensorNetwork::add_network_to_network, src/xerus/tensorNetwork.cpp:553-592,
link_traces_and_fix :598); contraction happens on demand (entry access,
cast to Tensor).  Sums and solves evaluate densely into a single node.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..config import require
from .network import TensorNetwork, TensorNode, Link


def _build_lazy_network(target: TensorNetwork, lhs_labels, rhs) -> bool:
    """Try to build target as an uncontracted graph from a product RHS.
    Returns False if the RHS shape doesn't allow laziness."""
    from ..indexing.expressions import IndexedTensor, Product
    from ..indexing import evaluate as ev

    if isinstance(rhs, IndexedTensor):
        rhs = Product([rhs])
    if not isinstance(rhs, Product):
        return False

    terms: List[ev._Term] = []
    for f in rhs.factors:
        terms.extend(ev._resolve_term(f))

    # occurrence map: label -> [(node_id, position)]
    occ: Dict[Tuple, List[Tuple[int, int]]] = {}
    for nid, term in enumerate(terms):
        for pos, lab in enumerate(term.labels):
            occ.setdefault(lab, []).append((nid, pos))

    for lab, places in occ.items():
        require(len(places) <= 2, f"index used {len(places)} > 2 times")
        if len(places) == 1:
            require(lab in lhs_labels, "open RHS index missing on LHS")
        else:
            require(lab not in lhs_labels, "contracted index may not appear on LHS")
    for lab in lhs_labels:
        require(lab in occ, "LHS index does not appear on RHS")

    nodes: List[TensorNode] = []
    for term in terms:
        nodes.append(TensorNode(term.tensor.copy(),
                                [None] * len(term.labels)))  # type: ignore

    external_links: List[Link] = []
    dimensions: List[int] = []
    for k, lab in enumerate(lhs_labels):
        nid, pos = occ[lab][0]
        dim = terms[nid].tensor.dimensions[pos]
        external_links.append(Link(nid, pos, dim, False))
        dimensions.append(dim)
        nodes[nid].neighbors[pos] = Link(k, pos, dim, True)

    for lab, places in occ.items():
        if len(places) == 2:
            (n1, p1), (n2, p2) = places
            dim = terms[n1].tensor.dimensions[p1]
            nodes[n1].neighbors[p1] = Link(n2, p2, dim, False)
            nodes[n2].neighbors[p2] = Link(n1, p1, dim, False)

    scalar = rhs.scalar
    target.dimensions = dimensions
    target.external_links = external_links
    target.nodes = nodes
    if scalar != 1.0:
        for n in target.nodes:
            if not n.erased:
                n.tensor.factor *= scalar
                break
    # self-link traces (same label twice in one tensor)
    for nid in range(len(target.nodes)):
        target.perform_traces(nid)
    return True


def _network_assign_indexed(self: TensorNetwork, lhs, rhs) -> None:
    from ..indexing import evaluate as ev
    lhs_labels = ev._resolve_lhs_labels(lhs, rhs)
    if _build_lazy_network(self, lhs_labels, rhs):
        return
    result, _ = ev._eval_expr(rhs, lhs_labels)
    single = TensorNetwork(result)
    self.dimensions = single.dimensions
    self.nodes = single.nodes
    self.external_links = single.external_links


TensorNetwork.assign_indexed = _network_assign_indexed
