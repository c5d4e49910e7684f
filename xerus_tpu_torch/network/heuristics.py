"""Contraction-order search: greedy portfolio + exact 3-node case + cache.

The port of ``xerus_tpu.network.heuristics`` (pure Python, a copy), the
reference's src/xerus/contractionHeuristic.cpp:36-381 and the exact
3-node ordering of tensorNetwork.cpp:1269-1313.  Scorers mirror the
reference's portfolio (score_size/mn/speed/r/big_tensor/littlestep,
contractionHeuristic.cpp:108-133), in the same order, and the native
search (``network/native.py``) is tried first, so both packages choose the
same pairwise order for the same network.  Results are cached per topology
signature, so repeated evaluations pay no search cost.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

_INF = float("inf")


def _score_size(m, n, r):
    return n * m - (n + m) * r


def _score_mn(m, n, r):
    return m * n


def _score_speed(m, n, r):
    return (n * m - (n + m) * r) / (n * m * r)


def _score_r(m, n, r):
    return -r


def _score_big_tensor(m, n, r):
    if n * m < (n + m) * r:
        return -1e10 + n * m * r
    return n * m - (n + m) * r


def _score_littlestep(m, n, r):
    if n * m < (n + m) * r:
        return -max(n, m) * r
    return n * m - (n + m) * r


_SCORERS = [_score_size, _score_mn, _score_speed, _score_r,
            _score_big_tensor, _score_littlestep]

_PATH_CACHE: Dict[tuple, List[Tuple[int, int]]] = {}
_MAX_CACHE = 65536


class _Graph:
    """Lightweight mutable view: node sizes + shared-dim maps."""

    def __init__(self, network, ids: Set[int]):
        self.sizes: Dict[int, float] = {}
        self.shared: Dict[int, Dict[int, float]] = {i: {} for i in ids}
        for nid in ids:
            node = network.nodes[nid]
            size = 1.0
            for link in node.neighbors:
                size *= link.dimension
                if (not link.external) and link.other in ids and link.other != nid:
                    d = self.shared[nid].get(link.other, 1.0)
                    self.shared[nid][link.other] = d * link.dimension
            self.sizes[nid] = size

    def clone(self) -> "_Graph":
        g = _Graph.__new__(_Graph)
        g.sizes = dict(self.sizes)
        g.shared = {k: dict(v) for k, v in self.shared.items()}
        return g

    def mnr(self, a: int, b: int) -> Tuple[float, float, float]:
        r = self.shared[a].get(b, 1.0)
        return self.sizes[a] / r, self.sizes[b] / r, r

    def merge(self, a: int, b: int) -> float:
        """Contract b into a; returns FLOP cost m*n*r."""
        m, n, r = self.mnr(a, b)
        cost = m * n * r
        self.sizes[a] = m * n
        del self.sizes[b]
        sa = self.shared[a]
        sa.pop(b, None)
        for other, dim in self.shared[b].items():
            if other == a:
                continue
            sa[other] = sa.get(other, 1.0) * dim
            so = self.shared[other]
            so.pop(b, None)
            so[a] = sa[other]
        del self.shared[b]
        return cost


def _greedy(graph: _Graph, scorer) -> Tuple[float, List[Tuple[int, int]]]:
    g = graph.clone()
    order: List[Tuple[int, int]] = []
    total = 0.0
    while len(g.sizes) > 1:
        best = None
        best_score = _INF
        for a in g.sizes:
            for b in g.shared[a]:
                if b <= a:
                    continue
                m, n, r = g.mnr(a, b)
                s = scorer(m, n, r)
                if s < best_score:
                    best_score = s
                    best = (a, b)
        if best is None:
            # disconnected remainder: outer-product the two smallest
            ids = sorted(g.sizes, key=lambda i: g.sizes[i])
            best = (min(ids[0], ids[1]), max(ids[0], ids[1]))
        a, b = best
        total += g.merge(a, b)
        order.append((a, b))
    return total, order


def _exact_three(network, ids: List[int]) -> List[Tuple[int, int]]:
    """Analytic best order for three nodes (tensorNetwork.cpp:1269-1313)."""
    a, b, c = ids
    g = _Graph(network, set(ids))
    sab = g.shared[a].get(b, 1.0)
    sbc = g.shared[b].get(c, 1.0)
    sac = g.shared[a].get(c, 1.0)
    sa = g.sizes[a] / (sab * sac)
    sb = g.sizes[b] / (sab * sbc)
    sc = g.sizes[c] / (sac * sbc)
    cost_ab = sa * sb * sac * sbc * (sab + sc)
    cost_ac = sa * sc * sab * sbc * (sac + sb)
    cost_bc = sb * sc * sab * sac * (sbc + sa)
    if cost_ab < cost_ac and cost_ab < cost_bc:
        return [(a, b), (a, c)]
    if cost_ac < cost_bc:
        return [(a, c), (a, b)]
    return [(b, c), (a, b)]


def _signature(network, ids: Set[int]) -> tuple:
    sig = []
    for nid in sorted(ids):
        node = network.nodes[nid]
        legs = tuple(sorted(
            (link.other if (not link.external and link.other in ids) else -1,
             link.dimension)
            for link in node.neighbors))
        sig.append((nid, legs))
    return tuple(sig)


def best_contraction_order(network, ids: Set[int]) -> List[Tuple[int, int]]:
    ids = set(ids)
    if len(ids) == 2:
        a, b = sorted(ids)
        return [(a, b)]
    if len(ids) == 3:
        return _exact_three(network, sorted(ids))

    key = _signature(network, ids)
    cached = _PATH_CACHE.get(key)
    if cached is not None:
        return cached

    from .native import native_best_order
    native = native_best_order(network, ids)
    if native is not None:
        if len(_PATH_CACHE) >= _MAX_CACHE:
            _PATH_CACHE.clear()
        _PATH_CACHE[key] = native
        return native

    graph = _Graph(network, ids)
    best_cost = _INF
    best_order: List[Tuple[int, int]] = []
    for scorer in _SCORERS:
        cost, order = _greedy(graph, scorer)
        if cost < best_cost:
            best_cost = cost
            best_order = order

    if len(_PATH_CACHE) >= _MAX_CACHE:
        _PATH_CACHE.clear()
    _PATH_CACHE[key] = best_order
    return best_order
