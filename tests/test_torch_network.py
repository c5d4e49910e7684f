"""The port's tensor network (xerus_tpu_torch.network) held against
xerus_tpu's on the CPU.

The cases of tests/test_tensor_network.py run in both packages from the
same ``set_seed``: contracted results agree to 1e-12 of their largest
entry in float64, node counts, dimensions and graph exports exactly.  The
contraction order is the same in both packages on the networks of
tests/test_native_pathopt.py and on TT chains: the same heuristics and the
same native search, which the port compiles into its own build directory.
Network files cross between the packages both ways, byte for byte under a
frozen clock."""

import os
import time

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.network import heuristics as heur_j
from xerus_tpu_torch.network import heuristics as heur_t
from xerus_tpu_torch.network import native as native_t

SEED = 0xBAADF00D


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


def _both(case, seed=SEED):
    out = []
    for pkg in (xe, xt):
        pkg.set_seed(seed)
        out.append(case(pkg))
    return out


def _same(a, b, rtol=1e-12):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, (np.ndarray, float)):
            x, y = np.asarray(x, float), np.asarray(y, float)
            assert x.shape == y.shape, k
            scale = max(float(np.abs(x).max(initial=0.0)), 1e-300)
            assert float(np.abs(x - y).max(initial=0.0)) <= rtol * scale, k
        else:
            assert x == y, k


def _alive(net):
    return len([n for n in net.nodes if not n.erased])


def _lazy_pair(pkg, shapes=([3, 4], [4, 5])):
    A, B = (pkg.Tensor.random(s) for s in shapes)
    i, j, k = pkg.indices(3)
    net = pkg.TensorNetwork()
    net(i, k) << A(i, j) * B(j, k)
    return net, A, B


# -- the cases of tests/test_tensor_network.py


def c_from_tensor(pkg):
    t = pkg.Tensor.random([3, 4])
    net = pkg.TensorNetwork(t)
    net.require_valid_network()
    zero = pkg.TensorNetwork()
    return {"degree": net.degree(), "dims": net.dimensions,
            "full": net.to_tensor().to_ndarray(), "ref": t.to_ndarray(),
            "zero nodes": _alive(zero), "zero": zero.to_tensor().to_ndarray(),
            "datasize": net.datasize()}


def c_lazy_product(pkg):
    net, A, B = _lazy_pair(pkg)
    net.require_valid_network()
    return {"alive": _alive(net), "full": net.to_tensor().to_ndarray(),
            "entry": net[[1, 2]], "linear entry": net[7],
            "frob": net.frob_norm(), "repr": repr(net)}


def c_network_in_expression(pkg):
    net, _A, _B = _lazy_pair(pkg)
    C = pkg.Tensor.random([5, 2])
    i, k, l = pkg.indices(3)
    out = pkg.Tensor()
    out(i, l) << net(i, k) * C(k, l)
    return {"out": out.to_ndarray()}


def c_network_times_network(pkg):
    A, B, C, D = (pkg.Tensor.random(s) for s in ([3, 4], [4, 5], [5, 6],
                                                 [6, 3]))
    i, j, k, l, m = pkg.indices(5)
    n1 = pkg.TensorNetwork()
    n1(i, k) << A(i, j) * B(j, k)
    n2 = pkg.TensorNetwork()
    n2(k, m) << C(k, l) * D(l, m)
    big = pkg.TensorNetwork()
    big(i, m) << n1(i, k) * n2(k, m)
    big.require_valid_network()
    return {"alive": _alive(big), "full": big.to_tensor().to_ndarray()}


def c_traces_and_rings(pkg):
    A = pkg.Tensor.random([4, 4])
    i, j, k, l = pkg.indices(4)
    tr = float(A(i, j) * pkg.Tensor.identity([4, 4])(i, j))
    mats = [pkg.Tensor.random([5, 5]) for _ in range(4)]
    ring = float(mats[0](i, j) * mats[1](j, k) * mats[2](k, l)
                 * mats[3](l, i))
    T = pkg.Tensor.random([3, 4, 4])
    net = pkg.TensorNetwork()
    net(i) << T(i, j, j)             # a self-link, traced on assignment
    return {"trace": tr, "ring": ring, "self": net.to_tensor().to_ndarray(),
            "self alive": _alive(net)}


def c_fix_and_resize_mode(pkg):
    net, _A, _B = _lazy_pair(pkg)
    net.fix_mode(0, 1)
    net.require_valid_network()
    grown, _A, _B = _lazy_pair(pkg)
    grown.resize_mode(1, 7)
    cut, _A, _B = _lazy_pair(pkg)
    cut.resize_mode(0, 2, 1)
    slate, _A, _B = _lazy_pair(pkg)
    slate.remove_slate(1, 3)
    return {"fix dims": net.dimensions, "fix": net.to_tensor().to_ndarray(),
            "grow": grown.to_tensor().to_ndarray(),
            "cut": cut.to_tensor().to_ndarray(),
            "slate": slate.to_tensor().to_ndarray()}


def c_scalar_scaling(pkg):
    A = pkg.Tensor.random([3, 3])
    net = pkg.TensorNetwork(A)
    net *= 2.5
    scaled = net.to_tensor().to_ndarray()
    net /= 2.5
    return {"scaled": scaled, "back": net.to_tensor().to_ndarray()}


def c_transfer_core(pkg):
    net, _A, _B = _lazy_pair(pkg)
    before = net.to_tensor().to_ndarray()
    net.transfer_core(0, 1)
    net.require_valid_network()
    q = net.nodes[0].tensor.to_ndarray().reshape(3, -1)
    kept, _A, _B = _lazy_pair(pkg, ([6, 2], [2, 7]))
    kept.transfer_core(1, 0, allow_rank_reduction=False)
    return {"before": before, "after": net.to_tensor().to_ndarray(),
            "orthonormal": bool(np.allclose(q.T @ q, np.eye(q.shape[1]),
                                            atol=1e-12)),
            "rank": net.nodes[0].tensor.dimensions,
            "kept": kept.to_tensor().to_ndarray(),
            "kept rank": kept.nodes[0].tensor.dimensions}


def c_round_edge(pkg):
    rng = pkg.misc.randomEngine
    base = rng.normal(size=(6, 2)) @ rng.normal(size=(2, 7))
    U, S, _Vt = np.linalg.svd(base)
    A = pkg.Tensor.from_ndarray(U[:, :6])
    B = pkg.Tensor.from_ndarray(np.diag(np.concatenate([S[:2], np.zeros(4)]))
                                @ np.eye(6, 7))
    i, j, k = pkg.indices(3)
    net = pkg.TensorNetwork()
    net(i, k) << A(i, j) * B(j, k)
    net.round_edge(0, 1, max_rank=2, eps=0.0)
    net.require_valid_network()
    pos, _ = net.find_common_edge(0, 1)
    soft, _A, _B = _lazy_pair(pkg, ([5, 4], [4, 6]))
    soft.round_edge(0, 1, max_rank=3, eps=0.0, soft_threshold=0.5)
    return {"rank": net.nodes[0].neighbors[pos].dimension,
            "full": net.to_tensor().to_ndarray(),
            "soft": soft.to_tensor().to_ndarray(),
            "soft dims": soft.nodes[0].tensor.dimensions}


def c_contraction_cost_and_draw(pkg):
    net, _A, _B = _lazy_pair(pkg, ([10, 20], [20, 30]))
    return {"cost": net.contraction_cost(0, 1), "self cost":
            net.contraction_cost(0, 0), "dot": net.draw()}


def c_chain_heuristic(pkg):
    dims = [2, 3, 4, 5, 4, 3, 2]
    mats = [pkg.Tensor.random([dims[p], dims[p + 1]]) for p in range(6)]
    idx = pkg.indices(7)
    net = pkg.TensorNetwork()
    expr = mats[0](idx[0], idx[1])
    for p in range(1, 6):
        expr = expr * mats[p](idx[p], idx[p + 1])
    net(idx[0], idx[6]) << expr
    ids = {n for n, node in enumerate(net.nodes) if not node.erased}
    order = list(net._contraction_order(ids))
    return {"full": net.to_tensor().to_ndarray(), "order": order}


def c_sum_to_dense_node(pkg):
    A, B = pkg.Tensor.random([3, 4]), pkg.Tensor.random([3, 4])
    i, j = pkg.indices(2)
    net = pkg.TensorNetwork()
    net(i, j) << A(i, j) + B(i, j)
    return {"alive": _alive(net), "full": net.to_tensor().to_ndarray()}


def c_tt_cast(pkg):
    tt = pkg.TTTensor.random([3] * 4, 2)
    tn = pkg.TensorNetwork(tt)
    tn.require_valid_network()
    out = {"nodes": len(tn.nodes), "full": tn.to_tensor().to_ndarray(),
           "cost": tn.contraction_cost(0, 1)}
    tn.fix_mode(0, 1)
    tn.sanitize()
    tn.require_valid_network()
    out["fixed"] = tn.to_tensor().to_ndarray()
    op = pkg.TTOperator.random([3, 4, 3, 4], 2)
    tno = op.copy_as_network()
    tn2 = pkg.TensorNetwork(tno)
    tn2.nodes[0].tensor *= 2.0
    out.update({"op nodes": len(tno.nodes), "op dims": tno.dimensions,
                "op": tno.to_tensor().to_ndarray(),
                "copy": tn2.to_tensor().to_ndarray(),
                "source": tno.to_tensor().to_ndarray()})
    return out


def c_contract_pair_and_ids(pkg):
    A, B, C = (pkg.Tensor.random(s) for s in ([3, 4], [4, 5], [5, 2]))
    i, j, k, l = pkg.indices(4)
    net = pkg.TensorNetwork()
    net(i, l) << A(i, j) * B(j, k) * C(k, l)
    pair = net.copy()
    pair.contract(0, 1)
    pair.require_valid_network(check_erased=False)
    ids = net.copy()
    res = ids.contract({0, 1, 2})
    stripped = net.stripped_subnet(lambda n: n != 1)
    return {"pair alive": _alive(pair), "pair": pair.to_tensor().to_ndarray(),
            "ids result": res, "ids": ids.to_tensor().to_ndarray(),
            "stripped dims": stripped.dimensions,
            "stripped": stripped.to_tensor().to_ndarray()}


def c_reduce_representation(pkg):
    A, B, C = (pkg.Tensor.random(s) for s in ([2, 8], [8, 3], [3, 9]))
    i, j, k, l = pkg.indices(4)
    net = pkg.TensorNetwork()
    net(i, l) << A(i, j) * B(j, k) * C(k, l)
    before = net.to_tensor().to_ndarray()
    net.reduce_representation()
    net.require_valid_network(check_erased=False)
    return {"alive": _alive(net), "before": before,
            "after": net.to_tensor().to_ndarray()}


def c_closed_subnetworks(pkg):
    a, b = pkg.Tensor.random([4]), pkg.Tensor.random([4])
    M = pkg.Tensor.random([3, 5])
    i, j, k = pkg.indices(3)
    net = pkg.TensorNetwork()
    net(j, k) << a(i) * b(i) * M(j, k)
    closed = pkg.TensorNetwork()
    closed() << a(i) * b(i)
    return {"full": net.to_tensor().to_ndarray(),
            "closed": closed.to_tensor().to_ndarray()}


CASES = [c_from_tensor, c_lazy_product, c_network_in_expression,
         c_network_times_network, c_traces_and_rings, c_fix_and_resize_mode,
         c_scalar_scaling, c_transfer_core, c_round_edge,
         c_contraction_cost_and_draw, c_chain_heuristic, c_sum_to_dense_node,
         c_tt_cast, c_contract_pair_and_ids, c_reduce_representation,
         c_closed_subnetworks]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[2:])
def test_network_matches_jax(case):
    ref, got = _both(case)
    _same(ref, got)


def test_network_results_are_right():
    xt.set_seed(SEED)
    net, A, B = _lazy_pair(xt)
    np.testing.assert_allclose(net.to_tensor().to_ndarray(),
                               A.to_ndarray() @ B.to_ndarray(), rtol=0,
                               atol=1e-12)
    r = c_transfer_core(xt)
    assert r["orthonormal"]
    r = c_round_edge(xt)
    assert r["rank"] == 2


# -- the contraction order (tests/test_native_pathopt.py)


def _random_network(pkg, num_nodes, dim=4, cross=True):
    """A chain of matrices plus, with ``cross``, a few rank-2 cross links
    (three-leg nodes), so the search has real choices."""
    idx = pkg.indices(3 * num_nodes + 2)
    mats = []
    expr = None
    for p in range(num_nodes):
        labels = [idx[p], idx[p + 1]]
        shape = [dim + p % 3, dim + (p + 1) % 3]
        if cross and p % 3 == 1 and p + 2 < num_nodes:
            labels.append(idx[num_nodes + 1 + p])
            shape.append(2)
        if cross and p % 3 == 0 and p >= 3:
            labels.append(idx[num_nodes + 1 + p - 2])
            shape.append(2)
        t = pkg.Tensor.random(shape)
        mats.append(t)
        term = t(*labels)
        expr = term if expr is None else expr * term
    net = pkg.TensorNetwork()
    net(idx[0], idx[num_nodes]) << expr
    return net


@pytest.mark.parametrize("num_nodes,cross", [(4, True), (6, True),
                                             (7, True), (9, True),
                                             (6, False), (7, False)])
def test_contraction_order_matches_jax(num_nodes, cross):
    """best_contraction_order chooses the same pairwise order in both
    packages (the same native search, or the same portfolio without it),
    and both contract to the same tensor: on the chains of
    tests/test_native_pathopt.py and on chains with cross links."""
    def case(pkg):
        heur = heur_j if pkg is xe else heur_t
        heur._PATH_CACHE.clear()
        net = _random_network(pkg, num_nodes, cross=cross)
        ids = {n for n, node in enumerate(net.nodes) if not node.erased}
        graph = heur._Graph(net, ids)
        portfolio = [heur._greedy(graph, s)[1] for s in heur._SCORERS]
        return {"order": heur.best_contraction_order(net, ids),
                "portfolio": portfolio,
                "full": net.to_tensor().to_ndarray()}
    ref, got = _both(case)
    _same(ref, got)


def test_tt_chain_order_matches_jax():
    def case(pkg):
        heur = heur_j if pkg is xe else heur_t
        heur._PATH_CACHE.clear()
        a = pkg.TTTensor.random([2] * 7, 3)
        b = pkg.TTTensor.random([2] * 7, 2)
        i = pkg.Index()
        net = pkg.TensorNetwork()
        net() << a(i & 0) * b(i & 0)
        ids = {n for n, node in enumerate(net.nodes) if not node.erased}
        return {"order": heur.best_contraction_order(net, ids),
                "value": net.to_tensor().to_ndarray(),
                "inner": pkg.tt.inner(a, b)}
    ref, got = _both(case)
    _same(ref, got)
    assert abs(got["value"] - got["inner"]) <= 1e-12 * abs(got["inner"])


def test_native_search_is_built_in_the_port():
    """The port compiles native/pathopt.cpp into its own build directory
    (nothing under native/) and its search is at least as good as the
    Python portfolio."""
    assert native_t.native_available()
    path = native_t.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("xerus_tpu_torch",
                                                       "_build"))
    xt.set_seed(SEED)
    net = _random_network(xt, 7)
    ids = {n for n, node in enumerate(net.nodes) if not node.erased}
    calls = native_t.native_best_order.calls
    order = native_t.native_best_order(net, ids)
    assert native_t.native_best_order.calls == calls + 1
    assert len(order) == len(ids) - 1

    def cost(o):
        g = heur_t._Graph(net, ids)
        return sum(g.merge(a, b) for a, b in o)
    best_py = min(heur_t._greedy(heur_t._Graph(net, ids), s)[0]
                  for s in heur_t._SCORERS)
    assert cost(order) <= best_py * (1 + 1e-9)


def test_python_portfolio_without_the_library(monkeypatch):
    """Without the native library the portfolio plans, as in JAX."""
    monkeypatch.setattr(native_t, "_load", lambda: None)
    heur_t._PATH_CACHE.clear()
    xt.set_seed(SEED)
    net = _random_network(xt, 6)
    ids = {n for n, node in enumerate(net.nodes) if not node.erased}
    order = heur_t.best_contraction_order(net, ids)
    graph = heur_t._Graph(net, ids)
    costs = [heur_t._greedy(graph, s) for s in heur_t._SCORERS]
    assert order == min(costs, key=lambda c: c[0])[1]
    heur_t._PATH_CACHE.clear()


# -- files


def _frozen_write(monkeypatch, pkg, obj, path, fmt):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    pkg.save_to_file(obj, str(path), getattr(pkg.FileFormat, fmt))
    monkeypatch.undo()


@pytest.mark.parametrize("fmt", ["BINARY", "TSV"])
def test_network_files_cross_between_the_packages(tmp_path, monkeypatch,
                                                  fmt):
    paths = {}
    for pkg in (xe, xt):
        pkg.set_seed(SEED)
        net, _A, _B = _lazy_pair(pkg)
        paths[pkg] = tmp_path / f"{pkg.__name__}.xtpu"
        _frozen_write(monkeypatch, pkg, net, paths[pkg], fmt)
    assert paths[xt].read_bytes() == paths[xe].read_bytes()
    for writer, reader in ((xe, xt), (xt, xe)):
        back = reader.load_from_file(str(paths[writer]))
        writer.set_seed(SEED)
        orig, _A, _B = _lazy_pair(writer)
        assert back.dimensions == orig.dimensions
        assert _alive(back) == _alive(orig)
        for n, o in zip(back.nodes, orig.nodes):
            assert np.array_equal(n.tensor.to_ndarray(), o.tensor.to_ndarray())


def test_network_from_numpy_carries_the_graph():
    xe.set_seed(SEED)
    jn = xe.TensorNetwork(xe.TTTensor.random([3, 4, 3], 2))
    net = xt.convert.network_from_numpy(
        jn.dimensions,
        [(l.other, l.index_position, l.dimension) for l in jn.external_links],
        [None if n.erased else
         (n.tensor.to_ndarray(), [(l.other, l.index_position, l.dimension,
                                   l.external) for l in n.neighbors])
         for n in jn.nodes])
    np.testing.assert_allclose(net.to_tensor().to_ndarray(),
                               jn.to_tensor().to_ndarray(), rtol=0,
                               atol=1e-15)


def test_network_operations_raise_without_a_card(monkeypatch):
    import torch
    xt.set_seed(SEED)
    net, _A, _B = _lazy_pair(xt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(xt.config, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.to_tensor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.copy().transfer_core(0, 1)
