"""The indexed DSL on TT operands (xerus_tpu_torch.tt.dsl and the TT route
of indexing/) held against xerus_tpu's on the CPU.

The DSL cases of tests/test_tt.py and the factorisation DSL of
tests/test_factorization_dsl.py applied to TT casts run in both packages
from one ``set_seed``; represented tensors, ranks, norms and canonical
flags agree to 1e-12 in float64.  Also here: ``frob_norm`` of a TT
expression stays in TT form (the dense-fallback counter does not move),
and an error raised inside the TT evaluation reaches the caller instead
of sending the expression down the dense route, as the JAX package's
catch-all would."""

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu_torch.tt import dsl as tt_dsl

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


def _state(tt, name="tt"):
    return {f"{name} full": np.asarray(tt.to_tensor().to_ndarray()),
            f"{name} ranks": list(tt.ranks()),
            f"{name} type": type(tt).__name__,
            f"{name} flags": (bool(tt.canonicalized), int(tt.corePosition))}


def c_operator_apply(pkg):
    A = pkg.TTOperator.random([3, 4, 3, 4], 2)
    x = pkg.TTTensor.random([3, 4], 2)
    i, j = pkg.indices(2)
    y = pkg.TTTensor()
    y(i & 0) << A(i / 2, j / 2) * x(j & 0)
    yt = pkg.TTTensor()
    yt(i & 0) << A(j / 2, i / 2) * x(j & 0)
    ys = pkg.TTTensor()
    ys(i & 0) << 2.5 * (A(i / 2, j / 2) * x(j & 0))
    return {**_state(y), **_state(yt, "transposed"), **_state(ys, "scaled"),
            "ref": (A.to_tensor().to_ndarray().reshape(12, 12)
                    @ x.to_tensor().to_ndarray().reshape(12))}


def c_operator_chain(pkg):
    A = pkg.TTOperator.random([2, 3, 2, 3], 2)
    B = pkg.TTOperator.random([2, 3, 2, 3], 2)
    x = pkg.TTTensor.random([2, 3], 2)
    i, j, k = pkg.indices(3)
    y = pkg.TTTensor()
    y(i & 0) << A(i / 2, j / 2) * B(j / 2, k / 2) * x(k & 0)
    C = pkg.TTOperator()
    C(i / 2, k / 2) << A(i / 2, j / 2) * B(j / 2, k / 2)
    Ct = pkg.TTOperator()
    Ct(i / 2, k / 2) << A(j / 2, i / 2) * B(j / 2, k / 2)
    return {**_state(y), **_state(C, "compose"), **_state(Ct, "transposed")}


def c_tt_sums(pkg):
    a = pkg.TTTensor.random([3, 3, 3], 2)
    b = pkg.TTTensor.random([3, 3, 3], 2)
    i = pkg.Index()
    c = pkg.TTTensor()
    c(i & 0) << a(i & 0) + 2.0 * b(i & 0)
    d = pkg.TTTensor()
    d(i & 0) << a(i & 0) - b(i & 0) / 4.0
    A = pkg.TTOperator.random([3, 3, 3, 3, 3, 3], 2)
    j = pkg.Index()
    r = pkg.TTTensor()
    r(i & 0) << A(i / 2, j / 2) * a(j & 0) - b(i & 0)
    return {**_state(c, "sum"), **_state(d, "diff"), **_state(r, "residual")}


def c_zero_sums(pkg):
    i = pkg.Index()
    A = pkg.Tensor([4, 4, 4])
    B = pkg.Tensor.random([4, 4, 4])
    ttA, ttB = pkg.TTTensor(A), pkg.TTTensor(B)
    ttC = pkg.TTTensor(3)
    out = {}
    for name, rhs in (("A+B", lambda: ttA(i & 0) + ttB(i & 0)),
                      ("A-B", lambda: ttA(i & 0) - ttB(i & 0)),
                      ("B-A", lambda: ttB(i & 0) - ttA(i & 0))):
        ttC(i & 0) << rhs()
        out.update(_state(ttC, name))
    return out


def c_frob_norm_in_tt_form(pkg):
    A = pkg.TTOperator.random([2] * 12, 2)
    x = pkg.TTTensor.random([2] * 6, 3)
    b = pkg.TTTensor.random([2] * 6, 2)
    i, j = pkg.indices(2)
    return {"residual": pkg.frob_norm(A(i / 2, j / 2) * x(j & 0) - b(i & 0)),
            "sum": (x(i & 0) + b(i & 0)).frob_norm(),
            "single": pkg.frob_norm(x(i & 0)),
            "op": pkg.frob_norm(A(i / 2, j / 2))}


def c_tt_in_dense_expression(pkg):
    tt = pkg.TTTensor.random([3, 4, 5], 2)
    A = pkg.TTOperator.random([3, 4, 3, 4], 2)
    M = pkg.Tensor.random([5, 2])
    i, j, k, l, m, n = pkg.indices(6)
    out = pkg.Tensor()
    out(i, j, k) << tt(i, j, k)
    mixed = pkg.Tensor()
    mixed(i, j, l) << tt(i, j, k) * M(k, l)
    app = pkg.Tensor()
    app(i, j, n) << A(i, j, k, l) * tt(k, l, n)
    inner = float(tt(i & 0) * tt.copy()(i & 0))
    return {"copy": out.to_ndarray(), "mixed": mixed.to_ndarray(),
            "apply": app.to_ndarray(), "inner": inner,
            "cast": pkg.Tensor(tt).to_ndarray(),
            "op cast": pkg.Tensor(A).to_ndarray()}


def c_dense_target_fallback(pkg):
    """A TT target with a non-TT right-hand side: dense evaluation, then an
    exact TT-SVD (the reference's "casting to Tensor first")."""
    T = pkg.Tensor.random([3, 4, 3])
    i, j, k = pkg.indices(3)
    tt = pkg.TTTensor()
    tt(i, j, k) << T(i, j, k)
    perm = pkg.TTTensor()
    x = pkg.TTTensor.random([3, 4, 3], 2)
    perm(i, j, k) << x(k, j, i)
    return {**_state(tt), **_state(perm, "permuted"), "ref": T.to_ndarray()}


def c_network_target(pkg):
    x = pkg.TTTensor.random([3, 4, 3], 2)
    M = pkg.Tensor.random([3, 5])
    i, j, k, l = pkg.indices(4)
    net = pkg.TensorNetwork()
    net(i, j, l) << x(i, j, k) * M(k, l)
    return {"alive": len([n for n in net.nodes if not n.erased]),
            "full": net.to_tensor().to_ndarray(), "dims": net.dimensions}


def c_factorisations_of_a_tt(pkg):
    """(U(i,r1), S(r1,r2), Vt(r2,j)) << SVD(Tensor(tt)(i,j)) and QR/QC of the
    TT's cast, as tests/test_factorization_dsl.py runs them on Tensors."""
    tt = pkg.TTTensor.random([3, 4, 5], 2)
    T = pkg.Tensor(tt)
    i, j, k, r1, r2 = pkg.indices(5)
    U, S, Vt = pkg.Tensor(), pkg.Tensor(), pkg.Tensor()
    (U(i, j, r1), S(r1, r2), Vt(r2, k)) << pkg.SVD(T(i, j, k))
    rec = pkg.Tensor()
    rec(i, j, k) << U(i, j, r1) * S(r1, r2) * Vt(r2, k)
    Q, C = pkg.Tensor(), pkg.Tensor()
    (Q(i, r1), C(r1, j, k)) << pkg.QC(T(i, j, k))
    rec2 = pkg.Tensor()
    rec2(i, j, k) << Q(i, r1) * C(r1, j, k)
    return {"s": np.diag(S.to_ndarray()), "rec": rec.to_ndarray(),
            "qc rank": Q.dimensions[-1], "qc rec": rec2.to_ndarray()}


def c_matmul_tensor_tt_ranks(pkg):
    """The TT-rank half of tests/test_indexed_expressions.py's
    matrix-multiplication-tensor cases (strassen.cxx TTRanks)."""
    out = {}
    for n in (2, 3):
        T = pkg.Tensor([n] * 6, pkg.Representation.Sparse)
        for a in range(n):
            for b in range(n):
                for c in range(n):
                    T[[a, b, b, c, a, c]] = 1.0
        rounded = pkg.TTTensor(T.copy())
        rounded.round(1e-12)
        svd = pkg.TTTensor(T, eps=1e-12)
        out[f"round ranks {n}"] = rounded.ranks()
        out[f"eps ranks {n}"] = svd.ranks()
        out[f"full {n}"] = svd.to_tensor().to_ndarray()
    return out


def c_multi_node_trace(pkg):
    """tmp(i1,i2,i3,i4) = A(i1,i3) * B(i2,i4), then tmp(i1,i1,i2,i2)
    (tensorNetwork.cxx contraction_multi_node_trace)."""
    A = pkg.Tensor.random([1, 10])
    B = pkg.Tensor.random([1, 10])
    i1, i2, i3, i4 = pkg.indices(4)
    tmp = pkg.TensorNetwork()
    tmp(i1, i2, i3, i4) << A(i1, i3) * B(i2, i4)
    return {"trace": float(tmp(i1, i1, i2, i2)),
            "ref": float(np.dot(A.to_ndarray()[0], B.to_ndarray()[0]))}


CASES = [c_matmul_tensor_tt_ranks, c_multi_node_trace, c_operator_apply, c_operator_chain, c_tt_sums, c_zero_sums,
         c_frob_norm_in_tt_form, c_tt_in_dense_expression,
         c_dense_target_fallback, c_network_target, c_factorisations_of_a_tt]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[2:])
def test_tt_dsl_matches_jax(case):
    ref, got = _both(case)
    _same(ref, got)


def c_products_past_52_labels(pkg):
    """d=20 TTs expanded into their cores in a dense-target product: more
    distinct indices than numpy's einsum can spell."""
    y = pkg.TTTensor.random([2] * 20, 3)
    x = pkg.TTTensor.random([2] * 20, 2)
    a, b, i, j = pkg.indices(4)
    s, M = pkg.Tensor(), pkg.Tensor()
    s() << y(i & 0) * x(i & 0)
    M(a, b) << y(a, j & 1) * x(b, j & 1)
    return {"inner": float(s[0]), "M": M.to_ndarray(),
            "sweep": float(pkg.tt.inner(y, x))}


def test_products_past_52_labels_match_jax():
    from xerus_tpu_torch.indexing import evaluate as ev
    ref, got = _both(c_products_past_52_labels)
    _same(ref, got)
    assert abs(got["inner"] - got["sweep"]) <= 1e-12 * abs(got["sweep"])
    xt.set_seed(SEED)
    y, x = (xt.TTTensor.random([2] * 20, r) for r in (3, 2))
    i = xt.Index()
    labels = {l for f in (y(i & 0), x(i & 0)) for t in ev._resolve_term(f)
              for l in t.labels}
    assert len(labels) > 52


def test_operator_apply_is_right():
    xt.set_seed(SEED)
    r = c_operator_apply(xt)
    np.testing.assert_allclose(r["tt full"].reshape(12), r["ref"], rtol=0,
                               atol=1e-12 * np.abs(r["ref"]).max())
    assert r["tt ranks"] == [4]


def test_frob_norm_stays_in_tt_form():
    """The residual of an operator application is evaluated as a TT
    (no dense fallback) and equals the dense residual."""
    xt.set_seed(SEED)
    A = xt.TTOperator.random([2] * 12, 2)
    x = xt.TTTensor.random([2] * 6, 3)
    b = xt.TTTensor.random([2] * 6, 2)
    i, j = xt.indices(2)
    before = tt_dsl.tt_assign.dense_fallbacks
    got = xt.frob_norm(A(i / 2, j / 2) * x(j & 0) - b(i & 0))
    assert tt_dsl.tt_assign.dense_fallbacks == before
    dense = (A.to_tensor().to_ndarray().reshape(64, 64)
             @ x.to_tensor().to_ndarray().reshape(64)
             - b.to_tensor().to_ndarray().reshape(64))
    assert abs(got - np.linalg.norm(dense)) <= 1e-12 * np.linalg.norm(dense)


def test_dense_fallbacks_are_counted():
    xt.set_seed(SEED)
    x = xt.TTTensor.random([3, 4, 3], 2)
    i, j, k = xt.indices(3)
    before = tt_dsl.tt_assign.dense_fallbacks
    y = xt.TTTensor()
    y(i, j, k) << x(k, j, i)               # not TT-shaped: dense route
    assert tt_dsl.tt_assign.dense_fallbacks == before + 1
    (x(i, j, k) - y(k, j, i)).frob_norm()  # a norm that densifies
    assert tt_dsl.tt_assign.dense_fallbacks == before + 2


def test_errors_inside_the_tt_evaluation_reach_the_caller(monkeypatch):
    """The JAX package's _try_tt returns None on any exception and then
    densifies; the port lets the error through."""
    xt.set_seed(SEED)
    A = xt.TTOperator.random([2] * 8, 2)
    x = xt.TTTensor.random([2] * 4, 2)
    i, j = xt.indices(2)

    def broken(*args, **kwargs):
        raise RuntimeError("device failure inside the TT evaluation")

    monkeypatch.setattr(tt_dsl, "apply_operator", broken)
    before = tt_dsl.tt_assign.dense_fallbacks
    with pytest.raises(RuntimeError, match="device failure"):
        xt.frob_norm(A(i / 2, j / 2) * x(j & 0))
    assert tt_dsl.tt_assign.dense_fallbacks == before


def test_mismatched_tt_sum_raises():
    xt.set_seed(SEED)
    a = xt.TTTensor.random([2, 2, 2], 2)
    b = xt.TTTensor.random([3, 2, 2], 2)
    i = xt.Index()
    with pytest.raises(ValueError):
        (a(i & 0) + b(i & 0)).frob_norm()
