"""The port's Riemannian kit and remaining algorithms held against xerus_tpu
on the CPU: TTTangentVector (projection, arithmetic, scalar product,
assembly), the retractions and the vector transport, SteepestDescent and
GeometricCG, decomposition_als, randomTTSVD and the cascade example.

Each case of tests/test_riemannian.py, test_other_algorithms.py and
test_cascade.py runs in both packages from one ``set_seed``.  Compared
gauge-free: represented tensors within 1e-10 of their largest entry,
scalar products and norms within 1e-12 relative, residuals within 1e-10
relative (SD and CG: every step decides by comparing residuals, so the
whole trajectory must agree), ranks exactly; and each JAX test's own
bar."""

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt

SEED = 0xBAADF00D
X_TOL = 1e-10


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


def _dense(tt):
    return np.asarray(tt.to_tensor().to_ndarray(), np.float64)


def _close(a, b, tol=X_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _tangent(pkg, dims=(3, 3, 3), rank=2):
    base = pkg.TTTensor.random(list(dims), rank)
    direction = pkg.TTTensor.random(list(dims), rank)
    return base, direction, pkg.TTTangentVector(base, direction)


def test_tangent_projection_and_metric():
    """Projection (idempotent), the scalar product and norm against the
    assembled TT, the projection of the base, added_to_base, arithmetic
    (test_riemannian.py:12-56)."""
    def case(pkg):
        base, direction, tv = _tangent(pkg, (3, 3, 3, 3))
        tt = tv.to_tttensor()
        again = pkg.TTTangentVector(base, tt).to_tttensor()
        d2 = pkg.TTTensor.random([3] * 4, 2)
        t2 = pkg.TTTangentVector(base, d2)
        combo = (tv * 0.5 + t2)
        combo -= tv
        combo *= 2.0
        return {"tt": _dense(tt), "again": _dense(again),
                "sp": tv.scalar_product(t2), "norm": tv.frob_norm(),
                "dense sp": float(np.sum(_dense(tt)
                                         * _dense(t2.to_tttensor()))),
                "of base": _dense(pkg.TTTangentVector(base,
                                                      base).to_tttensor()),
                "base": _dense(base),
                "added": _dense(tv.added_to_base()),
                "combo": _dense(combo.to_tttensor()),
                "ranks": tt.ranks()}
    j, t = _both(case)
    for k in ("tt", "again", "of base", "added", "combo"):
        _close(t[k], j[k])
    np.testing.assert_allclose(t["again"], t["tt"], atol=1e-8)
    np.testing.assert_allclose(t["of base"], t["base"], atol=1e-10)
    np.testing.assert_allclose(t["added"], t["base"] + t["tt"], atol=1e-10)
    assert abs(t["sp"] - t["dense sp"]) < 1e-8
    assert abs(t["norm"] - np.linalg.norm(t["tt"])) < 1e-8
    for k in ("sp", "norm"):
        assert abs(t[k] - j[k]) <= 1e-12 * abs(j[k])
    assert t["ranks"] == j["ranks"]


RETRACTIONS = ["SubmanifoldRetractionI", "HOSVDRetractionI",
               "ALSRetractionI", "SubmanifoldRetractionII",
               "HOSVDRetractionII", "ALSRetractionII"]


@pytest.mark.parametrize("name", RETRACTIONS)
def test_retraction_first_order_matches_jax(name):
    """Retraction(x, t v) = x + t v + O(t^2) (retractions.cxx oracle,
    test_riemannian.py:59-83); the retracted TTs equal JAX's.  The II
    forms take the tangent vector's TT; wrapped in TTRetractionI/II."""
    def case(pkg):
        base = pkg.TTTensor.random([3] * 3, 2)
        base /= base.frob_norm()
        direction = pkg.TTTensor.random([3] * 3, 2)
        tv = pkg.TTTangentVector(base, direction)
        tangent_tt = tv.to_tttensor()
        wrap = (pkg.TTRetractionII if name.endswith("II")
                else pkg.TTRetractionI)
        retraction = wrap(getattr(pkg, name))
        out = []
        for t in (1e-3, 5e-4):
            stepped = base.copy()
            retraction(stepped, (tangent_tt * t) if name.endswith("II")
                       else tv * t)
            out.append(_dense(stepped))
        return out, _dense(base), _dense(tangent_tt)
    (jx, _, _), (tx, base, tangent) = _both(case)
    errs = [np.linalg.norm(x - (base + t * tangent))
            for x, t in zip(tx, (1e-3, 5e-4))]
    assert errs[0] < 1e-2 and errs[1] < errs[0] / 2.5
    for a, b in zip(tx, jx):
        _close(a, b, 1e-9)


def test_vector_transport_matches_jax():
    """ProjectiveVectorTransport (test_riemannian.py:86-98): the moved
    vector lies in the tangent space at the new base, and equals JAX's."""
    def case(pkg):
        base, direction, tv = _tangent(pkg)
        new_base = pkg.TTTensor.random([3] * 3, 2)
        pkg.TTVectorTransport(pkg.ProjectiveVectorTransport)(new_base, tv)
        tt = tv.to_tttensor()
        return _dense(tt), _dense(pkg.TTTangentVector(new_base,
                                                      tt).to_tttensor())
    (j, _), (t, again) = _both(case)
    np.testing.assert_allclose(again, t, atol=1e-8)
    _close(t, j)


def _residual_history(pkg, solve):
    perf = pkg.PerformanceData()
    res = solve(perf)
    return res, [p.residual for p in perf.data]


@pytest.mark.parametrize("case", ["identity", "no operator"])
def test_steepest_descent_matches_jax(case):
    """SteepestDescentVariant on test_riemannian.py:101-118's instances:
    the JAX bars in both packages, the residual after every step above
    1e-8 of the first equal to JAX's, and the two solutions within the
    sum of their residuals of each other."""
    def run(pkg):
        if case == "identity":
            dims = [2] * 4
            A = pkg.TTOperator.identity(dims + dims)
            b = pkg.TTTensor.random(dims, 2)
            b /= b.frob_norm()
            x = pkg.TTTensor.random(dims, 2)
            variant = pkg.SteepestDescentVariant(30, 1e-10, True)
            res, hist = _residual_history(
                pkg, lambda perf: variant(A, x, b, 30, perf))
        else:
            b = pkg.TTTensor.random([3] * 3, 2)
            x = pkg.TTTensor.random([3] * 3, 2)
            variant = pkg.SteepestDescentVariant(30, 1e-12, False)
            res, hist = _residual_history(
                pkg, lambda perf: variant(x, b, 30, perf))
        return res, hist, _dense(x)
    (jr, jh, jx), (tr, th, tx) = _both(run)
    bar = 1e-4 if case == "identity" else 1e-6
    assert tr < bar and jr < bar
    # once the residual is below 1e-8 of the first, a step's
    # accept-or-backtrack decision compares residuals at rounding level
    # (the no-operator case: from 6.6e-8 the port's last step reaches
    # 2.2e-15, JAX's backtracks to no change); above it they agree
    above = [i for i, h in enumerate(jh) if h > 1e-8 * jh[0]]
    assert len(above) > 1 and len(th) > above[-1]
    np.testing.assert_allclose([th[i] for i in above],
                               [jh[i] for i in above], rtol=1e-10,
                               atol=1e-14)
    # both solutions lie within their residual of b (the operator is the
    # identity or absent)
    assert np.linalg.norm(tx - jx) <= tr + jr


def test_geometric_cg_poisson_matches_jax():
    """GeometricCGVariant on the 27-unknown Poisson system
    (test_riemannian.py:121-137): a 10x residual reduction, and the
    residual history equal to JAX's."""
    def run(pkg):
        dims = [3] * 3
        A = pkg.examples.laplace_operator(dims)
        b = pkg.TTTensor.ones(dims)
        b /= b.frob_norm()
        x = pkg.TTTensor.random(dims, 3)
        A_mat = A.to_tensor().to_ndarray().reshape(27, 27)
        b_vec = b.to_tensor().to_ndarray().reshape(-1)
        start = np.linalg.norm(A_mat @ _dense(x).reshape(-1) - b_vec)
        variant = pkg.GeometricCGVariant(40, 1e-10, True)
        res, hist = _residual_history(
            pkg, lambda perf: variant(A, x, b, 40, perf))
        end = np.linalg.norm(A_mat @ _dense(x).reshape(-1) - b_vec)
        return res, hist, start, end
    (jr, jh, _, _), (tr, th, start, end) = _both(run)
    assert end < start / 10
    assert len(th) == len(jh) > 1
    np.testing.assert_allclose(th, jh, rtol=1e-8, atol=1e-14)


def test_default_variants_are_the_jax_packages():
    for name in ("SteepestDescent", "GeometricCG"):
        j, t = getattr(xe, name), getattr(xt, name)
        assert (t.numSteps, t.convergenceEpsilon,
                t.assumeSymmetricPositiveDefiniteOperator) == (
            j.numSteps, j.convergenceEpsilon,
            j.assumeSymmetricPositiveDefiniteOperator)
        assert t.retraction.__name__ == j.retraction.__name__


@pytest.mark.parametrize("exact", [True, False])
def test_decomposition_als_matches_jax(exact):
    """test_other_algorithms.py:11-31: exact at a representable rank,
    within 2x of the TT-SVD error when truncating; the TT equals JAX's."""
    def case(pkg):
        dims = [4, 4, 4]
        target = (pkg.TTTensor.random(dims, 2).to_tensor() if exact
                  else pkg.Tensor.random(dims))
        x = pkg.TTTensor.random(dims, 2)
        pkg.decomposition_als(x, target)
        svd = pkg.TTTensor(target, eps=0.0, max_ranks=[2, 2])
        return _dense(x), target.to_ndarray(), _dense(svd)
    (jx, _, _), (tx, target, svd) = _both(case)
    if exact:
        np.testing.assert_allclose(tx, target, atol=1e-8)
    else:
        assert (np.linalg.norm(tx - target)
                < 2.0 * np.linalg.norm(svd - target) + 1e-12)
    _close(tx, jx, 1e-9)


def test_random_tt_svd():
    """randomTTSVD at a rank that represents the tensor is exact in both
    packages (their sketches differ: jax.random against a torch
    Generator); truncating, it is quasi-optimal against the TT-SVD; rank
    vectors and the oversampling check as JAX's."""
    def case(pkg):
        dims = [3, 4, 4, 3]
        low = pkg.TTTensor.random(dims, 2).to_tensor()
        full = pkg.Tensor.random(dims)
        exact = pkg.randomTTSVD(low, 2)
        trunc = pkg.randomTTSVD(full, [3, 4, 3])
        svd = pkg.TTTensor(full, eps=0.0, max_ranks=[3, 4, 3])
        with pytest.raises(ValueError):
            pkg.randomTTSVD(full, [3, 3])
        with pytest.raises(ValueError):
            pkg.randomTTSVD(full, 3, oversampling=[2, 2])
        return (_dense(exact), low.to_ndarray(), _dense(trunc),
                full.to_ndarray(), _dense(svd), exact.ranks(), trunc.ranks())
    (je, _, _, _, _, jr1, jr2), (te, low, tt, full, svd, tr1, tr2) = \
        _both(case)
    np.testing.assert_allclose(te, low, atol=1e-10 * np.abs(low).max())
    _close(te, je, 1e-10)
    assert (np.linalg.norm(tt - full)
            < 2.0 * np.linalg.norm(svd - full) + 1e-12)
    assert (tr1, tr2) == (jr1, jr2)


def test_cascade_operator_matches_jax():
    """The SLIM cascade MPO at 3 and 2 proteins (test_cascade.py:42-58):
    ranks and the dense operator equal JAX's."""
    from xerus_tpu.examples import cascade as jc
    from xerus_tpu_torch.examples import cascade as tc
    for num, n in ((3, 4), (2, 3)):
        j = jc.cascade_operator(num, n)
        t = tc.cascade_operator(num, n)
        assert t.ranks() == j.ranks() and not t.is_symmetric()
        np.testing.assert_allclose(t.to_tensor().to_ndarray(),
                                   j.to_tensor().to_ndarray(), atol=1e-15)
    for fn in ("create_M", "create_L", "create_S"):
        np.testing.assert_array_equal(getattr(tc, fn)(5).to_ndarray(),
                                      getattr(jc, fn)(5).to_ndarray())


def test_cascade_implicit_euler_matches_jax():
    """Implicit Euler on the cascade (test_cascade.py:61-120 cut to 3
    proteins, n=6, a rank-3 start, 4 steps; ALS_SPD with LU local solves
    on the non-symmetric generator): normalized states, each step's
    residual and the mean concentrations equal JAX's; run_cascade's table
    (test_cascade.py:123-129) too."""
    from xerus_tpu.examples import cascade as jc
    from xerus_tpu_torch.examples import cascade as tc

    def case(pkg):
        casc = jc if pkg is xe else tc
        A = casc.cascade_operator(3, 6)
        start = pkg.TTTensor.dirac([6] * 3, 0)
        start.use_dense_representations()
        start += 1e-14 * pkg.TTTensor.random(list(start.dimensions), [2, 2])
        residuals = []
        results = casc.implicit_euler(A, start, 1.0, 4, residuals=residuals)
        table = casc.mean_concentration_table(results)
        smoke = casc.mean_concentration_table(casc.run_cascade(
            num_proteins=3, num_steps=2, max_num_per_site=6, rank_x=3))
        return (residuals, [casc.one_norm(r) for r in results[1:]], table,
                [_dense(r) for r in results], smoke)
    (jres, _, jtab, jst, jsm), (tres, norms, ttab, tst, tsm) = _both(case)
    assert all(abs(v - 1.0) < 1e-8 for v in norms)
    np.testing.assert_allclose(tres, jres, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(ttab, jtab, rtol=0, atol=1e-10)
    for a, b in zip(tst, jst):
        _close(a, b, 1e-8)
    assert tsm.shape == (3, 3) and np.all(np.isfinite(tsm))
    np.testing.assert_allclose(tsm, jsm, rtol=0, atol=1e-10)


@pytest.mark.slow
def test_cascade_against_dense_evolution():
    """test_cascade.py:61-120's own instance and bars in the port (4
    proteins, n=8, rank-6 start, 6 steps): residuals below 1e-2, states
    within 1e-3 of the dense evolution, concentrations within 1e-2; the
    residuals equal JAX's."""
    from xerus_tpu.examples import cascade as jc
    from xerus_tpu_torch.examples import cascade as tc

    def case(pkg):
        casc = jc if pkg is xe else tc
        A = casc.cascade_operator(4, 8)
        start = pkg.TTTensor.dirac([8] * 4, 0)
        start.use_dense_representations()
        start += 1e-14 * pkg.TTTensor.random(list(start.dimensions),
                                             [5] * 3)
        residuals = []
        results = casc.implicit_euler(A, start, 1.0, 6, residuals=residuals)
        return (residuals, [_dense(r).reshape(-1) for r in results],
                casc.mean_concentration_table(results),
                A.to_tensor().to_ndarray().reshape(8 ** 4, 8 ** 4))
    (jres, _, _, _), (tres, states, conc, gen) = _both(case)
    assert max(tres) < 1e-2
    np.testing.assert_allclose(tres, jres, rtol=1e-8, atol=1e-14)
    op = np.eye(8 ** 4) - gen
    state = np.zeros(8 ** 4)
    state[0] = 1.0
    dense = [state]
    for _ in range(6):
        state = np.linalg.solve(op, state)
        state = state / state.sum()
        dense.append(state)
    for t in (1, 6):
        assert (np.linalg.norm(states[t] - dense[t])
                / np.linalg.norm(dense[t])) < 1e-3
    w = np.arange(8, dtype=float)
    dense_conc = np.array([[(s.reshape([8] * 4).sum(
        axis=tuple(a for a in range(4) if a != p)) * w).sum()
        for p in range(4)] for s in dense])
    assert np.abs(conc - dense_conc).max() < 1e-2
