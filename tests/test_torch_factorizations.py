"""The port's factorizations and solves (xerus_tpu_torch.core.factorizations)
held against xerus_tpu's on the CPU.

Every case of tests/test_factorizations.py runs in both packages from the
same ``set_seed`` and keeps that file's oracles, but the optional
pivoted-QR route's, which tests/test_torch_pivoted_qr.py holds against
the JAX package's.  QR and SVD signs differ
between jnp and torch, so only gauge-free results are compared:
reconstructions, singular values, orthogonality, ranks, dimensions and
solutions (to 1e-12 of the largest entry in float64; ranks, dimensions and
routes exactly).  The solve routes (Cholesky, LU, least squares) are read
off each package's performance counters; least squares is the
minimum-norm solution in both, on rank-deficient and wide systems too."""

import os

import numpy as np
import pytest
import torch

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.core import factorizations as fact_j
from xerus_tpu.misc import performance as perf_j
from xerus_tpu_torch.core import factorizations as fact_t
from xerus_tpu_torch.misc import performance as perf_t

SEED = 0xBAADF00D
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "gesdd_failure_96x96.npy")


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


def _fact(pkg):
    return fact_j if pkg is xe else fact_t


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


def _orth_cols(t, rank):
    q = t.to_ndarray().reshape(-1, rank)
    return float(np.abs(q.T @ q - np.eye(rank)).max())


def _orth_rows(t, rank):
    q = t.to_ndarray().reshape(rank, -1)
    return float(np.abs(q @ q.T - np.eye(rank)).max())


# -- the cases of tests/test_factorizations.py


def c_svd_roundtrip_and_orthogonality(pkg):
    t = pkg.Tensor.random([4, 5, 6])
    U, S, Vt = _fact(pkg).calculate_svd(t, 1)
    rec = pkg.contract(pkg.contract(U, S, 1), Vt, 1)
    assert pkg.approx_equal(rec, t, 1e-12)
    r = S.dimensions[0]
    assert _orth_cols(U, r) < 1e-12 and _orth_rows(Vt, r) < 1e-12
    d = np.diag(S.to_ndarray())
    assert np.all(np.diff(d) <= 1e-14)
    return {"rec": rec.to_ndarray(), "s": d, "dims": [U.dimensions,
            S.dimensions, Vt.dimensions], "S_rep": S.representation.name}


def c_svd_max_rank_truncation(pkg):
    t = pkg.Tensor.random([8, 8])
    U, S, Vt = _fact(pkg).calculate_svd(t, 1, max_rank=3)
    full_s = np.linalg.svd(t.to_ndarray(), compute_uv=False)
    assert np.allclose(np.diag(S.to_ndarray()), full_s[:3], atol=1e-12)
    return {"s": np.diag(S.to_ndarray()), "dims": S.dimensions,
            "rec": pkg.contract(pkg.contract(U, S, 1), Vt, 1).to_ndarray()}


def c_svd_eps_truncation(pkg):
    a = (np.outer(np.arange(1, 7), np.ones(6))
         + np.outer(np.ones(6), np.arange(6)))
    U, S, Vt = _fact(pkg).calculate_svd(pkg.Tensor.from_ndarray(a), 1,
                                        eps=1e-10)
    return {"rank": S.dimensions[0], "s": np.diag(S.to_ndarray())}


def c_svd_factor_handling(pkg):
    t = pkg.Tensor.random([5, 5])
    t *= -2.0
    U, S, Vt = _fact(pkg).calculate_svd(t, 1)
    rec = pkg.contract(pkg.contract(U, S, 1), Vt, 1)
    assert pkg.approx_equal(rec, t, 1e-12)
    assert np.all(np.diag(S.to_ndarray()) >= 0)
    return {"rec": rec.to_ndarray(), "s": np.diag(S.to_ndarray()),
            "vt_factor": Vt.factor}


def c_qr_roundtrip(pkg):
    out = {}
    for n, (dims, split) in enumerate([([6, 4], 1), ([3, 4, 5], 2),
                                       ([4, 12], 1)]):
        t = pkg.Tensor.random(dims)
        Q, R = _fact(pkg).calculate_qr(t, split)
        rec = pkg.contract(Q, R, 1)
        assert pkg.approx_equal(rec, t, 1e-12)
        assert _orth_cols(Q, Q.dimensions[-1]) < 1e-12
        r = R.to_ndarray().reshape(R.dimensions[0], -1)
        assert np.allclose(np.tril(r, -1), 0)
        out[f"rec{n}"] = rec.to_ndarray()
        out[f"dims{n}"] = [Q.dimensions, R.dimensions]
    return out


def c_rq_roundtrip(pkg):
    out = {}
    for n, (dims, split) in enumerate([([6, 4], 1), ([3, 4, 5], 1),
                                       ([12, 4], 1)]):
        t = pkg.Tensor.random(dims)
        R, Q = _fact(pkg).calculate_rq(t, split)
        rec = pkg.contract(R, Q, 1)
        assert pkg.approx_equal(rec, t, 1e-12)
        assert _orth_rows(Q, Q.dimensions[0]) < 1e-12
        out[f"rec{n}"] = rec.to_ndarray()
        out[f"dims{n}"] = [R.dimensions, Q.dimensions]
    return out


def c_qc_rank_revealing(pkg):
    a = (pkg.misc.randomEngine.normal(size=(6, 3))
         @ pkg.misc.randomEngine.normal(size=(3, 8)))
    t = pkg.Tensor.from_ndarray(a)
    Q, C = _fact(pkg).calculate_qc(t, 1)
    rec = pkg.contract(Q, C, 1)
    assert pkg.approx_equal(rec, t, 1e-12) and _orth_cols(Q, 3) < 1e-12
    return {"rank": Q.dimensions[-1], "rec": rec.to_ndarray()}


def c_cq_rank_revealing(pkg):
    a = (pkg.misc.randomEngine.normal(size=(8, 3))
         @ pkg.misc.randomEngine.normal(size=(3, 6)))
    t = pkg.Tensor.from_ndarray(a)
    C, Q = _fact(pkg).calculate_cq(t, 1)
    rec = pkg.contract(C, Q, 1)
    assert pkg.approx_equal(rec, t, 1e-12) and _orth_rows(Q, 3) < 1e-12
    return {"rank": C.dimensions[-1], "rec": rec.to_ndarray()}


def c_pseudo_inverse(pkg):
    t = pkg.Tensor.random([5, 3])
    pinv = _fact(pkg).pseudo_inverse(t, 1)
    assert np.allclose(pinv.to_ndarray(), np.linalg.pinv(t.to_ndarray()),
                       atol=1e-10)
    return {"dims": pinv.dimensions, "pinv": pinv.to_ndarray()}


def c_solve_square(pkg):
    A, b = pkg.Tensor.random([6, 6]), pkg.Tensor.random([6])
    x = _fact(pkg).solve(A, b)
    assert np.allclose(A.to_ndarray() @ x.to_ndarray(), b.to_ndarray(),
                       atol=1e-9)
    return {"x": x.to_ndarray()}


def c_solve_spd_path(pkg):
    g = pkg.Tensor.random([6, 6]).to_ndarray()
    A = pkg.Tensor.from_ndarray(g @ g.T + 6 * np.eye(6))
    x = _fact(pkg).solve(A, pkg.Tensor.random([6]))
    return {"x": x.to_ndarray()}


def c_solve_factor_propagation(pkg):
    A = pkg.Tensor.random([5, 5])
    A *= 2.0
    b = pkg.Tensor.random([5])
    b *= -3.0
    x = _fact(pkg).solve(A, b)
    assert np.allclose(A.to_ndarray() @ x.to_ndarray(), b.to_ndarray(),
                       atol=1e-9)
    return {"x": x.to_ndarray(), "factor": x.factor}


def c_solve_least_squares_overdetermined(pkg):
    A, b = pkg.Tensor.random([8, 3]), pkg.Tensor.random([8])
    x = _fact(pkg).solve_least_squares(A, b)
    expect, *_ = np.linalg.lstsq(A.to_ndarray(), b.to_ndarray(), rcond=None)
    assert np.allclose(x.to_ndarray(), expect, atol=1e-10)
    return {"x": x.to_ndarray()}


def c_solve_matrix_rhs_extra_degree(pkg):
    A, B = pkg.Tensor.random([6, 6]), pkg.Tensor.random([6, 4])
    X = _fact(pkg).solve(A, B, extra_degree=1)
    assert np.allclose(A.to_ndarray() @ X.to_ndarray(), B.to_ndarray(),
                       atol=1e-9)
    return {"dims": X.dimensions, "x": X.to_ndarray()}


def c_singular_solve_falls_back(pkg):
    a = np.zeros((4, 4))
    a[0, 0] = 1.0
    x = _fact(pkg).solve(pkg.Tensor.from_ndarray(a),
                         pkg.Tensor.from_ndarray(np.array([2.0, 0, 0, 0])))
    return {"x": x.to_ndarray()}


CASES = {name[2:]: fn for name, fn in dict(globals()).items()
         if name.startswith("c_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_factorization_matches_jax(name):
    ref, got = _both(CASES[name])
    _same(ref, got)


# -- the SVD's non-convergence guard (ROADMAP trap 6)


def test_svd_gesdd_nonconvergence_fallback(monkeypatch):
    """A nan spectrum from the first driver falls back to scipy's gesvd
    instead of reaching the QC rank rule."""
    def fake(a):
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        return u, torch.full_like(s, float("nan")), vt

    monkeypatch.setattr(fact_t, "_svd", fake)
    xt.set_seed(SEED)
    A = xt.Tensor.random([12, 7])
    u, s, vt = fact_t._svd_robust(A.to_torch())
    assert not torch.isnan(s).any()
    rec = (u * s) @ vt
    np.testing.assert_allclose(rec.numpy(), A.to_ndarray(), atol=1e-12)
    C, Q = fact_t.calculate_cq(A, 1)
    assert C.dimensions[-1] == 7
    np.testing.assert_allclose(
        np.tensordot(C.to_ndarray(), Q.to_ndarray(), axes=([1], [0])),
        A.to_ndarray(), atol=1e-12)


def test_svd_convergence_error_falls_back(monkeypatch):
    """A driver that raises LinAlgError takes the same fallback."""
    def fail(a):
        raise torch.linalg.LinAlgError("did not converge")

    monkeypatch.setattr(fact_t, "_svd", fail)
    a = torch.from_numpy(np.random.default_rng(3).normal(size=(9, 5)))
    u, s, vt = fact_t._svd_robust(a)
    np.testing.assert_allclose(((u * s) @ vt).numpy(), a.numpy(),
                               atol=1e-12)


def test_revealed_rank_rejects_nan_spectrum():
    with pytest.raises(ValueError, match="nan singular values"):
        fact_t._revealed_rank(np.array([np.nan, 1.0, 0.5]))


def test_gesdd_failure_fixture():
    """The captured 96x96 matrix on which XLA's CPU gesdd returned nan:
    finite factors, exact reconstruction, the JAX package's rank."""
    m = np.load(FIXTURE)
    out = {}
    for pkg in (xe, xt):
        T = pkg.Tensor.from_ndarray(m)
        C, Q = _fact(pkg).calculate_cq(T, 1)
        U, S, Vt = _fact(pkg).calculate_svd(T, 1)
        assert np.isfinite(C.to_ndarray()).all()
        assert np.isfinite(np.diag(S.to_ndarray())).all()
        out[pkg] = {"rank": C.dimensions[-1],
                    "cq": np.tensordot(C.to_ndarray(), Q.to_ndarray(),
                                       axes=([1], [0])),
                    "svd": pkg.contract(pkg.contract(U, S, 1), Vt,
                                        1).to_ndarray(),
                    "s": np.diag(S.to_ndarray())}
    got = out[xt]
    scale = np.abs(m).max()
    assert got["rank"] > 1
    np.testing.assert_allclose(got["cq"], m, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(got["svd"], m, rtol=0, atol=1e-12 * scale)
    _same(out[xe], got)


# -- solve routes and least squares


def _route(perf):
    """The solve sections a package entered, in route order."""
    sections = perf._CALLS.get("Dense LAPACK", {})
    return [n for n in ("Solve (Cholesky)", "Solve (PLU)",
                        "Solve Least Squares") if n in sections]


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return g @ g.T + n * np.eye(n)


def _sym_indefinite(rng, n):
    g = rng.normal(size=(n, n))
    return g + g.T


SYSTEMS = {"spd": (_spd, ["Solve (Cholesky)"]),
           "symmetric indefinite": (_sym_indefinite,
                                    ["Solve (Cholesky)", "Solve (PLU)"]),
           "non-symmetric": (lambda rng, n: rng.normal(size=(n, n)),
                             ["Solve (PLU)"]),
           "singular": (lambda rng, n: np.diag([1.0] + [0.0] * (n - 1)),
                        ["Solve (Cholesky)", "Solve (PLU)",
                         "Solve Least Squares"])}


@pytest.mark.parametrize("kind", sorted(SYSTEMS))
def test_solve_takes_the_jax_route(kind):
    """Each input goes down the same route in both packages: SPD ->
    Cholesky, symmetric indefinite -> Cholesky fails -> LU,
    non-symmetric -> LU, singular -> least squares."""
    make, sections = SYSTEMS[kind]
    rng = np.random.default_rng(11)
    a, b = make(rng, 7), rng.normal(size=7)
    x = {}
    for pkg, perf in ((xe, perf_j), (xt, perf_t)):
        perf.enable(True)
        perf.clear_analysis()
        try:
            x[pkg] = _fact(pkg).solve(pkg.Tensor.from_ndarray(a),
                                      pkg.Tensor.from_ndarray(b)).to_ndarray()
            taken = _route(perf)
        finally:
            perf.enable(False)
            perf.clear_analysis()
        assert taken == sections, (pkg.__name__, taken)
    _same({"x": x[xe]}, {"x": x[xt]})


@pytest.mark.parametrize("shape,rank", [((9, 6), 3), ((4, 9), 4),
                                        ((5, 8), 2)],
                         ids=["rank-deficient", "wide", "wide deficient"])
def test_least_squares_minimum_norm(shape, rank):
    """The minimum-norm solution with jnp.linalg.lstsq's cutoff, through
    ``solve`` (non-square) and ``solve_least_squares``, held against the
    JAX package and numpy."""
    rng = np.random.default_rng(sum(shape) + rank)
    a = rng.normal(size=(shape[0], rank)) @ rng.normal(size=(rank, shape[1]))
    b = rng.normal(size=shape[0])
    expect, *_ = np.linalg.lstsq(a, b, rcond=None)
    for fn in ("solve", "solve_least_squares"):
        x = {pkg: getattr(_fact(pkg), fn)(
            pkg.Tensor.from_ndarray(a), pkg.Tensor.from_ndarray(b)
        ).to_ndarray() for pkg in (xe, xt)}
        _same({"x": x[xe]}, {"x": x[xt]})
        _same({"x": expect}, {"x": x[xt]})


@pytest.mark.parametrize("what", ["qr", "qc", "cq", "solve"])
def test_sparse_qr_routes_not_ported(what):
    """The sparse QR / QC / CQ and the sparse one-right-hand-side solve
    (ROADMAP Queue 1 item 8, the JAX package's native SPQR-style route,
    now ported): the port's results equal the JAX package's on the same
    seeded sparse input, and reconstruct it.  The name is historical: the
    test once asserted that these routes raised."""
    def case(pkg):
        t = pkg.Tensor.random([5, 5], n=10)
        if what == "solve":
            x = _fact(pkg).solve(t, pkg.Tensor.random([5]))
            return {"x": x.to_ndarray()}
        L, R = getattr(_fact(pkg), f"calculate_{what}")(t, 1)
        rec = pkg.contract(L, R, 1).to_ndarray()
        np.testing.assert_allclose(rec, t.to_ndarray(), atol=1e-12)
        lm = L.to_ndarray().reshape(5, -1)
        orth = lm if what != "cq" else R.to_ndarray().reshape(-1, 5).T
        return {"rank": L.dimensions[-1], "proj": orth @ orth.T,
                "sparse": (L.is_sparse(), R.is_sparse())}

    ref, got = _both(case)
    _same(ref, got, rtol=1e-10)


def test_svd_of_sparse_input_matches_jax():
    """SVD densifies a sparse input in both packages."""
    ref, got = _both(lambda pkg: {"s": np.diag(_fact(pkg).calculate_svd(
        pkg.Tensor.random([6, 6], n=12), 1)[1].to_ndarray())})
    _same(ref, got)
