"""The port's column-pivoted Householder QR (xerus_tpu_torch.ops.pivoted_qr)
and its QC / CQ route (``_QC_METHOD = "qrp"``, the reference's dgeqp3
rank rule) held against xerus_tpu's on the CPU, in float64.

The same seeded numpy inputs go through both packages.  Householder signs
follow one rule in both, but a sign may flip where the pivot column's
leading entry is within rounding of 0, so Q and R are compared after
fixing the signs by sign(diag R), to 1e-12 of their largest entry.  Past
the numerical rank the trailing norms are rounding noise and the pivots
may differ, so ``perm`` is compared over the first ``rank`` positions
there and the rest by gauge-free quantities: ranks (exactly, and equal to
the port's own SVD route), reconstructions, orthonormality and the
represented tensors (to 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.core import factorizations as fact_j
from xerus_tpu.ops import pivoted_qr as pq_j
from xerus_tpu_torch.core import factorizations as fact_t
from xerus_tpu_torch.ops import pivoted_qr as pq_t

SEED = 0xBAADF00D
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


@pytest.fixture
def qrp_method(monkeypatch):
    """Both packages' QC / CQ on the pivoted-QR route."""
    monkeypatch.setattr(fact_j, "_QC_METHOD", "qrp")
    monkeypatch.setattr(fact_t, "_QC_METHOD", "qrp")


def _rng(*salt):
    return np.random.default_rng([SEED, *salt])


def _max_rel(x, y):
    x, y = np.asarray(x, float), np.asarray(y, float)
    assert x.shape == y.shape
    return float(np.abs(x - y).max(initial=0.0)
                 / max(float(np.abs(y).max(initial=0.0)), 1e-300))


def _signs(r, rank):
    s = np.sign(np.diag(np.asarray(r))[:rank])
    return np.where(s == 0, 1.0, s)


def _torch_qrp(a):
    import torch
    q, r, perm = pq_t.householder_qrp(torch.from_numpy(a))
    return q.numpy(), r.numpy(), perm.numpy()


def _jax_qrp(a, jit=jax.jit(pq_j.householder_qrp)):
    return tuple(np.asarray(x) for x in jit(jnp.asarray(a)))


@pytest.mark.parametrize("m,n", [(12, 7), (7, 12), (16, 16)])
def test_householder_qrp_matches_jax(m, n):
    """Full rank: the pivot sequence identical, sign-fixed Q and R within
    1e-12, a[:, perm] = q r, q^T q = I, |diag R| non-increasing."""
    a = _rng(m, n).normal(size=(m, n))
    q, r, perm = _torch_qrp(a)
    qj, rj, pj = _jax_qrp(a)
    k = min(m, n)
    assert q.shape == (m, k) and r.shape == (k, n) and perm.shape == (n,)
    assert perm.dtype == np.int32
    assert np.array_equal(perm, pj)
    s, sj = _signs(r, k), _signs(rj, k)
    assert _max_rel(q * s, qj * sj) <= TOL
    assert _max_rel(s[:, None] * r, sj[:, None] * rj) <= TOL
    assert np.abs(a[:, perm] - q @ r).max() <= TOL * np.abs(a).max()
    assert np.abs(q.T @ q - np.eye(k)).max() <= TOL
    assert np.all(np.tril(r, -1) == 0.0)
    d = np.abs(np.diag(r))
    assert np.all(d[:-1] >= d[1:] - TOL * d[0])


def _low_rank(lhs, rhs, rank):
    rng = _rng(lhs, rhs, rank)
    return rng.normal(size=(lhs, rank)) @ rng.normal(size=(rank, rhs))


@pytest.mark.parametrize("lhs,rhs,true_rank", [(6, 8, 3), (9, 5, 2),
                                               (7, 7, 7)])
def test_qc_cq_qrp_route_matches_jax(qrp_method, monkeypatch, lhs, rhs,
                                     true_rank):
    """calculate_qc / calculate_cq on the pivoted route in both packages:
    the ranks equal the true rank and the port's SVD route's, the pivots
    agree over the first ``rank`` positions, the sign-fixed factors agree,
    and each package's factors reconstruct with orthonormal Q."""
    a = _low_rank(lhs, rhs, true_rank)
    out = {}
    for name, pkg, fact in (("jax", xe, fact_j), ("torch", xt, fact_t)):
        t = pkg.Tensor.from_ndarray(a)
        Q, C = fact.calculate_qc(t, 1)
        C2, Q2 = fact.calculate_cq(t, 1)
        for rec, q, gram in ((pkg.contract(Q, C, 1), Q.to_ndarray(),
                              lambda q: q.T @ q),
                             (pkg.contract(C2, Q2, 1), Q2.to_ndarray(),
                              lambda q: q @ q.T)):
            assert np.abs(rec.to_ndarray() - a).max() <= TOL * np.abs(a).max()
            assert np.abs(gram(q) - np.eye(true_rank)).max() <= TOL
        out[name] = (Q.to_ndarray(), C.to_ndarray(), C2.to_ndarray(),
                     Q2.to_ndarray())
    monkeypatch.setattr(fact_t, "_QC_METHOD", "svd")
    t = xt.Tensor.from_ndarray(a)
    svd_ranks = (fact_t.calculate_qc(t, 1)[0].dimensions[-1],
                 fact_t.calculate_cq(t, 1)[0].dimensions[-1])
    assert svd_ranks == (true_rank, true_rank)
    for i in range(4):
        assert out["jax"][i].shape == out["torch"][i].shape
    assert out["torch"][0].shape[1] == out["torch"][2].shape[1] == true_rank
    # the pivots over the numerical rank, and the factors fixed by the
    # signs of diag R (C = R[:, argsort(perm)], so R[j, j] = C[j, perm[j]])
    for mat, (q_i, c_i), lead in ((a, (0, 1), lambda c: c),
                                  (a.T, (3, 2), lambda c: c.T)):
        perm = _torch_qrp(mat)[2]
        assert np.array_equal(perm[:true_rank],
                              np.asarray(pq_j.qrp(jnp.asarray(mat))[2])
                              [:true_rank])
        fixed = []
        for name in ("jax", "torch"):
            q = out[name][q_i].reshape(-1, true_rank) if q_i == 0 else \
                out[name][q_i].reshape(true_rank, -1).T
            c = lead(out[name][c_i]).reshape(true_rank, -1)
            s = np.sign(c[np.arange(true_rank), perm[:true_rank]])
            fixed.append((q * s, s[:, None] * c))
        assert _max_rel(fixed[1][0], fixed[0][0]) <= TOL
        assert _max_rel(fixed[1][1], fixed[0][1]) <= TOL


def _jax_rank_excess_tt(d=6, rank=4):
    """x + x in the JAX package, x a rank-``rank`` TT of seeded normal
    cores (``TTTensor.random`` without its canonicalization), so the sum's
    ranks are twice its true ranks (a sum of canonical TTs would move its
    core, which reveals the true ranks)."""
    ranks = xe.TTTensor.reduce_to_maximal_ranks([rank] * (d - 1), [2] * d)
    rng = _rng(d, rank)
    x = xe.TTTensor._make([xe.Tensor.from_ndarray(rng.normal(size=(
        1 if i == 0 else ranks[i - 1], 2, 1 if i == d - 1 else ranks[i])))
        for i in range(d)])
    y = x + x
    assert not y.canonicalized and y.ranks() == [2 * r for r in ranks]
    return y, ranks


def _orthogonality(tt):
    """Worst |G^T G - I| of the components left and right of the core."""
    worst = 0.0
    pos = tt.corePosition
    for n, comp in enumerate(tt.components):
        c = comp.to_ndarray()
        if n < pos:
            m = c.reshape(-1, c.shape[-1])
            worst = max(worst, float(np.abs(m.T @ m - np.eye(m.shape[1]))
                                     .max()))
        elif n > pos:
            m = c.reshape(c.shape[0], -1)
            worst = max(worst, float(np.abs(m @ m.T - np.eye(m.shape[0]))
                                     .max()))
    return worst


def test_move_core_and_dsl_qc_on_the_qrp_route_match_jax(qrp_method,
                                                         monkeypatch):
    """move_core(d-1) and back to 0 on a d=6 TT with twice its true ranks,
    in both packages under qrp: exact ranks (the true ones, and the port's
    SVD route's), the same represented tensor within 1e-12, orthogonal
    components; and one DSL QC of a rank-deficient matrix."""
    from xerus_tpu_torch.convert import tt_from_numpy
    y, true_ranks = _jax_rank_excess_tt()
    cores = [c.to_ndarray() for c in y.components]
    ports = {m: tt_from_numpy(cores, canonicalized=y.canonicalized,
                              core_position=y.corePosition)
             for m in ("qrp", "svd")}
    full = y.to_tensor().to_ndarray()
    for pos in (len(cores) - 1, 0):
        y.move_core(pos)
        for method in ("svd", "qrp"):
            monkeypatch.setattr(fact_t, "_QC_METHOD", method)
            ports[method].move_core(pos)
        z = ports["qrp"]
        assert y.ranks() == z.ranks() == ports["svd"].ranks() == true_ranks
        assert z.corePosition == y.corePosition == pos
        assert _max_rel(z.to_tensor().to_ndarray(),
                        y.to_tensor().to_ndarray()) <= TOL
        assert _max_rel(z.to_tensor().to_ndarray(), full) <= TOL
        assert _orthogonality(z) <= TOL and _orthogonality(y) <= TOL

    a = _low_rank(6, 8, 3)
    out = []
    for pkg in (xe, xt):
        A = pkg.Tensor.from_ndarray(a)
        i, j, r = pkg.indices(3)
        Q, C, rec = pkg.Tensor(), pkg.Tensor(), pkg.Tensor()
        (Q(i, r), C(r, j)) << pkg.QC(A(i, j))
        rec(i, j) << Q(i, r) * C(r, j)
        q = Q.to_ndarray()
        assert np.abs(q.T @ q - np.eye(q.shape[1])).max() <= TOL
        out.append((Q.dimensions, rec.to_ndarray()))
    assert out[0][0] == out[1][0] == [6, 3]
    assert _max_rel(out[1][1], out[0][1]) <= TOL
    assert _max_rel(out[1][1], a) <= TOL
