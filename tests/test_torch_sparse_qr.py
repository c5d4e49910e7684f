"""The port's sparse QR (xerus_tpu_torch.core.sparse_qr and the sparse
routes of core/factorizations.py) held against xerus_tpu's on the CPU.

The inputs are those of the 12 tests of tests/test_sparse_qr.py, run
through both packages.  The native route is the same C++ source built
twice (the port's copy into xerus_tpu_torch/_build/), so its outputs,
ranks and pivots must be equal; the dense Heath route runs its QR through
torch in the port and numpy in the JAX package, so there the ranks must
be equal and Q's column space, the reconstruction and the orthonormality
must meet that file's bars.  At object level the sparse QR / QC / CQ, the
sparse solves and a sparse TT's move_core run in both packages from one
``set_seed``: ranks, representations and gauge-free results must agree."""

import os

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.core import sparse_qr as sq_j
from xerus_tpu.core import factorizations as fact_j
from xerus_tpu_torch.core import sparse_qr as sq_t
from xerus_tpu_torch.core import factorizations as fact_t
from xerus_tpu_torch import build

import native_jax

SEED = 0xBAADF00D
PKGS = (sq_j, sq_t)


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's native sparse QR, loaded (``native_jax``): a
    worker whose first load raced another worker's make would otherwise
    hold the port's native route against the JAX package's dense one."""
    native_jax.loaded(sq_j)


def _fact(pkg):
    return fact_j if pkg is xe else fact_t


def _dense(flat, rows, cols):
    out = np.zeros((rows, cols))
    for p, v in flat.items():
        out[p // cols, p % cols] = v
    return out


def _mat(t, split):
    m = int(np.prod(t.dimensions[:split]))
    return t.to_ndarray().reshape(m, -1)


def _coo(A):
    pos = np.flatnonzero(A)
    return pos, A.reshape(-1)[pos]


def _random_scatter(seed, m, n, k):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), k)
    cols = rng.integers(0, n, size=rows.size)
    pos = np.unique(rows * n + cols)
    return pos, rng.standard_normal(pos.size), rng


def _banded(seed, m, n, k):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), k)
    base = (rows * n) // m
    cols = np.minimum(base + rng.integers(0, 2, size=rows.size), n - 1)
    pos = np.unique(rows * n + cols)
    return pos, rng.standard_normal(pos.size)


def _check_qc(out, A, rel=1e-12):
    q, c, rank = out
    m, n = A.shape
    Q, C = _dense(q, m, rank), _dense(c, rank, n)
    assert np.linalg.norm(Q.T @ Q - np.eye(rank)) < 1e-12
    assert np.linalg.norm(Q @ C - A) < rel * np.linalg.norm(A)
    return Q


def test_library_builds_into_the_ports_build_directory():
    """The port builds native/sparseqr.cpp with the Makefile's flags into
    xerus_tpu_torch/_build/ under a hashed name and never runs make in
    native/: a missing library fails here (callers would fall back to the
    dense route without a word)."""
    assert sq_t.native_available()
    path = sq_t.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libsparseqr_")
    assert sq_t.DEFAULT_ORDERING == sq_j.DEFAULT_ORDERING == 1
    assert sq_t.ROW_SPAN_NATIVE_LIMIT == sq_j.ROW_SPAN_NATIVE_LIMIT


def test_native_route_is_the_jax_packages():
    """tests/test_sparse_qr.py's tiny-pivot, rank-deficient and banded
    inputs on the native route: equal dicts, ranks and pivots."""
    A1 = np.array([[1e-20, 1.0], [0.0, 1.0]])
    rng = np.random.default_rng(3)
    half = rng.standard_normal((40, 6)) * (rng.random((40, 6)) < 0.5)
    A2 = np.concatenate([half, 2.0 * half], axis=1)
    cases = [(*_coo(A1), 2, 2, 16 * np.finfo(float).eps),
             (*_coo(A2), 40, 12, 1e-10),
             (*_banded(0xC0FFEE, 8192, 4096, 2), 8192, 4096, 0.0)]
    ranks = []
    for pos, vals, m, n, tol in cases:
        got = [pkg._factor_raw(pos, vals, m, n, tol) for pkg in PKGS]
        assert got[0][6] == got[1][6]                       # rank
        for a, b in zip(got[0][:6] + (got[0][7],), got[1][:6] + (got[1][7],)):
            np.testing.assert_array_equal(a, b)             # COO, pivots
        outs = [pkg.sparse_qc(pos, vals, m, n, tol) for pkg in PKGS]
        assert outs[0] == outs[1]
        ranks.append(outs[0][2])
    # the rank-deficient input keeps its true rank (its columns twice over)
    assert ranks[1] == np.linalg.matrix_rank(A2) == np.linalg.matrix_rank(half)


@pytest.mark.parametrize("ordering", [0, 1, 2])
def test_orderings_give_the_same_factorization(ordering, monkeypatch):
    """test_sparse_qr_orderings_equivalent and
    test_sparse_qr_rank_deficient_under_ordering: every ordering gives a
    valid A = Q C of the same rank, the least-squares solve under the
    permuted pivots is exact, and both packages agree bit for bit."""
    monkeypatch.setenv("XERUS_TPU_SPARSEQR_FORCE_NATIVE", "1")
    pos, vals, rng = _random_scatter(42, 96, 48, 4)
    A = np.zeros((96, 48))
    A[pos // 48, pos % 48] = vals
    outs = [pkg.sparse_qc(pos, vals, 96, 48, 0.0, ordering=ordering)
            for pkg in PKGS]
    assert outs[0] == outs[1]
    _check_qc(outs[1], A)
    assert outs[1][2] == 48
    b = rng.standard_normal(96)
    x_ref, *_ = np.linalg.lstsq(A, b, rcond=None)
    xs = [pkg.sparse_solve_ls(pos, vals, 96, 48, b, 1e-12, ordering=ordering)
          for pkg in PKGS]
    np.testing.assert_array_equal(xs[0], xs[1])
    assert np.linalg.norm(xs[1] - x_ref) < 1e-9 * max(1.0,
                                                      np.linalg.norm(x_ref))

    rng = np.random.default_rng(3)
    half = rng.standard_normal((40, 6)) * (rng.random((40, 6)) < 0.5)
    Ad = np.concatenate([half, 2.0 * half], axis=1)
    outs = [pkg.sparse_qc(*_coo(Ad), 40, 12, 1e-10, ordering=ordering)
            for pkg in PKGS]
    assert outs[0] == outs[1] and outs[1][2] == 6
    _check_qc(outs[1], Ad, rel=1e-8)


def test_dense_route_keeps_the_native_routes_rank_decisions(monkeypatch):
    """test_sparse_qr_dense_route_matches_native_semantics on both
    packages: random scatter takes the dense Heath route, gives an
    orthonormal A = Q C spanning the JAX package's column space, and the
    rank decisions of the native route, full-rank and deficient."""
    m, n = 128, 96
    pos, vals, rng = _random_scatter(11, m, n, 6)
    for pkg in PKGS:
        assert pkg.mean_row_span(pos.astype(np.int64), m, n) \
            > pkg.ROW_SPAN_NATIVE_LIMIT
    A = np.zeros((m, n))
    A[pos // n, pos % n] = vals
    dense = [pkg.sparse_qc(pos, vals, m, n, 0.0) for pkg in PKGS]
    Qj, Qt = (_check_qc(out, A) for out in dense)
    assert dense[0][2] == dense[1][2] == n
    assert np.abs(Qj @ Qj.T - Qt @ Qt.T).max() < 1e-12
    # the dense route of the port is dense_heath_qc on the compute device
    direct = sq_t.dense_heath_qc(pos, vals, m, n, 0.0)
    assert direct == dense[1]

    half = rng.standard_normal((m, n // 2)) * (rng.random((m, n // 2)) < 0.3)
    Ad = np.concatenate([half, -0.5 * half], axis=1)
    posd, valsd = _coo(Ad)
    r_dense = [pkg.sparse_qc(posd, valsd, m, n, 1e-10) for pkg in PKGS]
    for out in r_dense:
        _check_qc(out, Ad, rel=1e-10)
    Pj, Pt = (_dense(o[0], m, o[2]) for o in r_dense)
    assert np.abs(Pj @ Pj.T - Pt @ Pt.T).max() < 1e-10
    # the dense route declines the solve (the caller's dense solve runs)
    assert sq_t.sparse_solve_ls(posd, valsd, m, n, np.ones(m), 1e-12) is None
    monkeypatch.setenv("XERUS_TPU_SPARSEQR_FORCE_NATIVE", "1")
    r_native = [pkg.sparse_qc(posd, valsd, m, n, 1e-10)[2] for pkg in PKGS]
    assert r_dense[0][2] == r_dense[1][2] == r_native[0] == r_native[1] \
        == n // 2


def test_banded_input_stays_native():
    """test_sparse_qr_banded_stays_native and the banded large-scale
    case: the span predictor keeps narrow patterns on the native route,
    whose fill stays low and whose reconstruction holds."""
    pos, _ = _banded(5, 512, 256, 2)
    for pkg in PKGS:
        assert pkg.mean_row_span(pos.astype(np.int64), 512, 256) \
            <= pkg.ROW_SPAN_NATIVE_LIMIT
    m, n = 8192, 4096
    pos, vals = _banded(0xC0FFEE, m, n, 2)
    q_flat, c_flat, rank = sq_t.sparse_qc(pos, vals, m, n, 0.0)
    assert 0 < rank <= n and len(q_flat) < 10 * pos.size
    x = np.random.default_rng(0xC0FFEE).standard_normal(n)
    cx = np.zeros(rank)
    for p, v in c_flat.items():
        cx[p // n] += v * x[p % n]
    qcx = np.zeros(m)
    for p, v in q_flat.items():
        qcx[p // rank] += v * cx[p % rank]
    ax = np.zeros(m)
    np.add.at(ax, pos // n, vals * x[pos % n])
    assert np.linalg.norm(qcx - ax) < 1e-10 * np.linalg.norm(ax)


# -- object level: the sparse routes of calculate_qr / qc / cq and solves


def _both(case, seed=SEED):
    out = []
    for pkg in (xe, xt):
        pkg.set_seed(seed)
        out.append(case(pkg))
    return out


def _qr_case(pkg):
    t = pkg.Tensor.random([30, 12], n=50)
    t.factor = -1.5
    Q, R = _fact(pkg).calculate_qr(t, 1)
    return t, Q, R


def _rank_revealing(pkg):
    s = pkg.Tensor([16, 6], pkg.Representation.Sparse)
    for i in range(16):
        s._sparse[i * 6 + 0] = float(i + 1)
        s._sparse[i * 6 + 3] = 2.0 * (i + 1)
        s._sparse[i * 6 + 1] = float((i * 7) % 5 - 2)
        s._sparse[i * 6 + 4] = -0.5 * ((i * 7) % 5 - 2)
    return s


def _stays_sparse(pkg):
    s = pkg.Tensor([64, 64], pkg.Representation.Sparse)
    for i in range(0, 64, 2):
        s._sparse[i * 64 + (i % 64)] = float(i + 1)
    return s


def _tiny_pivot(pkg):
    s = pkg.Tensor([2, 2], pkg.Representation.Sparse)
    s._sparse[0] = 1e-20
    s._sparse[1] = 1.0
    s._sparse[3] = 1.0
    return s


def _tiny_pivot_tail(pkg):
    rng = np.random.default_rng(5)
    t = pkg.Tensor([20, 8], pkg.Representation.Sparse)
    for i in range(20):
        t._sparse[i * 8 + int(rng.integers(1, 8))] = float(rng.normal())
    t._sparse[0] = 1e-18
    t._sparse[5] = 2.5
    return t


INPUTS = {
    "random_30x12": lambda pkg: pkg.Tensor.random([30, 12], n=50),
    "rank_revealing": _rank_revealing,
    "wide_9x25": lambda pkg: pkg.Tensor.random([9, 25], n=40),
    "stays_sparse": _stays_sparse,
    "random_18x10": lambda pkg: pkg.Tensor.random([18, 10], n=35),
    "tiny_pivot": _tiny_pivot,
    "tiny_pivot_tail": _tiny_pivot_tail,
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_object_factorizations_match_jax(name):
    """QR (where full rank), QC and CQ of each sparse input of
    tests/test_sparse_qr.py in both packages: the same ranks and
    representations, reconstructions to 1e-12, orthonormal factors to
    1e-13 and the same column / row spaces."""
    def case(pkg):
        t = INPUTS[name](pkg)
        A = _mat(t, 1)
        f = _fact(pkg)
        out = {"A": A}
        Q, C = f.calculate_qc(t, 1)
        C2, Q2 = f.calculate_cq(t, 1)
        for key, (L, Rt) in (("qc", (Q, C)), ("cq", (C2, Q2))):
            r = L.dimensions[-1]
            Lm, Rm = _mat(L, 1), Rt.to_ndarray().reshape(r, -1)
            out[key] = (r, L.is_sparse(), Rt.is_sparse())
            assert np.linalg.norm(Lm @ Rm - A) <= 1e-12 * np.linalg.norm(A)
            orth = Lm if key == "qc" else Rm.T
            assert np.linalg.norm(orth.T @ orth - np.eye(r)) < 1e-13
            out[key + "_proj"] = orth @ orth.T
        if min(A.shape) == np.linalg.matrix_rank(A):
            Q3, R3 = f.calculate_qr(t, 1)
            Qm = _mat(Q3, 1)
            assert np.linalg.norm(Qm @ _mat(R3, 1) - A) \
                <= 1e-12 * np.linalg.norm(A)
            out["qr"] = (Q3.dimensions[-1], Q3.is_sparse(), R3.is_sparse())
            out["qr_proj"] = Qm @ Qm.T
        return out

    j, t = _both(case)
    np.testing.assert_array_equal(j["A"], t["A"])
    assert j.keys() == t.keys()
    for key in j:
        if key.endswith("_proj"):
            assert np.abs(j[key] - t[key]).max() < 1e-10, key
        elif key != "A":
            assert j[key] == t[key], key
    if name == "rank_revealing":
        assert t["qc"][0] == 2
    if name == "stays_sparse":
        assert t["qc"][1:] == (True, True)
    if name == "tiny_pivot":
        assert t["qc"][0] == 1


def test_sparse_qr_keeps_the_factor_and_its_sign():
    """tests/test_sparse_qr.py's first case: the factor -1.5 rides on R."""
    (tj, Qj, Rj), (tt, Qt, Rt) = _both(_qr_case)
    for t, Q, R in ((tj, Qj, Rj), (tt, Qt, Rt)):
        A = _mat(t, 1)
        Qm, Rm = _mat(Q, 1), _mat(R, 1)
        assert np.linalg.norm(Qm @ Rm - A) < 1e-12 * np.linalg.norm(A)
        assert np.linalg.norm(Qm.T @ Qm - np.eye(Qm.shape[1])) < 1e-13
    assert (Qt.is_sparse(), Rt.is_sparse(), Rt.factor) == \
        (Qj.is_sparse(), Rj.is_sparse(), Rj.factor)
    assert Rt.factor == -1.5


def test_sparse_solves_match_jax():
    """A sparse square system and a sparse least-squares problem through
    solve / solve_least_squares and ``x(i) << b(j) / A(j, i)``: the JAX
    package's solutions to 1e-12, the oracles of tests/test_sparse_qr.py,
    and the sparse route taken (no dense LAPACK section)."""
    def case(pkg):
        rng = np.random.default_rng(3)
        n = 24
        s = pkg.Tensor([n, n], pkg.Representation.Sparse)
        for i in range(n):
            s._sparse[i * n + i] = 4.0 + rng.uniform()
        for _ in range(20):
            i, j = rng.integers(0, n, 2)
            key = int(i) * n + int(j)
            s._sparse[key] = s._sparse.get(key, 0.0) + 0.3
        b = pkg.Tensor.from_ndarray(rng.normal(size=n))
        x = _fact(pkg).solve(s, b).to_ndarray()
        assert np.linalg.norm(s.to_ndarray() @ x - b.to_ndarray()) < 1e-10
        i, j = pkg.indices(2)
        y = pkg.Tensor()
        y(i) << b(j) / s(j, i)
        t = pkg.Tensor.random([40, 7], n=60)
        bb = pkg.Tensor.from_ndarray(rng.normal(size=40))
        z = _fact(pkg).solve_least_squares(t, bb).to_ndarray()
        want, *_ = np.linalg.lstsq(_mat(t, 1), bb.to_ndarray(), rcond=None)
        assert np.allclose(z, want, atol=1e-9)
        return x, y.to_ndarray(), z

    j, t = _both(case)
    for a, b in zip(j, t):
        assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()
    # the port's sparse route: the dense solve is never reached
    calls = []
    orig = fact_t._solve_matrix
    fact_t._solve_matrix = lambda a, b: calls.append(1) or orig(a, b)
    try:
        _both(case)
    finally:
        fact_t._solve_matrix = orig
    assert not calls


def test_sparse_tt_move_core_takes_the_sparse_route():
    """A TT of sparse components (a few entries per core, the regime of TT
    sparse cores) canonicalizes through the sparse QC / CQ in both
    packages: no dense copy is split off first, the components keep the
    JAX package's representations and ranks, and the represented tensor
    is unchanged."""
    def case(pkg):
        rng = np.random.default_rng(7)
        dims, ranks = [16] * 5, [1, 3, 3, 3, 3, 1]
        comps = []
        for k in range(5):
            rl, rr = ranks[k], ranks[k + 1]
            c = pkg.Tensor([rl, dims[k], rr], pkg.Representation.Sparse)
            for a in range(max(rl, rr)):
                c._sparse[((a % rl) * dims[k] + a) * rr + a % rr] = \
                    float(rng.normal())
            comps.append(c)
        x = pkg.TTTensor._make(comps)
        before = x.to_tensor().to_ndarray()
        sparse_in = [c.is_sparse() for c in x.components]
        x.move_core(2)
        mid = [c.is_sparse() for c in x.components]
        after = x.to_tensor().to_ndarray()
        x.move_core(0)
        x.require_correct_format()
        return (before, after, x.to_tensor().to_ndarray(), sparse_in,
                mid + [c.is_sparse() for c in x.components], x.ranks())

    calls = []
    orig = sq_t.sparse_qc
    sq_t.sparse_qc = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        j, t = _both(case)
    finally:
        sq_t.sparse_qc = orig
    assert all(t[3]) and j[3] == t[3]
    assert j[4] == t[4] and any(t[4])
    assert j[5] == t[5]
    for k in (0, 1, 2):
        assert np.abs(j[k] - t[k]).max() <= 1e-12 * np.abs(j[k]).max()
    assert np.abs(t[1] - t[0]).max() <= 1e-12 * np.abs(t[0]).max()
    assert calls
