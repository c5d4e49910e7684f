"""The port's TT classes (xerus_tpu_torch.tt) held against xerus_tpu's on
the CPU.

The cases of tests/test_tt.py run in both packages from the same
``set_seed`` (the random TTs draw from one numpy engine, so both packages
hold the same cores before any factorization).  QR/SVD signs differ
between jnp and torch, so only gauge-free results are compared, in
float64 to 1e-12 of their largest entry: the represented tensor at small
d, norms, ranks, and the canonical flags after each operation (which
must match exactly).  ``round_fast`` is held against JAX's object
``round()`` for every routed method, exact on representable ranks (1e-8
of the norm) and within JAX's quasi-optimality factor for the randomized
methods; gemm_exact also against JAX's own ``round_fast``.  Files cross
between the packages both ways, byte for byte under a frozen clock."""

import time

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt

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
    """The gauge-free state of a TT: represented tensor, ranks, flags."""
    return {f"{name} full": np.asarray(tt.to_tensor().to_ndarray()),
            f"{name} ranks": list(tt.ranks()),
            f"{name} dims": list(tt.dimensions),
            f"{name} flags": (bool(tt.canonicalized), int(tt.corePosition))}


# -- construction


def c_tt_svd_roundtrip(pkg):
    t = pkg.Tensor.random([3, 4, 5, 2])
    tt = pkg.TTTensor(t)
    tt.require_correct_format()
    return {**_state(tt), "ref": t.to_ndarray()}


def c_tt_svd_max_rank(pkg):
    t = pkg.Tensor.random([4, 4, 4, 4])
    tt = pkg.TTTensor(t, eps=0.0, max_ranks=[2, 2, 2])
    return _state(tt)


def c_tt_svd_eps(pkg):
    a = pkg.TTTensor.random([3] * 5, 2)
    t = pkg.Tensor(a)
    tt = pkg.TTTensor(t, eps=1e-12)
    return {**_state(tt), "ref": t.to_ndarray()}


def c_tto_svd_roundtrip(pkg):
    t = pkg.Tensor.random([2, 3, 2, 2, 3, 2])
    tto = pkg.TTOperator(t)
    tto.require_correct_format()
    return {**_state(tto), "ref": t.to_ndarray()}


def c_random_ranks(pkg):
    tt = pkg.TTTensor.random([4, 4, 4, 4, 4], 3)
    tt.require_correct_format()
    clamp = pkg.TTTensor.random([2, 2, 2], 10)
    op = pkg.TTOperator.random([2, 3, 2, 3], [2])
    return {**_state(tt), **_state(clamp, "clamp"), **_state(op, "op"),
            "norm": tt.frob_norm()}


def c_random_prescribed_spectrum(pkg):
    decay = lambda r: [2.0 ** (-i) for i in range(r)]
    tt = pkg.TTTensor.random([4] * 4, 3, singular_values=decay)
    tt.require_correct_format()
    tt.move_core(2)
    merged = pkg.contract(tt.components[2], tt.components[3], 1)
    _U, S, _Vt = pkg.calculate_svd(merged, 2, 0, 0.0)
    # the represented tensor depends on the singular vectors of each
    # bond's vanishing directions, which the prescription scales up
    return {"ranks": tt.ranks(), "flags": (tt.canonicalized, tt.corePosition),
            "s": np.diag(S.to_ndarray())}


def c_ones_kronecker_dirac_identity(pkg):
    out = {}
    for name, tt in (("ones", pkg.TTTensor.ones([2] * 6)),
                     ("kron", pkg.TTTensor.kronecker([3] * 4)),
                     ("dirac", pkg.TTTensor.dirac([3] * 4, [1, 2, 0, 1])),
                     ("identity", pkg.TTOperator.identity([3, 2, 3, 2])),
                     ("op ones", pkg.TTOperator.ones([2] * 8))):
        tt.require_correct_format()
        out.update(_state(tt, name))
        out[name + " norm"] = tt.frob_norm()
        out[name + " sparse"] = [c.is_sparse() for c in tt.components]
    return out


def c_from_dense_unfolding(pkg):
    rng = np.random.default_rng(5)
    out = {}
    for k, dims in enumerate(([2] * 8, [3, 4, 5, 2], [4, 3])):
        tt = pkg.TTTensor.from_dense_unfolding(rng.normal(size=dims))
        tt.require_correct_format()
        out.update(_state(tt, f"unfold {k}"))
    arr = rng.normal(size=[4] * 5)
    b = pkg.TTTensor.from_dense_unfolding(arr)
    b.round(6)
    out.update(_state(b, "rounded"))
    return out


def c_entry_access_and_cast(pkg):
    t = pkg.Tensor.random([3, 4, 5])
    tt = pkg.TTTensor(t)
    A = pkg.TTOperator.random([2, 3, 2, 3], 2)
    return {"entry": tt[[1, 2, 3]], "entry0": tt[0], "op entry": A[[1, 2, 0, 1]],
            "cast": pkg.Tensor(tt).to_ndarray(),
            "op cast": pkg.Tensor(A).to_ndarray()}


def c_degree_zero_and_one(pkg):
    t = pkg.Tensor([], pkg.Representation.Dense)
    t._dense = np.array(3.5)
    tt = pkg.TTTensor(t)
    one = pkg.TTTensor.from_tensor(pkg.Tensor.random([5]))
    for m in ("randomized", "svd", "gram", "subspace", "gemm_exact"):
        c = one.copy()
        c.round_fast(4, method=m)
    c.round_fast([], eps=1e-8)
    c.round(1)
    return {"degree": tt.degree(), "value": float(tt.to_tensor()[0]),
            **_state(c, "d1")}


# -- canonicalization


def c_move_core(pkg):
    tt = pkg.TTTensor.random([3, 4, 3, 4], [2, 3, 2])
    out = {}
    for pos in [2, 0, 3, 1]:
        tt.move_core(pos)
        tt.require_correct_format()
        out.update(_state(tt, f"core {pos}"))
    tt.canonicalized = False
    out["uncanon norm"] = tt.frob_norm()
    tt.canonicalize_right()
    out.update(_state(tt, "right"))
    return out


def c_move_core_rank_excess(pkg):
    a = pkg.TTTensor.random([2] * 4, 3)
    b = pkg.TTTensor.random([2] * 4, 3)
    out = {}
    for pos in range(4):
        s = a + b
        s.canonicalized = False
        s.move_core(pos)
        s.require_correct_format()
        out.update(_state(s, f"pos {pos}"))
        out[f"exceeds {pos}"] = s.exceeds_maximal_ranks()
    return out


def c_move_core_sparse(pkg):
    """Sparse components (kronecker) through a QC sweep: the port splits a
    dense copy (its sparse QR route is ROADMAP item 8)."""
    kron = pkg.TTTensor.kronecker([3] * 4)
    kron.move_core(3)
    kron.require_correct_format()
    return {**_state(kron), "norm": kron.frob_norm()}


# -- arithmetic


def c_add_sub_scale(pkg):
    a = pkg.TTTensor.random([3, 4, 3], [2, 2])
    b = pkg.TTTensor.random([3, 4, 3], [3, 2])
    c = a + b
    c.require_correct_format()
    d = 2.0 * a - b / 2.0
    e = -a
    e *= 3.0
    f = a.copy()
    f /= 4.0
    g = a.copy()
    g -= b
    return {**_state(c, "sum"), **_state(d, "combo"), **_state(e, "neg"),
            **_state(f, "div"), **_state(g, "isub")}


def c_sparse_sum(pkg):
    ident = pkg.TTOperator.identity([2, 3, 2, 3])
    s = ident + ident
    return {**_state(s), "sparse": [c.is_sparse() for c in s.components]}


def c_zero_sums(pkg):
    A = pkg.Tensor([4, 4, 4])
    B = pkg.Tensor.random([4, 4, 4])
    ttA, ttB = pkg.TTTensor(A), pkg.TTTensor(B)
    X, Y = pkg.Tensor([10]), pkg.Tensor.random([10])
    z = pkg.TTTensor(X) + pkg.TTTensor(Y)
    return {**_state(ttA + ttB, "A+B"), **_state(ttA - ttB, "A-B"),
            **_state(z, "d1")}


def c_frob_norm(pkg):
    tt = pkg.TTTensor.random([3, 4, 5], [2, 3])
    n1 = tt.frob_norm()
    tt.canonicalized = False
    return {"canon": n1, "uncanon": tt.frob_norm(),
            "dense": float(np.linalg.norm(tt.to_tensor().to_ndarray()))}


def c_entrywise_product(pkg):
    a = pkg.TTTensor.random([3, 4, 3], 2)
    b = pkg.TTTensor.random([3, 4, 3], 2)
    c = pkg.entrywise_product(a, b)
    c.require_correct_format()
    A = pkg.TTOperator.random([2, 3, 2, 3], 2)
    ident = pkg.TTOperator.identity([2, 3, 2, 3])
    t1, t2 = pkg.Tensor.random([3, 3]), pkg.Tensor.random([3, 3])
    return {**_state(c), **_state(pkg.entrywise_product(A, A), "op"),
            **_state(pkg.entrywise_product(ident, ident), "sparse"),
            "method": a.entrywise_product(b).to_tensor().to_ndarray(),
            "tensor": pkg.entrywise_product(t1, t2).to_ndarray()}


def c_dyadic_product(pkg):
    a = pkg.TTTensor.random([3, 4], 2)
    b = pkg.TTTensor.random([5, 2], 2)
    c = pkg.dyadic_product(a, b)
    c.require_correct_format()
    lst = pkg.dyadic_product([a, pkg.TTTensor.random([4], 1), b])
    M1 = pkg.TTOperator.random([10, 10], [])
    Op = pkg.dyadic_product([M1, pkg.TTOperator.identity([4, 4])])
    out = {**_state(c), **_state(lst, "list"), **_state(Op, "op")}
    dimsA, dimsB = [], []
    for d in range(4):
        A, B = pkg.Tensor.random(dimsA), pkg.Tensor.random(dimsB)
        ttC = pkg.dyadic_product(pkg.TTTensor(A), pkg.TTTensor(B))
        out[f"deg {d}"] = np.asarray(ttC.to_tensor().to_ndarray())
        dimsA.append(d + 2)
        dimsB.append(3 - d + 1)
    return out


def c_apply_operator(pkg):
    A = pkg.TTOperator.random([3, 4, 3, 4], 2)
    x = pkg.TTTensor.random([3, 4], 2)
    B = pkg.TTOperator.random([3, 4, 3, 4], 2)
    return {**_state(pkg.apply_operator(A, x)),
            **_state(pkg.apply_operator(A, x, True), "transposed"),
            **_state(pkg.apply_operator(A, B), "op op")}


def c_inner(pkg):
    a = pkg.TTTensor.random([3, 4, 3], 2)
    b = pkg.TTTensor.random([3, 4, 3], 3)
    A = pkg.TTOperator.random([2, 3, 2, 3], 2)
    mod = pkg.tt
    return {"inner": mod.inner(a, b), "op inner": mod.inner(A, A)}


def c_transpose_and_symmetry(pkg):
    A = pkg.TTOperator.random([3, 4, 3, 4], 2)
    At = A.transposed()
    A.transpose()
    A.require_correct_format()
    S = pkg.TTOperator.identity([2, 2, 2, 2])
    return {**_state(At, "functional"), **_state(A, "in place"),
            "sym": S.is_symmetric(), "nonsym": At.is_symmetric()}


def c_fix_and_resize_mode(pkg):
    tt = pkg.TTTensor.random([3, 4, 5], 2)
    cp = tt.copy()
    cp.fix_mode(1, 2)
    last = tt.copy()
    last.fix_mode(2, 4)
    one = pkg.TTTensor.random([5], [])
    one.fix_mode(0, 3)
    big = tt.copy()
    big.resize_mode(1, 6)
    small = tt.copy()
    small.resize_mode(2, 3)
    left, right = tt.chop(1)
    return {**_state(cp, "fix"), **_state(last, "fix last"),
            "scalar": float(one.to_tensor()[0]), **_state(big, "grow"),
            **_state(small, "cut"),
            "chop": ([c.dimensions for c in left],
                     [c.dimensions for c in right])}


def c_degrees_of_freedom(pkg):
    tt = pkg.TTTensor.random([4, 4, 4], 2)
    A = pkg.TTOperator.random([2, 2, 2, 2], 3)
    return {"tt": tt.degrees_of_freedom(), "op": A.degrees_of_freedom()}


def c_stack(pkg):
    from importlib import import_module
    TTStack = import_module(pkg.__name__ + ".tt.stack").TTStack
    A = pkg.TTOperator.random([3, 3, 3, 3], 2)
    B = pkg.TTOperator.random([3, 3, 3, 3], 2)
    x = pkg.TTTensor.random([3, 3], 2)
    stack = TTStack(x)
    stack.apply(A).apply(B, True)
    return {**_state(stack.contract()), "bound": stack.ranks_upper_bound(),
            **_state(stack.to_tttensor(), "again")}


def c_copy_as_network(pkg):
    tt = pkg.TTTensor.random([3] * 4, 2)
    net = pkg.TensorNetwork(tt)
    op = pkg.TTOperator.random([3, 4, 3, 4], 2).copy_as_network()
    return {"net": net.to_tensor().to_ndarray(),
            "nodes": len(net.nodes), "op": op.to_tensor().to_ndarray(),
            "op dims": op.dimensions}


# -- rounding


def c_round_exact_rank(pkg):
    a = pkg.TTTensor.random([4, 4, 4, 4], 2)
    b = pkg.TTTensor.random([4, 4, 4, 4], 2)
    c = a + b
    c.round(4)
    d = a + a
    d.round(eps=1e-12)
    d.require_correct_format()
    return {**_state(c, "sum"), **_state(d, "double")}


def c_round_max_rank(pkg):
    tt = pkg.TTTensor.random([5, 5, 5, 5], 4)
    tt.move_core(2)
    tt.round(2)
    tt.require_correct_format()
    vec = pkg.TTTensor.random([2] * 6, 6)
    vec.round([2, 3, 4, 3, 2])
    a = pkg.TTTensor.random([2] * 6, 2)
    a /= a.frob_norm()
    c = a + 1e-9 * pkg.TTTensor.random([2] * 6, 2)
    c.round(4, eps=1e-6)
    return {**_state(tt, "int"), **_state(vec, "vector"),
            **_state(c, "int eps")}


def c_soft_threshold(pkg):
    tt = pkg.TTTensor.random([4, 4, 4], 3)
    big = tt.copy()
    big.soft_threshold(1e6)
    mild = tt.copy()
    mild.soft_threshold([0.1 * tt.frob_norm(), 0.05 * tt.frob_norm()])
    return {**_state(big, "big"), **_state(mild, "mild")}


CASES = [c_tt_svd_roundtrip, c_tt_svd_max_rank, c_tt_svd_eps,
         c_tto_svd_roundtrip, c_random_ranks, c_random_prescribed_spectrum,
         c_ones_kronecker_dirac_identity, c_from_dense_unfolding,
         c_entry_access_and_cast, c_degree_zero_and_one, c_move_core,
         c_move_core_rank_excess, c_move_core_sparse, c_add_sub_scale,
         c_sparse_sum, c_zero_sums, c_frob_norm, c_entrywise_product,
         c_dyadic_product, c_apply_operator, c_inner,
         c_transpose_and_symmetry, c_fix_and_resize_mode,
         c_degrees_of_freedom, c_stack, c_copy_as_network,
         c_round_exact_rank, c_round_max_rank, c_soft_threshold]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[2:])
def test_tt_matches_jax(case):
    ref, got = _both(case)
    _same(ref, got)


def test_tt_results_are_right():
    """A few of the cases against numpy, beside the JAX package."""
    xt.set_seed(SEED)
    r = c_tt_svd_roundtrip(xt)
    np.testing.assert_allclose(r["tt full"], r["ref"], atol=1e-12)
    r = c_apply_operator(xt)
    assert r["tt ranks"] == [4]
    r = c_ones_kronecker_dirac_identity(xt)
    np.testing.assert_allclose(r["ones full"], np.ones([2] * 6), rtol=0,
                               atol=1e-15)
    assert abs(r["ones norm"] - 8.0) < 1e-12
    np.testing.assert_allclose(r["identity full"].reshape(6, 6), np.eye(6),
                               atol=1e-15)


# -- round_fast


def _quasi(pkg, method, factor):
    b = pkg.TTTensor.random([2] * 8, 8)
    orig = b.to_tensor().to_ndarray()
    exact = b.copy()
    exact.round(4)
    e_ref = np.linalg.norm(exact.to_tensor().to_ndarray() - orig)
    t = b.copy()
    t.round_fast(4, method=method)
    t.require_correct_format()
    e = np.linalg.norm(t.to_tensor().to_ndarray() - orig)
    assert e < factor * e_ref + 1e-12, (method, e, e_ref)
    return t


ROUTED = ["randomized", "randomized_unrolled", "svd", "gram", "subspace",
          "gemm_exact"]


@pytest.mark.parametrize("method", ROUTED)
def test_round_fast_matches_jax_round(method):
    """Every routed method on representable ranks reproduces the tensor
    (1e-8 of its norm) and re-canonicalizes to core 0, as JAX's object
    round() leaves it; deterministic methods at rank 4 of a rank-8 TT
    give JAX's round(4) tensor; the randomized ones stay within JAX's
    quasi-optimality factor of 6 of the exact rounding's error, the
    GEMM-only subspace truncation within its factor of 2."""
    xe.set_seed(SEED)
    ja = xe.TTTensor.random([2] * 8, 3)
    want = ja.to_tensor().to_ndarray()
    xt.set_seed(SEED)
    a = xt.TTTensor.random([2] * 8, 3)
    t = a.copy()
    t.round_fast(6, method=method)
    t.require_correct_format()
    assert t.canonicalized and t.corePosition == 0
    assert t.ranks() == ja.ranks()
    np.testing.assert_allclose(t.to_tensor().to_ndarray(), want, rtol=0,
                               atol=1e-8 * np.linalg.norm(want))
    xe.set_seed(SEED + 1)
    jb = xe.TTTensor.random([2] * 8, 8)
    jb.round(4)
    xt.set_seed(SEED + 1)
    if method.startswith("randomized") or method == "subspace":
        _quasi(xt, method, 2 if method == "subspace" else 6)
    else:
        b = xt.TTTensor.random([2] * 8, 8)
        b.round_fast(4, method=method)
        assert b.ranks() == jb.ranks()
        ref = jb.to_tensor().to_ndarray()
        np.testing.assert_allclose(b.to_tensor().to_ndarray(), ref, rtol=0,
                                   atol=1e-8 * np.linalg.norm(ref))


@pytest.mark.parametrize("method", ["svd", "gram", "randomized"])
def test_round_fast_rank_vector_matches_jax_round(method):
    ranks = [2, 3, 5, 6, 5, 3, 2]
    xe.set_seed(SEED)
    ja = xe.TTTensor.random([2] * 8, 12)
    orig = ja.to_tensor().to_ndarray()
    ja.round(list(ranks))
    want = ja.to_tensor().to_ndarray()
    xt.set_seed(SEED)
    t = xt.TTTensor.random([2] * 8, 12)
    t.round_fast(list(ranks), method=method)
    t.require_correct_format()
    assert t.ranks() == ranks and t.canonicalized and t.corePosition == 0
    got = t.to_tensor().to_ndarray()
    if method == "randomized":
        e_ref = np.linalg.norm(want - orig)
        assert np.linalg.norm(got - orig) < 6 * e_ref + 1e-12
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.linalg.norm(want))


def _eps_pair(pkg):
    a = pkg.TTTensor.random([3] * 6, 2)
    a /= a.frob_norm()
    b = pkg.TTTensor.random([3] * 6, 2)
    b /= b.frob_norm()
    return a, a + 1e-8 * b


@pytest.mark.parametrize("method,rank", [
    ("randomized", 4), ("randomized_unrolled", 4), ("svd", 4),
    ("gemm_exact", 4), ("subspace", 4), ("svd", [4] * 5), ("streaming", 4),
    ("cholqr", 4), ("gram_parallel", 4), ("subspace_parallel", 4),
    ("streaming", [4] * 5)])
def test_round_fast_eps(method, rank):
    """eps drops the 1e-8 directions: rank 2 and JAX's a, as in
    tests/test_tt.py."""
    xe.set_seed(SEED)
    ja, _ = _eps_pair(xe)
    xt.set_seed(SEED)
    _a, c = _eps_pair(xt)
    c.round_fast(rank, method=method, eps=1e-6)
    c.require_correct_format()
    assert max(c.ranks()) == 2
    np.testing.assert_allclose(c.to_tensor().to_ndarray(),
                               ja.to_tensor().to_ndarray(), rtol=0, atol=1e-6)


def test_round_fast_operator():
    xe.set_seed(SEED)
    orig = xe.TTOperator.random([2] * 8, 3).to_tensor().to_ndarray()
    xt.set_seed(SEED)
    B = xt.TTOperator.random([2] * 8, 3)
    B.round_fast(6, method="svd")
    B.require_correct_format()
    np.testing.assert_allclose(B.to_tensor().to_ndarray(), orig, rtol=0,
                               atol=1e-8 * np.linalg.norm(orig))


def test_round_fast_gemm_exact_matches_jax_round_fast():
    """One comparison with JAX's own round_fast('gemm_exact') at d=6:
    the certified truncation of a rank-8 TT to rank 3."""
    def case(pkg):
        a = pkg.TTTensor.random([2] * 6, 8)
        a.round_fast(3, method="gemm_exact")
        return {**_state(a), "norm": a.frob_norm()}
    ref, got = _both(case)
    _same(ref, got, rtol=1e-8)


@pytest.mark.parametrize("method", ["streaming", "cholqr", "gram_parallel",
                                    "subspace_parallel"])
def test_round_fast_unported_methods_raise(method):
    """The four methods that raised before they were ported (the name is
    kept) now run as JAX's round_fast does: on representable ranks the
    tensor at 1e-8 of its norm, JAX's ranks, re-canonicalized to core 0;
    at rank 4
    of a rank-8 TT the deterministic ones give JAX's round_fast tensor
    (1e-8), streaming (its sketches drawn by each package's own
    generator) stays within test_tt.py's factor 15 of the exact
    rounding's error, the parallel methods within its factor 2."""
    xe.set_seed(SEED)
    ja = xe.TTTensor.random([2] * 8, 3)
    want = ja.to_tensor().to_ndarray()
    ja.round_fast(6, method=method)
    xt.set_seed(SEED)
    t = xt.TTTensor.random([2] * 8, 3)
    t.round_fast(6, method=method)
    t.require_correct_format()
    assert t.canonicalized and t.corePosition == 0
    # streaming keeps every interior bond at the target before the
    # re-canonicalization: [2, 3, 6, 6, 6, 4, 2] in both packages
    assert t.ranks() == ja.ranks()
    np.testing.assert_allclose(t.to_tensor().to_ndarray(), want, rtol=0,
                               atol=1e-8 * np.linalg.norm(want))
    xt.set_seed(SEED + 1)
    b = _quasi(xt, method, 15 if method == "streaming" else 2)
    if method != "streaming":
        xe.set_seed(SEED + 1)
        jb = xe.TTTensor.random([2] * 8, 8)
        jb.round_fast(4, method=method)
        ref = jb.to_tensor().to_ndarray()
        assert b.ranks() == jb.ranks()
        np.testing.assert_allclose(b.to_tensor().to_ndarray(), ref, rtol=0,
                                   atol=1e-8 * np.linalg.norm(ref))


def test_round_fast_speed_presets_and_bad_input_raise():
    xt.set_seed(SEED)
    a = xt.TTTensor.random([2] * 6, 3)
    b = a.copy()
    b.round_fast(3, speed="bf16_frontier")     # the preset runs (item 2b)
    assert b.ranks() == a.ranks()
    with pytest.raises(ValueError, match="speed must be"):
        a.round_fast(2, speed="fp8_maximum")
    with pytest.raises(ValueError, match="randomized-kernel preset"):
        a.round_fast(2, method="svd", speed="bf16_frontier")
    with pytest.raises(ValueError, match="uniform int max_rank"):
        a.round_fast([2] * 5, speed="bf16_frontier")
    with pytest.raises(ValueError, match="unknown round_fast method"):
        a.round_fast(2, method="nonsense")
    with pytest.raises(ValueError):
        a.round_fast([2, 2], method="svd")
    with pytest.raises(ValueError):
        a.round_fast(0, method="svd")


# -- files


def _frozen_write(monkeypatch, pkg, obj, path, fmt):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    pkg.save_to_file(obj, str(path), getattr(pkg.FileFormat, fmt))
    monkeypatch.undo()


def _objects(pkg, kind):
    pkg.set_seed(SEED)
    if kind == "tensor":
        return pkg.TTTensor.random([3, 4, 3], 2)
    return pkg.TTOperator.random([2, 3, 2, 3], 2)


@pytest.mark.parametrize("fmt", ["BINARY", "TSV"])
@pytest.mark.parametrize("kind", ["tensor", "operator"])
def test_tt_files_cross_between_the_packages(tmp_path, monkeypatch, kind,
                                             fmt):
    """Written by either package, the same bytes; loaded by the other, the
    same components, flags and type.  The random TTs are canonicalized by
    each package's own QR, so each file is compared with its own
    writer's object."""
    paths = {}
    for pkg in (xe, xt):
        paths[pkg] = tmp_path / f"{pkg.__name__}.xtpu"
        _frozen_write(monkeypatch, pkg, _objects(pkg, kind), paths[pkg], fmt)
    for writer, reader in ((xe, xt), (xt, xe)):
        back = reader.load_from_file(str(paths[writer]))
        orig = _objects(writer, kind)
        assert type(back).__name__ == type(orig).__name__
        assert (back.canonicalized, back.corePosition) == \
            (orig.canonicalized, orig.corePosition)
        for c, o in zip(back.components, orig.components):
            assert np.array_equal(c.to_ndarray(), o.to_ndarray())
        # the port rewrites the JAX package's file byte for byte
        if reader is xt:
            again = tmp_path / "again.xtpu"
            _frozen_write(monkeypatch, xt, back, again, fmt)
            assert again.read_bytes() == paths[xe].read_bytes()


def test_tt_save_load_round_trip(tmp_path):
    xt.set_seed(SEED)
    tt = xt.TTTensor.random([3, 4, 3], 2)
    p = str(tmp_path / "tt.xtpu")
    xt.save_to_file(tt, p)
    back = xt.load_from_file(p)
    assert isinstance(back, xt.TTTensor)
    back.require_correct_format()
    for c, o in zip(back.components, tt.components):
        assert np.array_equal(c.to_ndarray(), o.to_ndarray())


# -- conversions and the device


def test_tt_from_numpy_carries_state():
    xe.set_seed(SEED)
    ja = xe.TTTensor.random([3, 4, 3], 2)
    ja.move_core(1)
    cores = [c.to_ndarray() for c in ja.components]
    t = xt.convert.tt_from_numpy(cores, canonicalized=ja.canonicalized,
                                 core_position=ja.corePosition)
    t.require_correct_format()
    assert (t.canonicalized, t.corePosition) == (True, 1)
    np.testing.assert_allclose(t.to_tensor().to_ndarray(),
                               ja.to_tensor().to_ndarray(), rtol=0,
                               atol=1e-15)
    cores[0][0, 0, 0] += 1.0          # the port holds copies
    assert t.components[0][[0, 0, 0]] != cores[0][0, 0, 0]
    A = xe.TTOperator.random([2, 3, 2, 3], 2)
    op = xt.convert.tt_from_numpy([c.to_ndarray() for c in A.components],
                                  operator=True)
    assert isinstance(op, xt.TTOperator) and not op.canonicalized
    np.testing.assert_allclose(op.to_tensor().to_ndarray(),
                               A.to_tensor().to_ndarray(), rtol=0,
                               atol=1e-15)


def test_tt_operations_raise_without_a_card(monkeypatch):
    """Outside host() every TT computation runs on the card; without one it
    raises and nothing carries on on the CPU."""
    import torch
    xt.set_seed(SEED)
    a = xt.TTTensor.random([2] * 4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(xt.config, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a.frob_norm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xt.TTTensor.random([2] * 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a.copy().round_fast(1, method="gemm_exact")
