"""The port's indexed-expression frontend (xerus_tpu_torch.indexing) held
against xerus_tpu's on the CPU.

The cases of tests/test_indexed_expressions.py, test_indices_misc.py and
the index-level guards of test_failguards.py run in both packages from the
same ``set_seed``: results agree to 1e-12 of their largest entry in
float64, raised error types exactly.  The README's quick-start block is the
slice as a whole.  Also here: the contraction planner (numpy's greedy
einsum path, cached per structure and shapes) against the left-to-right
order and numpy's own greedy path, and the DSL's aliasing
self-assignment."""

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.misc import performance as perf_j
from xerus_tpu_torch.indexing import evaluate as ev
from xerus_tpu_torch.misc import performance as perf_t

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


# -- the cases of tests/test_indexed_expressions.py (the TT-rank and
#    network cases are in tests/test_torch_tt_dsl.py)


def c_basic_contraction(pkg):
    A, B = pkg.Tensor.random([3, 4, 5]), pkg.Tensor.random([4, 6, 5])
    i, j, k, l = pkg.indices(4)
    C = pkg.Tensor()
    C(i, j) << A(i, k, l) * B(k, j, l)
    return {"C": C.to_ndarray(), "ref": np.einsum(
        'ikl,kjl->ij', A.to_ndarray(), B.to_ndarray())}


def c_matrix_chain(pkg):
    A, B, C = (pkg.Tensor.random(s) for s in ([3, 4], [4, 5], [5, 6]))
    i, j, k, l = pkg.indices(4)
    D = pkg.Tensor()
    D(i, l) << A(i, j) * B(j, k) * C(k, l)
    return {"D": D.to_ndarray(),
            "ref": A.to_ndarray() @ B.to_ndarray() @ C.to_ndarray()}


def c_outer_product(pkg):
    a, b = pkg.Tensor.random([3]), pkg.Tensor.random([4])
    i, j = pkg.indices(2)
    C = pkg.Tensor()
    C(i, j) << a(i) * b(j)
    return {"C": C.to_ndarray(),
            "ref": np.outer(a.to_ndarray(), b.to_ndarray())}


def c_full_contraction_scalar(pkg):
    A = pkg.Tensor.random([3, 4])
    i, j = pkg.indices(2)
    return {"float": float(A(i, j) * A(i, j)),
            "value": (A(i, j) * A(i, j)).value,
            "ref": float((A.to_ndarray() ** 2).sum())}


def c_trace_expression(pkg):
    A = pkg.Tensor.random([5, 5])
    i = pkg.Index()
    return {"tr": float(A(i, i)), "ref": float(np.trace(A.to_ndarray()))}


def c_partial_trace(pkg):
    A = pkg.Tensor.random([3, 4, 3])
    i, j = pkg.indices(2)
    out = pkg.Tensor()
    out(j) << A(i, j, i)
    return {"out": out.to_ndarray(),
            "ref": np.einsum('iji->j', A.to_ndarray())}


def c_fixed_indices(pkg):
    A = pkg.Tensor.random([3, 4])
    i = pkg.Index()
    row, col = pkg.Tensor(), pkg.Tensor()
    row(i) << A(1, i)
    col(i) << A(i, 2)
    return {"row": row.to_ndarray(), "col": col.to_ndarray(),
            "A": A.to_ndarray()}


def c_spans_pow_and(pkg):
    A, B = pkg.Tensor.random([2, 3, 4]), pkg.Tensor.random([2, 3, 4])
    i, j = pkg.indices(2)
    out = pkg.Tensor()
    out(i ^ 3) << A(i ^ 3) + B(i ^ 3)
    return {"sum": out.to_ndarray(), "dot": float(A(i & 0) * B(i & 0))}


def c_span_fraction(pkg):
    A, C = pkg.Tensor.random([3, 4, 3, 4]), pkg.Tensor.random([3, 4])
    i, j = pkg.indices(2)
    out = pkg.Tensor()
    out(i & 0) << A(i / 2, j / 2) * C(j & 0)
    return {"out": out.to_ndarray(), "ref": np.einsum(
        'abcd,cd->ab', A.to_ndarray(), C.to_ndarray())}


def c_sum_with_permutation(pkg):
    A = pkg.Tensor.random([3, 3])
    i, j = pkg.indices(2)
    sym = pkg.Tensor()
    sym(i, j) << A(i, j) + A(j, i)
    return {"sym": sym.to_ndarray()}


def c_scalar_scaling_in_expression(pkg):
    A = pkg.Tensor.random([4])
    i = pkg.Index()
    out = pkg.Tensor()
    out(i) << 3.0 * A(i) / 2.0
    return {"out": out.to_ndarray(), "neg": (-A(i))._to_tensor().to_ndarray()}


def c_assignment_reorders(pkg):
    A = pkg.Tensor.random([3, 4, 5])
    i, j, k = pkg.indices(3)
    B = pkg.Tensor()
    B(k, i, j) << A(i, j, k)
    return {"dims": B.dimensions, "B": B.to_ndarray()}


def c_aliasing_self_assignment(pkg):
    A = pkg.Tensor.random([4, 4])
    arr = A.to_ndarray()
    i, j, k = pkg.indices(3)
    A(i, j) << A(i, k) * A(k, j)
    return {"A": A.to_ndarray(), "ref": arr @ arr}


def c_solve_via_division(pkg):
    A, b = pkg.Tensor.random([5, 5]), pkg.Tensor.random([5])
    i, j = pkg.indices(2)
    x = pkg.Tensor()
    x(i) << b(j) / A(j, i)
    assert np.allclose(A.to_ndarray() @ x.to_ndarray(), b.to_ndarray(),
                       atol=1e-9)
    return {"x": x.to_ndarray()}


def c_solve_multimode(pkg):
    A, b = pkg.Tensor.random([3, 4, 3, 4]), pkg.Tensor.random([3, 4])
    i, j = pkg.indices(2)
    x = pkg.Tensor()
    x(i ^ 2) << b(j ^ 2) / A(j ^ 2, i ^ 2)
    return {"x": x.to_ndarray(), "ref": np.linalg.solve(
        A.to_ndarray().reshape(12, 12), b.to_ndarray().reshape(12)
    ).reshape(3, 4)}


def c_frob_norm_of_expression(pkg):
    A, B = pkg.Tensor.random([3, 4]), pkg.Tensor.random([3, 4])
    i, j = pkg.indices(2)
    return {"n": (A(i, j) - B(i, j)).frob_norm(),
            "ref": float(np.linalg.norm(A.to_ndarray() - B.to_ndarray()))}


def c_sum_inside_product_materializes(pkg):
    A, B, C = (pkg.Tensor.random(s) for s in ([3, 4], [3, 4], [4, 5]))
    i, j, k = pkg.indices(3)
    out = pkg.Tensor()
    out(i, k) << (A(i, j) + B(i, j)) * C(j, k)
    return {"out": out.to_ndarray()}


def c_solve_inside_product_materializes(pkg):
    M, b, w = (pkg.Tensor.random(s) for s in ([4, 4], [4], [4]))
    i, j = pkg.indices(2)
    out = pkg.Tensor()
    out() << (b(j) / M(j, i)) * w(i)
    return {"out": float(out[0])}


def c_matmul_tensor_contraction(pkg):
    """The DSL half of the matrix-multiplication-tensor stress test: a
    sparse order-6 T contracted with A and B reproduces A @ B (the TT
    ranks of T: tests/test_torch_tt_dsl.py)."""
    out = {}
    for n in (2, 3):
        T = pkg.Tensor([n] * 6, pkg.Representation.Sparse)
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    T[[i, j, j, k, i, k]] = 1.0
        A, B = pkg.Tensor.random([n, n]), pkg.Tensor.random([n, n])
        i1, i2, i3, i4, i5, i6 = pkg.indices(6)
        C1, C2 = pkg.Tensor(), pkg.Tensor()
        C1(i1, i3) << A(i1, i2) * B(i2, i3)
        C2(i5, i6) << T(i1, i2, i3, i4, i5, i6) * A(i1, i2) * B(i3, i4)
        assert np.allclose(C1.to_ndarray(), C2.to_ndarray(), atol=1e-12)
        out[f"C{n}"] = C2.to_ndarray()
    return out


def c_sparse_fast_paths(pkg):
    """Permutations and pairwise products with sparse operands keep the
    representation (the reference's dense/sparse dispatch)."""
    S = pkg.Tensor.random([6, 5], n=7)
    S2 = pkg.Tensor.random([5, 4], n=6)
    D = pkg.Tensor.random([5, 3])
    i, j, k = pkg.indices(3)
    P, Q, R = pkg.Tensor(), pkg.Tensor(), pkg.Tensor()
    P(j, i) << S(i, j)
    Q(i, k) << S(i, j) * S2(j, k)
    R(k, i) << 2.0 * S(i, j) * D(j, k)
    return {"reps": [t.representation.name for t in (P, Q, R)],
            "P": P.to_ndarray(), "Q": Q.to_ndarray(), "R": R.to_ndarray()}


def c_svd_soft_threshold(pkg):
    A = pkg.Tensor.random([6, 5])
    i, j, r1, r2 = pkg.indices(4)
    U, S, Vt = pkg.Tensor(), pkg.Tensor(), pkg.Tensor()
    s0 = np.linalg.svd(A.to_ndarray(), compute_uv=False)
    (U(i, r1), S(r1, r2), Vt(r2, j)) << pkg.SVD(A(i, j),
                                               soft_threshold=s0[2] * 1.01)
    rec = pkg.Tensor()
    rec(i, j) << U(i, r1) * S(r1, r2) * Vt(r2, j)
    return {"s": np.diag(S.to_ndarray()), "rec": rec.to_ndarray()}


# -- test_indices_misc.py: index semantics


def c_index_equality_and_fixed(pkg):
    i = pkg.Index()
    f1, f2 = (pkg.indexing.index.as_index(3) for _ in range(2))
    half = i.__div__(2)
    return {"eq": i == (i ^ 2), "fixed_eq": f1 == f2,
            "half": [half.fractional_span, half.span],
            "spans": [(i ^ 2).actual_span(5), (i & 2).actual_span(5),
                      (i / 5).actual_span(5)]}


def c_div_by_scalar_binding_name(pkg):
    A = pkg.Tensor.random([3, 3])
    out = pkg.Tensor()
    j, k = pkg.indices(2)
    out(j, k) << A(j, k).__div__(2.0)
    return {"out": out.to_ndarray(), "ref": A.to_ndarray() / 2.0}


CASES = {name[2:]: fn for name, fn in dict(globals()).items()
         if name.startswith("c_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_expression_matches_jax(name):
    ref, got = _both(CASES[name])
    _same(ref, got)
    if "ref" in got:      # the case's own oracle, on the port's result
        first = next(k for k in got if k != "ref")
        np.testing.assert_allclose(got[first], got["ref"], rtol=0,
                                   atol=1e-12 * np.abs(got["ref"]).max())


# -- expressions that must raise, with the error type of the JAX package


def _mismatch(pkg):
    A, B = pkg.Tensor.random([3, 4]), pkg.Tensor.random([5, 4])
    i, j, k = pkg.indices(3)
    pkg.Tensor()(i, j) << A(i, k) * B(k, j)


def _too_many_uses(pkg):
    A, B, C = (pkg.Tensor.random([3, 3]) for _ in range(3))
    i, j = pkg.indices(2)
    pkg.Tensor()(j) << A(i, i) * B(i, j) * C(i, j)


def _span_mismatch(pkg):
    A = pkg.Tensor.random([3, 4, 5])
    i, j = pkg.indices(2)
    pkg.Tensor()(i, j) << A(i, j)


def _invalid(lhs, rhs):
    def case(pkg):
        A = pkg.Tensor.random([10, 10])
        i, j = pkg.indices(2)
        pkg.Tensor()(*lhs(i, j)) << A(*rhs(i, j))
    return case


def _no_implicit_batching(pkg):
    A, b = pkg.Tensor.random([10, 10]), pkg.Tensor.random([10])
    i, j = pkg.indices(2)
    pkg.Tensor()(j) << A(i, j) * b(j)


def _triple(n):
    def case(pkg):
        i1, i2, i3, i4 = pkg.indices(4)
        A = pkg.Tensor.random([3, 3, 3])
        B, C, D, F = (pkg.Tensor.random([3, 3]) for _ in range(4))
        exprs = (lambda: A(i1, i1, i2) * B(i2, i2),
                 lambda: A(i1, i2, i2) * B(i2, i1),
                 lambda: A(i2, i2, i2) * B(i1, i1),
                 lambda: B(i1, i2) * C(i2, i3) * D(i3, i2),
                 lambda: B(i1, i2) * C(i2, i3) * D(i1, i2),
                 lambda: B(i1, i2) * C(i2, i3) * D(i3, i4) * F(i4, i2))
        float(exprs[n]())
    return case


def _float_of_non_scalar(pkg):
    A = pkg.Tensor.random([3, 3])
    i, j = pkg.indices(2)
    float(A(i, j))


# failguards: solve expressions (test_failguards.py:45)
def _solve_guard_b_indices(pkg):
    i, j, k, l = pkg.indices(4)
    pkg.Tensor()() << pkg.Tensor.random([3, 3])(k, l) / \
        pkg.Tensor.random([3, 3])(i, j)


def _solve_guard_lhs(pkg):
    i, j, k = pkg.indices(3)
    pkg.Tensor()(k) << pkg.Tensor.random([3])(i) / \
        pkg.Tensor.random([3, 3])(i, j)


# failguards: factorisation targets (:60) and types (:79)
def _factorisation(targets):
    def case(pkg):
        i, j, r = pkg.indices(3)
        A = pkg.Tensor.random([4, 5])
        Q, R = pkg.Tensor(), pkg.Tensor()
        spec = {"one target": lambda: ((Q(i, r),), pkg.QR),
                "svd two targets": lambda: ((Q(i, r), R(r, j)), pkg.SVD),
                "fixed index": lambda: ((Q(2, r), R(r, j)), pkg.QR),
                "rank span": lambda: ((Q(i, r & 2), R(r & 2, j)), pkg.QR),
                "source span": lambda: ((Q(i & 2, r), R(r, j)), pkg.QR)}
        tgt, f = spec[targets]()
        tgt << f(A(i, j))
    return case


def _factorisation_source(pkg):
    pkg.QR(pkg.Tensor.random([3, 3]))


def _factorisation_targets_type(pkg):
    i, j = pkg.indices(2)
    pkg.QR(pkg.Tensor.random([3, 3])(i, j)).__rlshift__("bad")


# failguards: entrywise compare (:89)
def _entrywise_compare(pkg):
    pkg.approx_entrywise_equal(pkg.Tensor.random([2, 3]),
                               pkg.Tensor.random([3, 2]))


RAISES = {"dimension mismatch": (_mismatch, "dimension mismatch"),
          "too many index uses": (_too_many_uses, None),
          "span mismatch": (_span_mismatch, None),
          "invalid span pow": (_invalid(lambda i, j: (i, j ^ 2),
                                        lambda i, j: (j ^ 2, i)), None),
          "invalid span and": (_invalid(lambda i, j: (i, j),
                                        lambda i, j: (j, i & 0)), None),
          "invalid span fraction one": (_invalid(lambda i, j: (i, j),
                                                 lambda i, j: (j, i / 1)),
                                        None),
          "invalid span fraction nondivisible": (
              _invalid(lambda i, j: (i, j), lambda i, j: (j, i / 3)), None),
          "no implicit batching": (_no_implicit_batching, None),
          **{f"triple index use {n}": (_triple(n), None) for n in range(6)},
          "float of non-scalar": (_float_of_non_scalar, None),
          "solve guard: b's indices": (_solve_guard_b_indices, "solve"),
          "solve guard: lhs index": (_solve_guard_lhs, "solve"),
          "factorisation: one target": (_factorisation("one target"),
                                        "needs two targets"),
          "factorisation: svd targets": (_factorisation("svd two targets"),
                                         r"SVD needs \(U, S, Vt\)"),
          "factorisation: fixed index": (_factorisation("fixed index"),
                                         "fixed indices"),
          "factorisation: rank span": (_factorisation("rank span"), None),
          "factorisation: source span": (_factorisation("source span"),
                                         None),
          "factorisation source type": (_factorisation_source,
                                        "factorisation source"),
          "factorisation targets type": (_factorisation_targets_type,
                                         "targets must be a tuple"),
          "entrywise compare dims": (_entrywise_compare,
                                     "entrywise compare")}


@pytest.mark.parametrize("name", sorted(RAISES))
def test_raises_like_jax(name):
    case, match = RAISES[name]
    raised = []
    for pkg in (xe, xt):
        pkg.set_seed(SEED)
        with pytest.raises(Exception, match=match) as info:
            case(pkg)
        raised.append(info.type)
    assert raised[0] is raised[1]


def test_network_operands_wait_for_their_step():
    """Network and TT operands have landed (ROADMAP items 4d and 4e,
    tests/test_torch_network.py, test_torch_tt_dsl.py); an operand that is
    neither a Tensor nor a network fails as in the JAX package."""
    for pkg in (xe, xt):
        i, j = pkg.indices(2)
        with pytest.raises(AttributeError):
            pkg.Tensor()(i) << pkg.indexing.IndexedTensor(object(), [i])


# -- the slice as a whole: README.md's quick-start block


def c_readme_quick_start(pkg):
    A = pkg.Tensor.random([8, 8])
    b = pkg.Tensor.random([8])
    i, j, r1, r2 = pkg.indices(4)
    U, S, Vt = pkg.Tensor(), pkg.Tensor(), pkg.Tensor()
    (U(i, r1), S(r1, r2), Vt(r2, j)) << pkg.SVD(A(i, j))
    x = pkg.Tensor()
    x(i) << b(j) / A(j, i)
    rec = pkg.Tensor()
    rec(i, j) << U(i, r1) * S(r1, r2) * Vt(r2, j)
    err = (rec(i, j) - A(i, j)).frob_norm() / A.frob_norm()
    assert err < 1e-12
    return {"rec": rec.to_ndarray(), "s": np.diag(S.to_ndarray()),
            "x": x.to_ndarray(), "ranks": [U.dimensions, S.dimensions,
                                           Vt.dimensions]}


def test_readme_quick_start_matches_jax():
    ref, got = _both(c_readme_quick_start)
    _same(ref, got)


# -- the contraction planner


def _chain_labels():
    # E(i,m) << B(i,k,l) * D(k,j,l) * F(j,m) with i,k,l,j,m = 0..4
    return ((0, 1, 2), (1, 3, 2), (3, 4)), (0, 4)


def test_planner_beats_left_to_right_on_a_chain():
    ops, out = _chain_labels()
    shapes = ((64, 8, 8), (8, 64, 8), (64, 4))
    plan = ev.contraction_plan(ops, out, shapes)
    planned = ev.plan_flops(ops, shapes, plan)
    ltr = ev.plan_flops(ops, shapes, ev.left_to_right_plan(3))
    assert ltr == 2 * 64 * 8 * 8 * 64 + 2 * 64 * 64 * 4
    assert planned == 2 * 8 * 64 * 8 * 4 + 2 * 64 * 8 * 8 * 4
    assert planned < ltr
    assert ev.contraction_plan(ops, out, shapes) is plan      # cached


def test_planned_chain_matches_jax():
    def case(pkg):
        B, D, F = (pkg.Tensor.random(s) for s in ([16, 4, 4], [4, 16, 4],
                                                  [16, 3]))
        i, j, k, l, m = pkg.indices(5)
        E = pkg.Tensor()
        E(i, m) << B(i, k, l) * D(k, j, l) * F(j, m)
        return {"E": E.to_ndarray()}
    ref, got = _both(case)
    _same(ref, got)


def _random_product(rng):
    """Canonical labels and shapes of a random product: each label on two
    operands (a contraction), twice on one (a trace) or on one and the
    output; some operands share nothing with the rest."""
    n = int(rng.integers(3, 8))
    ops = [[] for _ in range(n)]
    out = []
    for label in range(int(rng.integers(n, 2 * n))):
        kind = rng.random()
        a, b = (int(v) for v in rng.integers(0, n, size=2))
        if kind < 0.6 and a != b:
            ops[a].append(label)
            ops[b].append(label)
        elif kind < 0.7:
            ops[a] += [label, label]
        else:
            ops[a].append(label)
            out.append(label)
    dims = rng.integers(1, 4, size=max(max(o, default=0) for o in ops) + 1)
    shapes = tuple(tuple(int(dims[l]) for l in o) for o in ops)
    return tuple(map(tuple, ops)), tuple(out), shapes


def _groups(n, steps):
    """The operand groups left after each step of an einsum_path-form
    plan: the chosen operands leave the list, their union joins its end."""
    state = [frozenset([k]) for k in range(n)]
    seen = []
    for step in steps:
        merged = frozenset().union(*(state[i] for i in step))
        state = [g for k, g in enumerate(state) if k not in step] + [merged]
        seen.append(tuple(state))
    return seen


# an outer product of four: numpy leaves it to einsum in one step
_OUTER4 = (((0,), (1,), (2,), (3,)), (0, 1, 2, 3), ((2,), (3,), (4,), (5,)))


@pytest.mark.parametrize("seed", list(range(40)) + ["outer4"])
def test_planner_takes_numpys_greedy_path(seed):
    """contraction_plan takes np.einsum_path's greedy path on products it
    can spell (52 labels or fewer): the same pairs in the same order, and
    a step numpy leaves to einsum whole as pairwise steps over the same
    operands; the plan runs to numpy's einsum."""
    import string
    import torch
    ops, out, shapes = (_OUTER4 if seed == "outer4" else
                        _random_product(np.random.default_rng(seed)))
    subs = ",".join("".join(string.ascii_letters[l] for l in o) for o in ops)
    subs += "->" + "".join(string.ascii_letters[l] for l in out)
    views = [np.broadcast_to(np.zeros(()), s) for s in shapes]
    path = np.einsum_path(subs, *views, optimize="greedy")[0][1:]
    plan = ev.contraction_plan(ops, out, shapes)
    assert all(len(step) <= 2 for step in plan)
    ours = _groups(len(ops), plan)
    k = 0
    for step, state in zip(path, _groups(len(ops), path)):
        k += max(len(step) - 1, 1)
        assert ours[k - 1] == state, (step, plan)
    assert k == len(plan)
    rng = np.random.default_rng(0)
    arrays = [torch.from_numpy(rng.normal(size=s)) for s in shapes]
    got = ev._run_plan(arrays, ops, out, plan).numpy()
    want = np.einsum(subs, *(a.numpy() for a in arrays), optimize="greedy")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_outer_product_of_three_matches_jax():
    def case(pkg):
        a, b, c = (pkg.Tensor.random([n]) for n in (2, 3, 4))
        i, j, k = pkg.indices(3)
        C = pkg.Tensor()
        C(i, j, k) << a(i) * b(j) * c(k)
        return {"C": C.to_ndarray()}
    ref, got = _both(case)
    _same(ref, got)


def test_left_to_right_plan_runs():
    """The left-to-right order, run by the same executor, gives the same
    product (what chip_smoke compares the planned FLOPs with)."""
    rng = np.random.default_rng(5)
    import torch
    arrays = [torch.from_numpy(rng.normal(size=s))
              for s in ((5, 3, 2), (3, 4, 2), (4, 6))]
    ops, out = _chain_labels()
    ref = np.einsum("ikl,kjl,jm->im", *(a.numpy() for a in arrays))
    for plan in (ev.contraction_plan(ops, out, tuple(a.shape for a in arrays)),
                 ev.left_to_right_plan(3)):
        got = ev._run_plan(arrays, ops, out, plan).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# -- test_indices_misc.py: performance counters and the nan guard


def test_performance_analysis_counters():
    perf_t.enable(True)
    perf_t.clear_analysis()
    try:
        for _ in range(2):
            with perf_t.pa_section("Dense", "GEMM", "64x64"):
                pass
        report = perf_t.get_analysis()
    finally:
        perf_t.enable(False)
        perf_t.clear_analysis()
    assert "Dense" in report and "GEMM(64x64): 2 calls" in report


def test_performance_analysis_wired_into_dispatch():
    """The object layer's dense calls feed the same group -> name ->
    parameter map as the JAX package's (the TT kernel entry waits for the
    TT classes)."""
    reports = {}
    for pkg, perf in ((xe, perf_j), (xt, perf_t)):
        pkg.set_seed(SEED)
        perf.enable(True)
        perf.clear_analysis()
        try:
            a, b = pkg.Tensor.random([6, 6]), pkg.Tensor.random([6, 6])
            pkg.contract(a, b, 1)
            pkg.calculate_svd(a, 1)
            pkg.calculate_qr(a, 1)
            pkg.solve(a, pkg.Tensor.random([6]))
            reports[pkg] = perf.get_analysis()
        finally:
            perf.enable(False)
            perf.clear_analysis()
    for line in ("Dense BLAS", "Matrix-Matrix-Multiplication",
                 "Singular Value Decomposition(6x6)", "QR Factorisation(6x6)"):
        assert line in reports[xt]
    strip = [[ln.split(":")[0] for ln in r.splitlines()]
             for r in reports.values()]
    assert strip[0] == strip[1]


def test_nan_guard():
    import torch
    from xerus_tpu_torch.misc.profiling import guard_finite
    old = xt.config.nan_checks
    xt.config.nan_checks = True
    try:
        guard_finite(torch.ones(3))
        guard_finite(xt.Tensor.ones([2]))
        with pytest.raises(FloatingPointError):
            guard_finite(torch.tensor([1.0, float("nan")]), "test")
    finally:
        xt.config.nan_checks = old
