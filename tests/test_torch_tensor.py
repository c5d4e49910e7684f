"""The port's Tensor (xerus_tpu_torch.core.tensor, contract) held against
xerus_tpu's on the CPU.

Every case of tests/test_tensor_basics.py runs in both packages from the
same ``set_seed`` (the two engines draw the same numbers), keeps that
file's own oracles, and compares what the packages return: dimensions,
representations, counts and raised error types exactly, values to 1e-12
of the largest entry in float64.  Also here: the copy and aliasing rules
that torch's mutable tensors make necessary, the device rule (the card
unless ``host()``), and ``convert.tensor_from_state``."""

import numpy as np
import pytest
import torch

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu_torch.convert import tensor_from_state

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
    """Exact for everything but float data, which agrees to ``rtol`` of
    its largest magnitude."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _same(x, y, rtol)
        elif isinstance(x, (np.ndarray, float)):
            x, y = np.asarray(x, float), np.asarray(y, float)
            assert x.shape == y.shape, k
            scale = max(float(np.abs(x).max(initial=0.0)), 1e-300)
            assert float(np.abs(x - y).max(initial=0.0)) <= rtol * scale, k
        else:
            assert x == y, k


def _state(t):
    return {"dims": list(t.dimensions), "rep": t.representation.name,
            "data": t.to_ndarray()}


# -- the cases of tests/test_tensor_basics.py, one function per test, run
#    with either package as ``pkg``


def c_creation_zero_init(pkg):
    t = pkg.Tensor([2, 3, 4], pkg.Representation.Dense)
    assert t.frob_norm() == 0.0 and not t.has_factor()
    return {"degree": t.degree(), "size": t.size, "norm": t.frob_norm()}


def c_ones_identity_kronecker_dirac(pkg):
    T = pkg.Tensor
    o, ident = T.ones([2, 3]), T.identity([3, 2, 3, 2])
    k, d, d2 = T.kronecker([3, 3, 3]), T.dirac([4, 4], [1, 2]), \
        T.dirac([4, 4], 5)
    assert np.allclose(ident.to_ndarray().reshape(6, 6), np.eye(6))
    return {"ones": o.to_ndarray(), "ident": ident.to_ndarray(),
            "ident_rep": ident.representation.name, "kron": k.to_ndarray(),
            "dirac": d.to_ndarray(), "dirac2": d2.to_ndarray(),
            "kron_rep": k.representation.name}


def c_element_access_dense_sparse(pkg):
    t = pkg.Tensor([3, 3])
    sparse_default = t.is_sparse()
    t[[0, 1]] = 5.0
    a, b = t[[0, 1]], t[1]
    t.use_dense_representation()
    c = t[[0, 1]]
    t[[2, 2]] = -1.0
    return {"sparse_default": sparse_default, "reads": [a, b, c, t[8]],
            "dense": t.is_dense()}


def c_element_access_computed(pkg):
    """Reads of data a computation produced: a permuted view in the port."""
    A = pkg.Tensor.random([3, 4, 2])
    i, j, k = pkg.indices(3)
    B = pkg.Tensor()
    B(k, i, j) << 2.0 * A(i, j, k)
    return {"reads": np.array([B[[1, 2, 3]], B[5], B[23],
                               float(B(k, i, j) * B(k, i, j))]),
            "data": B.to_ndarray()}


def c_factor_semantics(pkg):
    t = pkg.Tensor.random([4, 4])
    base = t.to_ndarray()
    t *= 3.0
    had = t.has_factor()
    read = t[[1, 1]]
    t[[0, 0]] = 7.0
    assert np.isclose(read, 3 * base[1, 1])
    return {"had": had, "after": t.has_factor(), "read": read,
            "data": t.to_ndarray()}


def c_add_sub_scaling(pkg):
    a, b = pkg.Tensor.random([3, 4]), pkg.Tensor.random([3, 4])
    e = 2.0 * a
    e += b
    return {"sum": (a + b).to_ndarray(), "diff": (a - b).to_ndarray(),
            "axpy": e.to_ndarray(), "div": (a / 4.0).to_ndarray(),
            "neg": (-a).to_ndarray()}


def c_sparse_add_stays_sparse(pkg):
    a = pkg.Tensor.random([10, 10], n=5)
    b = pkg.Tensor.random([10, 10], n=5)
    c = a + b
    rep = c.representation.name
    s = c.to_ndarray()
    c -= b
    return {"rep": rep, "sum": s, "back": c.to_ndarray(),
            "a": a.to_ndarray()}


def c_norms(pkg):
    t = pkg.Tensor.random([5, 5])
    n1, o1 = t.frob_norm(), t.one_norm()
    t *= -2.0
    s = pkg.Tensor.random([6, 6], n=9)
    s *= -1.5
    return {"frob": n1, "one": o1, "scaled": t.frob_norm(),
            "sparse_frob": s.frob_norm(), "sparse_one": s.one_norm(),
            "free": pkg.frob_norm(t), "free_one": pkg.one_norm(t)}


def c_fix_mode(pkg):
    t = pkg.Tensor.random([3, 4, 5])
    u = t.copy()
    u.fix_mode(1, 2)
    assert np.allclose(u.to_ndarray(), t.to_ndarray()[:, 2, :])
    return _state(u)


def c_fix_mode_computed(pkg):
    """fix_mode on data a computation produced (torch-held in the port)."""
    t = pkg.Tensor.random([3, 4, 5]) + pkg.Tensor.random([3, 4, 5])
    t.fix_mode(2, 4)
    return _state(t)


def c_fix_mode_sparse(pkg):
    t = pkg.Tensor.random([4, 4], n=8)
    t.fix_mode(0, 1)
    return _state(t)


def c_resize_mode_grow_shrink(pkg):
    t = pkg.Tensor.random([3, 4])
    arr = t.to_ndarray()
    t.resize_mode(1, 6)
    grown = _state(t)
    t.resize_mode(1, 4)
    assert np.allclose(t.to_ndarray(), arr)
    t.resize_mode(0, 2, 1)
    return {"grown": grown["data"], "shrunk": t.to_ndarray(),
            "dims": t.dimensions}


def c_resize_mode_sparse(pkg):
    t = pkg.Tensor.random([3, 3], n=9)
    t.resize_mode(0, 5, 1)
    return _state(t)


def c_remove_slate(pkg):
    t = pkg.Tensor.random([3, 4])
    t.remove_slate(1, 1)
    return _state(t)


def c_perform_trace(pkg):
    t = pkg.Tensor.random([4, 3, 4])
    arr = t.to_ndarray()
    t.perform_trace(0, 2)
    assert np.allclose(t.to_ndarray(), np.einsum('iji->j', arr))
    return _state(t)


def c_reinterpret_dimensions(pkg):
    t = pkg.Tensor.random([4, 4])
    t.reinterpret_dimensions([2, 2, 2, 2])
    return _state(t)


def c_offset_add(pkg):
    t = pkg.Tensor([4, 4], pkg.Representation.Dense)
    t.offset_add(pkg.Tensor.ones([2, 2]), [1, 1])
    return _state(t)


def c_modify_entries_and_diagonal(pkg):
    t = pkg.Tensor.random([3, 3])
    t.modify_entries(lambda v: 2 * v)
    doubled = t.to_ndarray()
    t.modify_diagonal_entries(lambda v: 0.0)
    return {"doubled": doubled, "zeroed": t.to_ndarray()}


def c_dense_sparse_roundtrip(pkg):
    t = pkg.Tensor.random([6, 6], n=7)
    dense = t.dense_copy()
    back = dense.sparse_copy()
    assert pkg.approx_equal(back, t, 1e-14)
    return {"dense": dense.is_dense(), "back": back.is_sparse(),
            "nnz": back.sparsity(), "count": t.count_non_zero_entries()}


def c_count_non_zero_and_valid(pkg):
    t = pkg.Tensor.random([5, 5])
    out = {"valid": t.all_entries_valid(),
           "count": t.count_non_zero_entries()}
    t[[0, 0]] = 0.0
    out["count_after"] = t.count_non_zero_entries()
    return out


def c_multiindex_conversion(pkg):
    dims = [3, 4, 5]
    mis = [pkg.Tensor.position_to_multiIndex(p, dims) for p in [0, 7, 59, 33]]
    return {"mi": mis, "pos": [pkg.Tensor.multiIndex_to_position(mi, dims)
                               for mi in mis]}


def c_approx_equal(pkg):
    a = pkg.Tensor.random([4, 4])
    b2 = a + 1e-3 * pkg.Tensor.random([4, 4])
    return {"self": pkg.approx_equal(a, a.copy()),
            "close": pkg.approx_equal(a, b2, 1e-9),
            "entrywise": pkg.approx_entrywise_equal(
                a, a.to_ndarray().reshape(-1))}


def c_random_orthogonal(pkg):
    q = pkg.Tensor.random_orthogonal([6], [4])
    arr = q.to_ndarray()
    assert np.allclose(arr.T @ arr, np.eye(4), atol=1e-12)
    return _state(q)


def c_reshuffle(pkg):
    t = pkg.Tensor.random([2, 3, 4])
    out = pkg.reshuffle(t, [2, 0, 1])
    assert np.allclose(out.to_ndarray(),
                       np.transpose(t.to_ndarray(), (1, 2, 0)))
    return _state(out)


def c_reshuffle_sparse_preserves_rep(pkg):
    t = pkg.Tensor.random([4, 5], n=6)
    return _state(pkg.reshuffle(t, [1, 0]))


def c_binding_ctor_overloads(pkg):
    """Tensor(int degree) and the deep-copying Tensor(Tensor); the
    Tensor(TTTensor) cast is in tests/test_torch_tt.py."""
    t3 = pkg.Tensor(3)
    src = pkg.Tensor.random([2, 5])
    cp = pkg.Tensor(src)
    cp[[0, 0]] = 123.0
    return {"dims": t3.dimensions, "entry": float(t3[[0, 0, 0]]),
            "src": src[[0, 0]], "cp": cp.to_ndarray()}


def c_entrywise_product(pkg):
    a, b = pkg.Tensor.random([3, 4]), pkg.Tensor.random([3, 4])
    s = pkg.Tensor.random([3, 4], n=5)
    s *= 2.0
    return {"dense": pkg.entrywise_product(a, b).to_ndarray(),
            "sparse": _state(pkg.entrywise_product(s, a))["data"],
            "rep": pkg.entrywise_product(a, s).representation.name}


def c_contract(pkg):
    a, b = pkg.Tensor.random([3, 4, 5]), pkg.Tensor.random([4, 5, 2])
    a *= 0.5
    s = pkg.Tensor.random([4, 5, 2], n=6)
    s2 = pkg.Tensor.random([2, 3], n=4)
    return {"dense": _state(pkg.contract(a, b, 2)),
            "trans": pkg.contract(b, b, 2, lhs_trans=True).to_ndarray(),
            "mixed": _state(pkg.contract(a, s, 2))["data"],
            "sparse": _state(pkg.contract(s, s2, 1, lhs_trans=False)),
            "rtrans": pkg.contract(a, a, 2, rhs_trans=True).to_ndarray()}


CASES = {name[2:]: fn for name, fn in dict(globals()).items()
         if name.startswith("c_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_matches_jax(name):
    ref, got = _both(CASES[name])
    _same(ref, got)


def test_sparse_representation_kept_by_contract():
    """Sparse in, sparse out: the expected-density rule of contract."""
    ref, got = _both(lambda pkg: {
        "rep": pkg.contract(pkg.Tensor.random([30, 30], n=10),
                            pkg.Tensor.random([30, 30], n=10),
                            1).representation.name})
    assert ref == got == {"rep": "Sparse"}


# -- aliasing: torch tensors are mutable, jax arrays were not


def _computed(shape):
    """A dense Tensor whose data a computation produced (torch-held)."""
    t = xt.Tensor.random(shape)
    return t + xt.Tensor(shape, xt.Representation.Dense)


@pytest.mark.parametrize("make", [xt.Tensor.random, _computed],
                         ids=["host buffer", "torch-held"])
@pytest.mark.parametrize("write", ["setitem", "modify_entries",
                                   "modify_diagonal", "offset_add"])
def test_writes_on_a_copy_never_reach_the_source(make, write):
    src = make([3, 3])
    before = src.to_ndarray()
    for cp in (src.copy(), xt.Tensor(src)):
        if write == "setitem":
            cp[[1, 1]] = 99.0
        elif write == "modify_entries":
            cp.modify_entries(lambda v: v + 1.0)
        elif write == "modify_diagonal":
            cp.modify_diagonal_entries(lambda v: 0.0)
        else:
            cp.offset_add(xt.Tensor.ones([2, 2]), [0, 0])
        assert not np.array_equal(cp.to_ndarray(), before)
        assert np.array_equal(src.to_ndarray(), before)


def test_results_do_not_alias_host_buffers():
    """A computed result taken from a host buffer does not change when the
    buffer's tensor is written afterwards."""
    a = xt.Tensor.random([4])
    i = xt.Index()
    out = xt.Tensor()
    out(i) << a(i)
    kept = out.to_ndarray()
    a[[0]] = 1e9
    assert np.array_equal(out.to_ndarray(), kept)


@pytest.mark.parametrize("where", ["from_torch input", "to_torch output",
                                   "to_torch of a copy"])
def test_writes_through_torch_boundary_reach_no_tensor(where):
    """from_torch copies its argument and to_torch returns the caller's own
    tensor: writing either in place changes neither the Tensor nor its
    copies."""
    data = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 3)))
    A = xt.Tensor.from_torch(data) if where == "from_torch input" \
        else _computed([3, 3])
    copies = (A.copy(), xt.Tensor(A))
    before = A.to_ndarray()
    if where == "from_torch input":
        data.add_(1.0)
    elif where == "to_torch output":
        A.to_torch().add_(1.0)
        A.to_torch(apply_factor=False).mul_(-3.0)
    else:
        copies[0].to_torch().add_(1.0)
    for t in (A,) + copies:
        assert np.array_equal(t.to_ndarray(), before)


# -- sparse x dense through the device path (gather + index_add_)


@pytest.mark.parametrize("lhs_trans", [False, True])
@pytest.mark.parametrize("rhs_trans", [False, True])
@pytest.mark.parametrize("sparse_side", ["lhs", "rhs"])
def test_sparse_times_dense_device_path_matches_jax(monkeypatch, sparse_side,
                                                    lhs_trans, rhs_trans):
    """Every transposition of a mixed product through
    ops/sparse_kernels.py (the card's route at every size), held against
    the JAX package's scipy route at 1e-12."""
    from xerus_tpu_torch.ops import sparse_kernels
    monkeypatch.setattr(sparse_kernels, "DEVICE_SPARSE_THRESHOLD", 0)

    def case(pkg):
        m, k, n = 6, 5, 7
        lhs_dims = [k, m] if lhs_trans else [m, k]
        rhs_dims = [n, k] if rhs_trans else [k, n]
        def sparse(dims):
            return pkg.Tensor.random(dims, n=9)

        dense = pkg.Tensor.random
        a = (sparse if sparse_side == "lhs" else dense)(lhs_dims)
        b = (dense if sparse_side == "lhs" else sparse)(rhs_dims)
        a *= 0.5
        out = pkg.contract(a, b, 1, lhs_trans=lhs_trans,
                           rhs_trans=rhs_trans)
        return {"rep": out.representation.name, "out": out.to_ndarray()}
    ref, got = _both(case)
    assert got["rep"] == "Dense"
    _same(ref, got)


# -- the device rule


def test_object_layer_runs_on_the_compute_device():
    a = xt.Tensor.random([3, 3])
    assert a.to_torch().device.type == "cpu"          # inside host()
    assert xt.config.device.type == "cpu"
    assert (a + a)._dense.device.type == "cpu"


def test_float64_by_default():
    assert xt.value_dtype() == np.float64
    assert xt.Tensor.random([2, 2]).to_torch().dtype == torch.float64
    assert xt.EPSILON() == 8 * np.finfo(np.float64).eps


def test_set_value_dtype_round_trip():
    try:
        xt.set_value_dtype(np.float32)
        assert xt.Tensor.random([2, 2]).to_torch().dtype == torch.float32
    finally:
        xt.set_value_dtype(np.float64)
    assert xt.value_dtype() == np.float64


# -- carrying a JAX-package tensor across


@pytest.mark.parametrize("sparse", [False, True])
def test_tensor_from_state(sparse):
    xe.set_seed(7)
    src = xe.Tensor.random([3, 4], n=5) if sparse else xe.Tensor.random([3, 4])
    src *= -2.5
    t = tensor_from_state(src.dimensions, src.factor,
                          sparse=src._sparse if sparse else None,
                          dense=None if sparse else np.asarray(src._dense),
                          device=None if sparse else torch.device("cpu"))
    assert t.representation.name == src.representation.name
    assert t.factor == src.factor
    assert np.array_equal(t.to_ndarray(), src.to_ndarray())
    with pytest.raises(ValueError):
        tensor_from_state([2], 1.0)
