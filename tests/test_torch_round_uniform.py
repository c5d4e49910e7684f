"""The port's uniform, parallel and streaming roundings
(xerus_tpu_torch.ops.round_uniform) held against xerus_tpu.ops.tt_kernels
on the CPU.

Both packages round the same float64 cores (drawn by the JAX package's
TTTensor.random from one seed).  Truncations are compared through the
represented tensor, which is gauge-free: 1e-8 of its norm where the two
packages run the same deterministic algorithm (JAX's own tests hold
cholqr to svd at rtol 1e-6), 1e-10 for the streaming rounding fed JAX's
own sketches.  The cases of tests/test_kernels.py run on the port with
their own bars: exact recovery, the quasi-optimality factors against the
svd sweep, finite f32 results on zero-padded bonds, eps rank cuts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xerus_tpu as xe
from xerus_tpu.ops import tt_kernels as jtk
from xerus_tpu_torch.ops import round_uniform as ru

SEED = 0xBAADF00D


def _cores(dims, rank, seed=SEED):
    xe.set_seed(seed)
    tt = xe.TTTensor.random(dims, rank)
    return [np.asarray(c.to_ndarray()) for c in tt.components]


def _emb(seed=SEED):
    """a (rank 3) + 1e-9 z (rank 5): rank 8 carried, numerically rank 3."""
    xe.set_seed(seed)
    a = xe.TTTensor.random([2] * 8, 3)
    a /= a.frob_norm()
    z = xe.TTTensor.random([2] * 8, 5)
    z /= z.frob_norm()
    emb = a + 1e-9 * z
    return ([np.asarray(c.to_ndarray()) for c in emb.components],
            np.asarray(a.to_tensor().to_ndarray()))


def _full(cores):
    out = np.asarray(cores[0], np.float64)
    for c in cores[1:]:
        out = np.tensordot(out, np.asarray(c, np.float64), axes=1)
    return out.squeeze()


def _t(cores, dtype=torch.float64):
    return [torch.from_numpy(np.asarray(c)).to(dtype) for c in cores]


def _j(cores, dtype=jnp.float64):
    return [jnp.asarray(c, dtype) for c in cores]


def _np(cores):
    return [np.asarray(c.detach().numpy() if isinstance(c, torch.Tensor)
                       else c, np.float64) for c in cores]


def _err(cores, orig):
    return np.linalg.norm(_full(_np(cores)) - orig)


def _ranks(cores):
    return [int(c.shape[2]) for c in cores[:-1]]


def test_round_sweep_matches_jax_and_object_round():
    """The unrolled QR + SVD sweep: JAX's tensor, and exact when the rank
    suffices."""
    cores = _cores([3] * 6, 8)
    got = ru.tt_round_sweep(_t(cores), 4)
    ref = jtk.tt_round_sweep(_j(cores), 4)
    want = _full(_np(ref))
    assert np.linalg.norm(_full(_np(got)) - want) <= 1e-10 * np.linalg.norm(
        want)
    assert _ranks(got) == _ranks(ref)
    small = _cores([2] * 8, 4)
    out = ru.tt_round_sweep(_t(small), 8)
    np.testing.assert_allclose(_full(_np(out)), _full(small), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("method", ["svd", "gram", "cholqr", "gram_parallel",
                                    "subspace_parallel"])
def test_uniform_methods_match_jax(method):
    """Rank 8 -> 4 at d=10: the port's tensor is JAX's within 1e-8 of its
    norm, both at the svd sweep's error (cholqr, gram) or within JAX's
    factor 1.5 of it (the parallel methods); ranks are JAX's where the
    padded forms keep JAX's shapes."""
    cores = _cores([2] * 10, 8)
    orig = _full(cores)
    got = ru.tt_round_sweep_uniform(_t(cores), 4, method=method)
    ref = jtk.tt_round_sweep_uniform(_j(cores), 4, method=method)
    want = _full(_np(ref))
    assert np.linalg.norm(_full(_np(got)) - want) <= 1e-8 * np.linalg.norm(
        want)
    assert _ranks(got) == _ranks(ref)
    e_svd = _err(jtk.tt_round_sweep_uniform(_j(cores), 4, method="svd"),
                 orig)
    e = _err(got, orig)
    if method in ("svd", "gram", "cholqr"):
        assert np.isclose(e, e_svd, rtol=1e-6)
    else:
        assert e < 1.5 * e_svd


@pytest.mark.parametrize("method", ["cholqr", "gram_parallel",
                                    "subspace_parallel"])
def test_uniform_methods_f32_on_zero_padded_bonds(method):
    """float32 with zero-padded (exactly singular) bonds: finite, and the
    error within tests/test_kernels.py's bars of the f64 svd sweep's."""
    cores = _cores([2] * 10, 8)
    orig = _full(cores)
    e_svd = _err(ru.tt_round_sweep_uniform(_t(cores), 4, method="svd"), orig)
    out = ru.tt_round_sweep_uniform(_t(cores, torch.float32), 4,
                                    method=method)
    assert all(bool(torch.isfinite(c).all()) for c in out)
    e32 = _err(out, orig)
    if method == "cholqr":
        assert np.isclose(e32, e_svd, rtol=1e-3)
    else:
        assert e32 < 1.5 * e_svd + 1e-4 * np.linalg.norm(orig)


@pytest.mark.parametrize("method", ["gram_parallel", "subspace_parallel"])
def test_parallel_methods_recover_representable_rank(method):
    """A rank-3 TT carried at rank 8 (+1e-9 noise) rounds to it."""
    cores, a = _emb()
    out = ru.tt_round_sweep_uniform(_t(cores), 4, method=method)
    np.testing.assert_allclose(_full(_np(out)), a, rtol=0, atol=1e-8)


def test_subspace_parallel_eps_cuts_the_noise():
    """eps on the Rayleigh sigma estimates cuts the 1e-9 directions: a's
    rank-3 bonds, as in JAX."""
    cores, a = _emb()
    out = ru.tt_round_sweep_uniform(_t(cores), 4, eps=1e-6,
                                    method="subspace_parallel")
    ref = jtk.tt_round_sweep_uniform(_j(cores), 4, eps=1e-6,
                                     method="subspace_parallel")
    assert max(_ranks(out)) == 3 and _ranks(out) == _ranks(ref)
    np.testing.assert_allclose(_full(_np(out)), a, rtol=0, atol=1e-7)


def _eps_pair(seed=SEED):
    xe.set_seed(seed)
    a = xe.TTTensor.random([3] * 6, 2)
    a /= a.frob_norm()
    b = xe.TTTensor.random([3] * 6, 2)
    b /= b.frob_norm()
    c = a + 1e-8 * b
    return ([np.asarray(x.to_ndarray()) for x in c.components],
            np.asarray(a.to_tensor().to_ndarray()))


@pytest.mark.parametrize("method", ["svd", "gram"])
def test_uniform_eps_trims_ranks(method):
    cores, a = _eps_pair()
    out = ru.tt_round_sweep_uniform(_t(cores), 4, eps=1e-6, method=method)
    np.testing.assert_allclose(_full(_np(out)), a, rtol=0, atol=1e-7)
    assert _ranks(out) == [2] * 5
    assert max(_ranks(ru.tt_round_sweep_uniform(_t(cores), 4))) == 4


def test_eps_fast_matches_jax_ranks():
    """Randomized preconditioning, then the svd-eps sweep: the 1e-8
    directions go, ranks [2]*5 as JAX's tt_round_eps_fast gives."""
    cores, a = _eps_pair()
    out = ru.tt_round_eps_fast(_t(cores), 4, 1e-6)
    ref = jtk.tt_round_eps_fast(_j(cores), 4, 1e-6)
    assert _ranks(out) == _ranks(ref) == [2] * 5
    np.testing.assert_allclose(_full(_np(out)), a, rtol=0, atol=1e-6)


def _jax_streaming_sketches(d, n, l, psi, dtype):
    """The draws of JAX's _round_streaming_scan (PRNGKey(0))."""
    key = jax.random.PRNGKey(0)
    kW, kL = jax.random.split(key)
    keysW = jax.random.split(kW, d)
    keysL = jax.random.split(kL, d)
    om = [jax.random.normal(keysW[1 + t], (l, n, l), dtype=dtype)
          for t in range(d - 1)]
    ph = [jax.random.normal(keysL[k], (l + psi, n, l + psi), dtype=dtype)
          for k in range(d - 1)]
    return ([torch.from_numpy(np.array(x)) for x in om],
            [torch.from_numpy(np.array(x)) for x in ph])


@pytest.mark.parametrize("target", [6, 4])
def test_streaming_matches_jax_with_its_sketches(target):
    """With JAX's own sketches the port's streaming rounding is JAX's
    (1e-10 of the norm): representable (rank 3 -> 6) and truncating
    (rank 8 -> 4)."""
    cores = _cores([2] * 8, 3) if target == 6 else _cores([2] * 10, 8)
    d = len(cores)
    sk = _jax_streaming_sketches(d, 2, target, 32, jnp.float64)
    got = ru.tt_round_streaming_uniform(_t(cores), target, sketches=sk)
    ref = jtk.tt_round_streaming_uniform(_j(cores), target)
    want = _full(_np(ref))
    assert [tuple(c.shape) for c in got] == [tuple(c.shape) for c in ref]
    assert np.linalg.norm(_full(_np(got)) - want) <= 1e-10 * np.linalg.norm(
        want)


def test_streaming_own_sketches_contract():
    """tests/test_kernels.py's streaming contract on the port's own draws:
    exact on representable ranks, within 6x of the svd error when
    truncating, finite and within the f32 bar in float32; d == 1 is a
    no-op."""
    a = _cores([2] * 8, 3)
    out = ru.tt_round_streaming_uniform(_t(a), 6)
    full = _full(a)
    np.testing.assert_allclose(_full(_np(out)), full, rtol=0,
                               atol=1e-10 * np.linalg.norm(full))
    cs = _cores([2] * 10, 8)
    orig = _full(cs)
    e_s = _err(ru.tt_round_sweep_uniform(_t(cs), 4, method="svd"), orig)
    assert _err(ru.tt_round_streaming_uniform(_t(cs), 4), orig) < 6 * e_s
    st32 = ru.tt_round_streaming_uniform(_t(cs, torch.float32), 4)
    assert all(bool(torch.isfinite(c).all()) for c in st32)
    assert _err(st32, orig) < 6 * e_s + 1e-3 * np.linalg.norm(orig)
    one = ru.tt_round_streaming_uniform([torch.ones((1, 5, 1))], 3)
    assert len(one) == 1 and tuple(one[0].shape) == (1, 5, 1)


def _np_cores(dims, rank, seed):
    """Random f64 TT cores drawn with numpy (ranks min(rank, n^i, n^(d-i))):
    the default-tier randomized cases compile nothing of JAX."""
    rng = np.random.default_rng(seed)
    d, n = len(dims), dims[0]
    rk = [1] + [min(rank, n ** i, n ** (d - i)) for i in range(1, d)] + [1]
    return [rng.standard_normal((rk[i], dims[i], rk[i + 1])) / np.sqrt(rank)
            for i in range(d)]


def test_randomized_uniform_contract():
    """tests/test_kernels.py's randomized uniform cases (d = 10, rank 8)
    on the port with their bars: logical ranks (JAX's res_rank), exact at
    a representable rank, within 4x of the exact sweep when truncating,
    cholqr within rtol 1e-3 of Householder on the same sketch, cholqr1
    within 1.2x and exact to 1e-5 at rank 8, finite in float32."""
    cs = _np_cores([2] * 10, 8, 5)
    orig = _full(cs)
    for target in (8, 4):
        out = ru.tt_round_randomized_uniform(_t(cs), target, oversample=4)
        assert _ranks(out) == [jtk.res_rank(i + 1, 10, 2, target)
                               for i in range(9)]
    assert np.allclose(_full(_np(ru.tt_round_randomized_uniform(
        _t(cs), 8, oversample=4))), orig, atol=1e-8)
    e_det = _err(ru.tt_round_sweep(_t(cs), 4), orig)
    e_rnd = _err(ru.tt_round_randomized_uniform(_t(cs), 4, oversample=4),
                 orig)
    assert e_rnd < 4 * e_det
    e_chl = _err(ru.tt_round_randomized_uniform(_t(cs), 4, oversample=4,
                                                qr_method="cholqr"), orig)
    assert np.isclose(e_chl, e_rnd, rtol=1e-3)
    e_h = _err(ru.tt_round_randomized_uniform(_t(cs), 4), orig)
    e_c = _err(ru.tt_round_randomized_uniform(_t(cs), 4,
                                              qr_method="cholqr1"), orig)
    assert e_c < 1.2 * e_h + 1e-12
    assert _err(ru.tt_round_randomized_uniform(_t(cs), 8,
                                               qr_method="cholqr1"),
                orig) < 1e-5 * np.linalg.norm(orig)
    r32 = ru.tt_round_randomized_uniform(_t(cs, torch.float32), 4,
                                         qr_method="cholqr1")
    assert all(bool(torch.isfinite(c).all()) for c in r32)
    one = ru.tt_round_randomized_uniform([torch.ones((1, 5, 1))], 3)
    assert len(one) == 1 and tuple(one[0].shape) == (1, 5, 1)
    with pytest.raises(ValueError, match="qr_method"):
        ru.tt_round_randomized_uniform(_t(cs), 4, qr_method="cholqr1_invl")


def _jax_scan_sketches(cores, target, oversample):
    """The draws of JAX's _round_randomized_scan (PRNGKey(0), one (l, n, l)
    normal per core d-1 .. 1), cut to the port's sketch shapes."""
    from xerus_tpu_torch.ops import round_kernels as rk
    d, l = len(cores), target + oversample
    keys = jax.random.split(jax.random.PRNGKey(0), d)
    shapes = rk.sketch_shapes([c.shape for c in cores], target, oversample)
    return [torch.from_numpy(np.array(jax.random.normal(
        keys[d - 1 - i], (l, cores[i + 1].shape[1], l),
        dtype=jnp.float64))[:, :, :shapes[i][2]]) for i in range(d - 1)]


@pytest.mark.slow
@pytest.mark.parametrize("target", [8, 4])
def test_randomized_uniform_matches_jax(target):
    """The port's uniform entry has JAX's logical ranks; fed the padded
    scan's own sketches, the sweep it runs (``_round_randomized`` capped
    at the logical ranks) gives JAX's ``tt_round_randomized_uniform``
    tensor to 1e-8 of its norm."""
    from xerus_tpu_torch.ops import round_kernels as rk
    cs = _cores([2] * 10, 8)
    ref = jtk.tt_round_randomized_uniform(_j(cs), target)
    got = ru.tt_round_randomized_uniform(_t(cs), target)
    assert _ranks(got) == _ranks(ref)
    fed = rk._round_randomized(_t(cs), target, 8,
                               sketches=_jax_scan_sketches(cs, target, 8),
                               max_ranks=_ranks(ref))
    want = _full(_np(ref))
    assert [tuple(c.shape) for c in fed] == [tuple(c.shape) for c in ref]
    assert np.linalg.norm(_full(_np(fed)) - want) <= 1e-8 * np.linalg.norm(
        want)


def test_uniform_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown rounding method"):
        ru.tt_round_sweep_uniform(_t(_cores([2] * 4, 2)), 2, method="qr")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigh_sym_matches_jax_on_the_cpu(dtype):
    """The roundings' eigh (``round_kernels._eigh_sym``) on the CPU is
    torch.linalg.eigh in the input's dtype, ascending, with JAX's
    eigenvalues (float64 is used only for float32 on the card)."""
    from xerus_tpu_torch.ops.round_kernels import _eigh_sym
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(40, 60)) * np.logspace(0, -3, 60)
    G = (X @ X.T).astype(dtype)
    w, V = _eigh_sym(torch.from_numpy(G))
    assert w.dtype == V.dtype == torch.from_numpy(G).dtype
    wt, _Vt = torch.linalg.eigh(torch.from_numpy(G))
    assert torch.equal(w, wt)
    wj = np.asarray(jnp.linalg.eigh(jnp.asarray(G))[0])
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.max(np.abs(w.numpy() - wj)) <= tol * np.max(np.abs(wj))
    assert np.all(np.diff(w.numpy()) >= 0)
