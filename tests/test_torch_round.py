"""The port's TT rounding (xerus_tpu_torch.ops.round_kernels) held against
xerus_tpu.ops.tt_kernels on the same numpy-seeded cores.

Only gauge-free quantities are compared (QR and SVD signs differ between
the frameworks): the represented tensor, densified in float64, the
log-scale, truncation errors and log-norms.  Oracles in float64 use the
reference's tolerance for the round() oracles, rtol 1e-8
(tests/test_kernels.py); the f32 slice at d=10 compares log-norms to 1e-5
relative (f32 rounding along a 10-site chain)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xerus_tpu.ops import tt_kernels as jtk
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import (bench_round_instance, cliff_instance,
                                      cpu_round_sweep, host_tt_distance,
                                      host_tt_log_norm)
from xerus_tpu_torch.ops import gemm_exact as ge
from xerus_tpu_torch.ops import round_kernels as rk

CPU = torch.device("cpu")


def _tt(d, n, r, seed, ranks=None):
    """Random f64 TT: bench-style ranks min(r, n^i, n^(d-i)), or the
    given uniform bond rank (non-minimal at the boundaries)."""
    rng = np.random.default_rng(seed)
    cores = []
    for i in range(d):
        if ranks is None:
            rl = 1 if i == 0 else min(r, n ** i, n ** (d - i))
            rr = 1 if i == d - 1 else min(r, n ** (i + 1), n ** (d - i - 1))
        else:
            rl = 1 if i == 0 else ranks
            rr = 1 if i == d - 1 else ranks
        cores.append(rng.standard_normal((rl, n, rr)) / np.sqrt(r))
    return cores


def _dense(cores):
    t = np.ones((1, 1))
    for c in cores:
        c = np.asarray(c, np.float64)
        t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape(-1)


def _torch(cores):
    return [torch.from_numpy(np.array(c)) for c in cores]


def _np(cores):
    return [np.asarray(c) for c in cores]


def _jround(cores, target, method, eps=0.0):
    return _np(jtk.tt_round_sweep_segmented(
        [jnp.asarray(c) for c in cores], target, eps=eps, method=method))


def _tround(cores, target, method, eps=0.0):
    return [c.numpy() for c in rk.tt_round_sweep_segmented(
        _torch(cores), target, eps=eps, method=method)]


def test_chol_orth_cols_matches_reference():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(40, 8))
    Qj, Rj = jtk.chol_orth_cols(jnp.asarray(X), want_r=True)
    Qt, Rt = rk.chol_orth_cols(torch.from_numpy(X), want_r=True)
    Qt, Rt = Qt.numpy(), Rt.numpy()
    np.testing.assert_allclose(Qt.T @ Qt, np.eye(8), atol=1e-10)
    np.testing.assert_allclose(Qt @ Rt, X, atol=1e-10)
    # Cholesky is unique: Q and R themselves agree
    np.testing.assert_allclose(Qt, np.asarray(Qj), atol=1e-12)
    np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-12)
    # three shifted passes on an ill-conditioned input
    U, _ = np.linalg.qr(rng.normal(size=(40, 8)))
    V, _ = np.linalg.qr(rng.normal(size=(8, 8)))
    Xb = U @ np.diag(np.logspace(0, -6, 8)) @ V.T
    ueps = float(np.finfo(np.float64).eps)
    rels = (10 * 40 * ueps, 10 * ueps, 10 * ueps)
    Q3 = rk.chol_orth_cols(torch.from_numpy(Xb), rels).numpy()
    assert np.linalg.norm(Q3.T @ Q3 - np.eye(8)) < 1e-9
    np.testing.assert_allclose(
        Q3, np.asarray(jtk.chol_orth_cols(jnp.asarray(Xb), rels)), atol=1e-9)


def _qr_out_tensor(qs, true_k, logs):
    cores = [q[:a, :, :b] for q, (a, b) in zip(qs, true_k)]
    return np.exp(float(logs)) * _dense(cores)


@pytest.mark.parametrize("orth", ["cholqr", "ns"])
@pytest.mark.parametrize("min_run", [3, 100])
@pytest.mark.parametrize("ranks", [None, 6])
def test_qr_sweep_segmented_matches_reference(orth, min_run, ranks):
    """Bucketed scan runs (min_run 3) and unrolled sites (min_run 100),
    minimal and non-minimal (rank-reducing) TTs: the represented tensor
    and the log-scale agree with the reference."""
    cores = _tt(7, 2, 8, 1, ranks=ranks)
    jq, jk, jl = jtk._qr_sweep_segmented([jnp.asarray(c) for c in cores],
                                         min_run, orth)
    tq, tk_, tl = rk._qr_sweep_segmented(_torch(cores), min_run, orth)
    assert tk_ == jk
    assert [tuple(q.shape) for q in tq] == [q.shape for q in jq]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-10)
    ref = _dense(cores)
    out = _qr_out_tensor([q.numpy() for q in tq], tk_, tl)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-10
    # left-orthogonal cores
    for q, (a, b) in zip(tq[:-1], tk_[:-1]):
        m = q.numpy()[:a, :, :b].reshape(-1, b)
        np.testing.assert_allclose(m.T @ m, np.eye(b), atol=1e-10)


def _step_case(mode):
    rng = np.random.default_rng({"full_cols": 1, "full_rows": 2,
                                 "deficient": 3, "trunc": 4}[mode])
    if mode == "full_cols":
        return rng.standard_normal((12, 8)), 8, 8
    if mode == "full_rows":
        return rng.standard_normal((8, 20)), 8, 8
    if mode == "deficient":
        A = rng.standard_normal((8, 3)) @ rng.standard_normal((3, 20))
        return A, 8, 8
    return rng.standard_normal((16, 24)), 5, 8


@pytest.mark.parametrize("mode,method", [
    ("full_cols", "svd"), ("full_rows", "svd"), ("deficient", "svd"),
    ("trunc", "svd"), ("trunc", "gram"), ("trunc", "subspace"),
    ("trunc", "gemm_exact")])
def test_trunc_step_reconstruction_matches_reference(mode, method):
    A, keep, cap = _step_case(mode)
    jmode = "full_rows" if mode == "deficient" else mode
    jus, jvt = jtk._trunc_step(jnp.asarray(A), keep, cap, 0.0, method,
                               jnp.float64, jnp.asarray(1e-30, jnp.float64),
                               mode=jmode)
    tus, tvt = rk._trunc_step(torch.from_numpy(A), keep, cap, 0.0, method,
                              mode=jmode)
    assert tus.shape == jus.shape and tvt.shape == jvt.shape
    rec_j = np.asarray(jus) @ np.asarray(jvt)
    rec_t = tus.numpy() @ tvt.numpy()
    assert np.linalg.norm(rec_t - rec_j) / np.linalg.norm(A) < 1e-8
    if mode != "trunc":
        np.testing.assert_allclose(rec_t, A, atol=1e-10)
    # padded slots beyond keep are exactly zero
    assert np.all(tus.numpy()[:, keep:] == 0.0)
    assert np.all(tvt.numpy()[keep:] == 0.0)


@pytest.mark.parametrize("method", ["svd", "gram", "subspace", "gemm_exact"])
def test_round_sweep_segmented_matches_reference(method):
    """Densified f64 results agree with the reference's, and so do the
    truncation errors, to rtol 1e-8."""
    cores = _tt(8, 2, 8, 2)
    j = _jround(cores, 4, method)
    t = _tround(cores, 4, method)
    assert [c.shape for c in t] == [c.shape for c in j]
    e_j = host_tt_distance(cores, j)
    e_t = host_tt_distance(cores, t)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-8)
    assert host_tt_distance(t, j) < 1e-8 * np.linalg.norm(_dense(cores))


def test_gemm_exact_round_matches_svd_chain():
    """The certified rounding equals the SVD chain (rtol 1e-8 on the
    truncation error), reproduces a representable tensor exactly, and
    launches one truncation per trunc-mode bond of the schedule."""
    cores = _tt(8, 2, 8, 5)
    ge.reset_counters()
    gex = _tround(cores, 4, "gemm_exact")
    calls = ge.trunc_step_gemm_exact.calls
    svd = _tround(cores, 4, "svd")
    np.testing.assert_allclose(host_tt_distance(cores, gex),
                               host_tt_distance(cores, svd), rtol=1e-8)
    true_k = rk._qr_sweep_segmented(_torch(cores), 3, "ns")[1]
    sched = rk._round_schedule(true_k, [2] * 8, 1, [4] * 7, 0.0, 32)
    assert calls == sum(s["mode"] == "trunc" for s in sched) > 0
    exact = _tround(cores, 8, "gemm_exact")
    assert host_tt_distance(cores, exact) < 1e-10 * np.linalg.norm(
        _dense(cores))


def test_bench_schedule_has_17_truncating_bonds():
    """The d=32 rank-256 -> 128 instance: K2 sees 17 trunc-mode bonds,
    all at (256, 256) with keep 128 in a 128 bucket (sites 8..24)."""
    shapes = [c.shape for c in bench_round_instance()]
    true_k, kprev = [], 1
    for i in range(31):
        k = min(kprev * shapes[i][1], shapes[i][2])
        true_k.append((kprev, k))
        kprev = k
    true_k.append((kprev, 1))
    sched = rk._round_schedule(true_k, [2] * 32, 1, [128] * 31, 0.0, 32)
    trunc = [s for s in sched if s["mode"] == "trunc"]
    assert sorted(s["i"] for s in trunc) == list(range(8, 25))
    assert all((s["Bl"], s["n"] * s["Bk"], s["keep"], s["Bk"])
               == (256, 256, 128, 128) for s in trunc)


def test_eps_rounding_trims_like_reference():
    cores = _tt(8, 2, 8, 6)
    # a decaying spectrum so that eps drops directions
    cores = [c * np.exp(-0.7 * np.arange(c.shape[2]))[None, None, :]
             for c in cores]
    for method in ("svd", "gram"):
        j = _jround(cores, 8, method, eps=1e-2)
        t = _tround(cores, 8, method, eps=1e-2)
        assert [c.shape for c in t] == [c.shape for c in j]
        assert host_tt_distance(t, j) < 1e-8 * np.linalg.norm(_dense(cores))
    for method in ("subspace", "gemm_exact"):
        with pytest.raises(ValueError, match="singular values"):
            rk.tt_round_sweep_segmented(_torch(cores), 4, eps=1e-6,
                                        method=method)


def _jax_sketches(cores, target, oversample):
    """The sketch normals jax.random draws inside _round_randomized."""
    d = len(cores)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0), d)
    shapes = rk.sketch_shapes([c.shape for c in cores], target, oversample)
    return [np.asarray(jax.random.normal(keys[i], shapes[i],
                                         dtype=cores[0].dtype))
            for i in range(d - 1)]


@pytest.mark.parametrize("qr_method", ["householder", "cholqr1",
                                       "cholqr1_invl"])
def test_round_randomized_matches_reference(qr_method):
    """With the sketches jax.random draws, the port rounds to the same
    tensor (f64, rtol 1e-8 of its norm)."""
    cores = _tt(8, 2, 16, 7)
    j = _np(jtk._round_randomized(tuple(jnp.asarray(c) for c in cores), None,
                                  6, 4, qr_method=qr_method))
    t = rk._round_randomized(_torch(cores), 6, 4, qr_method=qr_method,
                             sketches=_torch(_jax_sketches(cores, 6, 4)))
    t = [c.numpy() for c in t]
    assert [c.shape for c in t] == [c.shape for c in j]
    assert host_tt_distance(t, j) < 1e-8 * np.linalg.norm(_dense(cores))


def test_round_randomized_own_sketch_and_refusals():
    cores = _torch(_tt(6, 2, 8, 8))
    g = torch.Generator(device="cpu").manual_seed(3)
    a = rk._round_randomized(cores, 4, 4, qr_method="cholqr1", generator=g)
    b = rk._round_randomized(cores, 4, 4, qr_method="cholqr1",
                             generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.isfinite(c).all() for c in a)
    assert max(c.shape[2] for c in a[:-1]) <= 4
    # the SPEED_PRESETS precisions run (tests/test_torch_speed_presets.py
    # holds their arithmetic); a precision the JAX package lacks raises
    low = rk._round_randomized(cores, 4, 4, qr_method="cholqr1", generator=g,
                               precision="default", gram_precision="high")
    assert all(torch.isfinite(c).all() for c in low)
    with pytest.raises(ValueError, match="precision"):
        rk._round_randomized(cores, 4, 4, precision="bf8")
    with pytest.raises(ValueError, match="precision"):
        rk._round_randomized(cores, 4, 4, gram_precision="tf32")
    with pytest.raises(ValueError, match="qr_method"):
        rk._round_randomized(cores, 4, 4, qr_method="none")


def test_tt_round_randomized_is_the_householder_sweep():
    """ops.tt_round_randomized (the JAX package's tt_kernels.py:2097
    entry): the full-precision Householder sweep with oversample 8 and
    the default sketch, quasi-optimal against the svd rounding."""
    from xerus_tpu_torch import ops
    cores = _torch(_tt(8, 2, 8, 5))
    got = ops.tt_round_randomized(cores, 4)
    want = rk._round_randomized(cores, 4, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    exact = _dense([c.numpy() for c in cores])
    svd = rk.tt_round_sweep_segmented(cores, 4, method="svd")
    e_svd = np.linalg.norm(_dense([c.numpy() for c in svd]) - exact)
    e_rnd = np.linalg.norm(_dense([c.numpy() for c in got]) - exact)
    assert e_rnd <= 6 * e_svd + 1e-12


def test_flop_counts_match_reference():
    shapes = [c.shape for c in bench_round_instance(12, 2, 32, 1)]
    assert rk.round_flops(shapes, 16) == jtk.round_flops(shapes, 16)
    assert (rk.randomized_round_flops(shapes, 16, 8)
            == jtk.randomized_round_flops(shapes, 16, 8))
    for m, n in ((64, 32), (32, 64)):
        assert rk._qr_flops(m, n) == jtk._qr_flops(m, n)
        assert rk._svd_flops(m, n) == jtk._svd_flops(m, n)


def test_bench_helpers_match_bench_py():
    """The instance, the cliff variant, the f64 chain and the log-norm
    reproduce bench.py's (d=12 keeps the f64 chain quick)."""
    import bench
    ref = bench._make_cores(np.random.Generator(np.random.PCG64(0xBAADF00D)),
                            12, 2, 32, np.float32)
    mine = bench_round_instance(12, 2, 32)
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(mine, ref))
    out_ref = bench.cpu_round_sweep(ref, 16)
    out = cpu_round_sweep(mine, 16)
    assert host_tt_log_norm(out) == bench._host_tt_log_norm(out_ref)
    cl = cliff_instance(mine, 12)
    assert all(np.all(np.abs(c[12:]) <= 1e-6 * np.abs(m[12:]) + 1e-30)
               for c, m in zip(cl, mine))


@pytest.mark.parametrize("method", ["svd", "gram", "subspace", "gemm_exact",
                                    "randomized"])
def test_small_slice_log_norms_match_reference(method):
    """The slice at small size (d=10, rank 16 -> 8, f32): every method's
    log-norm agrees with the reference's on the same f32 cores, and the
    deterministic ones with the f64 chain."""
    host = bench_round_instance(10, 2, 16, 0xBAADF00D)
    jc = [jnp.asarray(c, jnp.float32) for c in host]
    tc = list(cores_to_torch(host, CPU))
    with jax.enable_x64(False):
        if method == "randomized":
            sk = _jax_sketches(jc, 8, 8)
            j = jtk._round_randomized(tuple(jc), None, 8, 8,
                                      qr_method="cholqr1")
        else:
            j = jtk.tt_round_sweep_segmented(jc, 8, method=method)
        j = [np.asarray(c, np.float64) for c in j]
    if method == "randomized":
        t = rk._round_randomized(tc, 8, 8, qr_method="cholqr1",
                                 sketches=[torch.from_numpy(s) for s in sk])
    else:
        t = rk.tt_round_sweep_segmented(tc, 8, method=method)
    t = [c.numpy().astype(np.float64) for c in t]
    lj, lt = host_tt_log_norm(j), host_tt_log_norm(t)
    assert abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
    if method in ("svd", "gemm_exact"):
        l64 = host_tt_log_norm(cpu_round_sweep(host, 8))
        assert abs(lt - l64) <= 2e-4 * abs(l64)


@pytest.mark.slow
def test_gemm_exact_oracles_f64():
    """The reference's f64 oracles (tests/test_kernels.py): gemm_exact
    against the SVD chain at rtol 1e-8 on three instance families, exact
    reproduction of a representable TT, and the rank-deficient case."""
    for dims, r, tgt, seed in (((3,) * 6, 8, 4, 11), ((2,) * 10, 8, 4, 12),
                               ((4,) * 5, 12, 5, 13)):
        rng = np.random.default_rng(seed)
        d = len(dims)
        cores = [rng.standard_normal((1 if i == 0 else r, dims[i],
                                      1 if i == d - 1 else r))
                 for i in range(d)]
        e_svd = host_tt_distance(cores, _tround(cores, tgt, "svd"))
        e_ge = host_tt_distance(cores, _tround(cores, tgt, "gemm_exact"))
        np.testing.assert_allclose(e_ge, e_svd, rtol=1e-8)
    cores = _tt(8, 2, 4, 14)
    out = _tround(cores, 4, "gemm_exact")
    assert host_tt_distance(cores, out) < 1e-10 * np.linalg.norm(
        _dense(cores))
    # rank-deficient input (keep above the true rank)
    rng = np.random.default_rng(15)
    small = [rng.standard_normal((1 if i == 0 else 3, 3, 1 if i == 4 else 3))
             for i in range(5)]
    padded = [np.pad(c, ((0, 0 if i == 0 else 2), (0, 0),
                         (0, 0 if i == 4 else 2)))
              for i, c in enumerate(small)]
    out = _tround(padded, 5, "gemm_exact")
    assert host_tt_distance(small, out) < 1e-10 * np.linalg.norm(
        _dense(small))
