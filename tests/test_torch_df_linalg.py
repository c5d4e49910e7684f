"""The port's double-word linear algebra (xerus_tpu_torch.ops.df_cholesky,
df_eigh, df_rounding) held against xerus_tpu's and float64 on the CPU.

The cases of tests/test_df32.py at their sizes and bars: df Cholesky
residual 1e-12 (to kappa 1e12), the kappa=1e10 solve 1e-10 where the f32
factorization fails, df_eigh eigenvalues 1e-12 of the spectral scale,
residuals 1e-10 and orthogonality 1e-8, df_svd singular values 1e-11,
df_svd_jw's small-sigma floor 5e-8.  Against the JAX package: the same
functions on the same inputs, compared through eigenvalues, singular
values, factors and solutions, never eigenvectors (the seed's signs).
On the CPU the port seeds df_eigh with the LAPACK syevd that JAX's CPU
eigh calls, so its spectra are JAX's to 1e-13 of the scale.  tt_round_df
is held to the float64 object round() (1e-11) at d=7 in the default tier
without JAX, and to JAX's own at d=4 in the slow tier (JAX compiles one
program per site shape: about 30 s)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import xerus_tpu_torch as xt
from xerus_tpu.ops import df32 as jdf
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops import df_rounding as tround

# both packages' ops/__init__ export functions under these module names
jchol = importlib.import_module("xerus_tpu.ops.df_cholesky")
jeig = importlib.import_module("xerus_tpu.ops.df_eigh")
tchol = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
teig = importlib.import_module("xerus_tpu_torch.ops.df_eigh")

CPU = torch.device("cpu")


def _t(x):
    return tdf.df_from_f64(x, CPU)


def _j(x):
    return tuple(jnp.asarray(v) for v in jdf.df_from_f64(x))


def _tf(pair):
    return tdf.df_to_f64(*pair)


def _jf(pair):
    return jdf.df_to_f64(np.asarray(pair[0]), np.asarray(pair[1]))


def _spd(n, kappa, seed=7):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.logspace(0, -np.log10(kappa), n)
    return (Q * lam) @ Q.T


@pytest.mark.parametrize("n,kappa,block", [(96, 1e4, 64), (128, 1e12, 64),
                                           (100, 1e6, 64)])
def test_df_cholesky_residual_and_factor(n, kappa, block):
    """Residual 1e-12 past the f32 wall; n=100 takes the identity-tail
    padding.  The factor is unique: JAX's within 1e-12 of its norm where
    kappa(L) = 1e2, 1e3."""
    A = _spd(n, kappa)
    L = _tf(tchol.df_cholesky(*_t(A), block=block))
    assert L.shape == (n, n)
    assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) < 1e-12
    if kappa <= 1e6:
        J = _jf(jchol.df_cholesky(*_j(A), block=block))
        assert np.linalg.norm(L - J) / np.linalg.norm(J) < 1e-12


def test_df_solve_spd_chol_beyond_f32_wall():
    """kappa=1e10: the plain f32 factorization fails, the df-Cholesky
    solve reaches 1e-10, as does JAX's."""
    rng = np.random.default_rng(3)
    n = 128
    A = _spd(n, 1e10)
    b = A @ rng.normal(size=n)
    x = _tf(tchol.df_solve_spd_chol(*_t(A), *_t(b)))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10
    xj = _jf(jchol.df_solve_spd_chol(*_j(A), *_j(b)))
    assert np.linalg.norm(A @ xj - b) / np.linalg.norm(b) < 1e-10
    # the f32-factorization solve does not: JAX's gives NaN, the port's
    # (cholesky_ex, no host check) runs on from the failed factor
    old = _tf(tdf.df_solve_spd_refined(*_t(A), *_t(b)))
    assert not np.linalg.norm(A @ old - b) / np.linalg.norm(b) < 1e-2
    solve = tchol.make_df_solve_spd_chol(n, "float32")
    np.testing.assert_array_equal(_tf(solve(*_t(A), *_t(b))), x)


@pytest.mark.parametrize("n,spread", [(64, 1.0), (128, 4.0)])
def test_df_eigh_f64_quality_and_jax_spectrum(n, spread):
    rng = np.random.default_rng(1)
    if n == 128:
        rng.normal(size=(64, 64))
        rng.uniform(-1, 1, size=64)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam_true = np.sort(rng.uniform(-1, 1, size=n)) * 10 ** spread
    A = (Q * lam_true) @ Q.T
    wh, wl, Vh, Vl = teig.df_eigh(*_t(A))
    w, V = _tf((wh, wl)), _tf((Vh, Vl))
    scale = np.abs(lam_true).max()
    assert np.abs(np.sort(w) - lam_true).max() / scale < 1e-12
    assert np.linalg.norm(A @ V - V * w[None, :]) / np.linalg.norm(A) < 1e-10
    assert np.linalg.norm(V.T @ V - np.eye(n)) < 1e-8
    out = jeig.df_eigh(*_j(A))
    wj = _jf(out[:2])
    assert np.abs(np.sort(w) - np.sort(wj)).max() / scale < 1e-13


def test_df_eigh_degenerate_cluster():
    """An exactly 8-fold eigenvalue: V stays orthonormal, residual at df
    level (any orthonormal basis of the cluster is valid)."""
    rng = np.random.default_rng(5)
    n = 48
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([np.full(8, 2.0), np.linspace(3, 50, n - 8)])
    A = (Q * lam) @ Q.T
    wh, wl, Vh, Vl = teig.df_eigh(*_t(A))
    w, V = _tf((wh, wl)), _tf((Vh, Vl))
    assert np.abs(np.sort(w) - np.sort(lam)).max() / 50 < 1e-12
    assert np.linalg.norm(A @ V - V * w[None, :]) / np.linalg.norm(A) < 1e-10
    assert np.linalg.norm(V.T @ V - np.eye(n)) < 1e-8
    # the cluster's projector is gauge-free: JAX's within 1e-10
    Vj = _jf(jeig.df_eigh(*_j(A))[2:])
    P = V[:, :8] @ V[:, :8].T
    Pj = Vj[:, :8] @ Vj[:, :8].T
    assert np.linalg.norm(P - Pj) < 1e-10


@pytest.mark.parametrize("m,n,spread", [(96, 64, 2.0), (256, 128, 3.0)])
def test_df_svd_separated_spectrum(m, n, spread):
    rng = np.random.default_rng(2)
    if m == 256:
        rng.normal(size=(96, 64))
        rng.normal(size=(64, 64))
    U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s_true = np.linspace(1.0, 10.0 ** -spread, n)
    A = (U0 * s_true) @ V0.T
    Uh, Ul, sh, sl, Vh, Vl = teig.df_svd(*_t(A))
    s, U, V = _tf((sh, sl)), _tf((Uh, Ul)), _tf((Vh, Vl))
    assert np.abs(s - s_true).max() < 1e-11
    assert np.linalg.norm((U * s) @ V.T - A) / np.linalg.norm(A) < 1e-11
    assert np.linalg.norm(V.T @ V - np.eye(n)) < 1e-8
    # the Gram route's sigma error is ~u_df sigma_max^2 / sigma: 5e-13 at
    # the smallest sigma, 1e-3
    sj = _jf(jeig.df_svd(*_j(A))[2:4])
    assert np.abs(s - sj).max() < 1e-12


def test_df_svd_clustered_tail_degrades_gracefully():
    rng = np.random.default_rng(4)
    m, n = 128, 64
    U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s_true = np.sort(10 ** rng.uniform(-4, 0, size=n))[::-1]
    A = (U0 * s_true) @ V0.T
    Uh, Ul, sh, sl, Vh, Vl = teig.df_svd(*_t(A))
    s, U, V = _tf((sh, sl)), _tf((Uh, Ul)), _tf((Vh, Vl))
    assert np.isfinite(U).all() and np.isfinite(V).all()
    assert np.linalg.norm((U * s) @ V.T - A) / np.linalg.norm(A) < 1e-2
    assert np.abs(s[:16] - s_true[:16]).max() < 1e-11


def test_df_svd_jw_small_sigma_accuracy():
    """Jordan-Wielandt: the whole spectrum within 5e-8 absolute, the
    dominant one df-accurate, 1e-2x the Gram route's error at sigma
    ~ 1e-8, orthonormal live blocks; JAX's singular values within
    1e-13."""
    rng = np.random.default_rng(7)
    m, n = 48, 40
    s_true = np.logspace(0, -12, n)
    U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (U0 * s_true) @ V0.T
    Uh, Ul, sh, sl, Vh, Vl = teig.df_svd_jw(*_t(A))
    s, U, V = _tf((sh, sl)), _tf((Uh, Ul)), _tf((Vh, Vl))
    assert np.abs(s - s_true).max() < 5e-8
    assert np.abs(s[:12] - s_true[:12]).max() < 1e-11
    g = _tf(teig.df_svd(*_t(A))[2:4])
    k = 25
    assert np.abs(s[k] - s_true[k]) < 1e-2 * np.abs(g[k] - s_true[k])
    live = s > 1e-6 * s.max()
    eye = np.eye(int(live.sum()))
    assert np.linalg.norm(U[:, live].T @ U[:, live] - eye, ord=2) < 5e-3
    assert np.linalg.norm(V[:, live].T @ V[:, live] - eye, ord=2) < 5e-3
    assert np.linalg.norm((U * s) @ V.T - A) / np.linalg.norm(A) < 1e-6
    sj = _jf(jeig.df_svd_jw(*_j(A))[2:4])
    assert np.abs(s - sj).max() < 1e-13


def _dense(cs):
    out = np.asarray(cs[0])
    for c in cs[1:]:
        out = np.tensordot(out, np.asarray(c), axes=([out.ndim - 1], [0]))
    return out.squeeze()


def _tt_pair(pkg, d):
    pkg.set_seed(11)
    a = pkg.TTTensor.random([3] * d, 3)
    a /= a.frob_norm()
    b = pkg.TTTensor.random([3] * d, 3)
    b /= b.frob_norm()
    return [np.asarray(c.to_ndarray()) for c in (a + 1e-9 * b).components]


def test_tt_round_df_matches_f64_oracle():
    """test_df32.py's oracle at d=7 on the port alone: the float64 object
    round(3) within 1e-11, and eps=1e-7 drops the 1e-9 tail that f32
    cannot see (ranks 3, within 1e-8 of the unrounded TT)."""
    with xt.host():
        cores64 = _tt_pair(xt, 7)
        t2 = xt.TTTensor._make([xt.Tensor.from_ndarray(c.copy())
                                for c in cores64])
        t2.round(3)
        oracle = _dense([np.asarray(c.to_ndarray()) for c in t2.components])
        reads = tround.host_bool.reads
        got = _dense(tround.tt_round_df_from_f64(cores64, 3))
        # a spectrum per truncation, and one read of the CGS2 sites (the
        # defect selects on the device, as the reference's lax.cond)
        assert tround.host_bool.reads - reads == (7 - 1) + 1
        out2 = tround.tt_round_df_from_f64(cores64, 6, eps=1e-7)
    assert np.linalg.norm(got - oracle) / np.linalg.norm(oracle) < 1e-11
    assert max(c.shape[0] for c in out2[1:]) == 3
    assert np.linalg.norm(_dense(out2) - _dense(cores64)) < 1e-8


@pytest.mark.slow
def test_tt_round_df_matches_jax_tt_round_df():
    """JAX's own tt_round_df on the d=4 pair: the same tensor within 1e-12
    of its norm."""
    import xerus_tpu as xe
    from xerus_tpu.ops.df_rounding import tt_round_df_from_f64
    cores64 = _tt_pair(xe, 4)
    want = _dense(tt_round_df_from_f64(cores64, 3))
    got = _dense(tround.tt_round_df_from_f64(cores64, 3, device=CPU))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
