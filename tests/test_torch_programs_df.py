"""The double-word stack's programs (ops/programs.py) on the CPU, where a
program runs its function eagerly: the df rounding's three site programs
(make_qr_apply, make_svd_site, make_trunc_apply), make_df_eigh and
make_df_solve_spd_chol return their plain functions' results bit for bit;
qr_apply's device-side select returns the branch the defect picks, as
the reference's lax.cond does, on a panel that takes CGS2 and one that
does not; df_eigh seeded by K4's plain version (the card's seed) matches
the LAPACK-seeded one and, in the slow tier, the JAX package's.  Inputs
from numpy seeds; each test states its tolerance.  The JAX comparisons
run the JAX functions unjitted, which takes 10-20 s of op dispatch on
this host: they are in the slow tier."""

import importlib

import numpy as np
import pytest
import torch

from xerus_tpu_torch.examples import bench_round_instance
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops import mixed_precision as tmp
from xerus_tpu_torch.ops import programs as pg
from xerus_tpu_torch.ops import small_eig as se

# ops/__init__ exports functions under these module names
tchol = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
teig = importlib.import_module("xerus_tpu_torch.ops.df_eigh")
tround = importlib.import_module("xerus_tpu_torch.ops.df_rounding")

CPU = torch.device("cpu")
SEED = 0xBAADF00D


def _same(a, b):
    """Trees of tensors equal bit for bit."""
    la, lb = pg._leaves(a), pg._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _df(x):
    return tdf.df_from_f64(x, CPU)


def _panel(m, r, kappa, seed):
    """An (m, r) panel with singular values from 1 down to 1 / kappa."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(m, r)))
    V, _ = np.linalg.qr(rng.normal(size=(r, r)))
    return (U * np.logspace(0, -np.log10(kappa), r)) @ V.T


def _tt_sum(a, b, beta):
    """The cores of the TT a + beta b (block-diagonal interior cores)."""
    d = len(a)
    out = [np.concatenate([a[0], beta * b[0]], axis=2)]
    for x, y in zip(a[1:d - 1], b[1:d - 1]):
        z = np.zeros((x.shape[0] + y.shape[0], x.shape[1],
                      x.shape[2] + y.shape[2]))
        z[:x.shape[0], :, :x.shape[2]] = x
        z[x.shape[0]:, :, x.shape[2]:] = y
        out.append(z)
    return out + [np.concatenate([a[-1], b[-1]], axis=0)]


def _sym(n, seed):
    """A symmetric (n, n) matrix with eigenvalues spread over [-3, 7],
    gaps about 0.43 (distinct, so eigenvectors compare up to sign)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.linspace(-3.0, 7.0, n) + 0.05 * rng.normal(size=n)
    return (Q * lam) @ Q.T, np.sort(lam)


# kappa 10 keeps CholeskyQR (defect ~ u_df kappa^2); 1e7 defeats it
PANELS = [("cholqr", 10.0, False), ("cgs2", 1e7, True)]


@pytest.mark.parametrize("name,kappa,takes_cgs2", PANELS)
def test_qr_apply_select_is_the_branch_the_defect_picks(name, kappa,
                                                        takes_cgs2):
    """make_qr_apply's program returns the CGS2 branch (df_qr) where the
    df orthogonality defect of CholeskyQR's Q exceeds CGS2_DEFECT and the
    CholeskyQR branch elsewhere, bit for bit, and its flag says which."""
    M = _df(_panel(24, 8, kappa, 5))
    N = _df(np.random.default_rng(6).normal(size=(8, 12)))
    args = M + N
    Qh, Ql, Ph, Pl, took = pg.call(tround.make_qr_apply, args)
    assert bool(took) is takes_cgs2
    Ch, Cl, Rh, Rl = tround._df_qr_chol(*M)
    Gh, Gl = tround.ozaki_matmul(Ch.T, Cl.T, Ch, Cl)
    defect = torch.linalg.vector_norm((Gh - torch.eye(8)) + Gl)
    assert bool(defect > tround.CGS2_DEFECT) is takes_cgs2
    if takes_cgs2:
        (Ch, Cl), (Rh, Rl) = tmp.df_qr(*M)
    assert _same((Qh, Ql), (Ch, Cl))
    assert _same((Ph, Pl), tround.ozaki_matmul(Rh, Rl, *N))
    assert _same((Qh, Ql, Ph, Pl, took), tround._qr_apply(*args))


def test_site_programs_are_the_plain_functions():
    """make_svd_site and make_trunc_apply (keyed by keep) return
    df_svd of the transposed unfolding and the truncation step, bit for
    bit."""
    M = _df(np.random.default_rng(7).normal(size=(6, 16)))
    out = pg.call(tround.make_svd_site, M)
    assert _same(out, teig.df_svd(M[0].T, M[1].T))
    prev = _df(np.random.default_rng(8).normal(size=(10, 6)))
    args = tuple(out[i] for i in (0, 1, 4, 5, 2, 3)) + prev
    got = pg.call(tround.make_trunc_apply, args, 4)
    assert _same(got, tround._trunc_apply(4, *args))
    assert got[0].shape == (4, 16)


def test_tt_round_df_programs_equal_eager_and_count_cgs2_once():
    """tt_round_df through its programs equals its eager run bit for bit
    on a rank-16 d=8 TT with a 1e-9 tail (some sites take CGS2, some do
    not); each call reads d - 1 spectra and the CGS2 count once."""
    cores = _tt_sum(bench_round_instance(8, 2, 16, SEED),
                    bench_round_instance(8, 2, 16, SEED + 1), 1e-9)
    runs = []
    for eager in (True, False):
        fb0, reads0 = (tround.tt_round_df.cgs2_fallbacks,
                       tround.host_bool.reads)
        runs.append((tround.tt_round_df_from_f64(cores, 16, device=CPU,
                                                 eager=eager),
                     tround.tt_round_df.cgs2_fallbacks - fb0,
                     tround.host_bool.reads - reads0))
    (a, fa, ra), (b, fb, rb) = runs
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert fa == fb and 0 < fa < 7
    assert ra == rb == 7 + 1


def test_df_solve_and_df_eigh_programs_are_the_plain_functions():
    """make_df_solve_spd_chol (keyed by n, dtype, block, refinement steps)
    and make_df_eigh return df_solve_spd_chol's and df_eigh's results bit
    for bit."""
    A, _ = _sym(40, 9)
    A = A @ A.T + np.eye(40)
    b = np.random.default_rng(10).normal(size=40)
    args = _df(A) + _df(b)
    prog = tchol.make_df_solve_spd_chol(40, "float32", 16, 2)
    assert isinstance(prog, pg.Program)
    assert _same(prog(*args), tchol.df_solve_spd_chol(*args, block=16,
                                                      refine_iters=2))
    S = _df(_sym(12, 11)[0])
    assert _same(teig.make_df_eigh(12, "float32", 3)(*S),
                 teig.df_eigh(*S, iters=3))


def _k4_seeded_df_eigh(monkeypatch, Ah, Al):
    monkeypatch.setattr(teig, "_seed_eigh", teig._k4_seed)
    return teig.df_eigh(Ah, Al)


@pytest.mark.parametrize("n", [3, 24, 32])
def test_k4_seeded_df_eigh_matches_the_lapack_seeded(monkeypatch, n):
    """df_eigh seeded by K4's plain version (the card's seed; route cta up
    to 32) against df_eigh seeded by LAPACK's syevd (the JAX package's CPU
    seed): ascending eigenvalues within 1e-13 of the largest, and every
    eigenvector's direction (1 - |v . u| within 1e-12; distinct
    eigenvalues, so the subspaces are lines)."""
    A, lam = _sym(n, 12 + n)
    assert se.eigh_plan(n).route == se.CTA
    ref = teig.df_eigh(*_df(A))
    got = _k4_seeded_df_eigh(monkeypatch, *_df(A))
    w, wr = tdf.df_to_f64(got[0], got[1]), tdf.df_to_f64(ref[0], ref[1])
    V, Vr = tdf.df_to_f64(got[2], got[3]), tdf.df_to_f64(ref[2], ref[3])
    scale = np.abs(lam).max()
    assert np.all(np.diff(w) > 0)
    assert np.abs(w - wr).max() <= 1e-13 * scale
    assert np.abs(w - lam).max() <= 1e-13 * scale
    assert np.max(1.0 - np.abs(np.sum(V * Vr, axis=0))) <= 1e-12


def test_k4_seed_is_nan_where_k4_fails():
    """A matrix K4 reports failed (a NaN entry) seeds NaN, as
    jnp.linalg.eigh gives, with no host read."""
    A = torch.eye(4)
    A[1, 2] = A[2, 1] = float("nan")
    w, V = teig._k4_seed(A)
    assert torch.isnan(w).all() and torch.isnan(V).all()


# -- against the JAX package, unjitted (slow tier: op dispatch) -----------

@pytest.mark.slow
@pytest.mark.parametrize("name,kappa,takes_cgs2", PANELS)
def test_qr_apply_matches_jax_lax_cond(name, kappa, takes_cgs2):
    """The port's qr_apply against the JAX package's _jit_qr_apply run
    unjitted (its lax.cond evaluated eagerly): the same branch (the JAX
    defect read through its own CholeskyQR), Q within 1e-12 and
    R @ next within 1e-13 of ||M|| ||next||."""
    import jax
    import jax.numpy as jnp
    from xerus_tpu.ops import df32 as jdf
    from xerus_tpu.ops.ozaki import ozaki_matmul as jozaki
    jround = importlib.import_module("xerus_tpu.ops.df_rounding")
    M64 = _panel(24, 8, kappa, 5)
    N64 = np.random.default_rng(6).normal(size=(8, 12))
    got = tround._qr_apply(*_df(M64), *_df(N64))
    jargs = [jnp.asarray(v) for v in jdf.df_from_f64(M64)
             + jdf.df_from_f64(N64)]
    with jax.disable_jit():
        want = jround._jit_qr_apply((24, 8), (8, 12), "float32")(*jargs)
        Qh, Ql, _, _ = jround._df_qr_chol(*jargs[:2])
        Gh, Gl = jozaki(Qh.T, Ql.T, Qh, Ql)
        defect = float(jnp.linalg.norm((Gh - jnp.eye(8)) + Gl))
    assert (defect > 1e-11) is takes_cgs2 is bool(got[4])

    def f64(h, l):
        return jdf.df_to_f64(np.asarray(h), np.asarray(l))
    assert np.abs(tdf.df_to_f64(got[0], got[1])
                  - f64(want[0], want[1])).max() <= 1e-12
    assert np.abs(tdf.df_to_f64(got[2], got[3]) - f64(want[2], want[3])) \
        .max() <= 1e-13 * np.linalg.norm(M64) * np.linalg.norm(N64)


@pytest.mark.slow
def test_k4_seeded_df_eigh_matches_jax(monkeypatch):
    """df_eigh seeded by K4's plain version against the JAX package's
    df_eigh at n=24: eigenvalues within 1e-13 of the largest, the same
    ascending order, and each eigenvector's direction within 1e-12."""
    import jax.numpy as jnp
    from xerus_tpu.ops import df32 as jdf
    jeig = importlib.import_module("xerus_tpu.ops.df_eigh")
    A, lam = _sym(24, 36)
    got = _k4_seeded_df_eigh(monkeypatch, *_df(A))
    want = jeig.df_eigh(*[jnp.asarray(v) for v in jdf.df_from_f64(A)])
    w = tdf.df_to_f64(got[0], got[1])
    wj = jdf.df_to_f64(np.asarray(want[0]), np.asarray(want[1]))
    V = tdf.df_to_f64(got[2], got[3])
    Vj = jdf.df_to_f64(np.asarray(want[2]), np.asarray(want[3]))
    assert np.abs(w - wj).max() <= 1e-13 * np.abs(lam).max()
    assert np.all(np.diff(w) > 0) and np.all(np.diff(wj) > 0)
    assert np.max(1.0 - np.abs(np.sum(V * Vj, axis=0))) <= 1e-12
