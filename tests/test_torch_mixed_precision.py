"""The port's mixed-precision ALS (xerus_tpu_torch.ops.mixed_precision)
held against xerus_tpu.ops.mixed_precision on the CPU: the df QR, one df
half-sweep from identical df cores, and the whole f32 + df solve driven as
bench.py drives the north-star instance, at a small size."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xerus_tpu.ops import df32 as jdf
from xerus_tpu.ops import mixed_precision as jmp
from xerus_tpu.ops.tt_kernels import jit_f32
from xerus_tpu_torch.convert import cores_to_df, cores_to_torch, df_to_numpy
from xerus_tpu_torch.examples import host_poisson_residual, qtt_poisson_instance
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops import mixed_precision as tmp

CPU = torch.device("cpu")
SEED = 0xBAADF00D


def full_tensor(cores):
    t = np.ones((1, 1))
    for c in cores:
        t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape(-1)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _qr_both(a):
    (qh, ql), (rh, rl) = tmp.df_qr(*tdf.df_from_f64(a, CPU))
    (jqh, jql), _ = jmp.df_qr(*jdf.df_from_f64(a))
    return (tdf.df_to_f64(qh, ql), tdf.df_to_f64(rh, rl),
            jdf.df_to_f64(np.asarray(jqh), np.asarray(jql)))


def test_df_qr_orthogonal_and_reconstructs():
    a = np.random.Generator(np.random.PCG64(1)).normal(size=(60, 30))
    Q, R, jQ = _qr_both(a)
    assert np.linalg.norm(Q.T @ Q - np.eye(30)) <= 1e-13
    assert np.linalg.norm(Q @ R - a) / np.linalg.norm(a) <= 1e-13
    assert np.abs(np.tril(R, -1)).max() == 0.0
    # CGS2 fixes the signs (positive R diagonal): Q itself is comparable
    assert np.abs(Q - jQ).max() <= 1e-13


def test_df_qr_rank_deficient_column():
    """Deficient columns take the projected canonical vector: the frame
    stays orthonormal, R's diagonal keeps the ~0 norm."""
    base = np.random.Generator(np.random.PCG64(2)).normal(size=(20, 2))
    a = np.concatenate([base, base[:, :1] * 2.0, base,
                        np.zeros((20, 1))], axis=1)               # rank 2
    Q, R, jQ = _qr_both(a)
    assert np.linalg.norm(Q.T @ Q - np.eye(6)) <= 1e-13
    assert np.linalg.norm(Q @ R - a) / np.linalg.norm(a) <= 1e-13
    assert np.all(np.abs(np.diag(R)[2:]) < 1e-12)
    assert np.abs(Q - jQ).max() <= 1e-12


def test_df_tensordot_div_sqrt():
    rng = np.random.Generator(np.random.PCG64(3))
    a, b = rng.normal(size=(4, 5, 6)), rng.normal(size=(6, 5, 3))
    out = tmp.df_tensordot(tdf.df_from_f64(a, CPU), tdf.df_from_f64(b, CPU),
                           axes=([2, 1], [0, 1]))
    ref = np.tensordot(a, b, axes=([2, 1], [0, 1]))
    assert _rel(tdf.df_to_f64(*out), ref) < 1e-13
    x, y = rng.uniform(0.5, 2.0, 50), rng.uniform(0.5, 2.0, 50)
    q = tdf.df_to_f64(*tmp.df_div(*tdf.df_from_f64(x, CPU),
                                  *tdf.df_from_f64(y, CPU)))
    s = tdf.df_to_f64(*tmp.df_sqrt(*tdf.df_from_f64(x, CPU)))
    assert np.abs(q / (x / y) - 1).max() < 1e-13
    assert np.abs(s / np.sqrt(x) - 1).max() < 1e-13
    n = tdf.df_to_f64(*tmp.df_norm_vec(*tdf.df_from_f64(x, CPU)))
    assert abs(n / np.linalg.norm(x) - 1) < 1e-13


def test_df_half_sweep_matches_reference():
    """One df half-sweep from identical df cores (the right-canonical f64
    start split into hi/lo): represented tensor within 1e-12."""
    xs, A, b = qtt_poisson_instance(6, 4, SEED)
    jx = tuple(jdf.df_from_f64(c) for c in xs)
    jA = tuple(jdf.df_from_f64(c) for c in A)
    jb = tuple(jdf.df_from_f64(c) for c in b)
    jout = jit_f32(jmp._als_half_sweep_df)(jx, jA, jb)
    tout = tmp._als_half_sweep_df(cores_to_df(xs, CPU), cores_to_df(A, CPU),
                                  cores_to_df(b, CPU))
    jfull = full_tensor([jdf.df_to_f64(np.asarray(h), np.asarray(l))
                         for h, l in jout])
    tfull = full_tensor(df_to_numpy(tout))
    assert _rel(tfull, jfull) <= 1e-12
    # the sweep solved something: the residual is at the df floor
    assert host_poisson_residual(df_to_numpy(tout), A, b) < 1e-12


def test_reverse_df_is_exact_involution():
    xs, A, _ = qtt_poisson_instance(5, 3, SEED)
    for cores, op in ((cores_to_df(xs, CPU), False),
                      (cores_to_df(A, CPU), True)):
        back = tmp._reverse_df(tmp._reverse_df(cores, op=op), op=op)
        for (h, l), (h2, l2) in zip(cores, back):
            assert torch.equal(h, h2) and torch.equal(l, l2)


def _whole_run(d, rank, max_f32=16, df_sweeps=2):
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    # the reference, driven as bench.py:_e2e_poisson_row drives it
    x32 = tuple(jnp.asarray(c.astype(np.float32)) for c in xs)
    A32 = tuple(jnp.asarray(c.astype(np.float32)) for c in A)
    b32 = tuple(jnp.asarray(c.astype(np.float32)) for c in b)
    run = jmp.make_als_f32_df_run(tuple(tuple(c.shape) for c in x32),
                                  "float32", max_f32, df_sweeps)
    jout, jhist, jcnt = run(x32, A32, b32,
                            tuple(jdf.df_from_f64(c) for c in A),
                            tuple(jdf.df_from_f64(c) for c in b))
    jsol = [jdf.df_to_f64(np.asarray(h), np.asarray(l)) for h, l in jout]
    tout, thist, tcnt = tmp.als_f32_df_run(
        cores_to_torch(xs, CPU), cores_to_torch(A, CPU), cores_to_torch(b, CPU),
        cores_to_df(A, CPU), cores_to_df(b, CPU), max_f32, df_sweeps)
    tsol = df_to_numpy(tout)
    assert tcnt == int(jcnt)
    assert tcnt % 2 == 0 and 0 < tcnt <= max_f32
    assert np.all(np.isfinite(thist.numpy()[:tcnt]))
    assert np.all(np.isinf(thist.numpy()[tcnt:]))
    assert host_poisson_residual(jsol, A, b) <= 1e-10
    assert host_poisson_residual(tsol, A, b) <= 1e-10
    assert _rel(full_tensor(tsol), full_tensor(jsol)) <= 1e-9


def test_als_f32_df_run_matches_reference_small():
    _whole_run(4, 2)


@pytest.mark.slow
def test_als_f32_df_run_matches_reference():
    _whole_run(8, 5)


def test_als_f32_df_run_odd_cap_stays_finite():
    """An odd f32 cap rounds down to even: the df phase needs the core at
    site 0 (an lr-ended state breaks its canonicalization)."""
    xs, A, b = qtt_poisson_instance(5, 3, SEED)
    for cap in (1, 3):
        out, _, cnt = tmp.als_f32_df_run(
            cores_to_torch(xs, CPU), cores_to_torch(A, CPU),
            cores_to_torch(b, CPU), cores_to_df(A, CPU), cores_to_df(b, CPU),
            cap, 1)
        assert cnt % 2 == 0
        assert all(bool(torch.isfinite(h).all()) for h, _ in out)
