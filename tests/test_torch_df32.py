"""The port's df32 arithmetic (xerus_tpu_torch.ops.df32) held against the
JAX package's (xerus_tpu.ops.df32) and against float64, on the CPU."""

import numpy as np
import pytest
import torch

from xerus_tpu.ops import df32 as jdf
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops.df_matvec import df_matvec as df_matvec_wrapper

CPU = torch.device("cpu")


def _rand(shape, seed):
    return np.random.Generator(np.random.PCG64(seed)).normal(size=shape)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_f64(pair):
    return tdf.df_to_f64(*pair)


def _jax_f64(pair):
    return jdf.df_to_f64(np.asarray(pair[0]), np.asarray(pair[1]))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


def test_two_prod_matches_reference_and_exact_product():
    """p + err against the exact product (an f32 x f32 product is exact in
    f64).  The masked-split two_prod rounds its error sum e1 + e2 + q4
    twice, so it is exact only to O(u^2 |ab|) (the reference's docstring
    bound): on these 10^4 pairs 31 differ, by at most 1.03e-14 relative.
    The port runs the reference's operations in the reference's order, so
    it agrees with it bit for bit."""
    rng = np.random.Generator(np.random.PCG64(5))
    a = (rng.normal(size=10_000) * np.exp2(rng.integers(-30, 30, 10_000))
         ).astype(np.float32)
    b = (rng.normal(size=10_000) * np.exp2(rng.integers(-30, 30, 10_000))
         ).astype(np.float32)
    p, err = tdf.two_prod(_t(a), _t(b))
    got = p.numpy().astype(np.float64) + err.numpy().astype(np.float64)
    exact = a.astype(np.float64) * b.astype(np.float64)
    assert np.max(np.abs(got - exact) / np.abs(exact)) <= 2.0 ** -45
    assert np.mean(got == exact) > 0.99
    jp, jerr = jdf.two_prod(a, b)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def test_split_f64_is_exact():
    a = _rand((1000,), 6)
    hi, lo = tdf._split(_t(a))
    np.testing.assert_array_equal(hi.numpy() + lo.numpy(), a)
    # hi keeps at most 26 significant bits: hi*hi is exact in f64
    m, _ = np.frexp(hi.numpy())
    assert np.all(np.ldexp(m, 26) == np.round(np.ldexp(m, 26)))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_df_elementwise_matches_reference(op):
    x = _rand((500,), 7) * 3.0
    y = _rand((500,), 8)
    exact = {"add": x + y, "sub": x - y, "mul": x * y}[op]
    jfn = {"add": jdf.df_add, "sub": jdf.df_sub, "mul": jdf.df_mul}[op]
    tfn = {"add": tdf.df_add, "sub": tdf.df_sub, "mul": tdf.df_mul}[op]
    jout = _jax_f64(jfn(*jdf.df_from_f64(x), *jdf.df_from_f64(y)))
    tout = _port_f64(tfn(*tdf.df_from_f64(x, CPU), *tdf.df_from_f64(y, CPU)))
    assert _rel(tout, exact) < 1e-13
    assert _rel(jout, exact) < 1e-13
    assert _rel(tout, jout) < 1e-14


def test_df_scale_and_neg():
    x = _rand((300,), 9)
    s = np.float32(0.37)
    xh, xl = tdf.df_from_f64(x, CPU)
    got = _port_f64(tdf.df_scale(xh, xl, torch.tensor(s)))
    assert _rel(got, x * np.float64(s)) < 1e-13
    np.testing.assert_array_equal(_port_f64(tdf.df_neg(xh, xl)),
                                  -_port_f64((xh, xl)))


@pytest.mark.parametrize("shape,axis", [((37, 5), 0), ((6, 100), 1),
                                        ((4, 64, 3), 1)])
def test_df_reduce_sum_matches_reference(shape, axis):
    x = _rand(shape, 10)
    exact = x.sum(axis=axis)
    jout = _jax_f64(jdf.df_reduce_sum(*jdf.df_from_f64(x), axis=axis))
    tout = _port_f64(tdf.df_reduce_sum(*tdf.df_from_f64(x, CPU), axis=axis))
    assert _rel(tout, exact) < 1e-13
    assert _rel(jout, exact) < 1e-13
    assert _rel(tout, jout) < 1e-14


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (33, 60, 17), (60, 30, 60)])
def test_df_matmul_matches_reference(m, k, n):
    A = _rand((m, k), 11)
    B = _rand((k, n), 12)
    exact = A @ B
    jout = _jax_f64(jdf.df_matmul(*jdf.df_from_f64(A), *jdf.df_from_f64(B)))
    tout = _port_f64(tdf.df_matmul(*tdf.df_from_f64(A, CPU),
                                   *tdf.df_from_f64(B, CPU)))
    assert _rel(tout, exact) < 1e-13
    assert _rel(jout, exact) < 1e-13
    assert _rel(tout, jout) < 1e-14


def test_df_matvec_and_contract_last_first():
    A = _rand((3, 4, 20), 13)
    B = _rand((20, 5), 14)
    got = _port_f64(tdf.df_contract_last_first(*tdf.df_from_f64(A, CPU),
                                               *tdf.df_from_f64(B, CPU)))
    assert got.shape == (3, 4, 5)
    assert _rel(got, np.tensordot(A, B, axes=1)) < 1e-13
    M, v = _rand((40, 70), 15), _rand((70,), 16)
    jout = _jax_f64(jdf.df_matvec(*jdf.df_from_f64(M), *jdf.df_from_f64(v)))
    tout = _port_f64(tdf.df_matvec(*tdf.df_from_f64(M, CPU),
                                   *tdf.df_from_f64(v, CPU)))
    assert _rel(tout, M @ v) < 1e-13
    assert _rel(tout, jout) < 1e-14


def test_df_matmul_past_ozaki_gate_raises(monkeypatch):
    """Past the Ozaki gate (m*k*n >= 2^21, k >= 128, f32) df_matmul no
    longer raises: it dispatches to the Ozaki split GEMM as the JAX
    package's does (the name is kept from when the GEMM was missing), and
    returns JAX's product within test_df32.py's 1e-13 relative bar."""
    from xerus_tpu_torch.ops import ozaki
    A = _rand((128, 128), 17)
    B = _rand((128, 128), 18)
    calls = []
    real = ozaki.ozaki_matmul
    monkeypatch.setattr(ozaki, "ozaki_matmul",
                        lambda *a: calls.append(1) or real(*a))
    tout = _port_f64(tdf.df_matmul(*tdf.df_from_f64(A, CPU),
                                   *tdf.df_from_f64(B, CPU)))
    assert calls == [1]
    jout = _jax_f64(jdf.df_matmul(*jdf.df_from_f64(A), *jdf.df_from_f64(B)))
    assert np.abs(tout - jout).max() / np.abs(jout).max() < 1e-13
    assert _rel(tout, A @ B) < 1e-13
    # below the gate (k < 128) the broadcast tree runs
    tdf.df_matmul(*tdf.df_from_f64(A[:, :127], CPU),
                  *tdf.df_from_f64(B[:127], CPU))
    assert calls == [1]


def _spd(n, cond, seed):
    q, _ = np.linalg.qr(_rand((n, n), seed))
    return (q * np.logspace(0, -np.log10(cond), n)) @ q.T


@pytest.mark.parametrize("n", [64, 1030])
def test_df_solve_spd_refined(n):
    """kappa ~ 1e3 SPD solve to df accuracy; at n = 1030 (m*k >= 2^20) the
    refinement residual goes through the df_matvec wrapper, which on CPU
    tensors runs its plain version."""
    A = _spd(n, 1e3, 17)
    b = _rand((n,), 18)
    calls0 = df_matvec_wrapper.calls
    launches0 = df_matvec_wrapper.launches
    xh, xl = tdf.df_solve_spd_refined(*tdf.df_from_f64(A, CPU),
                                      *tdf.df_from_f64(b, CPU), iterations=3)
    x = tdf.df_to_f64(xh, xl)
    gated = n * n >= tdf.PALLAS_MATVEC_THRESHOLD
    assert df_matvec_wrapper.calls - calls0 == (3 if gated else 0)
    assert df_matvec_wrapper.launches == launches0     # no kernel on CPU
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-12
    if not gated:
        jx = jdf.df_to_f64(*map(np.asarray, jdf.df_solve_spd_refined(
            *jdf.df_from_f64(A), *jdf.df_from_f64(b), iterations=3)))
        assert _rel(x, jx) < 1e-11
