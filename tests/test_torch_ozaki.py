"""The port's Ozaki split GEMM (xerus_tpu_torch.ops.ozaki) held against
xerus_tpu.ops.ozaki and float64 on the CPU.

Bars from tests/test_df32.py: 1e-13 of sum |A||B| against the float64
product (under per-row ranges of 2^+-20), 1e-12 relative for f32 inputs,
1e-13 between the gated Ozaki dispatch of df_matmul and its broadcast
path.  The split takes its exponents through log2/ceil/exp2, and a log2
one ulp off at a power of two picks another (equally error-free) split,
so the port's products are held to JAX's with a tolerance (1e-13 of the
scale), never slice by slice; the split itself is checked to be exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xerus_tpu.ops import df32 as jdf
from xerus_tpu.ops import ozaki as jz
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops import ozaki as tz

CPU = torch.device("cpu")


def _wild(m, k, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, k)) * np.exp2(
        rng.integers(-20, 20, size=(m, 1)).astype(float))
    return A, rng.normal(size=(k, n))


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (96, 300, 80)])
def test_ozaki_matmul_df_accuracy_matches_jax(m, k, n):
    A, B = _wild(m, k, n, 3)
    ref = A @ B
    scale = (np.abs(A) @ np.abs(B)).max()
    got = tdf.df_to_f64(*tz.ozaki_matmul(*tdf.df_from_f64(A, CPU),
                                         *tdf.df_from_f64(B, CPU)))
    jh, jl = jz.ozaki_matmul(*[jnp.asarray(x) for x in jdf.df_from_f64(A)],
                             *[jnp.asarray(x) for x in jdf.df_from_f64(B)])
    jax_out = jdf.df_to_f64(np.asarray(jh), np.asarray(jl))
    assert np.abs(got - ref).max() / scale < 1e-13
    assert np.abs(got - jax_out).max() / scale < 1e-13


def test_ozaki_matmul_f32_inputs():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(50, 70)).astype(np.float32)
    B = rng.normal(size=(70, 40)).astype(np.float32)
    got = tdf.df_to_f64(*tz.ozaki_matmul_f32(torch.from_numpy(A),
                                             torch.from_numpy(B)))
    ref = A.astype(np.float64) @ B.astype(np.float64)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


@pytest.mark.parametrize("k", [2, 3, 64, 128, 300, 512, 1 << 20])
def test_slice_width_is_jax(k):
    assert tz._slice_width(k) == jz._slice_width(k)


@pytest.mark.parametrize("axis", [0, 1])
def test_ozaki_split_is_error_free(axis):
    """slices + remainder == A exactly, each slice on the grid of its
    remainder's top bit, the remainder shrinking slice by slice."""
    A, _ = _wild(40, 300, 1, 5)
    A = A.astype(np.float32)
    if axis == 0:
        A = np.ascontiguousarray(A.T)
    delta = tz._slice_width(300)
    s = int(np.ceil(24 / delta))
    slices, R = tz.ozaki_split(torch.from_numpy(A), axis, delta, s)
    total = sum(x.numpy().astype(np.float64) for x in slices)
    np.testing.assert_array_equal(total + R.numpy().astype(np.float64),
                                  A.astype(np.float64))
    top = np.abs(A).max(axis=axis, keepdims=True)
    rem = A.astype(np.float64)
    for x in slices:
        # slice i sits on the grid delta bits below its remainder's top
        # bit (per row or column) and takes |R| down by 2^(1 - delta):
        # (R + sigma) - sigma rounds on a grid of 2^(e - delta) below
        # sigma and 2^(e - delta + 1) above it
        mu = np.abs(rem).max(axis=axis, keepdims=True)
        ulp = np.exp2(np.ceil(np.log2(mu)) - delta)
        x = x.numpy().astype(np.float64)
        np.testing.assert_array_equal(x / ulp, np.round(x / ulp))
        rem = rem - x
        assert np.all(np.abs(rem) <= mu * 2.0 ** (1 - delta))
    np.testing.assert_array_equal(rem, R.numpy().astype(np.float64))
    assert np.all(np.abs(R.numpy()) <= top * 2.0 ** (s * (1 - delta)))


def test_df_matmul_ozaki_dispatch_consistent():
    """Forced through Ozaki and through the broadcast tree, df_matmul
    agrees to 1e-13, and with JAX's Ozaki dispatch."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(128, 200))
    B = rng.normal(size=(200, 128))
    args = (*tdf.df_from_f64(A, CPU), *tdf.df_from_f64(B, CPU))
    old = tdf.OZAKI_MATMUL_THRESHOLD
    try:
        tdf.OZAKI_MATMUL_THRESHOLD = 1
        oz = tdf.df_to_f64(*tdf.df_matmul(*args))
        tdf.OZAKI_MATMUL_THRESHOLD = 1 << 60
        bc = tdf.df_to_f64(*tdf.df_matmul(*args))
    finally:
        tdf.OZAKI_MATMUL_THRESHOLD = old
    assert np.abs(oz - bc).max() / np.abs(bc).max() < 1e-13
    jh, jl = jdf.df_matmul(*[jnp.asarray(x) for x in jdf.df_from_f64(A)],
                           *[jnp.asarray(x) for x in jdf.df_from_f64(B)])
    j = jdf.df_to_f64(np.asarray(jh), np.asarray(jl))
    assert np.abs(oz - j).max() / np.abs(j).max() < 1e-13
