"""The port's fused MPO apply + randomized rounding
(xerus_tpu_torch.ops.apply_kernels) and its helpers (round_kernels
``_cholqr2``, ``res_rank``) held against xerus_tpu on the CPU.

With the sketches jax.random draws passed in, the port's sweep is the JAX
package's: the rounded product's represented tensor within 1e-10
relative, for each QR route.  Without them the port draws from a
torch.Generator, so the object entry is held to the JAX test's own bars
(test_kernels.py:430-470): exact at a representable rank (1e-9), within
4x of the optimal truncation error plus 1e-12 at a cut."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.ops import apply_kernels as ja
from xerus_tpu.ops import tt_kernels as jtk
from xerus_tpu_torch.ops import apply_kernels as ta
from xerus_tpu_torch.ops import round_kernels as trk

SEED = 0xBAADF00D


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


def _stacks(d, rank, seed=SEED):
    xe.set_seed(seed)
    A = xe.examples.laplace_operator([2] * d)
    x = xe.TTTensor.random([2] * d, rank)
    A_np = [np.asarray(c.to_ndarray()) for c in A.components]
    x_np = [np.asarray(c.to_ndarray()) for c in x.components]
    a = max(max(c.shape[0], c.shape[3]) for c in A_np)
    r = max(max(c.shape[0], c.shape[2]) for c in x_np)
    A_stack = np.zeros((d, a, 2, 2, a))
    x_stack = np.zeros((d, r, 2, r))
    for k in range(d):
        A_stack[k, :A_np[k].shape[0], :, :, :A_np[k].shape[3]] = A_np[k]
        x_stack[k, :x_np[k].shape[0], :, :x_np[k].shape[2]] = x_np[k]
    return A_stack, x_stack


def _jax_sketches(d, n, target, oversample, dtype=jnp.float64):
    """The Omegas _apply_round_scan draws: site k+1 takes key d-1-k of
    split(PRNGKey(0), d)."""
    l = target + oversample
    keys = jax.random.split(jax.random.PRNGKey(0), d)
    return [torch.from_numpy(np.array(jax.random.normal(
        keys[d - 1 - k], (l, n, l), dtype=dtype))) for k in range(d - 1)]


def _contract(Qs, final):
    """The represented vector of (Qs (d-1, l, n, l), final (l, n))."""
    v = np.asarray(Qs[0])[:1]
    for k in range(1, len(Qs)):
        v = np.einsum("...a,anb->...nb", v, np.asarray(Qs[k]))
    v = np.einsum("...a,an->...n", v, np.asarray(final))
    return v.reshape(-1)


@pytest.mark.parametrize("qr_method", ["cholqr1", "cholqr", "householder"])
def test_apply_round_scan_equals_jax_with_its_sketches(qr_method):
    d, target, over = 7, 4, 3
    A_stack, x_stack = _stacks(d, 3)
    jQ, jF = ja._apply_round_scan(jnp.asarray(A_stack), jnp.asarray(x_stack),
                                  target, over, qr_method)
    A_t, x_t = torch.from_numpy(A_stack), torch.from_numpy(x_stack)
    keep = (A_t.clone(), x_t.clone())
    tQ, tF = ta._apply_round_scan(A_t, x_t, target, over, qr_method,
                                  sketches=_jax_sketches(d, 2, target, over))
    assert torch.equal(A_t, keep[0]) and torch.equal(x_t, keep[1])
    jv, tv = _contract(jQ, jF), _contract(tQ.numpy(), tF.numpy())
    assert np.linalg.norm(tv - jv) <= 1e-10 * np.linalg.norm(jv)


def test_apply_operator_rounded_cores_equals_jax_with_its_sketches():
    """The core-level entry with the logical bond caps: same ranks, and
    the same represented tensor within 1e-10."""
    d = 6
    xe.set_seed(SEED)
    H = xe.examples.heisenberg_mpo(d)
    x = xe.TTTensor.random([2] * d, 3)
    A_np = [np.asarray(c.to_ndarray()) for c in H.components]
    x_np = [np.asarray(c.to_ndarray()) for c in x.components]
    j = ja.apply_operator_rounded_cores(A_np, x_np, 5)
    t = ta.apply_operator_rounded_cores(
        [torch.from_numpy(c) for c in A_np],
        [torch.from_numpy(c) for c in x_np], 5,
        sketches=_jax_sketches(d, 2, 5, 8))
    assert [tuple(c.shape) for c in t] == [tuple(c.shape) for c in j]
    jt = xe.TTTensor._make([xe.Tensor.from_ndarray(np.asarray(c)) for c in j])
    tt = xt.TTTensor._make([xt.Tensor.from_ndarray(c.numpy()) for c in t])
    jv, tv = jt.to_tensor().to_ndarray(), tt.to_tensor().to_ndarray()
    assert np.linalg.norm(tv - jv) <= 1e-10 * np.linalg.norm(jv)


def test_apply_operator_rounded_objects():
    """test_kernels.py:430-470 in the port (d=8 Laplace and Heisenberg on
    a rank-3 TT): exact at representable targets, quasi-optimal at a cut,
    a float32 core-level run accurate to its precision."""
    d = 8
    xt.set_seed(SEED)
    L = xt.examples.laplace_operator([2] * d)
    x = xt.TTTensor.random([2] * d, 3)
    x_keep = x.to_tensor().to_ndarray()
    exact = xt.apply_operator(L, x)
    want = exact.to_tensor().to_ndarray()
    got = xt.ops.apply_operator_rounded(L, x, 8)
    got.require_correct_format()
    assert type(got) is xt.TTTensor
    assert np.linalg.norm(got.to_tensor().to_ndarray() - want) \
        < 1e-9 * np.linalg.norm(want)
    np.testing.assert_array_equal(x.to_tensor().to_ndarray(), x_keep)

    ref = exact.copy()
    ref.round(4)
    e_ref = np.linalg.norm(ref.to_tensor().to_ndarray() - want)
    g4 = xt.ops.apply_operator_rounded(L, x, 4)
    assert max(g4.ranks()) <= 4
    e_g = np.linalg.norm(g4.to_tensor().to_ndarray() - want)
    assert e_g < 4 * e_ref + 1e-12

    H = xt.examples.heisenberg_mpo(d)
    y = xt.ops.apply_operator_rounded(H, x, 12)
    yw = xt.apply_operator(H, x).to_tensor().to_ndarray()
    assert np.linalg.norm(y.to_tensor().to_ndarray() - yw) \
        < 1e-9 * np.linalg.norm(yw)

    A32 = [c._torch().to(torch.float32) for c in L.components]
    x32 = [c._torch().to(torch.float32) for c in x.components]
    out = xt.ops.apply_operator_rounded_cores(A32, x32, 8)
    assert all(c.dtype == torch.float32 for c in out)
    t32 = xt.TTTensor._make([xt.Tensor.from_ndarray(c.double().numpy())
                             for c in out])
    err = np.linalg.norm(t32.to_tensor().to_ndarray() - want)
    assert err < 1e-4 * np.linalg.norm(want)


def test_draws_are_seeded():
    """Without sketches the port draws from a torch.Generator seeded 0:
    two calls give the same rounding, other sketches another one."""
    A_stack, x_stack = _stacks(6, 3)
    A_t, x_t = torch.from_numpy(A_stack), torch.from_numpy(x_stack)
    a = ta._apply_round_scan(A_t, x_t, 3, 2)
    b = ta._apply_round_scan(A_t, x_t, 3, 2)
    c = ta._apply_round_scan(A_t, x_t, 3, 2,
                             sketches=_jax_sketches(6, 2, 3, 2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError):
        ta._apply_round_scan(A_t, x_t, 3, 2, qr_method="tsqr")


def test_cholqr2_and_res_rank_match_jax():
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((40, 6))
    j = np.asarray(jtk._cholqr2(jnp.asarray(Y), jnp.asarray(1e-30)))
    t = trk._cholqr2(torch.from_numpy(Y)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-12)
    np.testing.assert_allclose(t.T @ t, np.eye(6), atol=1e-13)
    for args in ((0, 8, 2, 16), (3, 8, 2, 16), (5, 8, 2, 3), (1, 5, 4, 9)):
        assert trk.res_rank(*args) == jtk.res_rank(*args)
