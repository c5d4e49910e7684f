"""K2, the certified GEMM-only truncation: the port's plain version
(xerus_tpu_torch.ops.gemm_exact) held against the JAX package's XLA branch
and its Pallas kernel in interpret mode, on the same numpy-seeded inputs.

Bars are the reference's own (tests/test_pallas_lowering.py): the
truncation error |err_port - err_ref| < 5e-6 in f32, and for spectra with
a clear subspace (cliff, overranked) the reconstructions agree to 5e-6 of
||cur||.  The generic Marchenko-Pastur-tight spectrum cuts inside a
near-degenerate cluster, where equally valid truncations keep different
directions, so only the error is compared there.  Only gauge-invariant
quantities are compared: US @ vt, and the row spaces."""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from xerus_tpu.ops import tt_kernels as jtk
from xerus_tpu_torch.examples.k2_grid import ExactProducts
from xerus_tpu_torch.ops import gemm_exact as ge

B, M, CAP, KEEP = 256, 512, 128, 96


def _kind(kind, rng):
    if kind == "generic":
        return rng.standard_normal((B, M)) * rng.uniform(0.1, 1.0,
                                                         size=(B, 1))
    if kind == "cliff":
        U, _ = np.linalg.qr(rng.standard_normal((B, B)))
        V, _ = np.linalg.qr(rng.standard_normal((M, B)))
        s = np.concatenate([np.linspace(10.0, 1.0, KEEP),
                            np.full(B - KEEP, 1e-6)])
        return (U * s) @ V.T
    return rng.standard_normal((B, 7)) @ rng.standard_normal((7, M))


def _err(A64, us, vt):
    rec = np.asarray(us, np.float64) @ np.asarray(vt, np.float64)
    return (np.linalg.norm(A64 - rec) ** 2
            / (np.linalg.norm(A64) ** 2 + 1e-30)), rec


def _jax_step(A, use_pallas):
    with jax.enable_x64(False):
        us, vt = jtk._trunc_step_gemm_exact(
            jnp.asarray(A, jnp.float32), KEEP, CAP, jnp.float32, 1e-30,
            use_pallas=use_pallas)
        return np.asarray(us), np.asarray(vt)


def _port_step(A):
    us, vt = ge.trunc_step_gemm_exact(torch.tensor(A, dtype=torch.float32),
                                      KEEP, CAP)
    return us.numpy(), vt.numpy()


@pytest.mark.parametrize("kind", ["generic", "cliff", "overranked"])
def test_plain_body_matches_xla_branch(kind):
    """The port's plain version against the reference's plain XLA branch
    at the shape of tests/test_pallas_lowering.py, with its bars."""
    A = _kind(kind, np.random.default_rng(7))
    A64 = A.astype(np.float32).astype(np.float64)
    err_x, rec_x = _err(A64, *_jax_step(A, False))
    err_p, rec_p = _err(A64, *_port_step(A))
    assert abs(err_p - err_x) < 5e-6, (kind, err_p, err_x)
    if kind != "generic":
        scale = np.linalg.norm(A64) + 1e-30
        assert np.linalg.norm(rec_p - rec_x) / scale < 5e-6, kind


def test_plain_body_matches_pallas_interpret():
    """The port's plain version against the reference's Pallas kernel run
    in interpret mode (the kernel K2 replaces), cliff spectrum."""
    A = _kind("cliff", np.random.default_rng(11))
    A64 = A.astype(np.float32).astype(np.float64)
    err_i, rec_i = _err(A64, *_jax_step(A, "interpret"))
    err_p, rec_p = _err(A64, *_port_step(A))
    assert abs(err_p - err_i) < 5e-6, (err_p, err_i)
    assert np.linalg.norm(rec_p - rec_i) / np.linalg.norm(A64) < 5e-6


def test_body_flags_and_outputs_match_reference_f64():
    """float64, small: the body's certificates and iteration count agree
    with the reference, and the row spaces of vt0 and vt_bal agree to
    f64 roundoff (the iteration is the same op for op)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 24))
    keep, cap = 5, 8
    mask_j = (jnp.arange(cap) < keep).astype(jnp.float64)
    j_vt0, j_vtb, j_okp, j_conv, j_it = jtk._gemm_exact_body(
        jnp.asarray(A), mask_j, jnp.float64, jnp.asarray(1e-30, jnp.float64),
        *jtk._gemm_exact_tuning(jnp.float64))
    mask_t = (torch.arange(cap) < keep).to(torch.float64)
    p_vt0, p_vtb, p_okp, p_conv, p_it = ge._gemm_exact_body(
        torch.from_numpy(A), mask_t, *ge._gemm_exact_tuning(torch.float64))
    assert ge._gemm_exact_tuning(torch.float64) == jtk._gemm_exact_tuning(
        jnp.float64)
    assert ge._gemm_exact_tuning(torch.float32) == jtk._gemm_exact_tuning(
        jnp.float32)
    assert bool(p_okp) == bool(j_okp) and bool(p_conv) == bool(j_conv)
    assert abs(p_it - int(j_it)) <= 2, (p_it, int(j_it))
    for jv, pv in ((j_vt0, p_vt0), (j_vtb, p_vtb)):
        jv, pv = np.asarray(jv)[:keep], pv.numpy()[:keep]
        # projector onto the row space: gauge-free
        pj = np.linalg.pinv(jv) @ jv
        pp = np.linalg.pinv(pv) @ pv
        assert np.linalg.norm(pj - pp) < 1e-8


def test_ns_polar_rows_matches_reference():
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((6, 30))
    Y[4:] = 0.0
    mask = np.array([1, 1, 1, 1, 0, 0], np.float64)
    jq, jok = jtk._ns_polar_rows(jnp.asarray(Y), 64, jnp.float64,
                                 rowmask=jnp.asarray(mask))
    pq, pok = ge._ns_polar_rows(torch.from_numpy(Y), 64,
                                rowmask=torch.from_numpy(mask))
    assert bool(jok) and bool(pok)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-12)
    assert np.all(pq.numpy()[4:] == 0.0)


def test_finish_takes_householder_lq_when_polar_fails():
    """okp False: orthonormal rows spanning vt_bal's row space, padded."""
    rng = np.random.default_rng(5)
    vt_bal = torch.from_numpy(rng.standard_normal((4, 10)))
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
    vt = ge._finish_gemm_exact(None, vt_bal, False, mask).numpy()
    live = vt[:3]
    np.testing.assert_allclose(live @ live.T, np.eye(3), atol=1e-12)
    assert np.all(vt[3] == 0.0)
    # the live rows span the first three rows of vt_bal
    rows = vt_bal.numpy()[:3]
    np.testing.assert_allclose(rows @ live.T @ live, rows, atol=1e-12)


def test_wrapper_takes_plain_version_on_cpu_only():
    ge.reset_counters()
    A = _kind("cliff", np.random.default_rng(8))[:64, :96]
    us, vt = ge.trunc_step_gemm_exact(torch.tensor(A), 5, 8)
    assert us.shape == (64, 8) and vt.shape == (8, 96)
    assert ge.trunc_step_gemm_exact.calls == 1
    assert ge.gemm_exact_kernel.launches == 0


def test_wrapper_raises_off_cpu_without_kernel():
    cur = torch.empty((16, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ge.trunc_step_gemm_exact(cur, 4, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        ge.gemm_exact_kernel(torch.zeros((16, 16)), 4, 8)


def test_svd_fallback_when_not_certified(monkeypatch):
    """A bond that does not certify takes the exact SVD truncation."""
    ge.reset_counters()
    monkeypatch.setattr(ge, "_gemm_exact_tuning", lambda dtype: (1, 48, 0, 2))
    A = torch.from_numpy(np.random.default_rng(9).standard_normal((20, 30)))
    us, vt = ge.trunc_step_gemm_exact(A, 4, 8)
    assert ge.trunc_step_gemm_exact.svd_fallbacks == 1
    s = np.linalg.svd(A.numpy(), compute_uv=False)
    err = np.linalg.norm(A.numpy() - us.numpy() @ vt.numpy()) ** 2
    np.testing.assert_allclose(err, np.sum(s[4:] ** 2), rtol=1e-10)


class _HalfGrams(TorchFunctionMode):
    """Computes every Gram product the plain version makes (x @ x^T or
    x^T @ x: the second operand the first's transpose) only on and above
    the diagonal, row by row, and mirrors it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.matmul, torch.Tensor.__matmul__,
                    torch.matmul) and not kwargs:
            a, b = args
            if (a.dim() == 2 and a.data_ptr() == b.data_ptr()
                    and a.shape == b.shape[::-1]
                    and a.stride() == b.stride()[::-1]):
                n = a.shape[0]
                out = torch.empty((n, n), dtype=a.dtype)
                for i in range(n):
                    out[i, i:] = (a[i:i + 1] @ b[:, i:])[0]
                    out[i + 1:, i] = out[i, i + 1:]
                return out
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype,B,M,keep,cap", [
    (torch.float32, 48, 40, 6, 8), (torch.float64, 40, 56, 5, 8),
    (torch.float32, 32, 32, 16, 16), (torch.float32, 32, 40, 16, 16),
    pytest.param(torch.float32, 512, 512, 256, 256, marks=pytest.mark.slow)])
def test_flop_count_matches_flop_counter(dtype, B, M, keep, cap):
    """gemm_exact_flops, the formula chip_smoke.py and PERF.md use for K2's
    bound, is exactly what torch.utils.flop_counter counts around the plain
    version when each of its Grams (G and the Newton-Schulz Grams) is
    computed only on and above its diagonal, for the outer, polish,
    two-stage retry and Newton-Schulz counts it ran (the plain version's
    counters, as the kernel's flags count them).  At (512, 512) keep 256
    the input is the rank-512 rounding instance's middle bond (a Gaussian
    matrix's flat spectrum would not certify); at (32, 32) keep 16 a
    graded bond as in tests/test_torch_k2_fault7.py, whose power steps
    retry; at (32, 40) keep 16 a cliff inside the kept columns under
    exactly rounded products, whose one retry stops after its first
    stage."""
    from torch.utils.flop_counter import FlopCounterMode
    if B == 512:
        from xerus_tpu_torch.examples.k2_grid import bond_inputs
        bonds = bond_inputs(512, 256, torch.device("cpu"))
        cur = bonds[len(bonds) // 2][0].to(dtype)
    elif B == 32:
        from xerus_tpu_torch.examples.k2_grid import graded_bond
        shape = ((keep, 800.0, 10.0) if M == 32 else (12, 10.0, 1e5))
        cur = torch.tensor(graded_bond(B, M, *shape, 1), dtype=dtype)
    else:
        A = np.random.default_rng(B + M).standard_normal((B, M))
        cur = torch.tensor(A, dtype=dtype)
    mask = (torch.arange(cap) < keep).to(dtype)
    tuning = ge._gemm_exact_tuning(dtype)
    ge.reset_counters()
    products = ExactProducts() if (B, M) == (32, 40) else nullcontext()
    threads = torch.get_num_threads()
    if B == 32:   # the same sums whatever the worker's thread count
        torch.set_num_threads(1)
    try:
        with FlopCounterMode(display=False) as fc, products, _HalfGrams():
            _vt0, _vtb, _okp, conv, outer = ge._gemm_exact_body(cur, mask,
                                                                *tuning)
    finally:
        torch.set_num_threads(threads)
    ns, ns_rows = ge._gemm_exact_body.ns_iters, ge._gemm_exact_body.ns_row_iters
    retries, stops = ge._power_orth.retries, ge._power_orth.stops
    assert bool(conv) and outer > 0 and 0 < ns_rows < ns
    assert (retries > 0) == (B == 32) and stops == ((B, M) == (32, 40))
    assert fc.get_total_flops() == ge.gemm_exact_flops(
        B, M, cap, outer, ns, ns_rows, tuning[2], retries, stops)


class _Captured(Exception):
    pass


@pytest.mark.slow
def test_f64_uncertified_bond_is_the_references_decision():
    """On the d=32 rank-256 -> 128 rounding instance in float64, bonds 6,
    14 and 15 of the gemm_exact sweep do not certify within the
    reference's float64 cap of 256 outer steps and take the SVD fallback;
    every other bond up to 15 certifies.  The JAX package's own body
    decides each of those bonds the same way on the same input, as the
    plain version does (chip_smoke holds K2 to the plain version bond by
    bond on the card)."""
    from xerus_tpu_torch.examples import bench_round_instance
    from xerus_tpu_torch.ops import round_kernels as rk
    cores = [torch.from_numpy(np.asarray(c, np.float64))
             for c in bench_round_instance(32, 2, 256, 0xBAADF00D)]
    seen = []
    body = ge._gemm_exact_body

    def capture(cur, mask, *tuning):
        if len(seen) == 16:
            raise _Captured
        out = body(cur, mask, *tuning)
        seen.append((cur.clone(), mask.clone(), bool(out[3]), int(out[4])))
        return out

    capture.ns_iters = capture.ns_row_iters = 0
    try:
        ge._gemm_exact_body = capture
        with pytest.raises(_Captured):
            rk.tt_round_sweep_segmented(cores, 128, method="gemm_exact")
    finally:
        ge._gemm_exact_body = body
    tuning = ge._gemm_exact_tuning(torch.float64)
    assert tuning == jtk._gemm_exact_tuning(jnp.float64) == (256, 64, 16, 3)
    uncertified = (6, 14, 15)
    assert [k for k, (*_, ok, _it) in enumerate(seen) if not ok] \
        == list(uncertified)
    for k, (cur, mask, ok, it) in enumerate(seen):
        j = jtk._gemm_exact_body(jnp.asarray(cur.numpy()),
                                 jnp.asarray(mask.numpy()), jnp.float64,
                                 1e-30, *tuning)
        assert bool(j[3]) == ok == (k not in uncertified), k
        if not ok:
            assert it == int(j[4]) == tuning[0]
