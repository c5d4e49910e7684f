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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xerus_tpu.ops import tt_kernels as jtk
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


@pytest.mark.parametrize("dtype,B,M,keep,cap", [
    (torch.float32, 48, 40, 6, 8), (torch.float64, 40, 56, 5, 8)])
def test_flop_count_matches_flop_counter(dtype, B, M, keep, cap):
    """gemm_exact_flops, the formula chip_smoke.py and PERF.md use for K2's
    bound, is exactly what torch.utils.flop_counter counts around the plain
    version, for the outer, polish and Newton-Schulz counts it ran (the
    plain version's counters, as the kernel's flags count them)."""
    from torch.utils.flop_counter import FlopCounterMode
    A = np.random.default_rng(B + M).standard_normal((B, M))
    cur = torch.tensor(A, dtype=dtype)
    mask = (torch.arange(cap) < keep).to(dtype)
    tuning = ge._gemm_exact_tuning(dtype)
    ge.reset_counters()
    with FlopCounterMode(display=False) as fc:
        _vt0, _vtb, _okp, conv, outer = ge._gemm_exact_body(cur, mask,
                                                            *tuning)
    ns, ns_rows = ge._gemm_exact_body.ns_iters, ge._gemm_exact_body.ns_row_iters
    assert bool(conv) and outer > 0 and 0 < ns_rows < ns
    assert fc.get_total_flops() == ge.gemm_exact_flops(
        B, M, cap, outer, ns, ns_rows, tuning[2])
