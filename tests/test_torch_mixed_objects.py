"""The port's mixed-precision entries on TT objects, als_spd_mixed and
als_spd_fused (xerus_tpu_torch.algorithms, ops.mixed_precision), held
against xerus_tpu on the CPU: the cases of tests/test_mixed_precision.py
from one ``set_seed`` at d=4-6.  Both packages reach float64 quality
(residual below 1e-12 by a dense float64 check) and their solutions agree
within 1e-10 of the largest entry; the f32 half-sweep counts are equal,
and the f32 histories, which sit at the f32 floor here (ROADMAP fault 2),
stay below 1e-6 in both."""

import numpy as np
import pytest
import torch

import xerus_tpu as xe
import xerus_tpu_torch as xt

SEED = 0xBAADF00D


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


def _both(case, seed=SEED):
    out = []
    for pkg in (xe, xt):
        pkg.set_seed(seed)
        out.append(case(pkg))
    return out


def _dense(tt):
    return np.asarray(tt.to_tensor().to_ndarray(), np.float64)


def _close(a, b, rtol):
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale


def _mixed_problem(pkg, d, rank):
    A = pkg.examples.laplace_operator([2] * d)
    b = pkg.TTTensor.ones([2] * d)
    b /= b.frob_norm()
    return A, b, pkg.TTTensor.random([2] * d, rank)


def _tt_residual(A, x, b):
    n = x.to_tensor().to_ndarray().size
    Am = A.to_tensor().to_ndarray().reshape(n, n)
    xv = x.to_tensor().to_ndarray().reshape(-1)
    bv = b.to_tensor().to_ndarray().reshape(-1)
    return float(np.linalg.norm(Am @ xv - bv) / np.linalg.norm(bv))


def test_als_spd_mixed_matches_jax():
    """tests/test_mixed_precision.py::test_mixed_als_reaches_f64_quality at
    d=4: both reach float64 quality, x is not changed."""
    def case(pkg):
        A, b, x = _mixed_problem(pkg, 4, 3)
        x0 = x.copy()
        if pkg is xe:
            from xerus_tpu.ops.mixed_precision import als_spd_mixed
            sol = pkg.TTTensor._make([pkg.Tensor.from_ndarray(c) for c in
                                      als_spd_mixed(A, x, b, 4)])
        else:
            sol = pkg.als_spd_mixed(A, x, b, 4)
        assert np.array_equal(_dense(x), _dense(x0))   # x is not changed
        return _tt_residual(A, sol, b), _dense(sol)

    (jr, jx), (tr, tx) = _both(case)
    assert jr < 1e-12 and tr < 1e-12
    _close(tx, jx, 1e-10)


def test_als_spd_fused_matches_jax():
    """xe.als_spd_fused at d=6: the same f32 half-sweep count, float64
    quality in both, solutions within 1e-10; the symmetry guard refuses a
    general operator."""
    def case(pkg):
        A, b, x = _mixed_problem(pkg, 6, 4)
        sol, hist = pkg.als_spd_fused(A, x, b, 12, 2)
        return _tt_residual(A, sol, b), _dense(sol), hist

    (jr, jx, jh), (tr, tx, th) = _both(case)
    assert len(th) == len(jh) and len(th) % 2 == 0
    assert max(th) < 1e-6 and max(jh) < 1e-6
    assert jr < 1e-12 and tr < 1e-12
    _close(tx, jx, 1e-10)
    xt.set_seed(SEED)
    A = xt.TTOperator.random([2] * 6, 2)
    with pytest.raises(ValueError, match="symmetric"):
        xt.als_spd_fused(A, xt.TTTensor.random([2] * 3, 2),
                         xt.TTTensor.ones([2] * 3))


def test_als_spd_fused_is_the_core_level_run():
    """On the QTT Poisson instance made into objects, als_spd_fused gives
    the core-level als_f32_df_run's history and solution."""
    from xerus_tpu_torch.convert import (cores_to_df, cores_to_torch,
                                         df_to_numpy, tt_from_numpy)
    from xerus_tpu_torch.examples import (host_poisson_residual,
                                          qtt_poisson_instance)
    from xerus_tpu_torch.ops.mixed_precision import als_f32_df_run
    xs, A, b = qtt_poisson_instance(6, 4, SEED)
    cpu = torch.device("cpu")
    out, hist, cnt = als_f32_df_run(
        cores_to_torch(xs, cpu), cores_to_torch(A, cpu),
        cores_to_torch(b, cpu), cores_to_df(A, cpu), cores_to_df(b, cpu),
        16, 2)
    sol, ohist = xt.als_spd_fused(tt_from_numpy(A, operator=True),
                                  tt_from_numpy(xs, canonicalized=True),
                                  tt_from_numpy(b))
    assert ohist == hist[:cnt].tolist()
    ref = df_to_numpy(out)
    got = [c.to_ndarray() for c in sol.components]
    assert abs(host_poisson_residual(got, A, b)
               - host_poisson_residual(ref, A, b)) < 1e-13
