"""The port's f32 ALS half-sweeps and TT residual
(xerus_tpu_torch.ops.als_kernels) held against xerus_tpu.ops.tt_kernels on
the same f32 cores of a small QTT Poisson instance.

Tolerances are f32 ones: the two frameworks reach different LAPACK paths
(Cholesky, QR) and einsum orders, so agreement is to f32 rounding
amplified by the local solves, not bitwise.  Only gauge-invariant
quantities are compared (QR signs differ): the represented tensor and
the residual."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xerus_tpu.ops import tt_kernels as jtk
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import qtt_poisson_instance
from xerus_tpu_torch.ops import als_kernels as tak

CPU = torch.device("cpu")
SEED = 0xBAADF00D


def full_tensor(cores):
    t = np.ones((1, 1))
    for c in cores:
        c = np.asarray(c, dtype=np.float64)
        t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape(-1)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def instance():
    xs, A, b = qtt_poisson_instance(8, 5, SEED)
    f32 = lambda cs: [c.astype(np.float32) for c in cs]
    return f32(xs), f32(A), f32(b)


def _jax(cores):
    return tuple(jnp.asarray(c) for c in cores)


def _sweep_both(direction, x, A, b):
    jfn = jtk._als_half_sweep if direction == "lr" else jtk._als_half_sweep_rl
    tfn = tak._als_half_sweep if direction == "lr" else tak._als_half_sweep_rl
    jout = jtk.jit_f32(jfn)(_jax(x), _jax(A), _jax(b))
    tout = tfn(cores_to_torch(x, CPU), cores_to_torch(A, CPU),
               cores_to_torch(b, CPU))
    return [np.asarray(c) for c in jout], [c.numpy() for c in tout]


def test_half_sweeps_match_reference(instance):
    """One lr half-sweep from the right-canonical start, then one rl
    half-sweep from the reference's lr result."""
    x, A, b = instance
    j_lr, t_lr = _sweep_both("lr", x, A, b)
    assert _rel(full_tensor(t_lr), full_tensor(j_lr)) <= 1e-4
    j_rl, t_rl = _sweep_both("rl", j_lr, A, b)
    assert _rel(full_tensor(t_rl), full_tensor(j_rl)) <= 1e-4
    # the rl sweep leaves the core at site 0: sites 1.. are right-orthogonal
    for c in t_rl[1:]:
        m = c.reshape(c.shape[0], -1)
        assert np.abs(m @ m.T - np.eye(m.shape[0])).max() < 1e-5


def test_tt_residual_rel_matches_reference(instance):
    """Same cores into both.  In f32 the residual is compared where it lies
    well above f32 rounding (the random start, and a swept state perturbed
    by 1e-3): at the f32 floor (~1e-7) the value is the computation's own
    rounding noise and differs between frameworks by tens of percent.  In
    f64 the comparison is tight at the floor too."""
    x, A, b = instance
    swept = _sweep_both("lr", x, A, b)[0]
    rng = np.random.Generator(np.random.PCG64(7))
    perturbed = [c + 1e-3 * np.abs(c).max() * rng.normal(size=c.shape)
                 .astype(np.float32) for c in swept]
    for cores in (x, perturbed):
        jres = float(jtk.jit_f32(jtk.tt_residual_rel)(_jax(cores), _jax(A),
                                                      _jax(b)))
        tres = float(tak.tt_residual_rel(cores_to_torch(cores, CPU),
                                         cores_to_torch(A, CPU),
                                         cores_to_torch(b, CPU)))
        assert abs(tres - jres) / jres <= 1e-3
    f64 = lambda cs: [c.astype(np.float64) for c in cs]
    jres = float(jtk.tt_residual_rel(_jax(f64(swept)), _jax(f64(A)),
                                     _jax(f64(b))))
    tres = float(tak.tt_residual_rel(
        *(cores_to_torch(f64(cs), CPU, torch.float64)
          for cs in (swept, A, b))))
    assert jres < 1e-5
    assert abs(tres - jres) / jres <= 1e-8


def test_tt_log_norm_qr_matches_dense(instance):
    x, _, _ = instance
    got = float(tak._tt_log_norm_qr(cores_to_torch(x, CPU, torch.float64)))
    assert abs(got - np.log(np.linalg.norm(full_tensor(x)))) < 1e-12


def test_local_solve_lu_matches_cholesky(instance):
    x, A, b = instance
    args = (cores_to_torch(x, CPU), cores_to_torch(A, CPU),
            cores_to_torch(b, CPU))
    pos = tak._als_half_sweep(*args, assume="pos")
    gen = tak._als_half_sweep(*args, assume="gen")
    assert _rel(full_tensor([c.numpy() for c in gen]),
                full_tensor([c.numpy() for c in pos])) <= 1e-4
    with pytest.raises(ValueError, match="assume"):
        tak._als_half_sweep(*args, assume="sym")
