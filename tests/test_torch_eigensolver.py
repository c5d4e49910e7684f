"""The port's eigensolver (xerus_tpu_torch.algorithms.eigensolver:
EigenALSVariant, smallest_eigenvalue, DMRG_groundstate / ALS_groundstate,
and the padded-stack drivers of ops/dmrg_kernels it reaches) held against
xerus_tpu and exact diagonalization on the CPU.

Each case runs in both packages from one ``set_seed`` (random TTs and the
rank bump's random TT draw from one numpy engine).  Only gauge-free
results are compared: energies (within 1e-10 of each other where no rank
cut splits a degenerate multiplet), the represented state up to a global
sign, eigen-residuals ||H x - lambda x||, ranks.  The bars against exact
diagonalization are the JAX package's own (test_eigensolver.py: 1e-10,
1e-8, 1e-7, 1e-9)."""

import numpy as np
import pytest

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.ops import dmrg_kernels as jd
from xerus_tpu_torch.ops import dmrg_kernels as td

SEED = 0xBAADF00D
E_TOL = 1e-10


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


def _matrix(op):
    t = op.to_tensor().to_ndarray()
    n = int(np.sqrt(t.size))
    return t.reshape(n, n)


def _vec(x):
    return x.to_tensor().to_ndarray().reshape(-1)


def _overlap(a, b):
    return abs(float(np.dot(a, b))) / (np.linalg.norm(a) * np.linalg.norm(b))


def _heisenberg_case(d, rank, **kw):
    def case(pkg):
        H = pkg.examples.heisenberg_mpo(d)
        x = pkg.TTTensor.random([2] * d, rank)
        lam = pkg.smallest_eigenvalue(H, x, **kw)
        return lam, _vec(x), x.ranks(), _matrix(H)
    return case


@pytest.mark.parametrize("d", [6, pytest.param(8, marks=pytest.mark.slow)])
def test_dmrg_ground_state_matches_jax_and_exact(d):
    """Two-site EigenALSVariant (solver="exact") from rank 4 at full rank
    2^(d/2) (JAX test_dmrg_ground_state_matches_exact: d=8, max_rank 16;
    the default tier runs d=6)."""
    (je, jx, jr, Hm), (te, tx, tr, _) = _both(
        _heisenberg_case(d, 4, sites=2, max_rank=2 ** (d // 2),
                         solver="exact"))
    exact = np.linalg.eigvalsh(Hm)[0]
    assert abs(te - je) < E_TOL and abs(te - exact) < 1e-10
    assert np.linalg.norm(Hm @ tx - te * tx) < 1e-9
    assert np.isclose(np.linalg.norm(tx), 1.0, atol=1e-10)
    assert tr == jr and _overlap(tx, jx) > 1 - 1e-9


def test_single_site_eigensolver_matches_jax():
    """ALS_groundstate-style single-site sweeps at d=6 from rank 8, 30
    sweeps (JAX test_single_site_eigensolver)."""
    (je, jx, jr, Hm), (te, tx, tr, _) = _both(
        _heisenberg_case(6, 8, sites=1, num_sweeps=30))
    exact = np.linalg.eigvalsh(Hm)[0]
    assert abs(te - exact) < 1e-8 and abs(te - je) < E_TOL
    assert tr == jr


def test_named_variants_are_the_jax_packages():
    for name in ("DMRG_groundstate", "ALS_groundstate"):
        j, t = getattr(xe, name), getattr(xt, name)
        assert (t.sites, t.numSweeps, t.convergenceEpsilon, t.maxRank,
                t.eps) == (j.sites, j.numSweeps, j.convergenceEpsilon,
                           j.maxRank, j.eps)
    (je, _, _, _), (te, _, _, _) = _both(lambda pkg: (
        pkg.ALS_groundstate(pkg.examples.heisenberg_mpo(4),
                            pkg.TTTensor.random([2] * 4, 4)), 0, 0, 0))
    assert abs(te - je) < E_TOL


@pytest.mark.parametrize("d,max_rank", [
    (6, 4), pytest.param(8, 6, marks=pytest.mark.slow),
    pytest.param(10, 12, marks=pytest.mark.slow)])
def test_dmrg_adaptive_rank_grows(d, max_rank):
    """From rank 2, 6 sweeps (JAX test_dmrg_adaptive_rank_grows: d=10,
    max_rank 12; the default tier runs d=6, max_rank 4, the slow tier
    also d=8, max_rank 6): ranks adapt upward, to JAX's."""
    (je, jx, jr, _), (te, tx, tr, _) = _both(
        _heisenberg_case(d, 2, sites=2, max_rank=max_rank, num_sweeps=6,
                         solver="exact"))
    assert max(tr) > 2 and np.isfinite(te)
    assert tr == jr and abs(te - je) < 1e-8


def test_laplace_smallest_eigenvalue():
    """PSD Laplace MPO, d=4 n=3 from rank 4, max_rank 8 (JAX
    test_laplace_smallest_eigenvalue); the default solver under host() is
    "exact", as the JAX package's on a CPU."""
    def case(pkg):
        A = pkg.examples.laplace_operator([3] * 4)
        x = pkg.TTTensor.random([3] * 4, 4)
        lam = pkg.smallest_eigenvalue(A, x, sites=2, max_rank=8)
        return lam, _matrix(A)
    (je, Am), (te, _) = _both(case)
    exact = np.linalg.eigvalsh(Am)[0]
    assert abs(te - exact) < 1e-9 and abs(te - je) < E_TOL


def test_default_solver_off_the_card_is_exact(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the padded-stack sweeps ran under host()")

    monkeypatch.setattr(td, "dmrg_groundstate_scan", fail)
    xt.set_seed(SEED)
    H = xt.examples.heisenberg_mpo(4)
    assert np.isfinite(xt.smallest_eigenvalue(H, xt.TTTensor.random([2] * 4,
                                                                    2)))


def test_smallest_eigenvalue_lanczos_path():
    """solver="lanczos" from rank 2 (the rank-bump path) at d=8, max_rank
    16 (JAX test_smallest_eigenvalue_lanczos_path): within 1e-7 of exact
    and equal to JAX's; non-uniform dimensions are refused."""
    (je, jx, jr, Hm), (te, tx, tr, _) = _both(
        _heisenberg_case(8, 2, sites=2, num_sweeps=6, max_rank=16,
                         solver="lanczos"))
    exact = np.linalg.eigvalsh(Hm)[0]
    assert abs(te - exact) < 1e-7 and abs(te - je) < E_TOL
    assert tr == jr and _overlap(tx, jx) > 1 - 1e-8
    with pytest.raises(ValueError):
        xt.smallest_eigenvalue(xt.TTOperator.identity([2, 3, 2, 3]),
                               xt.TTTensor.random([2, 3], 2),
                               solver="lanczos")


def test_explicit_shift_and_negative_ground():
    """shift=0.0 on the Heisenberg chain (negative ground) and an explicit
    shift 1.05 lambda_max on the PSD Laplace, d=5 (JAX
    test_shifted_dmrg_explicit_shift_and_negative_ground at d=5, n=3)."""
    def case(pkg, fn):
        H = pkg.examples.heisenberg_mpo(5)
        x = pkg.TTTensor.random([2] * 5, 4)
        e_h = fn(H, x, num_half_sweeps=10, solver="lanczos",
                 lobpcg_iters=32, shift=0.0)
        A = pkg.examples.laplace_operator([3] * 5)
        Am = _matrix(A)
        ev = np.linalg.eigvalsh(Am)
        x = pkg.TTTensor.random([3] * 5, 4)
        e_a = fn(A, x, num_half_sweeps=10, solver="lanczos",
                 lobpcg_iters=32, shift=float(1.05 * ev[-1]))
        return e_h, e_a, np.linalg.eigvalsh(_matrix(H))[0], ev[0]
    out = []
    for pkg, fn in ((xe, jd.dmrg_groundstate_scan),
                    (xt, td.dmrg_groundstate_scan)):
        pkg.set_seed(SEED)
        out.append(case(pkg, fn))
    (jh, ja, _, _), (th, ta, exact_h, exact_a) = out
    assert abs(th - exact_h) < 1e-9 and abs(ta - exact_a) < 1e-9
    assert abs(th - jh) < E_TOL and abs(ta - ja) < 1e-9


def test_auto_shift_and_multistart_on_psd_laplace():
    """The auto shift (shift=None: lambda_max estimated on -A) on the PSD
    Laplace, d=5 n=3 rank 4, through dmrg_groundstate_scan and through
    smallest_eigenvalue(num_starts=3) (JAX
    test_shifted_dmrg_psd_operator_all_solvers and
    test_shifted_multistart_psd, Lanczos): within 1e-9 of exact, and of
    JAX's."""
    def case(pkg):
        A = pkg.examples.laplace_operator([3] * 5)
        x = pkg.TTTensor.random([3] * 5, 4)
        scan = (jd if pkg is xe else td).dmrg_groundstate_scan
        e1 = scan(A, x, num_half_sweeps=10, solver="lanczos",
                  lobpcg_iters=32, shift=None)
        r1 = np.linalg.norm(_matrix(A) @ _vec(x) - e1 * _vec(x))
        x = pkg.TTTensor.random([3] * 5, 4)
        e2 = pkg.smallest_eigenvalue(A, x, solver="lanczos", num_starts=3,
                                     max_rank=4, num_sweeps=5)
        return e1, r1, e2, np.linalg.eigvalsh(_matrix(A))[0]
    (j1, _, j2, _), (t1, tr1, t2, exact) = _both(case)
    assert exact > 0
    assert abs(t1 - exact) < 1e-9 and tr1 < 1e-7
    assert abs(t2 - exact) < 1e-9
    assert abs(t1 - j1) < 1e-9 and abs(t2 - j2) < 1e-9


@pytest.mark.slow
def test_scan_solvers_match_exact_at_d8():
    """JAX test_dmrg_scan_lanczos_and_lobpcg_match_exact and
    test_scan_dmrg_kernel_matches_exact in the port: d=8 rank 16, each
    scan solver within its JAX bar of exact diagonalization and of JAX."""
    for solver, iters, bar in (("eigh", 24, 1e-10), ("lanczos", 32, 1e-8),
                               ("lobpcg", 40, 1e-8)):
        out = []
        for pkg, fn in ((xe, jd.dmrg_groundstate_scan),
                        (xt, td.dmrg_groundstate_scan)):
            pkg.set_seed(SEED)
            H = pkg.examples.heisenberg_mpo(8)
            x = pkg.TTTensor.random([2] * 8, 16)
            e = fn(H, x, num_half_sweeps=10, solver=solver,
                   lobpcg_iters=iters, conv_eps=1e-13)
            out.append((e, _matrix(H)))
        (je, Hm), (te, _) = out
        exact = np.linalg.eigvalsh(Hm)[0]
        assert abs(te - exact) < bar and abs(te - je) < bar, solver
