"""The port's ALS / DMRG / ASD on TT objects (xerus_tpu_torch.algorithms.als,
ops.als_kernels' drivers), held against xerus_tpu on the CPU.

Each case of tests/test_als.py runs in
both packages from one ``set_seed`` (random TTs draw from one numpy
engine, so both packages start from the same cores).  QR signs differ
between jnp and torch, so only gauge-free results are compared: the
residual each solve returns and the residual after every half-sweep
(PerformanceData) within 1e-10 in float64, the number of half-sweeps and
the final ranks and core position exactly, and the represented tensor
within 1e-8 of its largest entry."""

import numpy as np
import pytest
import torch

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu_torch.ops import als_kernels as tak

SEED = 0xBAADF00D
RES_TOL = 1e-10


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


def _solve_state(res, x, perf=None):
    out = {"res": float(res), "x": _dense(x), "ranks": list(x.ranks()),
           "flags": (bool(x.canonicalized), int(x.corePosition))}
    if perf is not None:
        out["hist"] = [p.residual for p in perf.data]
        out["sweep flags"] = [p.flags for p in perf.data]
    return out


def _same_solve(j, t, x_tol=1e-8):
    assert abs(t["res"] - j["res"]) <= RES_TOL * max(1.0, abs(j["res"]))
    assert t["ranks"] == j["ranks"] and t["flags"] == j["flags"]
    _close(t["x"], j["x"], x_tol)
    if "hist" in j:
        assert len(t["hist"]) == len(j["hist"])           # half-sweeps
        np.testing.assert_allclose(t["hist"], j["hist"], rtol=0,
                                   atol=RES_TOL)
        assert t["sweep flags"] == j["sweep flags"]


# -- the cases of tests/test_als.py --------------------------------------

def c_identity(pkg):
    dims = [2] * 5
    A = pkg.TTOperator.identity(dims + dims)
    b = pkg.TTTensor.random(dims, 2)
    b /= b.frob_norm()
    x = pkg.TTTensor.random(dims, 2)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.ALS_SPD(A, x, b, 1e-10, perf), x, perf)


def c_without_operator(pkg):
    dims = [3] * 4
    b = pkg.TTTensor.random(dims, 3)
    x = pkg.TTTensor.random(dims, 3)
    return _solve_state(pkg.ALS(x, b, 1e-10), x)


def c_spd_poisson(pkg):
    dims = [4] * 6
    A = pkg.examples.laplace_operator(dims)
    b = pkg.examples.poisson_rhs(dims)
    b /= b.frob_norm()
    x = pkg.TTTensor.random(dims, 4)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.ALS_SPD(A, x, b, 1e-12, perf), x, perf)


def c_nonspd(pkg):
    dims = [3] * 3
    A = pkg.TTOperator.random(dims + dims, 2)
    A += 5.0 * pkg.TTOperator.identity(dims + dims)
    b = pkg.TTTensor.random(dims, 2)
    x = pkg.TTTensor.random(dims, 4)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.ALS(A, x, b, 1e-12, perf), x, perf)


def c_dmrg_rank_adaptation(pkg):
    """Two-site DMRG: the SVD splits cut a rank-4 start to the rank-2
    solution."""
    dims = [2] * 6
    A = pkg.TTOperator.identity(dims + dims)
    b = pkg.TTTensor.random(dims, 2)
    b /= b.frob_norm()
    x = pkg.TTTensor.random(dims, 4)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.DMRG_SPD(A, x, b, 1e-10, perf), x, perf)


def c_asd(pkg):
    dims = [3] * 4
    A = pkg.examples.laplace_operator(dims)
    b = pkg.examples.poisson_rhs(dims)
    b /= b.frob_norm()
    x = pkg.TTTensor.random(dims, 3)
    res = pkg.ALSVariant(1, 40, "asd", assume_spd=True)(A, x, b, 40)
    return _solve_state(res, x)


def c_asd_generic_engine(pkg):
    dims = [3] * 4
    A = pkg.examples.laplace_operator(dims)
    b = pkg.examples.poisson_rhs(dims)
    x = pkg.TTTensor.random(dims, 3)
    return _solve_state(pkg.ASD(A, x, b, 6), x)


def c_core_position(pkg):
    dims = [3] * 4
    A = pkg.TTOperator.identity(dims + dims)
    b = pkg.TTTensor.random(dims, 2)
    x = pkg.TTTensor.random(dims, 2)
    x.move_core(2)
    return _solve_state(pkg.ALS_SPD(A, x, b, 1e-10), x)


def c_lu_dispatch(pkg):
    dims = [3] * 3
    A = pkg.TTOperator.random(dims + dims, 2)
    A += 8.0 * pkg.TTOperator.identity(dims + dims)
    b = pkg.TTTensor.random(dims, 2)
    x = pkg.TTTensor.random(dims, 4)
    perf = pkg.PerformanceData()
    out = _solve_state(pkg.ALS_SPD(A, x, b, 12, perf), x, perf)
    out["symmetric"] = A.is_symmetric()
    return out


def _indefinite(pkg):
    dims = [2] * 4
    A = pkg.TTOperator.identity(dims + dims)
    core = np.zeros((1, 2, 2, 1))
    core[0, 0, 0, 0] = 1.0
    core[0, 1, 1, 0] = -1.0
    A.set_component(0, pkg.Tensor.from_ndarray(core))
    b = pkg.TTTensor.random(dims, 2)
    b /= b.frob_norm()
    return A, b, pkg.TTTensor.random(dims, 3)


def c_cholesky_fallback(pkg):
    A, b, x = _indefinite(pkg)
    perf = pkg.PerformanceData()
    out = _solve_state(pkg.ALS_SPD(A, x, b, 16, perf), x, perf)
    out["symmetric"] = A.is_symmetric()
    return out


def c_elision_gauge(pkg):
    dims = [2] * 4
    A = pkg.examples.laplace_operator(dims)
    b = pkg.TTTensor.random(dims, 2)
    b /= b.frob_norm()
    x = pkg.TTTensor.random(dims, [2, 4, 2])
    return _solve_state(pkg.ALS_SPD(A, x, b, 1e-13), x)


CASES = [c_identity, c_without_operator, c_spd_poisson, c_nonspd,
         c_dmrg_rank_adaptation, c_asd, c_asd_generic_engine, c_core_position,
         c_lu_dispatch, c_cholesky_fallback, c_elision_gauge]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[2:])
def test_als_matches_jax(case):
    j, t = _both(case)
    assert j.get("symmetric") == t.get("symmetric")
    _same_solve(j, t)


def test_solutions_are_right():
    """The port's results on their own: the solves reach the dense
    oracles of tests/test_als.py."""
    _j, t = _both(c_spd_poisson)
    assert t["res"] < 1e-8
    _j, t = _both(c_lu_dispatch)
    assert t["res"] < 1e-8 and not t["symmetric"]
    for case in (c_identity, c_dmrg_rank_adaptation):
        _j, t = _both(case)
        assert t["res"] < 1e-8
    _j, t = _both(c_dmrg_rank_adaptation)
    assert t["ranks"] == [2] * 5             # cut from [2, 4, 4, 4, 2]
    _j, t = _both(c_core_position)
    assert t["flags"] == (True, 2)


def test_local_solve_gives_nan_on_a_failed_factorization():
    """LAPACK's potrf stops at the failing pivot and leaves finite values,
    so a Cholesky solve of a symmetric indefinite system must select NaNs
    from the factorization's info, as jax.scipy.linalg.solve returns; a
    singular LU solve likewise."""
    import jax.numpy as jnp
    import jax.scipy.linalg
    A = np.diag([1.0, -1.0, 2.0])
    b = np.ones(3)
    j = np.asarray(jax.scipy.linalg.solve(jnp.asarray(A), jnp.asarray(b),
                                          assume_a="pos"))
    t = tak._local_solve(torch.from_numpy(A), torch.from_numpy(b), "pos")
    assert np.isnan(j).all() and torch.isnan(t).all()
    t = tak._local_solve(torch.zeros(3, 3, dtype=torch.float64),
                         torch.from_numpy(b), "gen")
    assert not torch.isfinite(t).all()
    spd = np.array([[2.0, 1.0], [1.0, 3.0]])
    t = tak._local_solve(torch.from_numpy(spd), torch.ones(2,
                         dtype=torch.float64), "pos")
    np.testing.assert_allclose(t.numpy(), np.linalg.solve(spd, np.ones(2)),
                               rtol=1e-14)


def test_cholesky_nan_restarts_with_lu(monkeypatch):
    """On the symmetric indefinite operator the first whole-solve call
    runs Cholesky local solves, meets a NaN residual and restarts from the
    initial cores with LU; the solution is finite and solves the system,
    as in the JAX package."""
    calls = []
    real = tak.als_run

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw["local_assume"], bool(torch.isfinite(
            out[1][:out[2]]).all())))
        return out

    monkeypatch.setattr(tak, "als_run", spy)
    xt.set_seed(SEED)
    A, b, x = _indefinite(xt)
    res = xt.ALS_SPD(A, x, b, 16)
    assert calls[0] == ("pos", False) and calls[-1] == ("gen", True)
    n = 16
    Ad = _dense(A).reshape(n, n)
    xd = _dense(x).reshape(n)
    assert np.isfinite(res) and np.all(np.isfinite(xd))
    assert np.linalg.norm(Ad @ xd - _dense(b).reshape(n)) < 1e-8


@pytest.mark.parametrize("solver,spd", [("lapack", False), ("asd", True),
                                        ("cg", True)])
def test_device_loop_matches_host_loop_reversal_paths(solver, spd):
    """tests/test_als.py's case: the whole-solve driver (als_run_rev) and
    the instrumented per-half-sweep loop give the same solve, in the port
    and against the JAX package's two loops."""
    def case(pkg):
        dims = [3] * 3
        ident = pkg.TTOperator.identity(dims + dims)
        A = pkg.TTOperator.random(dims + dims, 2)
        A += 5.0 * ident
        b = pkg.TTTensor.random(dims, 2)
        op = A if solver == "lapack" else ident
        variant = pkg.ALSVariant(1, 6, solver, assume_spd=spd)
        x0 = pkg.TTTensor.random(dims, 3)
        x_host, x_dev = x0.copy(), x0.copy()
        perf = pkg.PerformanceData(error_function=lambda t: 0.0)
        r_host = variant(op, x_host, b, perf_data=perf)
        return (_solve_state(r_host, x_host, perf),
                _solve_state(variant(op, x_dev, b), x_dev))

    (jh, jd), (th, td) = _both(case)
    _same_solve(th, jh)
    _same_solve(td, jd)
    _same_solve(td, th)
    assert len(th["hist"]) > 0


def test_cg_and_asd_presets_match_jax():
    """ALS_SPD_CG and ASD_SPD (the matrix-free whole-solve drivers) at a
    small size, a fixed number of half-sweeps."""
    def case(pkg):
        dims = [2] * 6
        A = pkg.examples.laplace_operator(dims)
        b = pkg.TTTensor.ones(dims)
        b /= b.frob_norm()
        out = {}
        for name, variant in (("cg", pkg.ALS_SPD_CG), ("asd", pkg.ASD_SPD)):
            x = pkg.TTTensor.random(dims, 3)
            perf = pkg.PerformanceData()
            out[name] = _solve_state(variant(A, x, b, 8, perf), x, perf)
        return out

    j, t = _both(case)
    for name in j:
        _same_solve(t[name], j[name])


# -- the drivers, core level -----------------------------------------------

def test_drivers_match_jax_factories():
    """als_sweep_res, als_multi_sweep_res and als_run against the JAX
    factories on the same float64 cores; als_run carries parity and the
    stagnation history across calls like make_als_run."""
    import jax.numpy as jnp
    from xerus_tpu.ops import tt_kernels as jtk
    from xerus_tpu_torch.examples import qtt_poisson_instance
    xs, A, b = qtt_poisson_instance(6, 4, SEED)
    jx, jA, jb = ([jnp.asarray(c) for c in cs] for cs in (xs, A, b))
    tx, tA, tb = ([torch.from_numpy(np.array(c)) for c in cs]
                  for cs in (xs, A, b))
    shapes = tuple(tuple(c.shape) for c in xs)

    def full(cores):
        t = np.ones((1, 1))
        for c in cores:
            c = np.asarray(c)
            t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
        return t.reshape(-1)

    jc, jr = jtk.make_als_sweep_res(shapes, "float64")(tuple(jx), tuple(jA),
                                                        tuple(jb))
    tc, tr = tak.als_sweep_res(tx, tA, tb)
    assert abs(float(tr) - float(jr)) <= RES_TOL
    _close(full(tc), full(jc), 1e-10)

    jc, jh = jtk.make_als_multi_sweep_res(shapes, "float64", 3)(
        tuple(jx), tuple(jA), tuple(jb))
    tc, th = tak.als_multi_sweep_res(tx, tA, tb, 3)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=RES_TOL)
    _close(full(tc), full(jc), 1e-10)

    run = jtk.make_als_run(shapes, "float64", 3)
    inf = float("inf")
    jc, tc = tuple(jx), tx
    parity, last, last2 = 0, inf, inf
    for _ in range(3):
        jc, jh, jn = run(jc, tuple(jA), tuple(jb), jnp.asarray(1e-12),
                         jnp.asarray(parity, jnp.int32),
                         jnp.asarray(5, jnp.int32), jnp.asarray(last),
                         jnp.asarray(last2))
        tc, th, tn = tak.als_run(tc, tA, tb, 1e-12, parity, 5, last, last2,
                                 3)
        assert tn == int(jn)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=RES_TOL)
        _close(full(tc), full(jc), 1e-9)
        hist = th[:tn].tolist()
        last, last2 = hist[-1], (hist[-2] if tn > 1 else last)
        parity = (parity + tn) % 2
        if tn < 3:
            break
    assert tak.als_sweep_flops(shapes, [c.shape for c in A]) == \
        jtk.als_sweep_flops(shapes, [c.shape for c in A])


def test_batched_half_sweep_matches_jax():
    import jax.numpy as jnp
    from xerus_tpu.ops import tt_kernels as jtk
    from xerus_tpu_torch.examples import qtt_poisson_instance
    insts = [qtt_poisson_instance(5, 3, SEED + i) for i in range(3)]
    A = insts[0][1]
    xb = [np.stack([inst[0][k] for inst in insts]) for k in range(5)]
    bb = [np.stack([inst[2][k] * (i + 1) for i, inst in enumerate(insts)])
          for k in range(5)]
    jout = jtk.als_half_sweep_batched([jnp.asarray(c) for c in xb],
                                      [jnp.asarray(c) for c in A],
                                      [jnp.asarray(c) for c in bb])
    tout = tak.als_half_sweep_batched([torch.from_numpy(c) for c in xb],
                                      [torch.from_numpy(c) for c in A],
                                      [torch.from_numpy(c) for c in bb])
    # the batched program (the sweep vmapped over the batch) against the
    # loop of single sweeps, within 1e-12 of each core's largest entry
    for i in range(3):
        one = tak.als_sweep([torch.from_numpy(c[i]) for c in xb],
                            [torch.from_numpy(c) for c in A],
                            [torch.from_numpy(c[i]) for c in bb])
        for o, c in zip(tout, one):
            assert float((o[i] - c).abs().max()) <= \
                1e-12 * float(c.abs().max())
    for i in range(3):
        def full(cores):
            t = np.ones((1, 1))
            for c in cores:
                t = np.einsum("ia,anb->inb", t, np.asarray(c[i])).reshape(
                    -1, c.shape[3])
            return t.reshape(-1)
        _close(full(tout), full(jout), 1e-10)


# -- whole solves at d >= 8 (slow tier) ----------------------------------

def c_quickstart(pkg):
    d = 9
    A = pkg.examples.laplace_operator([2] * d)
    b = pkg.TTTensor.ones([2] * d)
    x = pkg.TTTensor.random([2] * d, 3)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.ALS_SPD(A, x, b, 1e-12, perf), x, perf)


def c_cg_d8(pkg):
    dims = [2] * 8
    A = pkg.examples.laplace_operator(dims)
    b = pkg.TTTensor.ones(dims)
    b /= b.frob_norm()
    x = pkg.TTTensor.random(dims, 5)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.ALS_SPD_CG(A, x, b, 1e-10, perf), x, perf)


def c_asd_d10(pkg):
    d = 10
    L = pkg.examples.laplace_operator([2] * d)
    truth = pkg.TTTensor.random([2] * d, 3)
    b = pkg.apply_operator(L, truth)
    b.round(6)
    x = pkg.TTTensor.random([2] * d, 6)
    perf = pkg.PerformanceData()
    return _solve_state(pkg.ASD_SPD(L, x, b, 400, perf), x, perf)


@pytest.mark.slow
@pytest.mark.parametrize("case", [c_quickstart, c_cg_d8, c_asd_d10],
                         ids=lambda c: c.__name__[2:])
def test_whole_solves_match_jax(case):
    """tests/test_als.py's slow whole solves (the Quick start at d=9, the
    matrix-free CG at d=8, ASD at d=10) in both packages."""
    j, t = _both(case)
    _same_solve(j, t)
