"""The port's completion, search and UQ algorithms on TT objects
(xerus_tpu_torch.algorithms: ADFVariant, IHT, find_largest_entry, uq_adf,
the measurement sets on TTTensors and Tensors, PerformanceData), its
generators and models, held against xerus_tpu on the CPU.

Every case runs in both packages from one ``set_seed``: random TTs,
positions, weights and the host-bump kicks of ADF draw from one numpy
engine, so both packages see the same data.  Only gauge-free results are
compared: residuals and residual histories (rtol 1e-8 with an absolute
floor of 1e-14, as tests/test_torch_adf.py; 1e-6 over the hundreds of
iterations of a rank-adaptive solve), iteration counts, ranks and canonical flags exactly,
the represented tensor (1e-8 of its largest entry, 1e-12 for generators
and measurements), found positions exactly.  The adaptive device run
draws its kicks from jax.random in the JAX package and from a
torch.Generator in the port (ROADMAP fault 5), so it is compared by what
it reaches."""

import numpy as np
import pytest

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


def _close(a, b, rtol, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale + atol


def _same(j, t, rtol=1e-8):
    assert j.keys() == t.keys()
    for k in j:
        if isinstance(j[k], (float, np.ndarray)) or (
                isinstance(j[k], list) and j[k]
                and isinstance(j[k][0], float)):
            _close(t[k], j[k], rtol, atol=1e-14)
        else:
            assert t[k] == j[k], k


def _completion(pkg, dims, rank, num, start_rank=None, rank_one=False):
    target = pkg.TTTensor.random(dims, rank)
    target /= target.frob_norm()
    cls = pkg.RankOneMeasurementSet if rank_one else \
        pkg.SinglePointMeasurementSet
    ms = cls.random(num, dims)
    ms.measure(target)
    x = pkg.TTTensor.random(dims, rank if start_rank is None else start_rank)
    return ms, x


def _adf_state(res, x, ms, perf):
    return {"res": float(res), "x": _dense(x), "ranks": list(x.ranks()),
            "flags": (bool(x.canonicalized), int(x.corePosition)),
            "test": ms.test(x), "its": [p.iteration for p in perf.data],
            "hist": [p.residual for p in perf.data],
            "perf ranks": [p.ranks for p in perf.data]}


# -- ADF on TTTensors (tests/test_completion.py) ---------------------------

def c_adf_fixed_rank(pkg, check_every):
    ms, x = _completion(pkg, [4] * 4, 2, 150)
    perf = pkg.PerformanceData()
    res = pkg.ADFVariant(300, 1e-8, 0.999)(x, ms, perf_data=perf,
                                           check_every=check_every)
    return _adf_state(res, x, ms, perf)


def c_adf_rank_one_measurements(pkg, check_every):
    ms, x = _completion(pkg, [3] * 3, 2, 60, rank_one=True)
    perf = pkg.PerformanceData()
    res = pkg.ADFVariant(300, 1e-8, 0.999)(x, ms, perf_data=perf,
                                           check_every=check_every)
    return _adf_state(res, x, ms, perf)


def c_adf_host_bump(pkg, check_every):
    """tests/test_completion.py::test_adf_rank_adaptation: rank 1 -> 3
    through the host-bump loop (a random rank-1 kick, then round)."""
    ms, x = _completion(pkg, [4] * 4, 3, 200, start_rank=1)
    perf = pkg.PerformanceData()
    res = pkg.ADFVariant(400, 1e-7, 0.9999)(x, ms, max_ranks=[3, 3, 3],
                                            perf_data=perf,
                                            check_every=check_every)
    return _adf_state(res, x, ms, perf)


@pytest.mark.parametrize("check_every", [1, 4, "device"])
@pytest.mark.parametrize("case", [c_adf_fixed_rank,
                                  c_adf_rank_one_measurements],
                         ids=lambda c: c.__name__[2:])
def test_adf_fixed_rank_matches_jax(case, check_every):
    j, t = _both(lambda pkg: case(pkg, check_every))
    _same(j, t)
    assert t["res"] < 1e-5 and t["test"] < 1e-5


@pytest.mark.parametrize("check_every", [1, 8])
def test_adf_host_bump_matches_jax(check_every):
    j, t = _both(lambda pkg: c_adf_host_bump(pkg, check_every))
    _same(j, t, rtol=1e-6)
    assert t["ranks"] == [3, 3, 3] and t["res"] < 1e-7
    assert t["flags"] == (True, 0)
    # the ranks grew one bump at a time, recorded per iteration
    grown = sorted({tuple(r) for r in t["perf ranks"]})
    assert grown[0] == (1, 1, 1) and grown[-1] == (3, 3, 3)


def test_adf_adaptive_device_run_on_objects():
    """tests/test_completion.py::test_adf_adaptive_device_run_rank_one and
    the point-sample adaptive run on TTTensors: both packages reach the
    target at the maximal ranks."""
    def case(pkg, rank_one):
        dims = [3] * 4 if rank_one else [4] * 4
        ms, x = _completion(pkg, dims, 2, 200 if rank_one else 150,
                            start_rank=1, rank_one=rank_one)
        res = pkg.ADFVariant(400, 1e-8, 0.9999)(x, ms, max_ranks=[2] * 3,
                                                check_every="device")
        x.require_correct_format()
        return res, x.ranks(), ms.test(x)

    for rank_one in (False, True):
        j, t = _both(lambda pkg: case(pkg, rank_one), SEED + 9)
        assert j[1] == t[1] == [2, 2, 2]
        assert j[0] < 1e-7 and t[0] < 1e-7 and t[2] < 1e-7


def _one_rank_mesh(tmp_path):
    """A one-rank gloo group and its (dp, tp) mesh; the mesh paths at two
    and eight ranks are tests/test_torch_parallel.py's."""
    from xerus_tpu_torch.parallel import default_mesh
    from xerus_tpu_torch.parallel.mesh import process_group
    group = process_group("gloo", f"file://{tmp_path / 'rendezvous'}")
    return group, default_mesh


def test_adf_preset_and_mesh(tmp_path):
    """The ADF preset, and ADF(mesh=) (item 3b) on a one-rank gloo mesh
    equal to the run without one; a mesh that is not a DeviceMesh is
    refused."""
    assert isinstance(xt.ADF, xt.ADFVariant)
    assert (xt.ADF.maxIterations, xt.ADF.targetResidualNorm,
            xt.ADF.minimalResidualNormDecrease) == (0, 1e-8, 0.999)
    xt.set_seed(SEED)
    ms, x = _completion(xt, [3] * 3, 2, 20)
    with pytest.raises(TypeError, match="DeviceMesh"):
        xt.ADF(x.copy(), ms, mesh=object())
    y = x.copy()
    variant = xt.ADFVariant(30, 1e-10, 0.999)
    r_serial = variant(x, ms)
    group, default_mesh = _one_rank_mesh(tmp_path)
    with group:
        r_mesh = variant(y, ms, mesh=default_mesh())
    assert abs(r_mesh - r_serial) <= 1e-12 * max(r_serial, 1e-300)
    assert np.abs(_dense(y) - _dense(x)).max() <= 1e-12 * np.abs(
        _dense(x)).max()


def test_adf_float32_bump_survives_the_round():
    """tests/test_completion.py::test_adf_rank_bump_survives_f32_epsilon on
    the port: with a float32 value dtype the bump scale (16x the rounding
    threshold) keeps every bond's +1 through the round."""
    old = xt.config.value_dtype
    try:
        xt.set_seed(SEED)
        ms, _ = _completion(xt, [4] * 4, 3, 250)
        xt.config.value_dtype = np.dtype(np.float32)
        x = xt.TTTensor.random([4] * 4, 1)
        res = xt.ADFVariant(400, 1e-4, 0.9999)(x, ms, max_ranks=[3] * 3)
        assert x.ranks() == [3, 3, 3] and res < 1e-2
    finally:
        xt.config.value_dtype = old


# -- IHT on TTTensors ------------------------------------------------------

def c_iht(pkg, at_solution):
    dims = [3] * 3
    ms, x = _completion(pkg, dims, 2, 25)
    if at_solution:
        target = pkg.TTTensor.random(dims, 2)
        ms.measure(target)
        x = target.copy()
    perf = pkg.PerformanceData()
    res = pkg.IHT(x, ms, perf, max_iterations=3)
    return _adf_state(res, x, ms, perf)


@pytest.mark.parametrize("at_solution", [False, True])
def test_iht_matches_jax(at_solution):
    j, t = _both(lambda pkg: c_iht(pkg, at_solution))
    _same(j, t)
    if at_solution:
        assert t["res"] < 1e-8


# -- largest entry (tests/test_other_algorithms.py) ------------------------

def c_largest_entry(pkg):
    out = {}
    tt = pkg.TTTensor.dirac([3, 4, 3], [1, 2, 0])
    tt *= 5.0
    out["dirac"] = pkg.find_largest_entry(tt)
    tt = pkg.TTTensor.random([4] * 4, 2)
    out["small"] = pkg.find_largest_entry(tt, accuracy=0.1)
    # the squaring / soft-threshold iteration on the same instance
    mod = (xe.algorithms.largest_entry if pkg is xe
           else xt.algorithms.largest_entry)
    out["iterated"] = mod._find_largest_entry(tt, 0.1, 0.0)
    out["rank one, 4^9"] = pkg.find_largest_entry(
        pkg.TTTensor.random([4] * 9, 1))
    out["rank two, 4^9"] = pkg.find_largest_entry(
        pkg.TTTensor.random([4] * 9, 2), accuracy=0.1)
    return out


def test_largest_entry_matches_jax():
    j, t = _both(c_largest_entry)
    assert t == j
    assert t["dirac"] == 1 * 12 + 2 * 3 + 0


# -- UQ-ADF ------------------------------------------------------------------

def _uq_samples(pkg, truth, count):
    rng = pkg.misc.randomEngine
    arr = truth.to_tensor().to_ndarray()
    rvs, sols = [], []
    for _ in range(count):
        rv = [float(rng.normal()), float(rng.normal())]
        w = [pkg.algorithms.randvar_to_position(v, 3) for v in rv]
        rvs.append(rv)
        sols.append(pkg.Tensor.from_ndarray(
            np.einsum("abc,b,c->a", arr, w[0], w[1])))
    return rvs, sols


def c_uq_adf(pkg):
    truth = pkg.TTTensor.random([4, 3, 3], 2)
    truth /= truth.frob_norm()
    rvs, sols = _uq_samples(pkg, truth, 120)
    x = pkg.TTTensor.random([4, 3, 3], 2)
    assert pkg.uq_adf(x, rvs, sols) is None
    return {"x": _dense(x), "ranks": x.ranks(),
            "flags": (bool(x.canonicalized), int(x.corePosition)),
            "err": float(np.linalg.norm(_dense(x) - _dense(truth)))}


def c_uq_adf_set(pkg):
    truth = pkg.TTTensor.random([3, 3, 3], 2)
    truth /= truth.frob_norm()
    arr = truth.to_tensor().to_ndarray()
    ms = pkg.UQMeasurementSet()
    for rv in ([1.0, 0.0], [0.0, 1.0]):
        w = [pkg.algorithms.randvar_to_position(v, 3) for v in rv]
        ms.add_initial(rv, pkg.Tensor.from_ndarray(
            np.einsum("abc,b,c->a", arr, w[0], w[1])))
    rvs, sols = _uq_samples(pkg, truth, 80)
    for rv, sol in zip(rvs, sols):
        ms.add(rv, sol)
    x = pkg.uq_adf(ms, pkg.TTTensor.random([3, 3, 3], 2))
    return {"x": _dense(x), "ranks": x.ranks()}


def c_uq_mc(pkg):
    tt = pkg.TTTensor.random([4, 3, 3], 2)
    rvs, sols = pkg.uq_mc(tt, 10, 1)
    avg = pkg.uq_avg(tt, 50)
    return {"rvs": np.array(rvs), "sols": np.stack([s.to_ndarray()
                                                    for s in sols]),
            "avg": avg.to_ndarray(),
            "embedding": pkg.algorithms.randvar_to_position(0.7, 4)}


@pytest.mark.parametrize("case", [c_uq_adf, c_uq_adf_set, c_uq_mc],
                         ids=lambda c: c.__name__[2:])
def test_uq_matches_jax(case):
    j, t = _both(case)
    _same(j, t)
    if case is c_uq_adf:
        assert t["err"] < 1e-3


def test_uq_adf_mesh_is_not_ported(tmp_path):
    """uq_adf(mesh=) (item 3b, ported) on a one-rank gloo mesh equals the
    run without one; a mesh that is not a DeviceMesh is refused.  The
    name is historical: the test once asserted that mesh= raised."""
    xt.set_seed(SEED)
    x = xt.TTTensor.random([3, 3], 1)
    rvs = [[0.1 * k] for k in range(8)]
    sols = [xt.Tensor.from_ndarray(np.array([1.0, 0.1 * k, 0.0]))
            for k in range(8)]
    with pytest.raises(TypeError, match="DeviceMesh"):
        xt.uq_adf(x.copy(), rvs, sols, mesh=object())
    y = x.copy()
    xt.uq_adf(x, rvs, sols, max_iterations=20)
    group, default_mesh = _one_rank_mesh(tmp_path)
    with group:
        xt.uq_adf(y, rvs, sols, max_iterations=20, mesh=default_mesh())
    assert np.abs(_dense(y) - _dense(x)).max() <= 1e-12 * np.abs(
        _dense(x)).max()


# -- measurement sets on objects --------------------------------------------

def c_measurements(pkg):
    tt = pkg.TTTensor.random([4, 3, 4], 2)
    dense = pkg.Tensor.random([4, 3, 4])
    sp = pkg.SinglePointMeasurementSet.random(15, tt)
    r1 = pkg.RankOneMeasurementSet.random(7, tt)
    cb = pkg.SinglePointMeasurementSet.random(
        5, [4, 3, 4], lambda p: float(sum(p)))
    out = {"sp pos": sp.positions, "sp vals": sp.measuredValues,
           "r1 vals": r1.measuredValues, "cb vals": cb.measuredValues,
           "sp test": sp.test(tt), "r1 test": r1.test(tt),
           "sp dense": sp.test(dense), "r1 dense": r1.test(dense)}
    sp.measure(dense)
    r1.measure(dense)
    out["sp on dense"] = sp.measuredValues
    out["r1 on dense"] = r1.measuredValues
    return out


def test_measurement_sets_on_objects_match_jax():
    j, t = _both(c_measurements)
    _same(j, t, rtol=1e-12)
    assert t["sp test"] == 0.0 and t["r1 test"] < 1e-12


# -- generators and models ---------------------------------------------------

def c_generators(pkg):
    ex = pkg.examples
    out = {"laplace": _dense(ex.laplace_operator([3, 4, 2])),
           "laplace 1": _dense(ex.laplace_operator([5])),
           "rhs": _dense(ex.poisson_rhs([2, 3, 2])),
           "heisenberg": _dense(ex.heisenberg_mpo(4, 1.0, 0.5, 0.3)),
           "heisenberg 1": _dense(ex.heisenberg_mpo(1, h=0.7)),
           "peaking": _dense(ex.peaking_diagonals(4, 3)),
           "norm ratio": [ex.inverse_index_norm([1, 2, 3]),
                          ex.inverse_index_ratio([1, 2, 3], 0.5)]}
    low = ex.random_low_rank([3] * 4, 2)
    out["low rank"] = _dense(low)
    out["low rank ranks"] = low.ranks()
    A, b, x0 = pkg.models.poisson_problem(4, 2, 3)
    out["poisson"] = [_dense(A), _dense(b), _dense(x0)]
    H, h0 = pkg.models.heisenberg_groundstate_problem(4, rank=2)
    out["heisenberg problem"] = [_dense(H), _dense(h0)]
    truth, ms, c0 = pkg.models.completion_problem([3] * 4, 2, 30)
    out["completion"] = [_dense(truth), _dense(c0)]
    out["completion pos"] = ms.positions
    out["completion vals"] = ms.measuredValues
    return out


def test_generators_and_models_match_jax():
    j, t = _both(c_generators)
    assert j.keys() == t.keys()
    for k in j:
        if isinstance(j[k], list) and isinstance(j[k][0], np.ndarray):
            for a, b in zip(t[k], j[k]):
                _close(a, b, 1e-12)
        elif isinstance(j[k], list) and isinstance(j[k][0], int):
            assert t[k] == j[k], k
        else:
            _close(t[k], j[k], 1e-12)


# -- PerformanceData ---------------------------------------------------------

def _perf_records(pkg, tmp_path):
    perf = pkg.PerformanceData(error_function=lambda x: 0.5 * x.degree())
    perf << "Poisson d=4\nrank 3"
    x = pkg.TTTensor.random([2] * 4, 2)
    for i, r in enumerate((1.0, 0.25, 0.01, 1e-4)):
        perf.add(r, x, i % 2)
    perf.add(1e-5, None, 3, iteration=10)
    for i, p in enumerate(perf.data):
        p.elapsed_time = 0.001 * (i + 1) ** 2      # a fixed clock
    path = tmp_path / f"{pkg.__name__}.dat"
    perf.dump_to_file(str(path))
    hist = perf.get_histogram(2.0, assume_convergence=True)
    return {"file": path.read_bytes(),
            "points": [(p.iteration, p.residual, p.error, p.ranks, p.flags)
                       for p in perf.data],
            "histogram": sorted(hist.buckets.items()),
            "total": hist.total_count(),
            "inactive": len(pkg.NoPerfData.data), "bool": bool(pkg.NoPerfData)}


def test_performance_data_matches_jax(tmp_path):
    j, t = _both(lambda pkg: _perf_records(pkg, tmp_path))
    assert t == j
    assert t["file"].startswith(b"# iteration\ttime\tresidual")


@pytest.mark.slow
def test_workload5_host_bump_in_both_packages():
    """Benchmark workload 5 (d=5, n=4, rank 3, 400 samples) drawn in the
    benchmark's order, then completed from rank 1 through the host-bump
    loop (check_every=1) in both packages: the same iterations, ranks
    [3, 3, 3, 3] and residual below the 1e-8 target."""
    def case(pkg):
        truth = pkg.TTTensor.random([4] * 5, 3)
        truth /= truth.frob_norm()
        ms = pkg.SinglePointMeasurementSet.random(400, [4] * 5)
        ms.measure(truth)
        x = pkg.TTTensor.random([4] * 5, 1)
        perf = pkg.PerformanceData()
        res = pkg.ADFVariant(400, 1e-8, 0.9999)(x, ms, max_ranks=[3] * 4,
                                                perf_data=perf)
        return _adf_state(res, x, ms, perf)

    j, t = _both(case, SEED + 5)
    _same(j, t, rtol=1e-6)
    assert t["ranks"] == [3] * 4 and t["res"] < 1e-8
