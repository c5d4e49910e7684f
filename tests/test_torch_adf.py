"""The port's completion path (xerus_tpu_torch.ops.adf_kernels,
algorithms.adf, iht, largest_entry, examples.completion) held against
xerus_tpu on the CPU.

QR signs differ between jnp and torch, and the ADF step is
gauge-covariant, so only gauge-free quantities are compared: the
represented tensor (densified in float64), residuals, residual histories
and iteration counts, values at points, ranks.  Tolerances: one iteration
rtol 1e-10; residual histories of whole fixed-rank solves rtol 1e-8 (for
rank-one sets with an absolute floor of 1e-14: the residuals are relative
to the measured values' norm, and near the 1e-8 target their last bits are
float64 rounding of sums of size 1).  The
rank bumps of the adaptive solve draw from jax.random in the JAX package
and from a torch.Generator in the port, so adaptive solves are compared by
what they reach, not by their iterates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xerus_tpu as xe
from xerus_tpu import TTTensor
from xerus_tpu.ops import adf_kernels as jak
from xerus_tpu_torch.algorithms import adf as tadf
from xerus_tpu_torch.algorithms import iht as tiht
from xerus_tpu_torch.algorithms import largest_entry as tle
from xerus_tpu_torch.algorithms.measurements import (RankOneMeasurementSet,
                                                     SinglePointMeasurementSet)
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import host_full_tensor, workload5_instance
from xerus_tpu_torch.ops import adf_kernels as tak
from xerus_tpu_torch.ops import round_kernels as rk

CPU = torch.device("cpu")


def _np_cores(tt):
    return [np.asarray(c.to_ndarray()) for c in tt.components]


def _t(cores, dtype=torch.float64):
    return list(cores_to_torch([np.asarray(c) for c in cores], CPU, dtype))


def _dense(cores):
    return host_full_tensor([np.asarray(c.detach().cpu() if isinstance(
        c, torch.Tensor) else c, np.float64) for c in cores])


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _random_cores(dims, ranks, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    rs = [1] + list(ranks) + [1]
    return [rng.standard_normal((rs[k], n, rs[k + 1])) * scale
            for k, n in enumerate(dims)]


def _point_problem(dims, ranks, M, seed):
    rng = np.random.default_rng(seed + 1)
    cores = _random_cores(dims, ranks, seed)
    P = np.stack([rng.integers(0, n, size=M) for n in dims], axis=1)
    vals = rng.standard_normal(M)
    return cores, P.astype(np.int64), vals


def _completion(dims, rank, num, seed, start_rank=None):
    """The instance of tests/test_completion.py's ADF tests, built by the
    JAX package; returns (JAX set, port set, start TT)."""
    xe.set_seed(seed)
    target = TTTensor.random(dims, rank)
    target /= target.frob_norm()
    ms = xe.SinglePointMeasurementSet.random(num, dims)
    ms.measure(target)
    x0 = TTTensor.random(dims, rank if start_rank is None else start_rank)
    port = SinglePointMeasurementSet.from_arrays(ms.positions,
                                                 ms.measuredValues)
    return ms, port, x0


# -- one iteration -------------------------------------------------------

def test_one_iteration_matches_reference():
    dims = [3, 4, 2, 3]
    cores, P, vals = _point_problem(dims, [2, 3, 2], 90, 11)
    j_new, j_res = jak._adf_iteration(
        tuple(jnp.asarray(c) for c in cores),
        jak.build_onehots(P, dims, np.float64), jnp.asarray(vals))
    t_new, t_res = tak._adf_iteration(
        tuple(_t(cores)), tak.build_onehots(torch.from_numpy(P), dims,
                                            torch.float64),
        torch.from_numpy(vals))
    np.testing.assert_allclose(float(t_res), float(j_res), rtol=1e-10)
    assert _rel(_dense(t_new), _dense([np.asarray(c) for c in j_new])) < 1e-10


def test_one_rankone_iteration_matches_reference():
    dims = [3, 4, 3]
    cores = _random_cores(dims, [2, 2], 12)
    rng = np.random.default_rng(13)
    Ws = [rng.standard_normal((50, n)) for n in dims]
    vals = rng.standard_normal(50)
    j_new, j_res = jak._adf_iteration_rankone(
        tuple(jnp.asarray(c) for c in cores),
        tuple(jnp.asarray(w) for w in Ws), jnp.asarray(vals))
    t_new, t_res = tak._adf_iteration_rankone(
        tuple(_t(cores)), tuple(torch.from_numpy(w) for w in Ws),
        torch.from_numpy(vals))
    np.testing.assert_allclose(float(t_res), float(j_res), rtol=1e-10)
    assert _rel(_dense(t_new), _dense([np.asarray(c) for c in j_new])) < 1e-10


def test_float32_step_size_with_an_empty_slice_stays_finite():
    """The JAX package's jnp.maximum(norms, 1e-300) is max(norms, 0) in
    float32; the where keeps a slice without measurements at step 0."""
    dims = [3, 3, 3]
    cores, P, vals = _point_problem(dims, [2, 2], 30, 14)
    P[:, 1] = np.minimum(P[:, 1], 1)           # slice 2 of mode 1: empty
    j_new, j_res = jak._adf_iteration(
        tuple(jnp.asarray(c, jnp.float32) for c in cores),
        jak.build_onehots(P, dims, np.float32), jnp.asarray(vals, jnp.float32))
    t_new, t_res = tak._adf_iteration(
        tuple(_t(cores, torch.float32)),
        tak.build_onehots(torch.from_numpy(P), dims, torch.float32),
        torch.from_numpy(vals).float())
    assert all(torch.isfinite(c).all() for c in t_new)
    np.testing.assert_allclose(float(t_res), float(j_res), rtol=1e-5)
    assert _rel(_dense(t_new), _dense([np.asarray(c) for c in j_new])) < 1e-4
    alpha = tak._step_size(torch.tensor([1.0, 2.0]), torch.tensor([0.0, 4.0]))
    assert alpha.tolist() == [0.0, 0.5]


def test_canonicalize_left_matches_reference():
    cores = _random_cores([3, 4, 2], [3, 2], 15)
    j = jak.canonicalize_left_cores(tuple(jnp.asarray(c) for c in cores))
    t = tak.canonicalize_left_cores(_t(cores))
    assert _rel(_dense(t), _dense([np.asarray(c) for c in j])) < 1e-13
    for c in t[1:]:
        m = c.reshape(c.shape[0], -1)
        np.testing.assert_allclose((m @ m.T).numpy(), np.eye(m.shape[0]),
                                   atol=1e-13)


# -- padded, rank-masked form --------------------------------------------

def _padded(cores, caps):
    d = len(cores)
    out = []
    for k, c in enumerate(cores):
        capL = 1 if k == 0 else caps[k - 1]
        capR = 1 if k == d - 1 else caps[k]
        buf = np.zeros((capL, c.shape[1], capR))
        buf[:c.shape[0], :, :c.shape[2]] = c
        out.append(buf)
    return out


def _assert_dead_slots_zero(cores, ranks):
    for k, c in enumerate(cores):
        if k > 0:
            assert torch.all(c[ranks[k - 1]:] == 0)
        if k < len(cores) - 1:
            assert torch.all(c[:, :, ranks[k]:] == 0)


@pytest.mark.parametrize("rank_one", [False, True])
def test_masked_iteration_and_left_sweep_match_reference(rank_one):
    dims, ranks, caps = [3, 4, 4, 3], [1, 2, 2], [3, 3, 3]
    cores, P, vals = _point_problem(dims, ranks, 80, 16)
    padded = _padded(cores, caps)
    if rank_one:
        rng = np.random.default_rng(17)
        Ws = [rng.standard_normal((80, n)) for n in dims]
        j_oh = tuple(jnp.asarray(w) for w in Ws)
        t_oh = tuple(torch.from_numpy(w) for w in Ws)
    else:
        j_oh = jak.build_onehots(P, dims, np.float64)
        t_oh = tak.build_onehots(torch.from_numpy(P), dims, torch.float64)
    jr = jnp.asarray(ranks, jnp.int32)
    j_new, j_res = jak._adf_iteration_masked(
        tuple(jnp.asarray(c) for c in padded), j_oh, jnp.asarray(vals), jr,
        tuple(caps), jnp.float64, rank_one)
    j_new = jak._canonicalize_left_masked(j_new, jr, tuple(caps), jnp.float64)
    t_new, t_res = tak._adf_iteration_masked(
        tuple(_t(padded)), t_oh, torch.from_numpy(vals), ranks, caps,
        torch.float64, rank_one)
    _assert_dead_slots_zero(t_new, ranks)
    t_new = tak._canonicalize_left_masked(t_new, ranks, caps, torch.float64)
    _assert_dead_slots_zero(t_new, ranks)
    np.testing.assert_allclose(float(t_res), float(j_res), rtol=1e-10)
    assert _rel(_dense(t_new), _dense([np.asarray(c) for c in j_new])) < 1e-10
    # the unpadded cores of a fixed-rank iteration give the same tensor
    u_new, u_res = (tak._adf_iteration_rankone if rank_one
                    else tak._adf_iteration)(tuple(_t(cores)), t_oh,
                                             torch.from_numpy(vals))
    np.testing.assert_allclose(float(u_res), float(t_res), rtol=1e-12)
    assert _rel(_dense(u_new), _dense(t_new)) < 1e-12


def test_bump_cores_with_the_reference_vectors():
    dims, ranks, caps = [3, 4, 4, 3], [1, 3, 2], [3, 3, 3]
    cores = _padded(_random_cores(dims, ranks, 18), caps)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, len(dims))
    gs = [torch.tensor(np.asarray(
        jax.random.normal(keys[k], (n,), jnp.float64))) for k, n in
          enumerate(dims)]
    j_new, j_ranks = jak._bump_cores(
        tuple(jnp.asarray(c) for c in cores), jnp.asarray(ranks, jnp.int32),
        tuple(caps), key, 0.25, jnp.float64)
    t_new, t_ranks = tak._bump_cores(tuple(_t(cores)), ranks, caps, gs, 0.25,
                                     torch.float64)
    assert t_ranks == [int(r) for r in np.asarray(j_ranks)] == [2, 3, 3]
    for a, b in zip(t_new, j_new):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)


# -- whole solves ----------------------------------------------------------

def _port_solve(variant, x0, ms, **kw):
    return tadf.adf_cores(variant, _t(_np_cores(x0)), ms, **kw)


def test_fixed_rank_device_run_matches_reference():
    """tests/test_completion.py::test_adf_device_loop_matches_per_iteration's
    instance: the converging run and the run with its stop rules off.  The
    port's K=1, chained-K and device drivers give the JAX device run's
    iteration count and residual history."""
    jms, ms, x3 = _completion([4] * 4, 2, 150, 0xBAADF00D)
    pd = xe.PerformanceData()
    x = x3.copy()
    rj = xe.ADFVariant(300, 1e-8, 0.999)(x, jms, perf_data=pd,
                                         check_every="device")
    jhist = np.array([p.residual for p in pd.data])
    for check_every in ("device", 1, 4):
        out = _port_solve(tadf.ADFVariant(300, 1e-8, 0.999), x3, ms,
                          check_every=check_every)
        assert out.iterations == len(jhist), check_every
        np.testing.assert_allclose(out.history, jhist, rtol=1e-8)
        np.testing.assert_allclose(out.residual, rj, rtol=1e-8)
    assert out.residual < 1e-6 and ms.test(out.cores) < 1e-5

    # K=4 divides the 8 iterations: no chained overshoot past the cap
    x = x3.copy()
    xe.ADFVariant(8, 0.0, 1.0)(x, jms, check_every="device")
    for check_every in ("device", 1, 4):
        out = _port_solve(tadf.ADFVariant(8, 0.0, 1.0), x3, ms,
                          check_every=check_every)
        assert out.iterations == 8
        assert _rel(_dense(out.cores), _dense(_np_cores(x))) < 1e-8


def test_device_run_carries_the_stagnation_window_across_dispatches(
        monkeypatch):
    """With dispatches of 5 iterations the fixed-rank device run stops
    where one dispatch would: res_dec and last enter each dispatch."""
    jms, ms, x0 = _completion([4] * 4, 2, 150, 0xBAADF00D)
    whole = _port_solve(tadf.ADFVariant(300, 1e-8, 0.999), x0, ms,
                        check_every="device")
    monkeypatch.setattr(tadf, "CAP", 5)
    chunked = _port_solve(tadf.ADFVariant(300, 1e-8, 0.999), x0, ms,
                          check_every="device")
    assert chunked.iterations == whole.iterations
    np.testing.assert_allclose(chunked.history, whole.history, rtol=1e-12)


def test_adaptive_run_restarts_its_window_per_dispatch_as_reference():
    """At full rank (no bump, so no random kick) the adaptive run is
    deterministic: dispatched 8 iterations at a time, each dispatch
    starting with an empty stagnation window and the last residual carried
    in, the port's counts and histories follow the JAX program's."""
    jms, ms, x0 = _completion([4] * 4, 2, 150, 0xBAADF00D)
    dims, caps = [4] * 4, (2, 2, 2)
    cores = [np.asarray(c) for c in jak.canonicalize_left_cores(
        tuple(jnp.asarray(c) for c in _np_cores(x0)))]
    nv = float(np.linalg.norm(jms.measuredValues))
    fn = jak.make_adf_adaptive_run(tuple(c.shape for c in cores), "float64",
                                   8, caps, 1e-6)
    j_oh = jak.build_onehots(jms.positions, dims, np.float64)
    t_oh = tak.build_onehots(torch.from_numpy(jms.positions), dims,
                             torch.float64)
    jc, tc = tuple(jnp.asarray(c) for c in cores), tuple(_t(cores))
    jvals = jnp.asarray(jms.measuredValues)
    tvals = torch.tensor(np.array(jms.measuredValues))
    last, counts = nv, []
    for _ in range(6):
        jc, jr, jh, jn = fn(jc, j_oh, jvals, jnp.asarray(1e-8 * nv),
                            jnp.asarray(0.999), jnp.asarray(caps, jnp.int32),
                            jnp.asarray(last), jnp.asarray(8, jnp.int32))
        tc, tr, th, tn = tak.adf_adaptive_run(
            tc, t_oh, tvals, 1e-8 * nv, 0.999, list(caps), last, 8, 8, caps,
            1e-6, torch.Generator().manual_seed(0))
        assert tn == int(jn) and tr == list(caps)
        np.testing.assert_allclose(th[:tn].numpy(), np.asarray(jh)[:tn],
                                   rtol=1e-8)
        last = float(th[tn - 1])
        counts.append(tn)
        if tn < 8:
            break
    assert counts[-1] < 8 and len(counts) > 1
    assert _rel(_dense(tc), _dense([np.asarray(c) for c in jc])) < 1e-8


def test_device_run_counts_one_host_read_per_iteration():
    jms, ms, x0 = _completion([4] * 4, 2, 150, 0xBAADF00D)
    reads0 = rk.host_bool.reads
    out = _port_solve(tadf.ADFVariant(300, 1e-8, 0.999), x0, ms,
                      check_every="device")
    assert rk.host_bool.reads - reads0 == out.iterations


def test_rank_one_device_run_matches_reference():
    xe.set_seed(0xBAADF00D)
    dims = [3] * 3
    target = TTTensor.random(dims, 2)
    target /= target.frob_norm()
    jms = xe.RankOneMeasurementSet.random(60, dims)
    jms.measure(target)
    x0 = TTTensor.random(dims, 2)
    ms = RankOneMeasurementSet.from_arrays(jms.positions, jms.measuredValues)
    pd = xe.PerformanceData()
    xe.ADFVariant(300, 1e-8, 0.999)(x0.copy(), jms, perf_data=pd,
                                    check_every="device")
    out = _port_solve(tadf.ADFVariant(300, 1e-8, 0.999), x0, ms,
                      check_every="device")
    jhist = np.array([p.residual for p in pd.data])
    assert out.iterations == len(jhist)
    np.testing.assert_allclose(out.history, jhist, rtol=1e-8, atol=1e-14)
    assert out.residual < 1e-5


def test_small_adaptive_run_reaches_the_target_in_both_packages():
    """dims [4]*4, rank 1 -> 2, check_every="device": both packages reach
    the 1e-8 target at ranks [2, 2, 2]."""
    jms, ms, x0 = _completion([4] * 4, 2, 150, 0xBAADF00D + 3, start_rank=1)
    xj = x0.copy()
    rj = xe.ADFVariant(400, 1e-8, 0.9999)(xj, jms, max_ranks=[2] * 3,
                                          check_every="device")
    out = _port_solve(tadf.ADFVariant(400, 1e-8, 0.9999), x0, ms,
                      max_ranks=[2] * 3, check_every="device")
    assert xj.ranks() == out.ranks == [2, 2, 2]
    assert rj < 1e-8 and out.residual < 1e-8
    assert ms.test(out.cores) < 1e-8


def test_adaptive_rank_one_run_reaches_the_target():
    """tests/test_completion.py::test_adf_adaptive_device_run_rank_one on
    the port."""
    xe.set_seed(0xBAADF00D + 9)
    dims = [3] * 4
    truth = TTTensor.random(dims, 2)
    truth /= truth.frob_norm()
    jms = xe.RankOneMeasurementSet.random(200, dims)
    jms.measure(truth)
    x0 = TTTensor.random(dims, 1)
    ms = RankOneMeasurementSet.from_arrays(jms.positions, jms.measuredValues)
    out = _port_solve(tadf.ADFVariant(400, 1e-8, 0.9999), x0, ms,
                      max_ranks=[2] * 3, check_every="device")
    assert out.ranks == [2, 2, 2]
    assert out.residual < 1e-7 and ms.test(out.cores) < 1e-7


def test_host_bump_path_waits_for_the_object_layer():
    """At core level the K=1 and chained drivers solve at the cores' ranks:
    the rank growth of the host-bump loop belongs to the object layer
    (ADFVariant.__call__ on a TTTensor, tests/test_torch_algorithms.py),
    which reaches the maximal ranks."""
    jms, ms, x0 = _completion([4] * 4, 2, 150, 0xBAADF00D, start_rank=1)
    for check_every in (1, 4):
        out = _port_solve(tadf.ADFVariant(30, 1e-8, 0.999), x0, ms,
                          max_ranks=[2] * 3, check_every=check_every)
        assert out.ranks == [1, 1, 1] and 0 < out.iterations <= 30
    import xerus_tpu_torch as xt
    with xt.host():
        x = xt.convert.tt_from_numpy(_np_cores(x0))
        res = tadf.ADFVariant(300, 1e-8, 0.999)(x, ms, max_ranks=[2] * 3)
    assert x.ranks() == [2, 2, 2] and res < 1e-6


def test_reduce_to_maximal_ranks_matches_reference():
    for ranks, dims in (([8] * 9, [4] * 10), ([3] * 4, [4] * 5),
                        ([5, 5], [2, 3, 2])):
        assert (tadf.reduce_to_maximal_ranks(ranks, dims)
                == TTTensor.reduce_to_maximal_ranks(ranks, dims))
    assert tadf.reduce_to_maximal_ranks([8] * 9, [4] * 10) == [4] + [8] * 7 + [4]


# -- IHT, largest entry, instances -----------------------------------------

def test_iht_matches_reference():
    """tests/test_completion.py::test_iht_runs_and_stays_bounded's size,
    from a start off the solution: residuals and iterate agree."""
    jms, ms, _ = _completion([3] * 3, 2, 25, 0xBAADF00D)
    xe.set_seed(21)
    x0 = TTTensor.random([3] * 3, 2)
    xj = x0.copy()
    rj = xe.IHT(xj, jms, max_iterations=3)
    cores, rt = tiht.iht_cores(_t(_np_cores(x0)), ms, max_iterations=3)
    np.testing.assert_allclose(rt, rj, rtol=1e-8)
    assert _rel(_dense(cores), _dense(_np_cores(xj))) < 1e-8
    # at the solution the residual stays tiny
    target_ms = SinglePointMeasurementSet.from_arrays(jms.positions,
                                                      jms.measuredValues)
    xs = TTTensor.random([3] * 3, 2)
    target_ms.measure(_t(_np_cores(xs)))
    _, r = tiht.iht_cores(_t(_np_cores(xs)), target_ms, max_iterations=3)
    assert np.isfinite(r) and r < 1e-8


def test_iht_large_x_matches_reference():
    from xerus_tpu.algorithms.iht import _build_large_x
    dims = [3, 2, 4]
    cores = _random_cores(dims, [2, 2], 22)
    P = np.array([[0, 1, 3], [2, 0, 1], [1, 1, 0]], dtype=np.int64)
    scaled = np.array([0.5, -1.0, 2.0])
    jl = _build_large_x(TTTensor._make([xe.Tensor.from_ndarray(c)
                                        for c in cores]), P, scaled)
    tl = tiht._build_large_x(_t(cores), torch.from_numpy(P),
                             torch.from_numpy(scaled))
    for a, b in zip(tl, jl.components):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.to_ndarray()))


def test_largest_entry_matches_reference():
    xe.set_seed(31)
    small = TTTensor.random([4] * 5, 3)
    assert (tle.find_largest_entry_cores(_t(_np_cores(small)))
            == xe.find_largest_entry(small))
    rank1 = TTTensor.random([4] * 9, 1)       # 262,144 entries, rank one
    general = TTTensor.random([4] * 9, 2)    # the squaring iteration
    import xerus_tpu_torch as xt
    with xt.host():                          # TTs past 65,536 entries
        assert (tle.find_largest_entry_cores(_t(_np_cores(rank1)))
                == xe.find_largest_entry(rank1))
        assert (tle.find_largest_entry_cores(_t(_np_cores(general)), 0.1)
                == xe.find_largest_entry(general, 0.1))


def test_workload5_instance_equals_the_reference_instance():
    """benchmarks/all_workloads.py workload 5's instance, built by the JAX
    package from the same seed: truth to 1e-14, positions exactly."""
    xe.set_seed(0xBAADF00D + 5)
    dims = [4] * 5
    truth = TTTensor.random(dims, 3)
    truth /= truth.frob_norm()
    jms = xe.SinglePointMeasurementSet.random(400, dims)
    jms.measure(truth)
    xc0 = TTTensor.random(dims, 1)
    inst = workload5_instance()
    np.testing.assert_allclose(host_full_tensor(inst.truth),
                               _dense(_np_cores(truth)), rtol=0, atol=1e-14)
    np.testing.assert_array_equal(inst.measurements.positions, jms.positions)
    np.testing.assert_allclose(inst.measurements.measuredValues,
                               jms.measuredValues, rtol=0, atol=1e-14)
    np.testing.assert_allclose(host_full_tensor(inst.start),
                               _dense(_np_cores(xc0)), rtol=0, atol=1e-14)
    assert inst.max_ranks == [3] * 4


def _workload5_port():
    inst = workload5_instance()
    out = tadf.adf_cores(
        tadf.ADFVariant(400, 1e-8, 0.9999), _t(inst.start),
        inst.measurements, max_ranks=inst.max_ranks,
        check_every="device")
    return inst, out


def test_workload5_on_the_port():
    """Benchmark workload 5 on the port (CPU): sample residual < 1e-8,
    ranks [3, 3, 3, 3], the largest entry found exactly."""
    inst, out = _workload5_port()
    assert out.residual < 1e-8 and out.ranks == [3, 3, 3, 3]
    arr = np.abs(_dense(out.cores))
    pos = tle.find_largest_entry_cores(out.cores, accuracy=0.05)
    assert arr[pos] == arr.max()


@pytest.mark.slow
def test_workload5_in_both_packages():
    """Workload 5 end to end in both packages: both below the 1e-8 target
    at ranks [3, 3, 3, 3], the same largest-entry position."""
    xe.set_seed(0xBAADF00D + 5)
    dims = [4] * 5
    truth = TTTensor.random(dims, 3)
    truth /= truth.frob_norm()
    jms = xe.SinglePointMeasurementSet.random(400, dims)
    jms.measure(truth)
    xj = TTTensor.random(dims, 1)
    rj = xe.ADFVariant(400, 1e-8, 0.9999)(xj, jms, max_ranks=[3] * 4,
                                          check_every="device")
    inst, out = _workload5_port()
    assert rj < 1e-8 and out.residual < 1e-8
    assert xj.ranks() == out.ranks == [3, 3, 3, 3]
    assert (tle.find_largest_entry_cores(out.cores, accuracy=0.05)
            == xe.find_largest_entry(xj, accuracy=0.05))
