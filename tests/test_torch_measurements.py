"""The port's measurement sets (xerus_tpu_torch.algorithms.measurements)
held against xerus_tpu's on the CPU: one seed gives the same positions and
weights in both packages, and measure/test on a TT, a dense tensor and a
callback agree to 1e-12."""

import numpy as np
import pytest
import torch

import xerus_tpu as xe
from xerus_tpu import Tensor, TTTensor
from xerus_tpu_torch.algorithms import measurements as tm
from xerus_tpu_torch.convert import cores_to_torch

CPU = torch.device("cpu")


def _gen(seed):
    return np.random.Generator(np.random.PCG64(seed))


def _cores(tt):
    return list(cores_to_torch([np.asarray(c.to_ndarray())
                                for c in tt.components], CPU, torch.float64))


@pytest.mark.parametrize("num,dims", [(20, [4, 4, 4]), (150, [4] * 4),
                                      (61, [2, 5, 3, 4]), (9, [3, 3])])
def test_same_seed_same_positions(num, dims):
    xe.set_seed(1234 + num)
    j = xe.SinglePointMeasurementSet.random(num, dims)
    t = tm.SinglePointMeasurementSet.random(num, dims, rng=_gen(1234 + num))
    np.testing.assert_array_equal(t.positions, j.positions)
    assert t.positions.dtype == np.int64
    assert t.size() == num and t.degree() == len(dims)


def test_same_seed_same_rank_one_weights():
    xe.set_seed(77)
    j = xe.RankOneMeasurementSet.random(10, [3, 4, 3])
    t = tm.RankOneMeasurementSet.random(10, [3, 4, 3], rng=_gen(77))
    for a, b in zip(t.positions, j.positions):
        np.testing.assert_array_equal(a, b)


def test_single_point_measure_and_test_on_cores():
    xe.set_seed(5)
    dims = [4, 4, 4, 3]
    tt = TTTensor.random(dims, 3)
    j = xe.SinglePointMeasurementSet.random(40, dims)
    j.measure(tt)
    t = tm.SinglePointMeasurementSet.from_arrays(j.positions)
    t.measure(_cores(tt))
    np.testing.assert_allclose(t.measuredValues, j.measuredValues, rtol=0,
                               atol=1e-12)
    other = TTTensor.random(dims, 2)
    assert abs(t.test(_cores(other)) - j.test(other)) < 1e-12
    assert t.test(_cores(tt)) < 1e-12


def test_single_point_dense_and_callback():
    xe.set_seed(6)
    dims = [3, 3]
    j = xe.SinglePointMeasurementSet.random(5, dims)
    t = tm.SinglePointMeasurementSet.from_arrays(j.positions)
    dense = Tensor.random(dims)
    j.measure(dense)
    t.measure(dense.to_ndarray())
    np.testing.assert_allclose(t.measuredValues, j.measuredValues, atol=1e-12)
    t.measure(torch.from_numpy(np.asarray(dense.to_ndarray())))
    np.testing.assert_allclose(t.measuredValues, j.measuredValues, atol=1e-12)
    t.measure(lambda p: float(p[0] + p[1]))
    np.testing.assert_array_equal(t.measuredValues, t.positions.sum(axis=1))


def test_rank_one_measure_and_test_on_cores_and_dense():
    xe.set_seed(8)
    dims = [3, 4, 3]
    tt = TTTensor.random(dims, 2)
    j = xe.RankOneMeasurementSet.random(10, dims)
    j.measure(tt)
    t = tm.RankOneMeasurementSet.random(10, dims, rng=_gen(8 + 1))
    t.positions = j.positions
    t.measure(_cores(tt))
    np.testing.assert_allclose(t.measuredValues, j.measuredValues, rtol=0,
                               atol=1e-12)
    other = TTTensor.random(dims, 2)
    assert abs(t.test(_cores(other)) - j.test(other)) < 1e-12
    dense = tt.to_tensor()
    j.measure(dense)
    t.measure(np.asarray(dense.to_ndarray()))
    np.testing.assert_allclose(t.measuredValues, j.measuredValues, atol=1e-12)


def test_from_single_point_matches_reference():
    xe.set_seed(9)
    dims = [3, 2, 4]
    tt = TTTensor.random(dims, 2)
    sp = xe.SinglePointMeasurementSet.random(12, dims)
    sp.measure(tt)
    j = xe.RankOneMeasurementSet.from_single_point(sp, dims)
    t = tm.RankOneMeasurementSet.from_single_point(
        tm.SinglePointMeasurementSet.from_arrays(sp.positions,
                                                 sp.measuredValues), dims)
    for a, b in zip(t.positions, j.positions):
        np.testing.assert_array_equal(a, b)
    assert t.test(_cores(tt)) < 1e-12


def test_accessors_and_sort():
    """The per-measurement accessors and sort of
    tests/test_completion.py::test_measurement_accessors_and_sort."""
    sp = tm.SinglePointMeasurementSet()
    sp.add([2, 1, 0], 3.0)
    sp.add([0, 1, 2], 1.0)
    assert sp.get_position(0) == [2, 1, 0]
    assert sp.get_measuredValue(1) == 1.0
    sp.set_position(0, [1, 1, 1])
    sp.set_measuredValue(0, 7.0)
    sp.sort()
    assert sp.get_position(0) == [0, 1, 2]
    assert sp.get_measuredValue(0) == 1.0
    assert sp.get_measuredValue(1) == 7.0
    assert sp.frob_norm() == pytest.approx(np.sqrt(50.0))

    r1 = tm.RankOneMeasurementSet()
    r1.add([np.array([0.0, 2.0]), np.array([1.0, 0.0])], 4.0)
    r1.add([np.array([1.0, 0.0]), np.array([0.0, 3.0])], 6.0)
    np.testing.assert_array_equal(r1.get_position(0)[0], [0.0, 2.0])
    r1.set_measuredValue(0, 8.0)
    r1.sort()
    np.testing.assert_array_equal(r1.get_position(0)[0], [0.0, 2.0])
    assert r1.get_measuredValue(0) == 8.0
    r1.set_position(1, [np.array([0.5, 0.5]), np.array([1.0, 1.0])])
    np.testing.assert_array_equal(r1.get_position(1)[1], [1.0, 1.0])


def test_rank_one_normalize_matches_reference():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 4))
    j = xe.RankOneMeasurementSet()
    t = tm.RankOneMeasurementSet()
    for _ in range(5):
        w1, w2 = rng.normal(size=3) * 2.5, rng.normal(size=4) * 0.3
        j.add([w1, w2], float(w1 @ X @ w2))
        t.add([w1, w2], float(w1 @ X @ w2))
    j.normalize()
    t.normalize()
    for a, b in zip(t.positions, j.positions):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
    np.testing.assert_allclose(t.measuredValues, j.measuredValues, atol=1e-15)
    np.testing.assert_allclose(t._eval(X), t.measuredValues, atol=1e-12)


def test_positions_reach_a_device_once_and_are_range_checked():
    sp = tm.SinglePointMeasurementSet.from_arrays([[0, 1], [2, 0]],
                                                  [1.0, 2.0])
    a = sp.positions_on(CPU, [3, 2])
    assert a.dtype == torch.int64 and a.is_contiguous()
    assert sp.positions_on(CPU, [3, 2]) is a
    with pytest.raises(ValueError, match="out of range"):
        sp.positions_on(CPU, [2, 2])
    with pytest.raises(ValueError, match="degree"):
        sp.positions_on(CPU, [3, 2, 2])
    sp.add([1, 1], 3.0)
    assert sp.positions_on(CPU, [3, 2]) is not a
    cores = [torch.ones((1, 2, 1), dtype=torch.float64)] * 2
    with pytest.raises(ValueError, match="out of range"):
        tm.SinglePointMeasurementSet.from_arrays([[0, 2]]).measure(cores)


def test_too_many_measurements_and_bad_values_raise():
    with pytest.raises(ValueError, match="more measurements"):
        tm.SinglePointMeasurementSet.random(10, [3, 3], rng=_gen(0))
    with pytest.raises(ValueError, match="one value"):
        tm.SinglePointMeasurementSet.from_arrays([[0, 1]], [1.0, 2.0])
    with pytest.raises(TypeError, match="cannot measure"):
        tm.SinglePointMeasurementSet.from_arrays([[0, 1]]).measure("x")
