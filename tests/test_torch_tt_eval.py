"""K3's plain version (xerus_tpu_torch.ops.tt_eval) and pad_cores held
against xerus_tpu's TT evaluation on the CPU: the XLA path
``_evaluate_tt_at_points`` and the Pallas kernel in interpret mode, on the
three cases of tests/test_pallas_kernels.py, at that file's tolerance
(atol 1e-12).  On the CPU the wrapper runs the plain version and launches
nothing; the kernel itself is held against it on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from xerus_tpu import Tensor, TTTensor
from xerus_tpu.algorithms.measurements import _evaluate_tt_at_points
from xerus_tpu.ops.pallas_tt_eval import pad_cores as jax_pad_cores
from xerus_tpu.ops.pallas_tt_eval import tt_eval_at_points_pallas
from xerus_tpu_torch.ops import tt_eval as te
from xerus_tpu_torch.ops.stacking import pad_cores

# (dims, ranks, M, block_m) of test_pallas_matches_xla_path,
# test_pallas_nonuniform_dims and test_pallas_block_padding
CASES = [([4] * 6, [5] * 5, 100, 32), ([2, 5, 3, 4], [2, 4, 3], 17, 8),
         ([3] * 4, [2] * 3, 13, 8)]


def _instance(dims, ranks, M, seed):
    rng = np.random.default_rng(seed)
    rs = [1] + list(ranks) + [1]
    cores = [rng.standard_normal((rs[k], n, rs[k + 1]))
             for k, n in enumerate(dims)]
    P = np.stack([rng.integers(0, n, size=M) for n in dims], axis=1)
    return cores, P.astype(np.int64)


def _tt(cores):
    return TTTensor._make([Tensor.from_ndarray(c) for c in cores])


@pytest.mark.parametrize("dims,ranks,M,block_m", CASES)
def test_plain_matches_xla_path_and_pallas_interpret(dims, ranks, M, block_m):
    cores, P = _instance(dims, ranks, M, M)
    ref = np.asarray(_evaluate_tt_at_points(_tt(cores), P))
    pallas = np.asarray(tt_eval_at_points_pallas(cores, P, block_m=block_m,
                                                 interpret=True))
    got = te.tt_eval_at_points_reference(
        [torch.from_numpy(c) for c in cores], torch.from_numpy(P))
    assert got.shape == (M,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims,ranks,M,block_m", CASES)
def test_pad_cores_matches_reference(dims, ranks, M, block_m):
    cores, _P = _instance(dims, ranks, M, 1)
    js, jr = jax_pad_cores(cores)
    ts, tr = pad_cores([torch.from_numpy(c) for c in cores])
    assert tr == jr
    assert tuple(ts.shape) == tuple(js.shape)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    cores, P = _instance([3, 4, 2], [2, 3], 9, 5)
    tc = [torch.from_numpy(c) for c in cores]
    calls0, launches0 = te.tt_eval_at_points.calls, te.tt_eval_at_points.launches
    got = te.tt_eval_at_points(tc, torch.from_numpy(P))
    assert te.tt_eval_at_points.calls == calls0 + 1
    assert te.tt_eval_at_points.launches == launches0
    assert torch.equal(got, te.tt_eval_at_points_reference(
        tc, torch.from_numpy(P)))


def test_wrapper_refuses_other_devices():
    cores = [torch.zeros((1, 2, 1), device="meta")]
    with pytest.raises(RuntimeError, match="no kernel"):
        te.tt_eval_at_points(cores, torch.zeros((1, 1), dtype=torch.int64,
                                                device="meta"))


def test_plain_version_evaluates_every_entry_of_a_small_tt():
    """Over the full grid the plain version is the dense contraction, in
    float32 and float64, and at M=0 it returns an empty vector."""
    cores, _ = _instance([2, 3, 2], [2, 2], 1, 9)
    dense = np.einsum("xai,ibj,jcy->abc", *cores).reshape(-1)
    grid = np.indices([2, 3, 2]).reshape(3, -1).T.copy()
    for dtype, tol in ((torch.float64, 1e-14), (torch.float32, 1e-6)):
        got = te.tt_eval_at_points_reference(
            [torch.from_numpy(c).to(dtype) for c in cores],
            torch.from_numpy(grid))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.double().numpy(), dense, rtol=tol,
                                   atol=tol)
    empty = te.tt_eval_at_points([torch.from_numpy(c) for c in cores],
                                 torch.zeros((0, 3), dtype=torch.int64))
    assert empty.shape == (0,)
