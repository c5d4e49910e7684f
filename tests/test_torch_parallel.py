"""The port's parallel layer (xerus_tpu_torch.parallel, ADF's and UQ-ADF's
``mesh=``) on gloo ranks of this host's CPU.

One spawn per tier: ``xerus_tpu_torch/examples/parallel_checks.py`` runs
as N processes of one gloo group (rendezvous: a file under the test's
temporary directory, so concurrent workers never collide; one intra-op
thread per rank), and every rank runs every parallel entry beside the
port's serial path on the same seeded inputs.  The default tier runs 2
ranks and holds each entry to the oracles of ``BARS`` (the JAX package's
own: tests/test_parallel.py and ``__graft_entry__.py``) on both ranks,
which must agree (the results are replicated).  The slow tier runs 8
ranks and also holds the port's results against the JAX package's
parallel functions on its 8-device CPU mesh (tests/conftest.py)."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from xerus_tpu_torch.examples.parallel_checks import BARS, misses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# no name in these tests reads the card; the workers see none
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def _spawn(world: int, tmp: str, timeout: float):
    """Start ``world`` ranks of the checks and return their results."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "xerus_tpu_torch.examples.parallel_checks",
         "--rank", str(r), "--world", str(world),
         "--init", f"file://{os.path.join(tmp, 'rendezvous')}",
         "--out", tmp], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(2, str(tmp_path_factory.mktemp("gloo2")), timeout=300)


def _replicated(results, name):
    """Every rank holds the same result of entry ``name``."""
    first = results[0][name]
    for other in results[1:]:
        for key, v in first.items():
            if key.startswith(("value", "energies")):
                np.testing.assert_array_equal(np.asarray(other[name][key]),
                                              np.asarray(v))


def test_default_mesh_and_placements(two_ranks):
    """default_mesh(2) follows the JAX package's rule (tp = 1 for two
    devices), and the placements shard what the JAX shardings shard."""
    for res in two_ranks:
        m = res["_mesh"]
        assert m["default_shape"] == (2, 1)
        assert m["names"] == ("dp", "tp")
        assert m["placements"] == [
            "(Shard(dim=0), Replicate())", "(Replicate(), Replicate())",
            "(Replicate(), Shard(dim=1))"]


@pytest.mark.parametrize("name", sorted(BARS))
def test_entry_meets_the_serial_oracle(two_ranks, name):
    """Each parallel entry against the port's serial path on 2 ranks."""
    for rank, res in enumerate(two_ranks):
        assert not [m for m in misses(res) if m.startswith(name + ".")
                    or m.startswith(name + ":")], (rank, res[name])
    _replicated(two_ranks, name)


def test_without_a_process_group_nothing_is_initialized():
    """No function initializes a process group behind the caller's back:
    without one the mesh constructor raises, and a mesh argument that is
    not a DeviceMesh is refused."""
    import torch.distributed as dist
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.parallel import default_mesh
    from xerus_tpu_torch.parallel.mesh import Axis
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        default_mesh()
    with pytest.raises(TypeError, match="DeviceMesh"):
        Axis(object(), "dp")
    with xt.host():
        xt.set_seed(1)
        x = xt.TTTensor.random([3] * 3, 1)
        ms = xt.SinglePointMeasurementSet.random(20, x)
        with pytest.raises(TypeError, match="DeviceMesh"):
            xt.ADF(x.copy(), ms, mesh=object())
    assert not dist.is_initialized()


# -- slow tier: 8 ranks, held to the JAX package's parallel layer


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    return _spawn(8, str(tmp_path_factory.mktemp("gloo8")), timeout=1200)


@pytest.mark.slow
def test_eight_ranks_meet_the_oracles(eight_ranks):
    for rank, res in enumerate(eight_ranks):
        assert res["_mesh"]["default_shape"] == (4, 2)
        assert misses(res) == [], rank
    for name in BARS:
        _replicated(eight_ranks, name)


@pytest.mark.slow
def test_eight_ranks_match_the_jax_package(eight_ranks):
    """The port's 8-rank results against xerus_tpu.parallel on the 8
    virtual CPU devices, on the inputs the port drew: the inner product
    (1e-10 relative), the ADF gradient (1e-10), the ALS local solve
    (1e-8), the TSQR rounding (1e-10 relative), the tp ALS half-sweep
    (1e-8 relative) and the batched DMRG energies (1e-10)."""
    import jax
    from jax.sharding import Mesh
    from xerus_tpu.parallel import (default_mesh, sharded_adf_gradient,
                                    sharded_als_local_solve,
                                    sharded_tt_inner, tt_round_tsqr,
                                    tp_als_half_sweep)
    from xerus_tpu.parallel.sharded_ops import \
        sharded_dmrg_half_sweep_batched
    res = eight_ranks[0]
    mesh = default_mesh(8)
    mesh1d = Mesh(np.array(jax.devices()[:8]), ("tp",))

    def full(cores):
        out = np.asarray(cores[0], np.float64)
        for c in cores[1:]:
            out = np.tensordot(out, np.asarray(c, np.float64), axes=1)
        return out.reshape(-1)

    got = float(sharded_tt_inner(*res["inner"]["inputs"], mesh))
    assert abs(got - res["inner"]["value"]) <= 1e-10 * abs(got)
    g = np.asarray(sharded_adf_gradient(*res["adf_gradient"]["inputs"],
                                        mesh))
    np.testing.assert_allclose(res["adf_gradient"]["value"], g, rtol=0,
                               atol=1e-10)
    s = np.asarray(sharded_als_local_solve(*res["als_local_solve"]["inputs"],
                                           mesh))
    np.testing.assert_allclose(res["als_local_solve"]["value"], s, rtol=0,
                               atol=1e-8)
    t = full(tt_round_tsqr(res["tsqr_gram"]["inputs"], 6, mesh1d))
    assert np.linalg.norm(t - res["tsqr_gram"]["value"]) \
        <= 1e-10 * np.linalg.norm(t)
    h = full(tp_als_half_sweep(*res["tp_half_sweep"]["inputs"], mesh1d,
                               cg_iters=200))
    assert np.linalg.norm(h - res["tp_half_sweep"]["value"]) \
        <= 1e-8 * np.linalg.norm(h)
    xs, A = res["dmrg_batched"]["inputs"]
    _, e = sharded_dmrg_half_sweep_batched(xs, A, 8, mesh, lobpcg_iters=16)
    np.testing.assert_allclose(res["dmrg_batched"]["energies"],
                               np.asarray(e), rtol=0, atol=1e-10)


@pytest.mark.slow
def test_eight_rank_adf_and_uq_adf_meshes_match_the_jax_package(
        eight_ranks):
    """ADFVariant(mesh=) and uq_adf(mesh=) of the port (8 gloo ranks)
    against the JAX package's on its 8-device mesh, the same instances
    drawn in both from one set_seed: the completed tensors within 1e-8
    (the dp ADF oracle) and 1e-10."""
    import xerus_tpu as xe
    from xerus_tpu.algorithms import randvar_to_position
    from xerus_tpu.parallel import default_mesh
    from xerus_tpu_torch.examples.parallel_checks import SEED
    res = eight_ranks[0]
    mesh = default_mesh(8)
    xe.set_seed(3)
    truth = xe.TTTensor.random([3] * 5, 2)
    arr = truth.to_tensor().to_ndarray()
    ms = xe.SinglePointMeasurementSet()
    for p in np.random.default_rng(0).integers(0, 3, size=(200, 5)):
        ms.add([int(q) for q in p], float(arr[tuple(p)]))
    x1 = xe.TTTensor.random([3] * 5, 2)
    xe.ADFVariant(25, 1e-10, 0.999)(x1, ms, mesh=mesh)
    a = x1.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(a - res["adf_mesh"]["value"]) \
        <= 1e-8 * np.linalg.norm(a)

    xe.set_seed(SEED + 7)
    dims = [4, 3, 3]
    truth = xe.TTTensor.random(dims, 2)
    truth /= truth.frob_norm()
    rng = np.random.default_rng(21)
    arr = truth.to_tensor().to_ndarray()
    rvs, sols = [], []
    for _ in range(64):
        rv = [float(rng.normal()), float(rng.normal())]
        sols.append(xe.Tensor.from_ndarray(np.einsum(
            "abc,b,c->a", arr, randvar_to_position(rv[0], 3),
            randvar_to_position(rv[1], 3))))
        rvs.append(rv)
    x0 = xe.TTTensor.random(dims, 2)
    xe.uq_adf(x0, rvs, sols, max_iterations=40, mesh=mesh)
    u = x0.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(u - res["uq_adf_mesh"]["value"]) \
        <= 1e-10 * np.linalg.norm(u)
