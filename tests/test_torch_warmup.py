"""The port's ``warmup`` (xerus_tpu_torch/warmup.py) held against the JAX
package's (xerus_tpu/warmup.py) on the CPU: the same shapes, signature and
names, the same ValueError; under ``host()`` it leaves the entries'
results bit for bit as they were, and the entries a user calls at the
family's shapes afterwards make no new program (their keys are the ones
warmup reached).  The card's side, captures and replays, is in
tests/test_torch_warmup_cuda.py."""

import importlib
import inspect

import numpy as np
import pytest
import torch

import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import qtt_poisson_instance
from xerus_tpu_torch.examples.warm_entries import kind_entries
from xerus_tpu_torch.ops import adf_kernels, programs
from xerus_tpu_torch.ops.adf_kernels import build_onehots

jax_warmup = importlib.import_module("xerus_tpu.warmup")
port_warmup = importlib.import_module("xerus_tpu_torch.warmup")

ALL_KINDS = ("round", "randomized", "streaming", "apply_round", "als",
             "df_round", "dmrg")
ALL_NAMES = {"round_gram", "round_svd", "round_randomized",
             "round_streaming", "apply_round", "als_lr", "als_rl",
             "df_round", "dmrg_lanczos", "adf_iteration"}
# tests/test_misc.py's warmup case
MISC_NAMES = {"round_gram", "round_svd", "round_randomized", "als_lr",
              "als_rl", "adf_iteration"}


@pytest.fixture
def cpu():
    with xt.host():
        yield torch.device("cpu")


@pytest.mark.parametrize("dims, rank", [
    ([2] * 5, 4), ([2] * 8, 6), ([3, 4, 2, 5], 7), ([4] * 10, 8),
    ([2] * 32, 30), ([7], 3)])
def test_tt_shapes_match_the_jax_package(dims, rank):
    assert port_warmup._tt_shapes(dims, rank) == jax_warmup._tt_shapes(
        dims, rank)


def test_signature_is_the_jax_packages():
    assert (inspect.signature(xt.warmup).parameters.keys()
            == inspect.signature(xe.warmup).parameters.keys())
    for name, p in inspect.signature(xe.warmup).parameters.items():
        assert inspect.signature(xt.warmup).parameters[name].default \
            == p.default, name


def test_misc_case_gives_its_names(cpu):
    times = xt.warmup([2] * 5, 4, target_rank=2, dtype="float64",
                      num_measurements=8)
    assert set(times) == MISC_NAMES
    assert all(isinstance(t, float) and t >= 0.0 for t in times.values())


@pytest.mark.parametrize("dtype, spd", [("float32", True),
                                        ("float64", False)])
def test_all_kinds_give_the_jax_names(cpu, dtype, spd):
    times = xt.warmup([2] * 5, 4, dtype=dtype, spd=spd, kinds=ALL_KINDS,
                      num_measurements=8)
    assert set(times) == ALL_NAMES


def test_dmrg_on_mixed_dims_raises_as_the_jax_package(cpu):
    with pytest.raises(ValueError) as port:
        xt.warmup([2, 3, 2], 2, kinds=("dmrg",))
    with pytest.raises(ValueError) as jax:
        xe.warmup([2, 3, 2], 2, kinds=("dmrg",))
    assert str(port.value) == str(jax.value)


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xt.warmup([2] * 5, 4, kinds=("round",))


def _family(dev, dims=(2,) * 6, rank=4, dtype=np.float64, seed=7):
    """Entries at a family's shapes on data other than warmup's."""
    rng = np.random.default_rng(seed)
    dims = list(dims)
    d = len(dims)
    x = [torch.from_numpy(rng.normal(size=s).astype(dtype)).to(dev)
         for s in port_warmup._tt_shapes(dims, rank)]
    # a sum of three Kronecker products of SPD matrices: an SPD operator
    # of rank 3, so the ALS half-sweeps' results are finite
    A = []
    for i, n in enumerate(dims):
        core = np.zeros((1 if i == 0 else 3, n, n, 1 if i == d - 1 else 3))
        for k in range(3):
            R = rng.normal(size=(n, n))
            core[0 if i == 0 else k, :, :, 0 if i == d - 1 else k] = (
                R @ R.T + n * np.eye(n))
        A.append(torch.from_numpy(core.astype(dtype)).to(dev))
    b = [torch.from_numpy(rng.normal(size=s).astype(dtype)).to(dev)
         for s in port_warmup._tt_shapes(dims, 1)]
    H = torch.from_numpy(rng.normal(size=(d, 5, dims[0], dims[0], 5))
                         .astype(dtype)).to(dev)
    P = torch.from_numpy(rng.integers(0, np.array(dims), size=(8, d))).to(dev)
    adf = (build_onehots(P, dims, x[0].dtype),
           torch.from_numpy(rng.normal(size=8).astype(dtype)).to(dev))
    return kind_entries(ALL_KINDS + ("adf_iteration",), x, rank // 2, A=A,
                        b=b, H=H, adf=adf)


def _same(a, b):
    la, lb = programs._leaves(a), programs._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def test_warmup_leaves_the_entries_results_bitwise(cpu):
    entries = _family(cpu)
    before = {name: entry(False) for name, entry in entries.items()}
    xt.warmup([2] * 6, 4, dtype="float64", kinds=ALL_KINDS,
              num_measurements=8)
    for name, entry in entries.items():
        assert _same(entry(False), before[name]), name


def test_entries_after_warmup_make_no_new_program(cpu):
    """Each factory's misses stay where warmup left them while the
    entries run at the family's shapes: every key they meet, warmup met
    first (also the rl half-sweeps', whose inputs are the lr sweeps'
    outputs with their strides)."""
    programs.clear()
    xt.warmup([2] * 6, 4, dtype="float64", kinds=ALL_KINDS,
              num_measurements=8)
    misses = [f.cache_info().misses for f in programs._FACTORIES]
    for entry in _family(cpu).values():
        entry(False)
    assert [f.cache_info().misses for f in programs._FACTORIES] == misses
    assert adf_kernels.make_adf_iteration.cache_info().hits > 0


def test_poisson_solve_after_warmup_makes_no_new_f32_program(cpu):
    """The f32 phase of the Poisson solve (``als_f32_df_run``) and
    ``ALS_SPD``'s ``als_run`` meet only the half-sweep programs the
    Poisson family's warmup made."""
    from xerus_tpu_torch.ops import als_kernels as ak
    from xerus_tpu_torch.ops import mixed_precision as mp
    xs, A, b = qtt_poisson_instance(6, 4, 0xBAADF00D)
    x32, A32, b32 = (cores_to_torch(t, cpu) for t in (xs, A, b))
    programs.clear()
    xt.warmup([2] * 6, 4, op_rank=2, kinds=("als",))
    misses = ak.make_als_sweep_res.cache_info().misses
    cores = x32
    for i in range(4):
        cores, _ = mp.f32_half_sweep(cores, A32, b32, i % 2 == 0)
    ak.als_run(x32, A32, b32, 0.0, 0, 4, np.inf, np.inf, 4)
    assert ak.make_als_sweep_res.cache_info().misses == misses


@pytest.mark.slow
def test_both_packages_warm_the_same_names(cpu):
    """Every kind through both packages' warmup (the JAX side compiles):
    the same names for the same arguments."""
    for kw in (dict(kinds=ALL_KINDS, num_measurements=8),
               dict(kinds=ALL_KINDS, num_measurements=8, dtype="float64",
                    spd=False, target_rank=3, op_rank=2),
               dict()):
        assert set(xt.warmup([2] * 5, 4, **kw)) == set(
            xe.warmup([2] * 5, 4, **kw))
