"""``xerus_tpu_torch.warmup`` on the card: after it, every entry a user
calls at the family's shapes replays (no capture), each result bit for
bit its function run eagerly; a second warmup of the family captures
nothing and builds nothing.

Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_warmup_cuda.py

Without a card every case skips (a CUDA graph needs one)."""

import numpy as np
import pytest
import torch

import xerus_tpu_torch as xt
from xerus_tpu_torch import build
from xerus_tpu_torch.examples.warm_entries import kind_entries
from xerus_tpu_torch.ops import programs
from xerus_tpu_torch.ops.adf_kernels import build_onehots
from xerus_tpu_torch.warmup import _tt_shapes

ALL_KINDS = ("round", "randomized", "streaming", "apply_round", "als",
             "df_round", "dmrg")
DIMS, RANK, M = [2] * 8, 6, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: programs are CUDA graphs")
    return torch.device("cuda")


def _entries(dev):
    rng = np.random.default_rng(11)
    d = len(DIMS)

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape)).to(dev)
    x = [t(s) for s in _tt_shapes(DIMS, RANK)]
    A = [t((1 if i == 0 else 3, n, n, 1 if i == d - 1 else 3))
         for i, n in enumerate(DIMS)]
    b = [t(s) for s in _tt_shapes(DIMS, 1)]
    P = torch.from_numpy(rng.integers(0, np.array(DIMS), size=(M, d)))
    adf = (build_onehots(P.to(dev), DIMS, torch.float64), t((M,)))
    return kind_entries(ALL_KINDS + ("adf_iteration",), x, RANK // 2, A=A,
                        b=b, H=t((d, 5, 2, 2, 5)), adf=adf)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b):
    la, lb = programs._leaves(a), programs._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _warm():
    return xt.warmup(DIMS, RANK, kinds=ALL_KINDS, num_measurements=M,
                     dtype="float64")


@pytest.mark.cuda
def test_entries_after_warmup_replay_bitwise_their_eager_runs(cuda):
    programs.clear()
    _warm()
    for name, entry in _entries(cuda).items():
        captures, replays = programs.Program.captures, programs.Program.replays
        eager_runs = programs.Program.eager_runs
        out = entry(False)
        torch.cuda.synchronize()
        assert programs.Program.captures == captures, name
        assert programs.Program.eager_runs == eager_runs, name
        if not name.startswith(("round_gram", "round_svd",
                                "round_streaming")):
            assert programs.Program.replays > replays, name
        assert _same(out, entry(True)), name


@pytest.mark.cuda
def test_a_second_warmup_captures_and_builds_nothing(cuda):
    _warm()
    counts = (programs.Program.captures, programs.Program.eager_runs)
    builds = dict(build.build_log)
    replays = programs.Program.replays
    _warm()
    assert (programs.Program.captures, programs.Program.eager_runs) == counts
    assert build.build_log == builds
    assert programs.Program.replays > replays
