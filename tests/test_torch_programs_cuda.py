"""The port's captured programs (ops/programs.py) on the card: each
program's replay against its function run eagerly, bit for bit, at small
sizes; launch counters through replays; a hidden host read raising at
capture; outputs a caller holds surviving the next replay.

Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_programs_cuda.py

Without a card every case skips (a CUDA graph needs one)."""

import numpy as np
import pytest
import torch

from xerus_tpu_torch.convert import cores_to_df, cores_to_torch
from xerus_tpu_torch.examples import qtt_poisson_instance
from xerus_tpu_torch.ops import adf_kernels as ak
from xerus_tpu_torch.ops import als_kernels as alk
from xerus_tpu_torch.ops import df_loops as dl
from xerus_tpu_torch.ops import mixed_precision as mp
from xerus_tpu_torch.ops import programs as pg
from xerus_tpu_torch.ops import round_kernels as rk
from xerus_tpu_torch.ops.df_matvec import df_matvec

SEED = 0xBAADF00D


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: programs are CUDA graphs")
    return torch.device("cuda")


def _same(a, b):
    la, lb = pg._leaves(a), pg._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _solve_args(d, rank, dev):
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    return (cores_to_torch(xs, dev), cores_to_torch(A, dev),
            cores_to_torch(b, dev), cores_to_df(A, dev), cores_to_df(b, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["lr", "rl"])
def test_sweep_program_replays_equal_eager(cuda, direction):
    xs, A, b = qtt_poisson_instance(6, 4, SEED)
    x, A, b = (cores_to_torch(t, cuda) for t in (xs, A, b))
    key = pg.shapes_key(x, A, b)
    prog = alk.make_als_sweep_res(key, "float32", direction)
    eager = prog.fn(x, A, b)
    # EAGER_CALLS eager runs, a warm-up and capture, two replays
    runs = [prog(x, A, b) for _ in range(pg.EAGER_CALLS + 3)]
    assert prog.eager_runs == pg.EAGER_CALLS and prog.captures == 1
    assert prog.replays == 2 and prog.nodes > 0
    assert all(_same(r, eager) for r in runs)


@pytest.mark.cuda
@pytest.mark.parametrize("d,rank", [(8, 5), (12, 23)])
def test_mixed_solve_replays_equal_eager_and_count_launches(cuda, d, rank):
    """The whole mixed solve, four times through the programs: the first
    runs them eagerly, a later one captures them, the fourth replays only.
    Each equals the eager run bit for bit and counts the same K1, K1q and
    df_qr numbers (at d=12 rank 23 two sites pass K1's gate)."""
    args = _solve_args(d, rank, cuda)
    pg.clear()                                # capture anew here

    def counted(**kw):
        df_matvec.launches = dl.df_qr_launch.launches = mp.df_qr.calls = 0
        out = mp.als_f32_df_run(*args, 16, 2, **kw)
        torch.cuda.synchronize()
        return out, (df_matvec.launches, dl.df_qr_launch.launches,
                     mp.df_qr.calls)

    eager, n_eager = counted(eager=True)
    captures = pg.Program.captures
    runs = [counted() for _ in range(3)]
    assert pg.Program.captures - captures >= 2
    captures, replays = pg.Program.captures, pg.Program.replays
    runs.append(counted())
    assert pg.Program.captures == captures
    assert pg.Program.replays - replays == runs[-1][0][2] + 2
    assert n_eager[1] == n_eager[2] == 2 * (d - 1)
    assert n_eager[0] == (12 if (d, rank) == (12, 23) else 0)
    for out, n in runs:
        assert n == n_eager
        assert _same(out[:2], eager[:2]) and out[2] == eager[2]


@pytest.mark.cuda
def test_adf_programs_replay_equal_eager(cuda):
    rng = np.random.Generator(np.random.PCG64(SEED))
    dims, caps = [4] * 5, [3, 3, 3, 3]
    truth = [rng.normal(size=s) for s in
             ((1, 4, 3), (3, 4, 3), (3, 4, 3), (3, 4, 3), (3, 4, 1))]
    pos = np.stack([rng.integers(0, 4, size=400) for _ in dims], axis=1)
    vals = np.ones((400, 1))
    for k, c in enumerate(truth):
        vals = np.einsum("ma,amb->mb", vals, c[:, pos[:, k], :])
    oh = ak.build_onehots(torch.from_numpy(pos).to(cuda), dims,
                          torch.float64)
    values = torch.from_numpy(vals[:, 0]).to(cuda)
    start = []
    for k, n in enumerate(dims):
        c = torch.zeros((1 if k == 0 else 3, n, 1 if k == 4 else 3),
                        dtype=torch.float64)
        c[0, :, 0] = torch.from_numpy(rng.normal(size=n))
        start.append(c.to(cuda))
    start = ak._canonicalize_left_masked(start, [1] * 4, caps, torch.float64)
    nv = float(torch.linalg.vector_norm(values))
    runs = [ak.adf_adaptive_run(start, oh, values, 1e-8 * nv, 0.999,
                                [1] * 4, nv, 60, 60, caps, 1e-6,
                                torch.Generator().manual_seed(1), eager=e)
            for e in (True, False, False)]
    for c, r, h, n in runs[1:]:
        assert r == runs[0][1] and n == runs[0][3]
        assert _same((c, h), runs[0][0:3:2])
    assert runs[0][1] != [1] * 4
    fixed = [ak.adf_device_run(runs[0][0], oh, values, 1e-8 * nv, 0.999,
                               [0.0] * 4, nv, 30, 30, eager=e)
             for e in (True, False, False)]
    for out in fixed[1:]:
        assert out[2] == fixed[0][2] and _same(out[:2], fixed[0][:2])


@pytest.mark.cuda
def test_a_hidden_host_read_raises_at_capture(cuda):
    def region(x):
        y = x * 2
        if y.sum().item() > 0:        # a host read
            y = y + 1
        return y

    prog = pg.Program(region)
    for _ in range(pg.EAGER_CALLS):           # eager runs read freely
        prog(torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError):
        prog(torch.ones(4, device=cuda))
    assert prog.graph is None
    torch.cuda.synchronize()
    assert torch.equal(torch.ones(2, device=cuda) * 3,
                       torch.full((2,), 3.0, device=cuda))


@pytest.mark.cuda
def test_a_held_output_survives_the_next_replay(cuda):
    prog = pg.Program(lambda x, y: (x @ y, (x + y).T))
    a = torch.randn(8, 8, device=cuda)
    b = torch.randn(8, 8, device=cuda)
    for _ in range(pg.EAGER_CALLS + 1):           # eager runs, capture
        prog(a, b)
    assert prog.graph is not None
    kept = prog(a, b)                             # replay
    want = (a @ b, (a + b).T)
    prog(b, a)                                    # replay on other inputs
    prog(a * 3, b)
    assert _same(kept, want) and kept[1].stride() == want[1].stride()
    with pytest.raises(ValueError):
        prog(a[:4], b[:4])


@pytest.mark.cuda
def test_chunked_newton_schulz_on_the_card(cuda):
    rng = np.random.Generator(np.random.PCG64(9))
    X = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32))
    X = X.to(cuda)
    out = []
    for fn in (rk._ns_orth_cols, rk._ns_orth_cols_stepwise):
        i0 = rk._ns_orth_cols.iterations
        q, ok = fn(X, 64)
        out.append((q, bool(ok), rk._ns_orth_cols.iterations - i0))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:] and out[0][2] > 0


@pytest.mark.cuda
def test_clear_gives_the_pools_back(cuda):
    """programs.clear() drops the factories' programs and their private
    pools; held_bytes() counts what the live programs hold."""
    pg.clear()
    x = torch.randn(256, 64, device=cuda)
    for _ in range(pg.EAGER_CALLS + 2):
        rk._ns_orth_cols(x, 64)
    assert pg.held_bytes() > 0
    reserved = torch.cuda.memory_reserved(cuda)
    pg.clear()
    assert pg.held_bytes() == 0
    assert torch.cuda.memory_reserved(cuda) < reserved


@pytest.mark.cuda
def test_a_program_under_inference_mode(cuda):
    """Inference tensors go through the eager runs, the capture and the
    replays."""
    prog = pg.Program(lambda x: (x * 2 + 1,))
    with torch.inference_mode():
        x = torch.arange(6.0, device=cuda)
        outs = [prog(x + k) for k in range(pg.EAGER_CALLS + 3)]
    assert prog.captures == 1 and prog.replays == 2
    assert all(torch.equal(o[0], (x + k) * 2 + 1) for k, o in enumerate(outs))
