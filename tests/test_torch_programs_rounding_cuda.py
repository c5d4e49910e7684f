"""The randomized roundings, the fused apply + round, the batched SPD
half-sweep and the double-word stack's programs on the card: each
replay against its function run eagerly, bit for bit, at small sizes;
counters through replays; no host read in a replay; the df rounding's
seeds on K4 with no eigh info check.

Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_programs_rounding_cuda.py

Without a card every case skips (a CUDA graph needs one)."""

import importlib

import numpy as np
import pytest
import torch

from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import bench_round_instance, qtt_poisson_instance
from xerus_tpu_torch.ops import als_kernels as alk
from xerus_tpu_torch.ops import apply_kernels as apk
from xerus_tpu_torch.ops import df32 as tdf
from xerus_tpu_torch.ops import dmrg_kernels as dk
from xerus_tpu_torch.ops import programs as pg
from xerus_tpu_torch.ops import round_kernels as rk
from xerus_tpu_torch.ops import small_eig as se
from xerus_tpu_torch.ops.dmrg_kernels import _pad_operator_stack
from xerus_tpu_torch.ops.stacking import pad_cores

tchol = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
teig = importlib.import_module("xerus_tpu_torch.ops.df_eigh")
tround = importlib.import_module("xerus_tpu_torch.ops.df_rounding")

SEED = 0xBAADF00D
RUNS = pg.EAGER_CALLS + 3       # eager runs, the capture, two replays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: programs are CUDA graphs")
    return torch.device("cuda")


def _same(a, b):
    la, lb = pg._leaves(a), pg._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _full(cores):
    """The represented tensor of a TT, float64 on the host."""
    t = np.ones((1, 1))
    for c in cores:
        t = (t @ c.double().cpu().numpy().reshape(c.shape[0], -1)).reshape(
            -1, c.shape[2])
    return t.reshape(-1)


def _replays(call, plain, program):
    """``call()`` RUNS times and ``plain()`` once: every call bitwise the
    plain run, the program's eager runs, capture and replays counted, no
    host read in any call."""
    reads = rk.host_bool.reads
    runs = [call() for _ in range(RUNS)]
    assert rk.host_bool.reads == reads
    want = plain()
    p = program()
    assert (p.eager_runs, p.captures, p.replays) == (pg.EAGER_CALLS, 1, 2)
    assert p.nodes > 0
    assert all(_same(r, want) for r in runs)


@pytest.mark.cuda
@pytest.mark.parametrize("speed", sorted(rk.SPEED_PRESETS))
def test_unrolled_randomized_program_replays_equal_eager(cuda, speed):
    cores = list(cores_to_torch(bench_round_instance(10, 2, 32, SEED),
                                cuda))
    p, g = (rk.SPEED_PRESETS[speed][k] for k in ("precision",
                                                 "gram_precision"))
    args = rk.randomized_inputs(cores, 16, 8, p, g)
    rk.make_randomized_round_unrolled.cache_clear()
    gemms = rk._bf16_pass.gemms
    _replays(lambda: rk.tt_round_randomized_unrolled(cores, 16, 8, p, g),
             lambda: rk.tt_round_randomized_unrolled(cores, 16, 8, p, g,
                                                     eager=True),
             lambda: pg.program_for(rk.make_randomized_round_unrolled, args,
                                    16, 8, p, g))
    per = (rk._bf16_pass.gemms - gemms) / (RUNS + 1)
    assert (per > 0) == (speed != "exact") and per == int(per)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            ) == (False, False)


@pytest.mark.cuda
def test_householder_randomized_program_replays_equal_eager(cuda):
    cores = list(cores_to_torch(bench_round_instance(10, 2, 32, SEED),
                                cuda, torch.float64))
    args = rk.randomized_inputs(cores, 16, 8)
    rk.make_randomized_round.cache_clear()
    _replays(lambda: rk.tt_round_randomized(cores, 16, 8),
             lambda: rk.tt_round_randomized(cores, 16, 8, eager=True),
             lambda: pg.program_for(rk.make_randomized_round, args, 16, 8))


@pytest.mark.cuda
def test_apply_round_program_replays_equal_eager(cuda):
    A = list(cores_to_torch(qtt_poisson_instance(8, 4, SEED)[1], cuda,
                            torch.float64))
    x = list(cores_to_torch(bench_round_instance(8, 2, 16, SEED), cuda,
                            torch.float64))
    x_stack = pad_cores(x)[0]
    A_stack = _pad_operator_stack(A, x_stack.dtype)
    sk = tuple(apk.draw_apply_sketches(8, 2, 20, torch.float64, cuda))
    apk.make_apply_round.cache_clear()
    _replays(lambda: apk.apply_operator_rounded_cores(A, x, 12),
             lambda: apk.apply_operator_rounded_cores(A, x, 12, eager=True),
             lambda: pg.program_for(apk.make_apply_round,
                                    (A_stack, x_stack, sk), 12, 8,
                                    "householder"))


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["lr", "rl"])
def test_batched_sweep_program_replays_equal_eager_and_the_loop(cuda,
                                                                direction):
    insts = [qtt_poisson_instance(8, 6, SEED + i) for i in range(4)]
    A = tuple(cores_to_torch(insts[0][1], cuda, torch.float64))
    xb = tuple(torch.from_numpy(np.stack([i[0][k] for i in insts]))
               .to(cuda) for k in range(8))
    bb = tuple(torch.from_numpy(np.stack([i[2][k] * (n + 1)
                                          for n, i in enumerate(insts)]))
               .to(cuda) for k in range(8))
    alk.make_als_sweep_batched.cache_clear()
    _replays(lambda: alk.als_half_sweep_batched(xb, A, bb, direction),
             lambda: alk.als_half_sweep_batched(xb, A, bb, direction,
                                                eager=True),
             lambda: pg.program_for(alk.make_als_sweep_batched, (xb, A, bb),
                                    direction, "pos"))
    # against the loop of single sweeps on the represented tensors (the
    # batched and single factorizations are other cuSOLVER routines, so the
    # cores differ in the gauge of near-null directions), 1e-12 relative
    out = alk.als_half_sweep_batched(xb, A, bb, direction)
    for n in range(4):
        one = alk.als_sweep([c[n] for c in xb], A, [c[n] for c in bb],
                            direction)
        got, want = _full([c[n] for c in out]), _full(one)
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    assert torch.backends.cuda.preferred_linalg_library() == \
        torch._C._LinalgBackend.Default


@pytest.mark.cuda
def test_df_rounding_programs_replay_equal_eager_on_k4(cuda):
    """tt_round_df at d=8 rank 16 -> 8: the third call replays every site
    program, bitwise the eager rounding; d - 1 spectra and one CGS2 count
    read, no eigh info check, one K4 launch per truncated site."""
    cores = [np.asarray(c, np.float64)
             for c in bench_round_instance(8, 2, 16, SEED)]
    plain = tround.tt_round_df_from_f64(cores, 8, device=cuda, eager=True)
    for _ in range(pg.EAGER_CALLS + 1):
        tround.tt_round_df_from_f64(cores, 8, device=cuda)
    counts = (pg.Program.captures, pg.Program.eager_runs)
    reads, checks = rk.host_bool.reads, dk.linalg_host_checks()
    k4 = se.small_eigh_launch.launches
    got = tround.tt_round_df_from_f64(cores, 8, device=cuda)
    assert (pg.Program.captures, pg.Program.eager_runs) == counts
    assert all(np.array_equal(a, b) for a, b in zip(got, plain))
    assert rk.host_bool.reads - reads == 8
    assert dk.linalg_host_checks() == checks
    assert se.small_eigh_launch.launches - k4 == 7


@pytest.mark.cuda
def test_df_solve_and_df_eigh_programs_replay_equal_eager(cuda):
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(64, 64)))
    lam = np.linspace(1.0, 9.0, 64)
    A = (Q * lam) @ Q.T
    b = rng.normal(size=64)
    args = tdf.df_from_f64(A, cuda) + tdf.df_from_f64(b, cuda)
    tchol.make_df_solve_spd_chol.cache_clear()
    teig.make_df_eigh.cache_clear()
    _replays(lambda: tchol.make_df_solve_spd_chol(64, "float32", 16,
                                                  3)(*args),
             lambda: tchol.df_solve_spd_chol(*args, block=16),
             lambda: tchol.make_df_solve_spd_chol(64, "float32", 16, 3))
    checks = dk.linalg_host_checks()
    _replays(lambda: teig.make_df_eigh(64, "float32")(*args[:2]),
             lambda: teig.df_eigh(*args[:2]),
             lambda: teig.make_df_eigh(64, "float32"))
    assert dk.linalg_host_checks() == checks
    w = tdf.df_to_f64(*teig.make_df_eigh(64, "float32")(*args[:2])[:2])
    assert np.abs(w - lam).max() <= 1e-13 * lam.max()
    se.check_health(cuda)


@pytest.mark.cuda
def test_k4_seed_failure_gives_nan_and_counts_in_the_health_record(cuda):
    se.check_health(cuda)
    A = torch.eye(8, device=cuda)
    A[3, 4] = A[4, 3] = float("nan")
    w, V = teig._k4_seed(A)
    assert torch.isnan(w).all() and torch.isnan(V).all()
    with pytest.raises(RuntimeError, match="did not converge"):
        se.check_health(cuda)
