"""The randomized roundings, the fused apply + round and the batched SPD
half-sweep as programs (ops/programs.py) on the CPU, where a program runs
its function eagerly: each factory returns its plain function's result
bit for bit, its callers reach it, the sketches drawn outside the program
are the ones the function draws inside, and the value that replaced the
host-to-device copy of sqrt(l) has the same bits.  Inputs from numpy
seeds; the JAX comparisons of these functions are in test_torch_round.py,
test_torch_apply_round.py, test_torch_round_uniform.py and
test_torch_als_objects.py."""

import numpy as np
import pytest
import torch

import xerus_tpu_torch as xt
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import bench_round_instance, qtt_poisson_instance
from xerus_tpu_torch.ops import als_kernels as alk
from xerus_tpu_torch.ops import apply_kernels as apk
from xerus_tpu_torch.ops import programs as pg
from xerus_tpu_torch.ops import round_kernels as rk
from xerus_tpu_torch.ops import round_uniform as ru
from xerus_tpu_torch.ops.dmrg_kernels import _pad_operator_stack
from xerus_tpu_torch.ops.stacking import pad_cores

CPU = torch.device("cpu")
SEED = 0xBAADF00D
PRESETS = sorted(rk.SPEED_PRESETS)


def _same(a, b):
    """Trees of tensors equal bit for bit."""
    la, lb = pg._leaves(a), pg._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _cores(dtype, d=8, rank=16):
    return list(cores_to_torch(bench_round_instance(d, 2, rank, SEED), CPU,
                               dtype))


def _in_function_draw(cores, target, oversample, dtype):
    """The sketches as _round_randomized drew them inside the sweep: a
    Generator seeded 0, R_{d-2} first, in the dtype the sweep runs in."""
    gen = torch.Generator(device=CPU).manual_seed(0)
    shapes = rk.sketch_shapes([tuple(c.shape) for c in cores], target,
                              oversample)
    out = [None] * len(shapes)
    for i in range(len(shapes) - 1, -1, -1):
        out[i] = torch.randn(shapes[i], generator=gen, dtype=dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("speed", PRESETS)
def test_sketches_drawn_outside_are_the_in_function_draw(dtype, speed):
    """randomized_inputs draws what the sweep drew inside: float32 where a
    lowered preset casts float64 cores down (bitwise)."""
    cores = _cores(dtype)
    p = rk.SPEED_PRESETS[speed]
    _, sk = rk.randomized_inputs(cores, 6, 8, p["precision"],
                                 p["gram_precision"])
    lowered = speed != "exact" and dtype == torch.float64
    want = _in_function_draw(cores, 6, 8,
                             torch.float32 if lowered else dtype)
    assert _same(sk, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sqrt_l_filled_on_the_device_has_torch_sqrt_bits(dtype):
    """sqrt(l) from a tensor filled with l (no host-to-device copy) is
    bitwise torch.sqrt of torch.tensor(l), for every l up to 4096."""
    for l in range(1, 4097):
        assert torch.equal(torch.sqrt(torch.full((), float(l), dtype=dtype)),
                           torch.sqrt(torch.tensor(l, dtype=dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("speed", PRESETS)
def test_unrolled_program_is_the_plain_sweep(dtype, speed):
    """make_randomized_round_unrolled's program (cholqr1) and its caller
    tt_round_randomized_unrolled equal _round_randomized with the
    in-function draw, bit for bit."""
    cores = _cores(dtype)
    p = rk.SPEED_PRESETS[speed]
    pp, gp = p["precision"], p["gram_precision"]
    want = rk._round_randomized(cores, 6, 8, qr_method="cholqr1",
                                precision=pp, gram_precision=gp)
    args = rk.randomized_inputs(cores, 6, 8, pp, gp)
    prog = pg.program_for(rk.make_randomized_round_unrolled, args, 6, 8, pp,
                          gp)
    assert isinstance(prog, pg.Program)
    assert _same(prog(*args), want)
    assert _same(rk.tt_round_randomized_unrolled(cores, 6, 8, pp, gp), want)
    assert _same(rk.tt_round_randomized_unrolled(cores, 6, 8, pp, gp,
                                                 eager=True), want)
    assert want[0].dtype == dtype


@pytest.mark.parametrize("qr_method", ["householder", "cholqr", "cholqr1"])
def test_randomized_program_is_the_plain_sweep(qr_method):
    """make_randomized_round's program with a QR method and bond caps
    equals _round_randomized, bit for bit; tt_round_randomized is its
    Householder form and tt_round_randomized_uniform its capped form."""
    cores = _cores(torch.float64, d=6, rank=12)
    caps = (2, 4, 6, 4, 2)        # the logical ranks at target 6
    want = rk._round_randomized(cores, 6, 8, qr_method=qr_method,
                                max_ranks=caps)
    args = rk.randomized_inputs(cores, 6, 8)
    got = pg.call(rk.make_randomized_round, args, 6, 8, qr_method, caps)
    assert _same(got, want)
    assert _same(ru.tt_round_randomized_uniform(cores, 6, 8, qr_method),
                 want)
    if qr_method == "householder":
        assert _same(rk.tt_round_randomized(cores, 6, 8),
                     rk._round_randomized(cores, 6, 8))


def test_callers_reach_the_randomized_programs():
    """round_fast's randomized methods, the speed presets and
    tt_round_eps_fast key their factories' caches (the caller reached a
    Program), and give what the plain sweep gives."""
    rk.make_randomized_round.cache_clear()
    rk.make_randomized_round_unrolled.cache_clear()
    with xt.host():
        x = xt.TTTensor.random([2] * 8, 12)
        cores = [c._torch() for c in x.components]
        y = x.copy()
        y.round_fast(5, method="randomized")
        z = x.copy()
        z.round_fast(5, speed="bf16_frontier")
        assert rk.make_randomized_round.cache_info().currsize == 1
        assert rk.make_randomized_round_unrolled.cache_info().currsize == 1
        want = rk._round_randomized(cores, 5, 8, qr_method="cholqr1",
                                    precision="default",
                                    gram_precision="high")
        # round_fast re-canonicalizes: compare the represented tensors
        w = xt.TTTensor._make([xt.Tensor.from_torch(c) for c in want])
        assert (z - w).frob_norm() <= 1e-12 * w.frob_norm()
        ru.tt_round_eps_fast(cores, 5, 1e-3)
    assert rk.make_randomized_round.cache_info().currsize == 2


def _apply_inputs():
    A = qtt_poisson_instance(6, 4, SEED)[1]
    A = list(cores_to_torch(A, CPU, torch.float64))
    x = list(cores_to_torch(bench_round_instance(6, 2, 8, SEED), CPU,
                            torch.float64))
    return A, x


@pytest.mark.parametrize("qr_method", ["householder", "cholqr1"])
def test_apply_round_program_is_the_plain_sweep(qr_method):
    """make_apply_round's program on the padded stacks equals
    _apply_round_scan bit for bit, and apply_operator_rounded_cores (its
    caller) with the sketches it draws equals the call given them."""
    A, x = _apply_inputs()
    x_stack = pad_cores(x)[0]
    A_stack = _pad_operator_stack(A, x_stack.dtype)
    sk = apk.draw_apply_sketches(6, 2, 12, torch.float64, CPU)
    want = apk._apply_round_scan(A_stack, x_stack, 4, 8, qr_method, sk)
    got = pg.call(apk.make_apply_round, (A_stack, x_stack, tuple(sk)), 4, 8,
                  qr_method)
    assert _same(got, want)
    drawn = apk.apply_operator_rounded_cores(A, x, 4, 8, qr_method)
    given = apk.apply_operator_rounded_cores(A, x, 4, 8, qr_method,
                                             sketches=sk)
    assert _same(drawn, given)
    # the draw is the one _apply_round_scan makes without sketches
    assert _same(apk._apply_round_scan(A_stack, x_stack, 4, 8, qr_method),
                 want)


def _batch(d, rank, B):
    insts = [qtt_poisson_instance(d, rank, SEED + i) for i in range(B)]
    A = tuple(torch.from_numpy(c) for c in insts[0][1])
    xb = tuple(torch.from_numpy(np.stack([inst[0][k] for inst in insts]))
               for k in range(d))
    bb = tuple(torch.from_numpy(np.stack([inst[2][k] * (i + 1)
                                          for i, inst in enumerate(insts)]))
               for k in range(d))
    return xb, A, bb


@pytest.mark.parametrize("local_assume", ["pos", "gen"])
@pytest.mark.parametrize("direction", ["lr", "rl"])
def test_batched_sweep_program_is_the_loop(direction, local_assume):
    """make_als_sweep_batched's program (the sweep vmapped over the batch)
    against the loop of single sweeps: within 1e-12 of each core's largest
    entry (bitwise on this host), every instance."""
    xb, A, bb = _batch(6, 4, 3)
    out = alk.als_half_sweep_batched(xb, A, bb, direction, local_assume)
    prog = pg.program_for(alk.make_als_sweep_batched, (xb, A, bb),
                          direction, local_assume)
    assert isinstance(prog, pg.Program)
    assert _same(prog(xb, A, bb), out)
    for i in range(3):
        one = alk.als_sweep([c[i] for c in xb], A, [c[i] for c in bb],
                            direction, local_assume=local_assume)
        for o, s in zip(out, one):
            assert float((o[i] - s).abs().max()) <= \
                1e-12 * float(s.abs().max())
