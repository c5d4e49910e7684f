"""The port's captured programs (xerus_tpu_torch.ops.programs and the
factories built on it) on the CPU, where every program runs its function
eagerly: the factories under the JAX package's names return what the
plain functions return, the solves' program paths equal their plain
versions bit for bit (the ALS and mixed-precision solves, the ADF runs
through a rank bump with the bond masks as tensors), the chunked
Newton-Schulz loop equals the per-step loop, and the counter bookkeeping
that carries launch counts through replays.  No JAX compile; the JAX
comparisons of these functions are in test_torch_mixed_precision.py,
test_torch_adf.py and test_torch_round.py."""

import numpy as np
import pytest
import torch

from xerus_tpu_torch.convert import cores_to_df, cores_to_torch
from xerus_tpu_torch.examples import qtt_poisson_instance
from xerus_tpu_torch.ops import adf_kernels as ak
from xerus_tpu_torch.ops import als_kernels as alk
from xerus_tpu_torch.ops import df32, df_matvec as dfm
from xerus_tpu_torch.ops import mixed_precision as mp
from xerus_tpu_torch.ops import programs as pg
from xerus_tpu_torch.ops import round_kernels as rk

CPU = torch.device("cpu")
SEED = 0xBAADF00D


def _same(a, b):
    """Trees of tensors equal bit for bit."""
    la, lb = pg._leaves(a), pg._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _poisson(d, rank, dtype=torch.float64):
    xs, A, b = qtt_poisson_instance(d, rank, SEED)
    return tuple(cores_to_torch(t, CPU, dtype) for t in (xs, A, b))


def test_factories_return_the_plain_functions_results():
    x, A, b = _poisson(5, 3)
    key, dt = pg.shapes_key(x, A, b), "float64"
    for direction in ("lr", "rl"):
        prog = alk.make_als_sweep_res(key, dt, direction)
        assert isinstance(prog, pg.Program)
        assert _same(prog(x, A, b), alk.als_sweep_res(x, A, b, direction))
        assert _same(alk.make_als_sweep(key, dt, direction)(x, A, b),
                     alk.als_sweep(x, A, b, direction))
    assert _same(alk.make_als_multi_sweep_res(key, dt, 3)(x, A, b),
                 alk.als_multi_sweep_res(x, A, b, 3))
    # cached by key, as the JAX factories are
    assert alk.make_als_sweep_res(key, dt, "lr") is \
        alk.make_als_sweep_res(key, dt, "lr")
    x_df = tuple((c.float(), torch.zeros_like(c.float())) for c in x)
    A_df = tuple(mp.df_split(c) for c in A)
    b_df = tuple(mp.df_split(c) for c in b)
    key = pg.shapes_key(x_df, A_df, b_df)
    assert _same(mp.make_df_als_sweep(key, "float32")(x_df, A_df, b_df),
                 mp._als_half_sweep_df(x_df, A_df, b_df))


def test_mixed_solve_programs_equal_the_plain_version():
    """als_f32_df_run through the programs (one sweep-and-residual program
    per f32 half-sweep, one df program per df half-sweep on contiguous
    chains) and make_als_f32_df_run equal the plain version bit for bit."""
    xs, A, b = qtt_poisson_instance(4, 2, SEED)
    args = (cores_to_torch(xs, CPU), cores_to_torch(A, CPU),
            cores_to_torch(b, CPU), cores_to_df(A, CPU), cores_to_df(b, CPU))
    eager = mp.als_f32_df_run(*args, 16, 2, eager=True)
    prog = mp.als_f32_df_run(*args, 16, 2)
    assert _same(eager[:2], prog[:2]) and eager[2] == prog[2]
    run = mp.make_als_f32_df_run(pg.shapes_key(*args), "float32", 16, 2)
    out = run(*args)
    assert _same(out[:2], eager[:2]) and out[2] == eager[2]
    for n in (1, 3):
        assert _same(mp.df_als_multi_sweep(eager[0], args[3], args[4], n),
                     mp.df_als_multi_sweep(eager[0], args[3], args[4], n,
                                           eager=True))


@pytest.mark.parametrize("solver", ["spd", "nonspd", "asd"])
def test_als_run_programs_equal_the_plain_version(solver):
    x, A, b = _poisson(5, 3)
    carry = (0.0, 0, 5, float("inf"), float("inf"), 5)
    if solver == "spd":
        runs = [alk.als_run(x, A, b, *carry, eager=e) for e in (True, False)]
    else:
        runs = [alk.als_run_rev(x, A, b, *carry, solver=solver, eager=e)
                for e in (True, False)]
    (c0, h0, n0), (c1, h1, n1) = runs
    assert n0 == n1 == 5 and _same((c0, h0), (c1, h1))


def _completion(dims, rank, M, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    ranks = [1] + [rank] * (len(dims) - 1) + [1]
    truth = [rng.normal(size=(ranks[k], n, ranks[k + 1]))
             for k, n in enumerate(dims)]
    pos = np.stack([rng.integers(0, n, size=M) for n in dims], axis=1)
    vals = np.ones((M, 1))
    for k, c in enumerate(truth):
        vals = np.einsum("ma,amb->mb", vals, c[:, pos[:, k], :])
    oh = ak.build_onehots(torch.from_numpy(pos), dims, torch.float64)
    return oh, torch.from_numpy(vals[:, 0])


def _padded_start(dims, caps, seed):
    """A rank-1 start padded to ``caps``, left-canonical."""
    rng = np.random.Generator(np.random.PCG64(seed))
    d = len(dims)
    cores = []
    for k, n in enumerate(dims):
        capL = 1 if k == 0 else caps[k - 1]
        capR = 1 if k == d - 1 else caps[k]
        c = torch.zeros((capL, n, capR), dtype=torch.float64)
        c[0, :, 0] = torch.from_numpy(rng.normal(size=n))
        cores.append(c)
    return ak._canonicalize_left_masked(cores, [1] * (d - 1), caps,
                                        torch.float64)


def test_adaptive_run_with_mask_tensors_equals_host_ranks_through_a_bump():
    """The adaptive run's program (bond masks as tensors, rebuilt after
    each bump) and the plain loop (masks from the host ranks at every
    iteration) agree bit for bit through the rank bumps: ranks, counts,
    histories and cores."""
    dims, caps = [4] * 4, [3, 3, 3]
    oh, vals = _completion(dims, 3, 200, SEED)
    start = _padded_start(dims, caps, 7)
    nv = float(torch.linalg.vector_norm(vals))
    runs = [ak.adf_adaptive_run(start, oh, vals, 1e-8 * nv, 0.999,
                                [1, 1, 1], nv, 40, 40, caps, 1e-6,
                                torch.Generator().manual_seed(3), eager=e)
            for e in (True, False)]
    (c0, r0, h0, n0), (c1, r1, h1, n1) = runs
    assert r0 == r1 and r0 != [1, 1, 1] and n0 == n1
    assert _same((c0, h0), (c1, h1))
    # one step of the program's function is the masked iteration and the
    # masked left sweep on the host ranks, bit for bit
    ranks, one = [2, 3, 1], torch.ones(())
    new, res0 = ak._adf_iteration_masked(c0, oh, vals, ranks, caps,
                                         torch.float64)
    step = ak._adaptive_step(c0, oh, vals, ak._colmasks(
        ranks, caps, CPU, torch.float64), torch.zeros(4), one, one, one)
    assert _same((ak._canonicalize_left_masked(new, ranks, caps,
                                               torch.float64), res0),
                 step[:2])


@pytest.mark.parametrize("rank_one", [False, True])
def test_device_run_program_equals_the_plain_version(rank_one):
    dims = [3, 4, 3]
    oh, vals = _completion(dims, 2, 120, SEED + 1)
    rng = np.random.Generator(np.random.PCG64(11))
    start = ak.canonicalize_left_cores(tuple(
        torch.from_numpy(rng.normal(size=s)) for s in
        ((1, 3, 2), (2, 4, 2), (2, 3, 1))))
    if rank_one:
        oh = tuple(o + 0.25 for o in oh)
    nv = float(torch.linalg.vector_norm(vals))
    runs = [ak.adf_device_run(start, oh, vals, 1e-8 * nv, 0.999,
                              [0.0] * 4, nv, 40, 40, rank_one, eager=e)
            for e in (True, False)]
    assert runs[0][2] == runs[1][2] > 1
    assert _same(runs[0][:2], runs[1][:2])
    key = pg.shapes_key(start, oh, vals)
    assert _same(ak.make_adf_iteration(key, "float64", rank_one)(
        start, oh, vals), (ak._adf_iteration_rankone if rank_one
                           else ak._adf_iteration)(start, oh, vals))


def _ns_case(name):
    rng = np.random.Generator(np.random.PCG64(5))
    colmask = None
    if name == "well-conditioned":
        X = rng.normal(size=(96, 24))
    elif name == "hits max_it":
        X = rng.normal(size=(96, 24)) @ np.diag(np.logspace(0, -4, 24))
    elif name == "rank-deficient":
        X = rng.normal(size=(96, 24))
        X[:, 5] = 0.0
    else:
        X = rng.normal(size=(96, 24))
        X[:, 17:] = 0.0
        colmask = (torch.arange(24) < 17).float()
    return torch.from_numpy(X.astype(np.float32)), colmask


@pytest.mark.parametrize("name,max_it,ok", [
    ("well-conditioned", 64, True), ("hits max_it", 12, False),
    ("rank-deficient", 64, False), ("dead masked columns", 64, True)])
def test_chunked_newton_schulz_equals_the_per_step_loop(name, max_it, ok):
    """Same Q bit for bit, the same iteration count and ``ok`` flag, and
    one host read per chunk of NS_CHUNK steps in place of one per step."""
    X, colmask = _ns_case(name)
    out = []
    for fn in (rk._ns_orth_cols, rk._ns_orth_cols_stepwise):
        i0, r0 = rk._ns_orth_cols.iterations, rk.host_bool.reads
        q, flag = fn(X, max_it, colmask)
        out.append((q, bool(flag), rk._ns_orth_cols.iterations - i0,
                    rk.host_bool.reads - r0))
    (q0, ok0, n0, reads0), (q1, ok1, n1, reads1) = out
    assert torch.equal(q0, q1) and ok0 == ok1 == ok and n0 == n1 > 0
    assert reads0 == max(1, -(-n0 // rk.NS_CHUNK)) < reads1
    if name == "hits max_it":
        assert n0 == max_it
    if colmask is not None:
        assert torch.all(q0[:, 17:] == 0)


def test_record_counts_undoes_and_reports_the_counters():
    """What a capture does with the launch counters, on the CPU: the run's
    counts come back as deltas and the counters as they were; add_counts
    is what each replay adds."""
    rng = np.random.Generator(np.random.PCG64(3))
    A = df32.df_from_f64(rng.normal(size=(12, 8)), CPU)
    v = df32.df_from_f64(rng.normal(size=8), CPU)

    def region():
        dfm.df_matvec(*A, *v)
        dfm.df_matvec(*A, *v)
        return mp.df_qr(*A)[0][0]

    before = pg.counter_values()
    out, deltas = pg.record_counts(region)
    assert pg.counter_values() == before and out.shape == (12, 8)
    assert {pg.counter_name(c): n for c, n in deltas.items()} == {
        "df_matvec.calls": 2, "df_qr.calls": 1}
    pg.add_counts(deltas)
    pg.add_counts(deltas)
    after = pg.counter_values()
    assert after["df_matvec.calls"] == dfm.df_matvec.calls
    assert dfm.df_matvec.calls == before["df_matvec.calls"] + 4
    assert mp.df_qr.calls == before["df_qr.calls"] + 2
    dfm.df_matvec.calls = before["df_matvec.calls"]
    mp.df_qr.calls = before["df_qr.calls"]


def test_every_captured_counter_registers_itself():
    """The launch and call counters a captured region moves, and the host
    reads that it must not, are registered by the modules that own
    them."""
    assert set(pg.counter_values()) >= {
        "df_matvec.calls", "df_matvec.launches", "df_qr_launch.launches",
        "df_chol_block_launch.launches", "df_trsm_rlt_launch.launches",
        "df_qr.calls", "_ns_orth_cols.iterations", "host_bool.reads"}
    moves = {pg.counter_name(c): m for c, m in pg._COUNTERS.items()}
    assert moves["host_bool.reads"] is False
    assert all(m for name, m in moves.items() if name != "host_bool.reads")


def test_record_counts_refuses_a_host_read():
    reads, before = rk.host_bool.reads, pg.counter_values()
    with pytest.raises(RuntimeError, match="host_bool.reads"):
        pg.record_counts(lambda: rk.host_bool(torch.tensor(True)))
    assert pg.counter_values() == before
    rk.host_bool.reads = reads


def test_clear_empties_every_program_factory():
    """programs.clear() drops the cached programs of every factory (their
    graphs and pools on the card)."""
    x = torch.zeros((3, 2, 3))
    key = pg.shapes_key(x)
    made = [alk.make_als_sweep_res(key, "float32", "lr"),
            mp.make_df_als_sweep(key, "float32"),
            rk._make_ns_chunk(key, "float32", 8)]
    assert all(isinstance(p, pg.Program) for p in made)
    assert alk.make_als_sweep_res in pg._FACTORIES
    pg.clear()
    assert all(f.cache_info().currsize == 0 for f in pg._FACTORIES)
    assert alk.make_als_sweep_res(key, "float32", "lr") is not made[0]
    assert pg.held_bytes() == 0


def test_a_program_on_cpu_tensors_runs_its_function():
    calls = []

    def fn(x, pair):
        calls.append(1)
        return x + pair[0], (pair[1] * 2,)

    prog = pg.Program(fn)
    x, pair = torch.ones(3), (torch.arange(3.0), torch.ones(2))
    out = prog(x, pair)
    assert calls == [1] and prog.graph is None and prog.captures == 0
    assert _same(out, fn(x, pair))
    with pytest.raises(TypeError):
        prog(x, (pair[0], 2.0))


def test_shapes_key_holds_shapes_strides_dtypes_and_structure():
    a = torch.zeros((2, 3, 4))
    key = pg.shapes_key((a,), a)
    assert key == ((((2, 3, 4), (12, 4, 1), "float32", "cpu"),),
                   ((2, 3, 4), (12, 4, 1), "float32", "cpu"))
    assert pg.shapes_key(a.permute(2, 1, 0)) != pg.shapes_key(
        a.permute(2, 1, 0).contiguous())
    assert pg.shapes_key(a) != pg.shapes_key(a.double())
    assert pg.shapes_key((a, a)) != pg.shapes_key([(a,), a])
