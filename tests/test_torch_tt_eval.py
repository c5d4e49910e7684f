"""K3's plain version (xerus_tpu_torch.ops.tt_eval) and pad_cores held
against xerus_tpu's TT evaluation on the CPU: the XLA path
``_evaluate_tt_at_points`` and the Pallas kernel in interpret mode, on the
three cases of tests/test_pallas_kernels.py, at that file's tolerance
(atol 1e-12).  On the CPU the wrapper runs the plain version and launches
nothing; the kernel itself is held against it on the card
(tests/test_torch_kernels_cuda.py).  What the wrapper does in plain Python
before a launch (the table of cores, the plan with its shared-memory
layout and route, the plain model of the kernel's two phases) is tested
here too."""

import ctypes
import importlib.util
import os

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


# ---------------------------------------------------------------------------
# What the wrapper does in plain Python before a launch: the table of cores,
# the plan (runs of sites, shared-memory layout, route) and the plain model
# of the kernel's two phases at the plan's offsets.

# (dims, ranks, M the plan is made for): ragged ranks and modes, n = 3 and 5,
# d = 1, the completion slice's shape at its three sizes, a rank-16 shape
PLAN_CASES = [([4] * 10, [4] + [8] * 7 + [4], 4 ** 10),
              ([4] * 10, [4] + [8] * 7 + [4], 20_000),
              ([4] * 10, [4] + [8] * 7 + [4], 400),
              ([4] * 5, [3] * 4, 400), ([2, 5, 3, 4], [2, 4, 3], 17),
              ([2, 5, 3, 4], [2, 4, 3], 10 ** 6), ([3] * 4, [2] * 3, 10 ** 6),
              ([5] * 7, [3, 7, 8, 8, 5, 2], 65_537), ([3], [], 77),
              ([2, 3, 2], [16, 9], 10 ** 7), ([2] * 24, [2] * 23, 10 ** 6)]


SMS = 132       # multiprocessors of the card the plans are made for (H100)


def _shapes(dims, ranks):
    rs = [1] + list(ranks) + [1]
    return tuple((rs[k], n, rs[k + 1]) for k, n in enumerate(dims))


def _rebuild(row, dtype):
    """A core read back from its table row alone, element by element."""
    ptr, s0, s1, s2, rl, n, rr = row
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    out = np.empty((rl, n, rr))
    for a in range(rl):
        for i in range(n):
            for b in range(rr):
                off = (a * s0 + i * s1 + b * s2) * ctypes.sizeof(ctype)
                out[a, i, b] = ctype.from_address(ptr + off).value
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dims,ranks", [
    ([2, 5, 3, 4], [2, 4, 3]), ([3], []), ([2] * 30, [2] * 29),
    ([4] * 5, [3] * 4)])
def test_core_table_rebuilds_the_cores_exactly(dims, ranks, dtype):
    """Address, strides and shape of each core are all the kernel is handed:
    they give back every element, for contiguous cores, for transposed
    views, for views into a larger buffer, and past the by-value table's
    size."""
    cores, _P = _instance(dims, ranks, 1, 7)
    tc = [torch.from_numpy(c).to(dtype) for c in cores]
    views = [c.transpose(0, 2).contiguous().transpose(0, 2) for c in tc]
    big = [torch.zeros((c.shape[0] + 1, c.shape[1] + 2, c.shape[2] + 3),
                       dtype=dtype) for c in tc]
    inside = []
    for b, c in zip(big, tc):
        v = b[1:, 2:, 3:]
        v.copy_(c)
        inside.append(v)
    for layout in (tc, views, inside):
        table = te.core_table(layout)
        assert len(table) == len(dims)
        for row, c in zip(table, layout):
            assert row[4:] == tuple(c.shape)
            np.testing.assert_array_equal(_rebuild(row, dtype),
                                          c.double().numpy())


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("dims,ranks,M", PLAN_CASES)
def test_plan_layout_is_sound(dims, ranks, M, itemsize):
    """Every offset the kernel is told: tables, ring, scratch and barriers
    lie inside the block's shared memory without overlap; rows start on
    16-byte boundaries and slices an odd number of 16-byte units apart;
    the runs cover the sites in order; the by-value table fits a kernel's
    parameter space."""
    plan = te.tt_eval_plan(_shapes(dims, ranks), itemsize, M, SMS)
    assert plan.route == te.ROUTE_SMEM
    assert plan.smem_bytes <= te.SMEM_LIMIT
    assert ctypes.sizeof(te._Table) + 5 * 8 <= 4096
    vec = 16 // itemsize
    assert [g.first for g in plan.groups] == [0] + [
        g.last + 1 for g in plan.groups[:-1]]
    assert plan.groups[-1].last == len(dims) - 1
    assert plan.groups[-1].code == te.DOT_CODE
    used = []      # (first byte, last byte + 1, what)
    for g in plan.groups:
        assert g.off % vec == 0 and g.pitch % vec == 0
        assert (g.pitch // vec) % 2 == 1
        assert g.rowpitch % vec == 0
        used.append((g.off * itemsize, (g.off + g.slices * g.pitch)
                     * itemsize, "table"))
    ring_end = plan.ring_off + plan.work_warps * plan.stage_bytes
    ring = (plan.ring_off, ring_end, "ring")
    assert plan.ring_off % 128 == 0 and plan.stage_bytes % 128 == 0
    assert plan.stage_bytes >= te.TILE * len(dims) * 8
    assert 1 <= plan.work_warps and 32 * plan.work_warps <= plan.threads
    assert plan.threads % 32 == 0 and plan.threads <= te.THREADS[plan.R]
    used.append((plan.bar_off, plan.bar_off + plan.work_warps * 8, "bars"))
    scratch = []
    for s, g in ((s, g) for g in plan.groups if g.last > g.first
                 for s in plan.sites[g.first:g.last + 1]):
        assert s.dst % vec == 0 and (s.dpitch // vec) % 2 == 1
        scratch.append((s.dst * itemsize, (s.dst + s.n * s.dpitch) * itemsize,
                        "staged core"))
    for st in plan.steps:
        assert 0 <= st.start < plan.threads
        if st.dst >= plan.ring_off // itemsize:     # an intermediate buffer
            scratch.append((st.dst * itemsize,
                            (st.dst + st.rows // st.rl_g * st.dst_pitch)
                            * itemsize, "intermediate"))
    spans = used + ([ring] if plan.early else []) + sorted(set(scratch))
    for lo, hi, what in spans:
        assert 0 <= lo <= hi <= plan.smem_bytes, what
    for k, (lo, hi, what) in enumerate(spans):
        for lo2, hi2, what2 in spans[k + 1:]:
            if what == what2 == "intermediate":
                continue        # a run's two buffers take turns
            assert hi <= lo2 or hi2 <= lo, (what, what2)
    if not plan.early:          # the scratch borrows the ring's bytes
        for lo, hi, _what in scratch:
            assert plan.ring_off <= lo and hi <= plan.bar_off


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("dims,ranks,M", PLAN_CASES)
def test_tables_and_measurements_match_plain_version(dims, ranks, M, dtype,
                                                     rtol):
    """The plain model of the kernel (cores staged and multiplied into
    tables at the plan's offsets, then one product per run and
    measurement) gives the plain version's values; nothing it reads was
    left unwritten (the image starts as NaN)."""
    cores, P = _instance(dims, ranks, 60, 11)
    tc = [torch.from_numpy(c).to(dtype) for c in cores]
    plan = te.tt_eval_plan(_shapes(dims, ranks), tc[0].element_size(), M,
                           SMS)
    image = te.build_tables(plan, tc)
    got, bad = te.eval_from_tables(plan, image, torch.from_numpy(P))
    want = te.tt_eval_at_points_reference(tc, torch.from_numpy(P))
    assert bad == 0 and got.dtype == dtype
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


def test_plan_merges_for_many_measurements_only():
    """A table is paid once per block: all 4^10 entries merge the ten
    sites into a few runs, 400 samples keep one run per site."""
    shapes = _shapes([4] * 10, [4] + [8] * 7 + [4])
    grid = te.tt_eval_plan(shapes, 8, 4 ** 10, SMS)
    few = te.tt_eval_plan(shapes, 8, 400, SMS)
    assert len(grid.groups) < 10 and grid.loads_per_entry < 456
    assert grid.blocks == SMS and grid.work_warps == 32
    assert [g.first for g in few.groups] == list(range(10))
    assert few.loads_per_entry == 456 and not few.steps
    assert few.blocks == 13 and few.work_warps == 1
    # one rule: MERGE_MIN_PER_BLOCK measurements per block, either dtype
    edge = te.MERGE_MIN_PER_BLOCK * SMS
    for itemsize in (8, 4):
        at = te.tt_eval_plan(shapes, itemsize, edge, SMS)
        below = te.tt_eval_plan(shapes, itemsize, edge - 1, SMS)
        assert [(g.first, g.last) for g in at.groups] == [
            (0, 3), (4, 6), (7, 9)]
        assert len(below.groups) == 10


def test_plan_override_and_its_limits():
    shapes = _shapes([4] * 10, [4] + [8] * 7 + [4])
    runs = ((0, 2), (3, 4), (5, 6), (7, 9))
    plan = te.tt_eval_plan(shapes, 8, 4 ** 10, SMS, groups=runs)
    assert tuple((g.first, g.last) for g in plan.groups) == runs
    wide = _shapes([4] * 4, [32] * 3)
    with pytest.raises(ValueError, match="one group per site"):
        te.tt_eval_plan(wide, 8, 1000, SMS, groups=((0, 1), (2, 3)))


def test_model_counts_out_of_range_indices_against_the_sites_own_size():
    """An index outside [0, n_k) of its own site, negative or in
    [n_k, max n) of a ragged TT, makes the measurement NaN and is counted
    once per measurement; the others are untouched."""
    dims, ranks = [2, 5, 3, 4], [2, 4, 3]
    cores, P = _instance(dims, ranks, 40, 2)
    tc = [torch.from_numpy(c) for c in cores]
    for M in (40, 10 ** 6):
        plan = te.tt_eval_plan(_shapes(dims, ranks), 8, M, SMS)
        image = te.build_tables(plan, tc)
        bad = torch.from_numpy(P).clone()
        bad[3, 0] = 2          # < max n = 5, but site 0 has 2 entries
        bad[7, 2] = -1
        bad[39, 1] = 5
        bad[39, 3] = 4         # two bad indices, one measurement
        got, n_bad = te.eval_from_tables(plan, image, bad)
        want = te.tt_eval_at_points_reference(tc, torch.from_numpy(P))
        assert n_bad == 3
        rows = torch.tensor([3, 7, 39])
        assert torch.isnan(got[rows]).all()
        keep = torch.ones(40, dtype=torch.bool)
        keep[rows] = False
        np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(),
                                   rtol=0, atol=1e-12)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_route_choice_agrees_with_the_chip_checks_cases():
    """The route each of chip_smoke.py's K3 cases expects is the one the
    plan chooses from its shapes, M and the positions' alignment."""
    smoke = _chip_smoke()
    assert len(smoke.K3_CASES) >= 15
    for name, dims, ranks, M, route in smoke.K3_CASES:
        for itemsize in (8, 4):
            aligned = "8-byte" not in name
            plan = te.tt_eval_plan(_shapes(dims, ranks), itemsize, M, SMS,
                                   aligned)
            assert plan.route == smoke.K3_ROUTES[route], name
            if plan.route == te.ROUTE_SMEM:
                assert plan.positions == ("bulk copies" if aligned
                                          else "plain loads"), name
    by_name = {c[0]: c for c in smoke.K3_CASES}
    mid = te.tt_eval_plan(_shapes(*by_name["stack 82 KB"][1:3]), 8,
                          by_name["stack 82 KB"][3], SMS)
    assert mid.smem_bytes > 48 * 1024
    assert len(by_name["d past the table"][1]) > te.MAX_SITES
    # the device-memory route's frontier: registers up to rank 32
    for name, capacity in (("rank 160", 0), ("d past the table", 8),
                           ("d past the table, rank 12", 32)):
        _n, dims, ranks, M, _r = by_name[name]
        plan = te.tt_eval_plan(_shapes(dims, ranks), 8, M, SMS)
        assert plan.R == capacity and str(capacity or "device memory") in \
            plan.describe()
    chain = by_name["long chain, scratch inside the ring"]
    assert not te.tt_eval_plan(_shapes(*chain[1:3]), 8, chain[3], SMS).early


def test_check_refuses_cores_whose_ranks_do_not_chain():
    cores, P = _instance([3, 4, 2], [2, 3], 4, 5)
    tc = [torch.from_numpy(c) for c in cores]
    te._check(tc, torch.from_numpy(P))
    with pytest.raises(ValueError, match="rows"):
        te._check([tc[0], tc[1][:1], tc[2]], torch.from_numpy(P))
    with pytest.raises(ValueError, match="contiguous"):
        te._check(tc, torch.from_numpy(P).T.contiguous().T)


@pytest.mark.parametrize("bad", ["negative index", "index equal to n",
                                 "bond rank mismatch"])
def test_cpu_route_rejects_bad_input_like_the_card(bad):
    """The CPU route checks its input as the card's does and raises
    ValueError: a negative index does not wrap, an index equal to its mode
    size does not surface as IndexError, mismatched bond ranks do not
    surface as an einsum error."""
    cores, P = _instance([3, 4, 5], [2, 3], 6, 1)
    cores = [torch.from_numpy(c) for c in cores]
    P = torch.from_numpy(P)
    if bad == "negative index":
        P[2, 1] = -1
    elif bad == "index equal to n":
        P[4, 2] = 5
    else:
        cores[1] = torch.zeros((2, 4, 4), dtype=torch.float64)
    calls = te.tt_eval_at_points.calls
    with pytest.raises(ValueError):
        te.tt_eval_at_points(cores, P)
    assert te.tt_eval_at_points.calls == calls + 1
    assert te.tt_eval_at_points.launches == 0
