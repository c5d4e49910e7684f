"""The port's CUDA kernels held against their plain versions on the card.

Imports no jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Without a card every case skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from xerus_tpu_torch.ops import df32
from xerus_tpu_torch.ops import gemm_exact as ge
from xerus_tpu_torch.ops import tt_eval as te
from xerus_tpu_torch.ops.df_matvec import df_matvec, df_matvec_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1800, 1800), (1030, 997), (130, 190),
                                 (1, 1), (33, 0)])
def test_df_matvec_kernel_matches_reference(cuda, m, k):
    """Kernel and plain version both within 1e-12 of the f64 product (the
    reduction orders differ, so not bitwise)."""
    rng = np.random.Generator(np.random.PCG64(m * 7919 + k))
    A = rng.normal(size=(m, k))
    x = rng.normal(size=(k,))
    args = (*df32.df_from_f64(A, cuda), *df32.df_from_f64(x, cuda))
    launches0 = df_matvec.launches
    kern = df32.df_to_f64(*df_matvec(*args))
    torch.cuda.synchronize()
    assert df_matvec.launches == launches0 + 1
    plain = df32.df_to_f64(*df_matvec_reference(*args))
    exact = A @ x
    if k == 0:
        assert np.all(kern == 0.0)
        return
    assert _rel(kern, exact) < 1e-12
    assert _rel(plain, exact) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(64, 64), (192, 64), (512, 256),
                                 (256, 512), (1, 512)])
def test_df_matvec_kernel_on_the_df_cholesky_shapes(cuda, m, k):
    """The df Cholesky's column loops pass K1 half-filled operands: the
    trailing columns of A and entries of x still zero.  Kernel and plain
    version within 1e-12 of || |A| |x| || of the f64 product."""
    rng = np.random.Generator(np.random.PCG64(m * 7919 + k + 1))
    A = rng.normal(size=(m, k))
    x = rng.normal(size=(k,))
    A[:, k // 2:] = 0.0
    x[k // 2 + 1:] = 0.0
    args = (*df32.df_from_f64(A, cuda), *df32.df_from_f64(x, cuda))
    kern = df32.df_to_f64(*df_matvec(*args))
    plain = df32.df_to_f64(*df_matvec_reference(*args))
    exact = A @ x
    scale = np.linalg.norm(np.abs(A) @ np.abs(x))
    assert np.linalg.norm(kern - exact) <= 1e-12 * scale
    assert np.linalg.norm(plain - exact) <= 1e-12 * scale


@pytest.mark.cuda
def test_df_matvec_kernel_rejects_bad_input(cuda):
    A = torch.zeros((8, 6), device=cuda)
    x = torch.zeros((6,), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        df_matvec(A[:, ::2], A[:, ::2], x[::2], x[::2])
    with pytest.raises(TypeError, match="float32"):
        df_matvec(A.double(), A.double(), x.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        df_matvec(A, A, x[:5], x[:5])
    with pytest.raises(ValueError, match="on cpu"):
        df_matvec(A, A, x.cpu(), x.cpu())


def _k2_case(kind, B, M, keep, seed):
    rng = np.random.default_rng(seed)
    if kind == "generic":
        return rng.standard_normal((B, M)) * rng.uniform(0.1, 1.0,
                                                         size=(B, 1))
    if kind == "cliff":
        U, _ = np.linalg.qr(rng.standard_normal((B, B)))
        V, _ = np.linalg.qr(rng.standard_normal((M, B)))
        s = np.concatenate([np.linspace(10.0, 1.0, keep),
                            np.full(B - keep, 1e-6)])
        return (U * s) @ V.T
    return rng.standard_normal((B, 7)) @ rng.standard_normal((7, M))


def _k2_err(cur, vt):
    c = cur.double().cpu().numpy()
    v = vt.double().cpu().numpy()
    return np.linalg.norm(c - (c @ v.T) @ v) ** 2 / np.linalg.norm(c) ** 2


def _k2_vt(cur, keep, cap, use_kernel):
    mask = (torch.arange(cap, device=cur.device) < keep).to(cur.dtype)
    if use_kernel:
        vt0, vt_bal, flags = ge.gemm_exact_kernel(cur, keep, cap)
        okp, conv = flags.tolist()[:2]
    else:
        vt0, vt_bal, okp, conv, _ = ge._gemm_exact_body(
            cur, mask, *ge._gemm_exact_tuning(cur.dtype))
    return ge._finish_gemm_exact(vt0, vt_bal, bool(okp), mask), bool(conv)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,keep,cap", [
    ("generic", 256, 512, 96, 128), ("cliff", 256, 512, 96, 128),
    ("overranked", 256, 512, 96, 128), ("generic", 256, 256, 128, 128),
    ("generic", 40, 24, 5, 8)])
def test_gemm_exact_kernel_matches_plain_f32(cuda, kind, B, M, keep, cap):
    """K2 and its plain version on the card: truncation errors within
    5e-6 (the reference's bar), both certified; two launches bitwise
    equal."""
    cur = torch.tensor(_k2_case(kind, B, M, keep, B + M),
                       dtype=torch.float32, device=cuda)
    launches0 = ge.gemm_exact_kernel.launches
    vk, conv_k = _k2_vt(cur, keep, cap, True)
    torch.cuda.synchronize()
    assert ge.gemm_exact_kernel.launches == launches0 + 1
    vp, conv_p = _k2_vt(cur, keep, cap, False)
    assert conv_k and conv_p
    assert abs(_k2_err(cur, vk) - _k2_err(cur, vp)) < 5e-6
    a = ge.gemm_exact_kernel(cur, keep, cap)
    b = ge.gemm_exact_kernel(cur, keep, cap)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,keep,cap,route", [
    ("generic", 256, 256, 128, 128, 16), ("cliff", 512, 1024, 256, 256, 0)])
def test_gemm_exact_kernel_routes(cuda, kind, B, M, keep, cap, route):
    """The rounding's (256, 256) keep-128 bond takes the 16-CTA cluster
    route, a shape past one cluster's shared memory the grid route; the
    route is chosen before the launch and the flags report the one that
    ran.  Each matches its plain version within 5e-6 in truncation error,
    and repeat launches are bitwise equal."""
    cur = torch.tensor(_k2_case(kind, B, M, keep, B + M),
                       dtype=torch.float32, device=cuda)
    assert ge.gemm_exact_route(B, M, cap, torch.float32) == route
    vk, conv_k = _k2_vt(cur, keep, cap, True)
    vp, conv_p = _k2_vt(cur, keep, cap, False)
    assert conv_k and conv_p
    assert abs(_k2_err(cur, vk) - _k2_err(cur, vp)) < 5e-6
    a = ge.gemm_exact_kernel(cur, keep, cap)
    b = ge.gemm_exact_kernel(cur, keep, cap)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    flags = dict(zip(ge.FLAGS, a[2].tolist()))
    assert flags["cluster_ctas"] == route
    assert 0 < flags["ns_rows"] <= flags["ns"] and flags["barriers"] > 0


@pytest.mark.cuda
def test_gemm_exact_kernel_f64_matches_svd(cuda):
    """f64 launches the double kernel; its truncation error equals the SVD
    truncation's to rtol 1e-8."""
    A = _k2_case("generic", 40, 24, 5, 3)
    cur = torch.tensor(A, dtype=torch.float64, device=cuda)
    vt, conv = _k2_vt(cur, 5, 8, True)
    s = np.linalg.svd(A, compute_uv=False)
    assert conv
    np.testing.assert_allclose(_k2_err(cur, vt),
                               np.sum(s[5:] ** 2) / np.sum(s ** 2), rtol=1e-8)


@pytest.mark.cuda
def test_gemm_exact_kernel_rejects_bad_input(cuda):
    cur = torch.zeros((16, 24), device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        ge.gemm_exact_kernel(cur.half(), 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ge.gemm_exact_kernel(cur[:, ::2], 4, 8)
    with pytest.raises(ValueError, match="keep_cap"):
        ge.gemm_exact_kernel(cur, 4, 32)
    with pytest.raises(ValueError, match="cap"):
        ge.gemm_exact_kernel(torch.zeros((12000, 1), device=cuda), 4, 8)


# K3: chip_smoke.py's phase_k3 shapes (dims, ranks, M): the completion
# slice's (d=10, n=4, r=8) with few and many measurements, the ragged case
# of tests/test_pallas_kernels.py, a short tail, no measurement, one, a tile
# and one either side, n = 3 and 5 with prime M, tables past 48 KB (r=16),
# the r=32 instantiation, a 24-site chain, 12 sites whose tables leave the
# build's scratch no room beside the ring, r=16 with merged runs, and the
# device-memory route's shapes: rank 160 and more sites than the by-value
# table holds (ranks 2 and 12: both register capacities)
K3_SLICE_RANKS = [4] + [8] * 7 + [4]
K3_SHAPES = [([4] * 10, K3_SLICE_RANKS, 20000),
             ([4] * 10, K3_SLICE_RANKS, 300007),
             ([2, 5, 3, 4], [2, 4, 3], 17), ([3] * 4, [2] * 3, 13),
             ([3] * 4, [2] * 3, 0), ([3] * 4, [2] * 3, 1),
             ([4] * 5, [3] * 4, 31), ([4] * 5, [3] * 4, 32),
             ([4] * 5, [3] * 4, 33), ([3] * 7, [5] * 6, 100003),
             ([5] * 7, [3, 7, 8, 8, 5, 2], 65537),
             ([4] * 10, [16] * 9, 20000), ([4] * 6, [32] * 5, 5000),
             ([2] * 24, [2] * 23, 200000), ([4] * 12, [8] * 11, 300001),
             ([4] * 10, [16] * 9, 500000), ([2] * 3, [160, 160], 50),
             ([2] * 40, [2] * 39, 1000), ([3] * 26, [12] * 25, 5000)]


def _k3_case(dims, ranks, M, dtype, device, seed=3):
    rng = np.random.default_rng(seed)
    rs = [1] + list(ranks) + [1]
    cores = [torch.tensor(rng.standard_normal((rs[k], n, rs[k + 1]))
                          / np.sqrt(rs[k]), dtype=dtype, device=device)
             for k, n in enumerate(dims)]
    P = np.stack([rng.integers(0, n, size=M) for n in dims],
                 axis=1).reshape(M, len(dims))
    return cores, torch.tensor(P, dtype=torch.int64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("dims,ranks,M", K3_SHAPES)
def test_tt_eval_kernel_matches_plain(cuda, dims, ranks, M, dtype, rtol):
    """K3 against its plain version on the card, one launch per call, in
    the cores' dtype: max |kernel - plain| <= rtol * max |plain|; a second
    launch gives the same bits; the launch took the route the plan names."""
    cores, pos = _k3_case(dims, ranks, M, dtype, cuda)
    launches0 = te.tt_eval_at_points.launches
    kern = te.tt_eval_at_points(cores, pos)
    torch.cuda.synchronize()
    assert te.tt_eval_at_points.launches == launches0 + 1
    plan = te.plan_launch(cores, pos).plan
    assert te.tt_eval_at_points.route == plan.describe()
    device_route = max(ranks) > 32 or len(dims) > te.MAX_SITES
    assert plan.route == (te.ROUTE_GENERIC if device_route else te.ROUTE_SMEM)
    plain = te.tt_eval_at_points_reference(cores, pos)
    assert kern.shape == (M,) and kern.dtype == dtype
    assert torch.equal(kern, te.tt_eval_at_points(cores, pos))
    if M:
        scale = float(plain.abs().max())
        assert float((kern - plain).abs().max()) <= rtol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_tt_eval_kernel_takes_positions_off_a_16_byte_boundary(cuda, dtype,
                                                               rtol):
    """Odd d and a positions view that starts 8 bytes off a 16-byte
    boundary: the bulk copies cannot take it, the warps' plain loads do."""
    cores, pos = _k3_case([4] * 5, [3] * 4, 402, dtype, cuda)
    view = pos[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    kern = te.tt_eval_at_points(cores, view)
    assert "plain loads" in te.tt_eval_at_points.route
    plain = te.tt_eval_at_points_reference(cores, view)
    assert float((kern - plain).abs().max()) <= rtol * float(plain.abs().max())
    assert torch.equal(kern, te.tt_eval_at_points(cores, pos)[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [((0, 5), (6, 9)), ((0, 4), (5, 9)),
                                  ((0, 1), (2, 3), (4, 5), (6, 7), (8, 9)),
                                  tuple((k, k) for k in range(10))])
def test_tt_eval_kernel_gives_the_plain_values_under_any_grouping(cuda, runs):
    """The values do not depend on how the plan groups the sites (beyond
    rounding)."""
    cores, pos = _k3_case([3] * 10, [4] + [6] * 7 + [4], 50001,
                          torch.float64, cuda)
    plain = te.tt_eval_at_points_reference(cores, pos)
    scale = float(plain.abs().max())
    out, bad = te.launch_plan(te.plan_launch(cores, pos, groups=runs))
    assert int(bad.sum().item()) == 0
    assert float((out - plain).abs().max()) <= 1e-12 * scale


@pytest.mark.cuda
def test_tt_eval_kernel_takes_cores_of_any_layout(cuda):
    """The kernel reads each core through its strides, so transposed views
    (a QR's column-major Q) evaluate like contiguous cores, bit for bit."""
    cores, pos = _k3_case([3] * 4, [2] * 3, 13, torch.float64, cuda)
    views = [c.transpose(0, 2).contiguous().transpose(0, 2) for c in cores]
    assert not views[1].is_contiguous()
    assert torch.equal(te.tt_eval_at_points(views, pos),
                       te.tt_eval_at_points(cores, pos))


@pytest.mark.cuda
def test_tt_eval_kernel_rejects_bad_input(cuda):
    cores, pos = _k3_case([3] * 4, [2] * 3, 13, torch.float64, cuda)
    launches0 = te.tt_eval_at_points.launches
    with pytest.raises(TypeError, match="float32 or float64"):
        te.tt_eval_at_points([c.half() for c in cores], pos)
    with pytest.raises(TypeError, match="int64"):
        te.tt_eval_at_points(cores, pos.int())
    with pytest.raises(ValueError, match="tensor"):
        te.tt_eval_at_points([cores[0][0]] + cores[1:], pos)
    with pytest.raises(ValueError, match="contiguous"):
        te.tt_eval_at_points(cores, pos.T.contiguous().T)
    with pytest.raises(ValueError, match="on cpu"):
        te.tt_eval_at_points(cores, pos.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        te.tt_eval_at_points([cores[0], cores[1].cpu()] + cores[2:], pos)
    assert te.tt_eval_at_points.launches == launches0
    with pytest.raises(ValueError, match="rows"):
        te.tt_eval_at_points([cores[0], cores[1][:1]] + cores[2:], pos)
    assert te.tt_eval_at_points.launches == launches0
    bad = pos.clone()
    bad[5, 2] = 3
    with pytest.raises(ValueError, match="outside the mode sizes"):
        te.tt_eval_at_points(cores, bad)
    bad[5, 2] = -1
    with pytest.raises(ValueError, match="outside the mode sizes"):
        te.tt_eval_at_points(cores, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tt_eval_kernel_counts_bad_indices_in_the_last_partial_tile(cuda,
                                                                    dtype):
    """Indices outside their own site's mode size (a ragged TT: inside the
    largest mode, outside this site's) in the last, partial tile: NaN at
    those measurements only, counted once each, and the wrapper raises."""
    M = 32 * 3 + 5
    cores, pos = _k3_case([2, 5, 3, 4], [2, 4, 3], M, dtype, cuda)
    good = te.tt_eval_at_points(cores, pos)
    bad = pos.clone()
    bad[M - 2, 0] = 2
    bad[M - 4, 2] = -1
    bad[M - 1, 1] = 5
    bad[M - 1, 3] = 4
    out, count = te._launch(cores, bad)
    rows = torch.tensor([M - 4, M - 2, M - 1], device=cuda)
    keep = torch.ones(M, dtype=torch.bool, device=cuda)
    keep[rows] = False
    assert int(count.sum().item()) == 3
    assert torch.isnan(out[rows]).all()
    assert torch.equal(out[keep], good[keep])
    with pytest.raises(ValueError, match="3 of 101 positions"):
        te.tt_eval_at_points(cores, bad)


@pytest.mark.cuda
def test_tt_eval_kernel_takes_an_empty_mode(cuda):
    """A site with no entries stages nothing: no measurement gives an empty
    result, and any index there is out of range."""
    cores = [torch.zeros((1, 0, 1), dtype=torch.float64, device=cuda)]
    none = torch.zeros((0, 1), dtype=torch.int64, device=cuda)
    assert te.tt_eval_at_points(cores, none).shape == (0,)
    five = torch.zeros((5, 1), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="5 of 5 positions"):
        te.tt_eval_at_points(cores, five)
    torch.cuda.synchronize()


# -- the double-word stack and the uniform roundings, card against CPU


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128, 512, 2048])
def test_ozaki_slice_gemms_are_exact_on_the_card(cuda, k):
    """Every slice product (bf16 in, f32 out on the card) equals the
    float64 product of the same slices bit for bit, rows whose maximum is
    an exact power of two included (where a log2 one ulp off would pick
    another split)."""
    from xerus_tpu_torch.ops import ozaki as oz
    rng = np.random.Generator(np.random.PCG64(k))
    A = rng.normal(size=(96, k)) * np.exp2(rng.integers(-20, 20, (96, 1)))
    A[::3, 0] = np.exp2(rng.integers(-20, 20, 32))
    A[::3, 1:] *= 0.5 / np.abs(A[::3, 1:]).max(axis=1, keepdims=True)
    A[::3, 1:] *= np.abs(A[::3, :1])
    B = rng.normal(size=(k, 80))
    At = torch.from_numpy(A.astype(np.float32)).to(cuda)
    Bt = torch.from_numpy(B.astype(np.float32)).to(cuda)
    delta = oz._slice_width(k)
    s = int(np.ceil(24 / delta))
    A_sl, _ = oz.ozaki_split(At, 1, delta, s)
    B_sl, _ = oz.ozaki_split(Bt, 0, delta, s)
    for a in A_sl:
        for b in B_sl:
            assert torch.equal(oz._gemm_exact(a, b).double(),
                               a.double() @ b.double())
    z = torch.zeros_like
    got = df32.df_to_f64(*oz.ozaki_matmul(At, z(At), Bt, z(Bt)))
    A32 = A.astype(np.float32).astype(np.float64)
    B32 = B.astype(np.float32).astype(np.float64)
    scale = (np.abs(A32) @ np.abs(B32)).max()
    assert np.abs(got - A32 @ B32).max() / scale < 1e-13


def _cpu_and_card(fn, cores, cuda):
    cpu = [c.double().numpy() for c in fn(
        [torch.from_numpy(c) for c in cores])]
    card = [c.double().cpu().numpy() for c in fn(
        [torch.from_numpy(c).to(cuda) for c in cores])]
    return cpu, card


@pytest.mark.cuda
def test_df_rounding_card_matches_cpu(cuda):
    """tt_round_df on the card (K1 in the column loops, cuSOLVER's seed
    eigh, bf16 slice GEMMs) and on the CPU: both within 1e-11 of the
    float64 chain at d=7, the same ranks, and with eps=1e-7 the 1e-9 tail
    dropped on both."""
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          cliff_instance, cpu_round_sweep,
                                          host_tt_distance, host_tt_log_norm)
    from xerus_tpu_torch.ops.df_matvec import df_matvec as k1
    from xerus_tpu_torch.ops.df_rounding import tt_round_df_from_f64
    host = [c.astype(np.float64) for c in bench_round_instance(7, 3, 6)]
    cores = cliff_instance(host, 3, 1e-9)
    chain = cpu_round_sweep(cores, 3)
    nrm = np.exp(host_tt_log_norm(chain))
    launches = k1.launches
    card = tt_round_df_from_f64(cores, 3, device=cuda)
    assert k1.launches > launches
    cpu = tt_round_df_from_f64(cores, 3, device=torch.device("cpu"))
    for out in (card, cpu):
        assert [c.shape for c in out] == [c.shape for c in chain]
        assert host_tt_distance(out, chain) / nrm < 1e-11
    eps_chain = cpu_round_sweep(cores, 6, eps=1e-7)
    for dev in (cuda, torch.device("cpu")):
        out = tt_round_df_from_f64(cores, 6, eps=1e-7, device=dev)
        assert [c.shape for c in out] == [c.shape for c in eps_chain]
        assert host_tt_distance(out, eps_chain) / nrm < 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cholqr", "gram_parallel",
                                    "subspace_parallel", "streaming"])
def test_uniform_rounding_card_matches_cpu(cuda, method):
    """Each uniform, parallel or streaming rounding in float64 at d=10,
    rank 16 -> 8, card against CPU within 1e-10 (one set of sketches)."""
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          host_tt_distance, host_tt_log_norm)
    from xerus_tpu_torch.ops import round_uniform as ru
    host = [c.astype(np.float64) for c in bench_round_instance(10, 2, 16)]
    sk = ru._streaming_sketches(10, 2, 8, 32, torch.float64,
                                torch.device("cpu"))

    def fn(cores):
        if method == "streaming":
            dev = cores[0].device
            return ru.tt_round_streaming_uniform(
                cores, 8, sketches=tuple([t.to(dev) for t in part]
                                         for part in sk))
        return ru.tt_round_sweep_uniform(cores, 8, method=method)

    cpu, card = _cpu_and_card(fn, host, cuda)
    assert [c.shape for c in card] == [c.shape for c in cpu]
    assert (host_tt_distance(card, cpu) / np.exp(host_tt_log_norm(cpu))
            < 1e-10)


@pytest.mark.cuda
def test_cholqr_f32_on_the_card_keeps_its_grams_orthogonal(cuda):
    """The cholqr rounding of the d=32 rank-256 instance in float32 on the
    card: every truncation Gram's eigenvectors orthogonal to 1e-4 (plain
    cuSOLVER float32 eigh left 1.9e-3 there) and the log-norm within 1e-4
    of the float64 chain's."""
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          cpu_round_sweep, host_tt_log_norm)
    from xerus_tpu_torch.ops import round_uniform as ru
    host = bench_round_instance(32, 2, 256)
    ref = host_tt_log_norm(cpu_round_sweep(host, 128))
    grams = []
    eigh = ru._eigh

    def record(A):
        grams.append(A.clone())
        return eigh(A)

    ru._eigh = record
    try:
        out = ru.tt_round_sweep_uniform(
            [torch.from_numpy(c).to(cuda, torch.float32) for c in host], 128,
            method="cholqr")
    finally:
        ru._eigh = eigh
    assert len(grams) == 31
    for G in grams:
        assert G.dtype == torch.float32
        _w, V = eigh(G)
        V = V.double()
        eye = torch.eye(V.shape[0], dtype=torch.float64, device=cuda)
        assert float(torch.linalg.matrix_norm(V.T @ V - eye)) < 1e-4
    got = host_tt_log_norm([c.double().cpu().numpy() for c in out])
    assert abs(got - ref) / abs(ref) < 1e-4
