"""The port's CUDA kernels held against their plain versions on the card.

Imports no jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Without a card every case skips (the kernels have no CPU mode)."""

import importlib

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


def _k2_input(kind, B, M, keep, device):
    """A K2 case in float32 on ``device``; kind "bond": the middle
    trunc-mode bond of the d=32 rank-B -> keep rounding instance, captured
    from its svd rounding on the card."""
    if kind == "bond":
        from xerus_tpu_torch.examples.k2_grid import bond_inputs
        bonds = bond_inputs(B, keep, device)
        cur, _keep, _cap = bonds[len(bonds) // 2]
        assert tuple(cur.shape) == (B, M)
        return cur
    return torch.tensor(_k2_case(kind, B, M, keep, B + M),
                        dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,keep,cap,route", [
    ("generic", 256, 256, 128, 128, 16), ("cliff", 512, 1024, 256, 256, 0),
    ("bond", 512, 512, 256, 256, 0), ("bond", 1024, 1024, 512, 512, 0)])
def test_gemm_exact_kernel_routes(cuda, kind, B, M, keep, cap, route):
    """The rounding's (256, 256) keep-128 bond takes the 16-CTA cluster
    route, shapes past one cluster's shared memory the grid route (the
    rank-512 and rank-1024 roundings' bonds among them); the route is
    chosen before the launch and the flags report the one that ran.  Each
    matches its plain version within 5e-6 in truncation error, repeat
    launches are bitwise equal, and the flags' counts lie within the
    tuning's caps."""
    cur = _k2_input(kind, B, M, keep, cuda)
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
    max_outer, max_ns, polish, _stall = ge._gemm_exact_tuning(torch.float32)
    assert 0 < flags["outer"] <= max_outer and flags["ns_rows"] <= max_ns
    assert 0 <= flags["retries"] <= flags["outer"] + polish
    assert flags["ns"] <= (flags["outer"] + polish + 2
                           + 2 * flags["retries"]) * max_ns


def _k2_retry_case(cur, keep, cap):
    """K2 and its plain version on one float32 bond on the card: each
    one's certificate and two-stage retries, and the truncation errors of
    both and of the SVD truncation (float64 on the host)."""
    vk, conv_k = _k2_vt(cur, keep, cap, True)
    flags = dict(zip(ge.FLAGS, ge.gemm_exact_kernel(cur, keep, cap)[2]
                     .tolist()))
    retries0 = ge._power_orth.retries
    vp, conv_p = _k2_vt(cur, keep, cap, False)
    s = np.linalg.svd(cur.double().cpu().numpy(), compute_uv=False)
    e_svd = np.sum(s[keep:] ** 2) / np.sum(s ** 2)
    return (conv_k, flags["retries"], _k2_err(cur, vk)), \
        (conv_p, ge._power_orth.retries - retries0, _k2_err(cur, vp)), e_svd


@pytest.mark.cuda
def test_gemm_exact_cluster_route_retries_on_the_graded_bond(cuda):
    """ROADMAP fault 7 on the cluster route: the graded (128, 128) keep-64
    bond of tests/test_torch_k2_fault7.py, whose power steps' one-stage
    Newton-Schulz ends at the cap.  K2 and its plain version on the card
    both take two-stage retries and certify, with truncation errors within
    5e-6 of each other and of the SVD truncation's."""
    from xerus_tpu_torch.examples.k2_grid import GRADED_BOND, graded_bond
    keep = GRADED_BOND["keep"]
    cur = torch.tensor(graded_bond(**GRADED_BOND), dtype=torch.float32,
                       device=cuda)
    assert ge.gemm_exact_route(128, 128, keep, torch.float32) == 16
    (ck, rk_, ek), (cp, rp, ep), e_svd = _k2_retry_case(cur, keep, keep)
    assert ck and cp and rk_ > 0 and rp > 0, (rk_, rp)
    assert abs(ek - ep) < 5e-6 and abs(ek - e_svd) < 5e-6


@pytest.mark.cuda
def test_gemm_exact_grid_route_certifies_the_fault7_bond(cuda):
    """ROADMAP fault 7 on the grid route: bond 0 of the d=32 rank-512 ->
    256 rounding, which fell back to the SVD before the two-stage retry.
    K2 and its plain version on the card both certify it, with truncation
    errors within 5e-6 of each other; a kernel that retries does so within
    its outer and polish steps."""
    from xerus_tpu_torch.examples.k2_grid import bond_inputs
    cur, keep, cap = bond_inputs(512, 256, cuda)[0]
    assert ge.gemm_exact_route(512, 512, cap, torch.float32) == 0
    (ck, rk_, ek), (cp, _rp, ep), _e_svd = _k2_retry_case(cur, keep, cap)
    assert ck and cp
    assert abs(ek - ep) < 5e-6
    polish = ge._gemm_exact_tuning(torch.float32)[2]
    flags = dict(zip(ge.FLAGS, ge.gemm_exact_kernel(cur, keep, cap)[2]
                     .tolist()))
    assert 0 <= rk_ == flags["retries"] <= flags["outer"] + polish


@pytest.mark.cuda
def test_gemm_exact_grid_stamps_keep_the_bits(cuda):
    """The profiling build of K2 (examples/k2_grid.py, compiled with the
    grid route's time stamps) gives the production build's bits at the
    rank-512 rounding's middle bond, and its stamps are consistent: the
    parts of CTA 0's cycles lie within them."""
    from xerus_tpu_torch.examples.k2_grid import stamped_launch
    cur = _k2_input("bond", 512, 512, 256, cuda)
    a = ge.gemm_exact_kernel(cur, 256, 256)
    st = stamped_launch(cur, 256, 256)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], st["outputs"]))
    assert st["flags"] == dict(zip(ge.FLAGS, a[2].tolist()))
    t = st["stamps"]
    parts = t["barrier_wait"] + t["products"] + t["folds"]
    assert 0 < parts <= t["cycles"] and t["k_slices"] > 0
    assert t["item_fill"] + t["k_loops"] + t["fold_epilogue"] <= t["products"]


@pytest.mark.cuda
def test_gemm_exact_grid_layout_matches_the_kernel(cuda):
    """The host's mirror of the grid route's workspace layout
    (``grid_layout``, which the CPU tests check for coverage) agrees with
    the bytes the kernel library asks the wrapper for."""
    lib = ge._library()
    for B, M, K in ((512, 512, 256), (1024, 1024, 512), (264, 200, 8),
                    (512, 1024, 256)):
        for elt, dtype in ((4, torch.float32), (8, torch.float64)):
            assert ge.gemm_exact_route(B, M, K, dtype) == 0
            assert (lib.xerus_gemm_exact_workspace_bytes(B, M, K, elt)
                    == ge.grid_layout(B, M, K)["total"] * elt)


@pytest.mark.cuda
def test_gemm_exact_kernel_f64_grid_matches_svd(cuda):
    """An f64 shape past one cluster takes the grid route; its truncation
    error equals the SVD truncation's to rtol 1e-8 (chip_smoke's
    K2_F64_RTOL), and repeat launches are bitwise equal."""
    A = _k2_case("generic", 264, 200, 8, 464)
    cur = torch.tensor(A, dtype=torch.float64, device=cuda)
    assert ge.gemm_exact_route(264, 200, 8, torch.float64) == 0
    vt, conv = _k2_vt(cur, 8, 8, True)
    s = np.linalg.svd(A, compute_uv=False)
    assert conv
    np.testing.assert_allclose(_k2_err(cur, vt),
                               np.sum(s[8:] ** 2) / np.sum(s ** 2), rtol=1e-8)
    a = ge.gemm_exact_kernel(cur, 8, 8)
    b = ge.gemm_exact_kernel(cur, 8, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


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


# K2 in float64 against its plain version, chip_smoke.py's bars on the
# object rounding's bonds: kept projectors ||P_k - P_p||_F / ||P_p||_F and
# the truncation errors' relative difference
K2_F64_PROJ_BAR = 1e-5
K2_F64_ERR_BAR = 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("B,M", [(256, 256), (256, 512)])
def test_gemm_exact_kernel_f64_bonds_take_the_cluster_route(cuda, B, M):
    """The f64 object rounding's bonds, (256, 256) and (256, 512) in the
    128 bucket, take the 16-CTA cluster route."""
    assert ge.gemm_exact_route(B, M, 128, torch.float64) == 16


@pytest.mark.cuda
def test_gemm_exact_kernel_f64_bond_matches_plain(cuda):
    """On a seeded (256, 256) keep-128 f64 bond the cluster kernel makes
    the plain version's certification decision, its kept projector lies
    within K2_F64_PROJ_BAR of the plain one and its truncation error
    within K2_F64_ERR_BAR; two launches are bitwise equal."""
    cur = torch.tensor(_k2_case("generic", 256, 256, 128, 11),
                       dtype=torch.float64, device=cuda)
    vk, conv_k = _k2_vt(cur, 128, 128, True)
    vp, conv_p = _k2_vt(cur, 128, 128, False)
    assert conv_k == conv_p
    a, b = vk.double(), vp.double()
    P = b.T @ b
    assert float((a.T @ a - P).norm() / P.norm()) <= K2_F64_PROJ_BAR
    ek, ep = _k2_err(cur, vk), _k2_err(cur, vp)
    assert abs(ek - ep) <= K2_F64_ERR_BAR * ep
    first = ge.gemm_exact_kernel(cur, 128, 128)
    second = ge.gemm_exact_kernel(cur, 128, 128)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert dict(zip(ge.FLAGS, first[2].tolist()))["cluster_ctas"] == 16


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
    """tt_round_df on the card (K1c for the column loops of the df
    Cholesky and the substitution, no K1, the seed eigh on K4, bf16 slice
    GEMMs) and on the CPU: both within 1e-11 of the float64 chain at d=7,
    the same ranks, and with eps=1e-7 the 1e-9 tail dropped on both."""
    from xerus_tpu_torch.examples import (bench_round_instance,
                                          cliff_instance, cpu_round_sweep,
                                          host_tt_distance, host_tt_log_norm)
    from xerus_tpu_torch.ops import df_loops as dl
    from xerus_tpu_torch.ops.df_matvec import df_matvec as k1
    from xerus_tpu_torch.ops.df_rounding import tt_round_df_from_f64
    host = [c.astype(np.float64) for c in bench_round_instance(7, 3, 6)]
    cores = cliff_instance(host, 3, 1e-9)
    chain = cpu_round_sweep(cores, 3)
    nrm = np.exp(host_tt_log_norm(chain))
    launches = (k1.launches, dl.df_chol_block_launch.launches,
                dl.df_trsm_rlt_launch.launches)
    card = tt_round_df_from_f64(cores, 3, device=cuda)
    assert k1.launches == launches[0]
    assert dl.df_chol_block_launch.launches > launches[1]
    assert dl.df_trsm_rlt_launch.launches > launches[2]
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


# ---------------------------------------------------------------------------
# K1q and K1c: the df column loops (ops/df_loops.py), each entry against its
# plain version on the card at the paths' shapes: backward errors within
# 2x the plain version's plus four units of the df format's 2^-48
# resolution (a (2, 2) factor's ||Q^T Q - I|| is 1.068e-14 against the
# plain version's 4.699e-15 by summation order alone), the same deficient
# columns, and two launches bitwise equal

DF_LOOP_FLOOR = 2.0 ** -46


def _held(k, p):
    return all(a <= 2.0 * b + DF_LOOP_FLOOR for a, b in zip(k, p))


def _df_pair(x, device):
    return df32.df_from_f64(x, device)


def _joined(pair):
    return df32.df_to_f64(*pair)


def _qr_input(m, r, seed, deficient=False):
    a = np.random.Generator(np.random.PCG64(seed)).normal(size=(m, r))
    if deficient:
        a[:, r // 3] = 2.0 * a[:, 1]
        a[:, r // 2] = 0.0
        a[:, r - 1] = a[:, 0] - 3.0 * a[:, 2]
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("m,r,deficient,route", [
    (60, 30, False, "cta"), (60, 30, True, "cta"), (2, 2, False, "cta"),
    (128, 64, True, "cta"), (512, 256, False, "cluster"),
    (512, 256, True, "cluster"), (500, 250, True, "cluster"),
    (1000, 400, False, "cluster"), (1024, 512, True, "gmem")])
def test_df_qr_kernel_matches_plain(cuda, m, r, deficient, route):
    from xerus_tpu_torch.ops import df_loops as dl
    from xerus_tpu_torch.ops import mixed_precision as mp
    plan = dl.df_qr_plan(m, r)
    assert plan.route == route
    a = _qr_input(m, r, m * 31 + r, deficient)
    ah, al = _df_pair(a, cuda)
    n0 = dl.df_qr_launch.launches
    (qh, ql), (rh, rl) = mp.df_qr(ah, al)
    (qh2, ql2), (rh2, rl2) = mp.df_qr(ah, al)
    torch.cuda.synchronize()
    assert dl.df_qr_launch.launches == n0 + 2
    for x, y in ((qh, qh2), (ql, ql2), (rh, rh2), (rl, rl2)):
        assert torch.equal(x, y)
    (pqh, pql), (prh, prl) = mp.df_qr_reference(ah, al)
    Q, R = _joined((qh, ql)), _joined((rh, rl))
    PQ, PR = _joined((pqh, pql)), _joined((prh, prl))
    k = dl.qr_backward_errors(Q, R, a)
    p = dl.qr_backward_errors(PQ, PR, a)
    assert _held(k, p)
    assert np.array_equal(np.diag(R) == 0.0, np.diag(PR) == 0.0)
    assert np.array_equal(np.triu(R), R)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 37, 64, 128, 200])
def test_df_chol_block_kernel_matches_plain(cuda, B):
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    from xerus_tpu_torch.ops import df_loops as dl
    assert dl.df_chol_block_plan(B).route == ("gmem" if B > 169 else "cta")
    rng = np.random.Generator(np.random.PCG64(B))
    Qm, _ = np.linalg.qr(rng.normal(size=(B, B)))
    A = (Qm * np.logspace(0, -6, B)) @ Qm.T
    big = np.zeros((B + 5, B + 5))
    big[3:3 + B, 2:2 + B] = A
    bh, bl = _df_pair(big, cuda)
    Ah, Al = bh[3:3 + B, 2:2 + B], bl[3:3 + B, 2:2 + B]   # row stride B + 5
    n0 = dl.df_chol_block_launch.launches
    L1 = dc._df_chol_unblocked(Ah, Al)
    L2 = dc._df_chol_unblocked(Ah, Al)
    torch.cuda.synchronize()
    assert dl.df_chol_block_launch.launches == n0 + 2
    assert torch.equal(L1[0], L2[0]) and torch.equal(L1[1], L2[1])
    P = dc._df_chol_unblocked_reference(Ah, Al)
    L, PL = _joined(L1), _joined(P)
    assert np.array_equal(np.tril(L), L)
    assert _held([dl.chol_backward_error(L, A)],
                 [dl.chol_backward_error(PL, A)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,B,route", [(64, 64, "whole"), (192, 64, "whole"),
                                       (1792, 64, "whole"), (13, 5, "whole"),
                                       (512, 256, "tiles"),
                                       (100, 200, "tiles"),
                                       (64, 1536, "gmem")])
def test_df_trsm_rlt_kernel_matches_plain(cuda, m, B, route):
    dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")
    from xerus_tpu_torch.ops import df_loops as dl
    assert dl.df_trsm_plan(m, B).route == route
    rng = np.random.Generator(np.random.PCG64(m * 7 + B))
    L = np.tril(rng.normal(size=(B, B)), -1) * 0.1 + np.diag(
        rng.uniform(0.5, 2.0, size=B))
    big = rng.normal(size=(m, B + 7))
    A = big[:, 4:4 + B]
    bh, bl = _df_pair(big, cuda)
    Ah, Al = bh[:, 4:4 + B], bl[:, 4:4 + B]               # row stride B + 7
    Lh, Ll = _df_pair(L, cuda)
    n0 = dl.df_trsm_rlt_launch.launches
    X1 = dc._df_trsm_rlt(Ah, Al, Lh, Ll)
    X2 = dc._df_trsm_rlt(Ah, Al, Lh, Ll)
    torch.cuda.synchronize()
    assert dl.df_trsm_rlt_launch.launches == n0 + 2
    assert torch.equal(X1[0], X2[0]) and torch.equal(X1[1], X2[1])
    P = dc._df_trsm_rlt_reference(Ah, Al, Lh, Ll)
    Ld = _joined((Lh, Ll))
    assert _held([dl.trsm_backward_error(_joined(X1), Ld, A)],
                 [dl.trsm_backward_error(_joined(P), Ld, A)])


def _loop_case(entry, shape, device):
    """Inputs of ``entry`` at ``shape`` on ``device``: a Gaussian matrix
    with three deficient columns (df_qr), an SPD block of condition 1e6
    (df_chol_block), a Gaussian panel and a lower-triangular factor
    (df_trsm_rlt); the df pairs as the launch functions take them."""
    rng = np.random.Generator(np.random.PCG64(sum(shape)))
    if entry == "df_qr":
        return _df_pair(_qr_input(*shape, sum(shape), True), device)
    B = shape[1]
    if entry == "df_chol_block":
        Qm, _ = np.linalg.qr(rng.normal(size=(B, B)))
        return _df_pair((Qm * np.logspace(0, -6, B)) @ Qm.T, device)
    L = np.tril(rng.normal(size=(B, B)), -1) * 0.1 + np.diag(
        rng.uniform(0.5, 2.0, size=B))
    return (*_df_pair(rng.normal(size=shape), device), *_df_pair(L, device))


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape,route", [
    ("df_qr", (512, 256), "cluster"), ("df_qr", (1000, 400), "cluster"),
    ("df_qr", (256, 256), "cluster"), ("df_chol_block", (64, 64), "cta"),
    ("df_chol_block", (128, 128), "cta"), ("df_trsm_rlt", (512, 256), "tiles"),
    ("df_trsm_rlt", (192, 64), "whole")])
def test_df_loop_gmem_routes_match_the_shared_memory_routes(cuda, entry,
                                                            shape, route):
    """Route gmem computes the same steps in the same orders as the route
    the plan takes at the paths' shapes, with the operands in global
    memory: bitwise the same outputs."""
    from xerus_tpu_torch.ops import df_loops as dl
    plan = {"df_qr": lambda s: dl.df_qr_plan(*s),
            "df_chol_block": lambda s: dl.df_chol_block_plan(s[0]),
            "df_trsm_rlt": lambda s: dl.df_trsm_plan(*s)}[entry](shape)
    assert plan.route == route
    launch = getattr(dl, entry + "_launch")
    args = _loop_case(entry, shape, cuda)
    n0 = launch.launches
    out = launch(*args, plan)
    gmem = launch(*args, dl.gmem_plan(entry, shape))
    torch.cuda.synchronize()
    assert launch.launches == n0 + 2
    flat = (lambda o: [*o[0], *o[1]]) if entry == "df_qr" else list
    for x, y in zip(flat(out), flat(gmem)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("case,route", [
    ("qr_60x30", "cta"), ("qr_1000x30", "cluster"), ("qr_1000x30", "gmem"),
    ("chol_64", "cta"), ("chol_64", "gmem"), ("trsm_192x64", "whole"),
    ("trsm_192x64", "gmem")])
def test_df_loop_kernels_match_the_jax_package(cuda, case, route):
    """K1q and K1c against the JAX package's df_qr, _df_chol_unblocked and
    _df_trsm_rlt on the same inputs (their CPU outputs stored in
    tests/data/df_loops_jax.npz by tests/df_loops_jax.py): the same
    deficient columns, Q within 1e-13, R, L and X within 1e-13 relative."""
    import df_loops_jax
    from xerus_tpu_torch.ops import df_loops as dl
    x, jax_out = df_loops_jax.inputs(), df_loops_jax.load()
    if case.startswith("qr"):
        m, r = x[case].shape
        plan = (dl.gmem_plan("df_qr", (m, r)) if route == "gmem"
                else dl.df_qr_plan(m, r))
        assert plan.route == route
        q, rr = dl.df_qr_launch(*_df_pair(x[case], cuda), plan)
        Q, R = _joined(q), _joined(rr)
        JR = jax_out[case + "_R"]
        assert np.abs(Q - jax_out[case + "_Q"]).max() <= 1e-13
        assert np.array_equal(np.diag(R) == 0.0, np.diag(JR) == 0.0)
        assert (np.diag(JR) == 0.0).sum() == 3
        assert np.abs(R - JR).max() <= 1e-13 * np.abs(JR).max()
    elif case == "chol_64":
        plan = (dl.gmem_plan("df_chol_block", (64, 64)) if route == "gmem"
                else dl.df_chol_block_plan(64))
        assert plan.route == route
        L = _joined(dl.df_chol_block_launch(*_df_pair(x[case], cuda), plan))
        JL = jax_out["chol_64_L"]
        assert np.linalg.norm(L - JL) / np.linalg.norm(JL) <= 1e-13
    else:
        plan = (dl.gmem_plan("df_trsm_rlt", (192, 64)) if route == "gmem"
                else dl.df_trsm_plan(192, 64))
        assert plan.route == route
        X = _joined(dl.df_trsm_rlt_launch(
            *_df_pair(x[case], cuda), *_df_pair(x["trsm_L_64"], cuda), plan))
        JX = jax_out["trsm_192x64_X"]
        assert np.linalg.norm(X - JX) / np.linalg.norm(JX) <= 1e-13


@pytest.mark.cuda
def test_df_qr_kernel_stats_give_the_deficiency_threshold(cuda):
    from xerus_tpu_torch.ops import df_loops as dl
    a = _qr_input(60, 30, 9, deficient=True)
    ah, al = _df_pair(a, cuda)
    stats = torch.zeros((30, 2), device=cuda)
    (_q, (rh, _rl)) = dl.df_qr_launch(ah, al, dl.df_qr_plan(60, 30), stats)
    s = stats.cpu().numpy()
    diag = rh.diagonal().cpu().numpy()
    assert np.array_equal(s[:, 0] <= s[:, 1], diag == 0.0)
    assert (diag == 0.0).sum() == 3
