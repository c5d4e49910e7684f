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
# slice's (d=10, n=4, r=8, M=20,000), the ragged case of
# tests/test_pallas_kernels.py, a short tail, no measurement, rank 160
K3_SHAPES = [([4] * 10, [4] + [8] * 7 + [4], 20000),
             ([2, 5, 3, 4], [2, 4, 3], 17), ([3] * 4, [2] * 3, 13),
             ([3] * 4, [2] * 3, 0), ([2] * 3, [160, 160], 50)]


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
    the cores' dtype: max |kernel - plain| <= rtol * max |plain|."""
    cores, pos = _k3_case(dims, ranks, M, dtype, cuda)
    launches0 = te.tt_eval_at_points.launches
    kern = te.tt_eval_at_points(cores, pos)
    torch.cuda.synchronize()
    assert te.tt_eval_at_points.launches == launches0 + 1
    plain = te.tt_eval_at_points_reference(cores, pos)
    assert kern.shape == (M,) and kern.dtype == dtype
    if M:
        scale = float(plain.abs().max())
        assert float((kern - plain).abs().max()) <= rtol * scale


@pytest.mark.cuda
def test_tt_eval_kernel_takes_cores_of_any_layout(cuda):
    """The wrapper copies the cores into one padded stack, so transposed
    views (a QR's column-major Q) evaluate like contiguous cores."""
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
    bad = pos.clone()
    bad[5, 2] = 3
    with pytest.raises(ValueError, match="outside the mode sizes"):
        te.tt_eval_at_points(cores, bad)
    bad[5, 2] = -1
    with pytest.raises(ValueError, match="outside the mode sizes"):
        te.tt_eval_at_points(cores, bad)
