"""K4 and K5 (csrc/jacobi.cu) against their plain versions on the card,
and a captured Lanczos half-sweep on them.

Imports no jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_small_eig_cuda.py

Without a card every case skips (the kernels have no CPU mode).  Kernel
and plain version sum in different orders, so they are held to each other
through gauge-free quantities within 1e-12 of the matrix's scale (values,
reconstructions) and each to orthonormality within 1e-12; two cluster
sizes of one route, route gmem and route cluster at one plan, and two
launches, are bitwise equal; past a cluster's shared memory (route gmem)
they are held to torch.linalg within 1e-12 n / 128; K5 takes at most 12
sweeps on graded blocks."""

import numpy as np
import pytest
import torch

from xerus_tpu_torch.ops import dmrg_kernels as dk
from xerus_tpu_torch.ops import programs
from xerus_tpu_torch.ops import round_kernels as rk
from xerus_tpu_torch.ops import small_eig as se

TOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _sym(B, m, seed):
    A = np.random.default_rng(seed).standard_normal((B, m, m))
    return A + A.transpose(0, 2, 1)


def _orth(Q):
    K = Q.shape[-1]
    return float((Q.transpose(-1, -2) @ Q
                  - torch.eye(K, dtype=Q.dtype, device=Q.device))
                 .abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,m", [(1, 24), (4, 24), (1, 3), (4, 3),
                                 (2, 32), (5, 7), (2, 48), (1, 96),
                                 (1, 128), (1, 256)])
def test_small_eigh_kernel_matches_plain(cuda, B, m):
    A = torch.from_numpy(_sym(B, m, 1000 + m)).to(cuda)
    launches = se.small_eigh_launch.launches
    w, V, status = se.small_eigh(A)
    torch.cuda.synchronize()
    assert se.small_eigh_launch.launches == launches + 1
    wp, Vp, sp = se.small_eigh_plain(A)
    assert bool((status > 0).all()) and bool((sp > 0).all())
    scale = float(A.abs().max())
    assert float((w - wp).abs().max()) <= TOL * scale
    rec = V @ torch.diag_embed(w) @ V.transpose(1, 2)
    assert float((rec - A).abs().max()) <= TOL * scale
    assert _orth(V) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N", [(1, 32, 32), (4, 32, 32), (1, 64, 64),
                                   (1, 128, 128), (1, 60, 60),
                                   (1, 256, 256), (2, 20, 12), (2, 12, 20),
                                   (1, 34, 34), (1, 100, 100)])
def test_small_svd_kernel_matches_plain(cuda, B, M, N):
    A = torch.from_numpy(np.random.default_rng(M * 7 + N).standard_normal(
        (B, M, N))).to(cuda)
    launches = se.small_svd_launch.launches
    U, S, Vh, status = se.small_svd(A)
    torch.cuda.synchronize()
    assert se.small_svd_launch.launches == launches + 1
    Up, Sp, Vhp, sp = se.small_svd_plain(A)
    assert bool((status > 0).all()) and bool((sp > 0).all())
    scale = float(Sp.max())
    assert float((S - Sp).abs().max()) <= TOL * scale
    rec = U @ torch.diag_embed(S) @ Vh
    assert float((rec - A).norm() / A.norm()) <= TOL
    assert _orth(U) <= TOL and _orth(Vh.transpose(1, 2)) <= TOL


@pytest.mark.cuda
def test_rank_deficient_split_gets_an_orthonormal_u(cuda):
    r, n = 16, 2
    G = np.zeros((2, r, n, n, r))
    G[:, :2, :, :, :3] = np.random.default_rng(5).standard_normal(
        (2, 2, n, n, 3))
    A = torch.from_numpy(G.reshape(2, r * n, n * r)).to(cuda)
    U, S, Vh, status = se.small_svd(A)
    assert bool((status > 0).all())
    assert bool((S[:, 4:] == 0).all()) and bool((S[:, :4] > 0).all())
    assert _orth(U) <= TOL
    assert float((U @ torch.diag_embed(S) @ Vh - A).norm() / A.norm()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,sizes", [("eigh", 64, (1, 2)),
                                          ("eigh", 256, (8, 16)),
                                          ("svd", 64, (2, 4)),
                                          ("svd", 128, (4, 8))])
def test_cluster_sizes_are_bitwise_equal(cuda, kind, n, sizes):
    """Every element's arithmetic is the same whichever CTA does it: two
    cluster sizes of a route give the same bits."""
    if kind == "eigh":
        A = torch.from_numpy(_sym(2, n, 7)).to(cuda)
        a, b = (se.small_eigh_launch(A, se.eigh_plan(n, se.CLUSTER, c))
                for c in sizes)
    else:
        A = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (2, n, n))).to(cuda)
        a, b = (se.small_svd_launch(A, se.svd_plan(n, n, c)) for c in sizes)
    assert bool((a[-1] > 0).all())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,ctas", [("eigh", 24, 1), ("eigh", 32, 2),
                                         ("eigh", 256, 16), ("svd", 32, 1),
                                         ("svd", 64, 2), ("svd", 128, 16)])
def test_route_gmem_is_bitwise_route_smem(cuda, kind, n, ctas):
    """Route gmem runs the cluster route's steps in the same orders with
    the columns in global memory instead of the CTAs' shared memory: the
    same bits at the same plan."""
    if kind == "eigh":
        A = torch.from_numpy(_sym(2, n, 7)).to(cuda)
        a, b = (se.small_eigh_launch(A, se.eigh_plan(n, r, ctas))
                for r in (se.CLUSTER, se.GMEM))
    else:
        A = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (2, n, n))).to(cuda)
        a, b = (se.small_svd_launch(A, se.svd_plan(n, n, ctas, r))
                for r in (se.CLUSTER, se.GMEM))
    assert bool((a[-1] > 0).all())
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [("eigh", (1, 512, 512)),
                                        ("svd", (1, 384, 384)),
                                        ("svd", (1, 520, 1040))])
def test_past_shared_memory_matches_torch_linalg(cuda, kind, shape):
    """Where the columns do not fit a cluster's shared memory the plans
    take route gmem (K5 at 520 columns with 17 warps a CTA), held to
    torch.linalg through values, orthogonality and the reconstruction."""
    n = min(shape[1:])
    tol = TOL * n / 128
    rng = np.random.default_rng(n)
    if kind == "eigh":
        A = torch.from_numpy(_sym(1, n, n)).to(cuda)
        assert se.eigh_plan(n).route == se.GMEM
        w, V, status = se.small_eigh(A)
        ref = torch.linalg.eigvalsh(A)
        rec, factors = V @ torch.diag_embed(w) @ V.transpose(1, 2), [V]
        vals = w
    else:
        A = torch.from_numpy(rng.standard_normal(shape)).to(cuda)
        assert se.svd_plan(*shape[1:]).route == se.GMEM
        U, S, Vh, status = se.small_svd(A)
        ref = torch.linalg.svdvals(A)
        rec, factors = U @ torch.diag_embed(S) @ Vh, [U, Vh.transpose(1, 2)]
        vals = S
    se.check_health(cuda)
    assert bool((status > 0).all())
    assert float((vals - ref).abs().max()) <= tol * float(ref.abs().max())
    assert float((rec - A).norm() / A.norm()) <= tol
    assert all(_orth(Q) <= tol for Q in factors)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("eigh", 24), ("eigh", 256),
                                    ("svd", 32), ("svd", 128)])
def test_two_launches_are_bitwise_equal(cuda, kind, n):
    if kind == "eigh":
        A = torch.from_numpy(_sym(1, n, 12)).to(cuda)
        a, b = se.small_eigh(A), se.small_eigh(A)
    else:
        A = torch.from_numpy(np.random.default_rng(13).standard_normal(
            (1, n, n))).to(cuda)
        a, b = se.small_svd(A), se.small_svd(A)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _graded(n, seed):
    """sigma = logspace(0, -11, n) under seeded orthogonal factors: the
    grading of the DMRG splits."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((n, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (U * np.logspace(0, -11, n)) @ V.T


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 128])
def test_graded_split_takes_at_most_12_sweeps(cuda, n):
    A = torch.from_numpy(_graded(n, 21 + n)[None]).to(cuda)
    U, S, Vh, status = se.small_svd(A)
    assert 0 < int(status[0]) <= 12
    ref = np.linalg.svd(A[0].cpu().numpy(), compute_uv=False)
    assert float(np.abs(S[0].cpu().numpy() - ref).max()) <= TOL
    assert float((U @ torch.diag_embed(S) @ Vh - A).norm() / A.norm()) <= TOL
    assert _orth(U) <= TOL and _orth(Vh.transpose(1, 2)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["shared memory short", "threads"])
def test_a_plan_the_kernel_cannot_run_raises(cuda, kind):
    """No fallback: a launch the kernel refuses raises."""
    A = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 32, 32))).to(cuda)
    plan = se.svd_plan(32, 32)
    plan = (plan._replace(smem=plan.smem - 8) if kind != "threads"
            else plan._replace(threads=plan.threads // 2))
    launches = se.small_svd_launch.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        se.small_svd_launch(A, plan)
    assert se.small_svd_launch.launches == launches


@pytest.mark.cuda
def test_nonfinite_input_fails_the_health_check(cuda):
    se.check_health(cuda)
    A = torch.from_numpy(_sym(2, 5, 9)).to(cuda)
    A[1, 3, 2] = float("nan")
    status = se.small_eigh(A)[2]
    assert int(status[1]) <= 0 < int(status[0])
    with pytest.raises(RuntimeError, match="did not converge"):
        se.check_health(cuda)


def _heisenberg_stacks(d, r, dev):
    import xerus_tpu_torch as xt
    with xt.host():
        xt.set_seed(11)
        H = xt.examples.heisenberg_mpo(d)
        x = xt.TTTensor.random([2] * d, r)
        x.move_core(0)
        x /= x.frob_norm()
        xs, _ = dk.pad_cores([c._torch() for c in x.components])
        A = dk._pad_operator_stack([c._torch() for c in H.components])
    return xs.to(dev).contiguous(), A.to(dev).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_captured_lanczos_half_sweep_replays_the_eager_run(cuda, batch):
    """make_dmrg_step captures (under sync debug "error": no host read in
    the region), and a replay is bitwise its eager function's run on the
    same input, K4 and K5 counted through the replay."""
    xs, A = _heisenberg_stacks(10, 8, cuda)
    if batch > 1:
        xs = xs.expand(batch, *xs.shape).contiguous()
    shift = torch.zeros((), dtype=xs.dtype, device=cuda)
    args = (xs, A, shift)
    prog = dk.make_dmrg_step(programs.shapes_key(*args), "float64", 8,
                             "lanczos", 24, False)
    for _ in range(programs.EAGER_CALLS + 1):
        prog(*args)
    assert prog.graph is not None
    reads, checks = rk.host_bool.reads, dk.linalg_host_checks()
    k4, k5 = se.small_eigh_launch.launches, se.small_svd_launch.launches
    got = prog(*args)
    torch.cuda.synchronize()
    assert prog.replays >= 1
    assert rk.host_bool.reads == reads and dk.linalg_host_checks() == checks
    assert se.small_eigh_launch.launches - k4 == 9
    assert se.small_svd_launch.launches - k5 == 9
    want = prog.fn(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    se.check_health(cuda)


@pytest.mark.cuda
def test_batched_half_sweep_raises_on_a_failed_matrix(cuda):
    """dmrg_half_sweep_batched reads the health record: a non-finite
    instance fails K4/K5 and the call raises, and the record is clean
    afterwards."""
    se.check_health(cuda)
    xs, A = _heisenberg_stacks(10, 8, cuda)
    xs = xs.expand(2, *xs.shape).contiguous()
    xs[1, 3] = float("nan")
    with pytest.raises(RuntimeError, match="did not converge"):
        dk.dmrg_half_sweep_batched(xs, A, 8)
    assert se.check_health(cuda)["failures"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [None, 0.0])
def test_scan_with_the_dense_eigh_runs_every_half_sweep(cuda, shift):
    """dmrg_groundstate_scan(solver="eigh") on the card runs eagerly past
    the third half-sweep at one shape key (cuSOLVER's eigh reads its info
    to the host, so no program captures it) and reaches the exact ground
    energy of the d=6 chain at its full ranks."""
    import xerus_tpu_torch as xt
    d, sweeps = 6, 4
    xt.set_seed(7)
    H = xt.examples.heisenberg_mpo(d)
    x = xt.TTTensor.random([2] * d, 8)
    assert x.components[0]._torch().is_cuda
    reads, checks = rk.host_bool.reads, dk.linalg_host_checks()
    e = dk.dmrg_groundstate_scan(H, x, num_half_sweeps=sweeps, conv_eps=0.0,
                                 solver="eigh", shift=shift)
    assert rk.host_bool.reads - reads == sweeps + (2 if shift is None else 0)
    assert dk.linalg_host_checks() > checks
    Hd = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    assert abs(e - np.linalg.eigvalsh((Hd + Hd.T) / 2)[0]) <= 1e-10
