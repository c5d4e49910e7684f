"""K4 and K5's plain versions (xerus_tpu_torch.ops.small_eig: Jacobi
eigh and QR-preconditioned Jacobi SVD in float64, the kernels' steps in
torch) held against LAPACK and jnp.linalg on the CPU, the kernels' pair
order, slot ring and plans, and the Lanczos half-sweep run on the plain
versions against its LAPACK route.

Eigenvectors and singular vectors are compared only through gauge-free
quantities: eigenvalues and singular values against numpy's LAPACK within
1e-13 of the largest, reconstructions ||V diag(w) V^T - A|| and
||U S Vh - A|| within 1e-13 of ||A||, ||V^T V - I|| within 1e-13 (float32
inputs: 1e-5, after the cast back).  The half-sweep's energy agrees with
the LAPACK route's within 1e-10 and its represented state up to a global
sign within 1e-8.  The graded splits and the penalized Ritz matrix are
also held to jnp.linalg here; every case against it is in the slow tier."""

import numpy as np
import pytest
import torch

import xerus_tpu_torch as xt
from xerus_tpu_torch.ops import dmrg_kernels as td
from xerus_tpu_torch.ops import small_eig as se

SEED = 0xBAADF00D
TOL = 1e-13
TOL_F32 = 1e-5


def _sym(rng, B, m):
    A = rng.standard_normal((B, m, m))
    return A + A.transpose(0, 2, 1)


def _ritz(rng, m=24, valid=10):
    """A Lanczos Ritz matrix as ``_ritz_smallest`` makes it: a tridiagonal
    block of ``valid`` rows, the rest lifted by 1e4 (max|T| + 1)."""
    T = np.zeros((1, m, m))
    a, b = rng.standard_normal(valid), rng.random(valid - 1)
    T[0, :valid, :valid] = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    big = 1e4 * (np.abs(T).max() + 1.0)
    T[0] += np.diag([0.0] * valid + [big] * (m - valid))
    return T


def _repeated(rng, m=24):
    """A symmetric matrix with a four-fold and a two-fold eigenvalue."""
    Q = np.linalg.qr(rng.standard_normal((m, m)))[0]
    w = rng.standard_normal(m)
    w[:4] = 1.5
    w[10:12] = -0.25
    return (Q @ np.diag(w) @ Q.T)[None]


def _deficient(rng, B=2, r=8, n=2, rank=3):
    """A (r n, n r) two-site block whose left bond has true rank 2 and
    right bond ``rank``, so its rank is min(2 n, n rank); the padded rows
    and columns are exact zeros, as a boundary split meets them."""
    G = np.zeros((B, r, n, n, r))
    G[:, :2, :, :, :rank] = rng.standard_normal((B, 2, n, n, rank))
    return G.reshape(B, r * n, n * r)


def _eigh_cases():
    rng = np.random.default_rng(SEED)
    return {"m=3": _sym(rng, 4, 3), "m=24": _sym(rng, 4, 24),
            "m=32": _sym(rng, 2, 32), "penalized Ritz": _ritz(rng),
            "repeated": _repeated(rng), "m=1": _sym(rng, 3, 1),
            "diagonal": np.diag(rng.standard_normal(6))[None],
            "m=48, route cluster": _sym(rng, 2, 48)}


def _svd_cases():
    rng = np.random.default_rng(SEED + 1)
    return {"32x32": rng.standard_normal((2, 32, 32)),
            "rank-deficient block": _deficient(rng),
            "5x3": rng.standard_normal((3, 5, 3)),
            "3x5": rng.standard_normal((3, 3, 5)),
            "zero": np.zeros((1, 6, 6)),
            "64x64": rng.standard_normal((1, 64, 64)),
            "48x40": rng.standard_normal((1, 48, 40)),
            "34x34, padded to 36 on 2 CTAs": rng.standard_normal((1, 34, 34))}


def _eigh_errors(A, w, V):
    A, w, V = (np.asarray(t, dtype=np.float64) for t in (A, w, V))
    m = A.shape[-1]
    rec = np.einsum("bik,bk,bjk->bij", V, w, V)
    return (np.abs(rec - A).max() / max(np.abs(A).max(), 1e-300),
            np.abs(np.einsum("bki,bkj->bij", V, V) - np.eye(m)).max())


@pytest.mark.parametrize("name", list(_eigh_cases()))
def test_small_eigh_plain_matches_lapack(name):
    A = _eigh_cases()[name]
    w, V, status = se.small_eigh_plain(torch.from_numpy(A))
    assert bool((status > 0).all()) and int(status.max()) <= se.CAP
    ref = np.linalg.eigvalsh(A)
    scale = np.abs(ref).max()
    assert np.abs(w.numpy() - ref).max() <= TOL * scale
    assert np.all(np.diff(w.numpy(), axis=1) >= 0)
    rec, orth = _eigh_errors(A, w, V)
    assert rec <= TOL and orth <= TOL


def test_small_eigh_plain_resolves_the_small_block_of_a_ritz_matrix():
    """The relative off-diagonal test: the valid block's lowest eigenpair
    is resolved to its own scale, not to the 1e4 (max|T| + 1) lift's."""
    T = _ritz(np.random.default_rng(SEED + 2))
    w, V, _ = se.small_eigh_plain(torch.from_numpy(T))
    blk = T[0, :10, :10]
    ref_w, ref_v = np.linalg.eigh(blk)
    assert abs(float(w[0, 0]) - ref_w[0]) <= TOL * np.abs(blk).max()
    v = V[0, :, 0].numpy()
    assert np.abs(v[10:]).max() == 0.0
    assert 1.0 - abs(float(v[:10] @ ref_v[:, 0])) <= 1e-13


def test_small_eigh_plain_reads_the_lower_triangle():
    rng = np.random.default_rng(SEED + 3)
    A = _sym(rng, 2, 7)
    junk = A + np.triu(rng.standard_normal((7, 7)), 1)
    w, V, _ = se.small_eigh_plain(torch.from_numpy(junk))
    w0, V0, _ = se.small_eigh_plain(torch.from_numpy(A))
    assert torch.equal(w, w0) and torch.equal(V, V0)


def _svd_check(A, U, S, Vh, tol):
    A, U, S, Vh = (np.asarray(t, dtype=np.float64) for t in (A, U, S, Vh))
    K = S.shape[-1]
    ref = np.linalg.svd(A, compute_uv=False)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(S - ref).max() <= tol * scale
    assert np.all(np.diff(S, axis=1) <= 0) and np.all(S >= 0)
    rec = np.einsum("bik,bk,bkj->bij", U, S, Vh)
    assert np.linalg.norm(rec - A) <= tol * max(np.linalg.norm(A), 1e-300)
    assert np.abs(np.einsum("bki,bkj->bij", U, U) - np.eye(K)).max() <= tol
    assert np.abs(np.einsum("bik,bjk->bij", Vh, Vh) - np.eye(K)).max() <= tol


@pytest.mark.parametrize("name", list(_svd_cases()))
def test_small_svd_plain_matches_lapack(name):
    A = _svd_cases()[name]
    U, S, Vh, status = se.small_svd_plain(torch.from_numpy(A))
    B, M, N = A.shape
    K = min(M, N)
    assert U.shape == (B, M, K) and S.shape == (B, K) and Vh.shape == (B, K, N)
    assert bool((status > 0).all())
    _svd_check(A, U, S, Vh, TOL)


def test_small_svd_plain_completes_u_where_sigma_is_zero():
    """The rank-4 block: sigma 5.. are exactly zero; U = Q V_J is
    orthonormal by construction (the shift projector needs orthonormal
    padded frames), not zero columns, and Vh's rows there are the
    orthonormal completion."""
    A = _deficient(np.random.default_rng(SEED + 4))
    U, S, Vh, _ = se.small_svd_plain(torch.from_numpy(A))
    assert torch.all(S[:, 4:] == 0) and torch.all(S[:, :4] > 0)
    K = S.shape[1]
    eye = torch.eye(K, dtype=U.dtype)
    assert float((U.transpose(1, 2) @ U - eye).abs().max()) <= TOL
    assert float((Vh @ Vh.transpose(1, 2) - eye).abs().max()) <= TOL
    assert float(U[:, :, 4:].norm(dim=1).min()) > 1.0 - TOL


def _graded(n, seed):
    """sigma = logspace(0, -11, n) under seeded orthogonal factors: the
    grading of the DMRG splits, where one-sided Jacobi alone took up to 27
    sweeps."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((n, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return ((U * np.logspace(0, -11, n)) @ V.T)[None]


@pytest.mark.parametrize("n", [32, 48])
def test_small_svd_plain_takes_at_most_12_sweeps_on_a_graded_split(n):
    """The pivoted QR first: at most 12 sweeps (6-8 measured), sigma
    within 1e-13 of the largest against LAPACK and jnp.linalg.svd."""
    import jax.numpy as jnp
    A = _graded(n, SEED + n)
    U, S, Vh, status = se.small_svd_plain(torch.from_numpy(A))
    assert 0 < int(status[0]) <= 12
    _svd_check(A, U, S, Vh, TOL)
    ref = np.asarray(jnp.linalg.svd(jnp.asarray(A), compute_uv=False))
    assert np.abs(S.numpy() - ref).max() <= TOL * ref.max()
    # without the QR, the same Jacobi takes far more sweeps here
    X = torch.from_numpy(A).clone()
    assert int(se.small_svd_plain(X)[3][0]) < _one_sided_sweeps(X[0])


def _one_sided_sweeps(W):
    """Sweeps of PR 15's K5 (one-sided Jacobi on W's columns with the same
    tests and rotation, no QR) on the (R, C) W."""
    W = W.clone()
    R, C = W.shape
    tol = se.svd_tol(R, C)
    dead2 = (tol * float(W.norm())) ** 2
    rounds = [(torch.tensor(P), torch.tensor(Q))
              for P, Q in se.round_robin(C) if P]
    for sweep in range(se.CAP):
        rotated = False
        for P, Q in rounds:
            x, y = W[:, P], W[:, Q]
            al, be, ga = (x * x).sum(0), (y * y).sum(0), (x * y).sum(0)
            rot = (al > dead2) & (be > dead2) & (ga != 0) \
                & se._off_diagonal(al, be, ga, tol)
            c, s, _ = se._rotation(al, be, ga)
            c, s = torch.where(rot, c, 1.0), torch.where(rot, s, 0.0)
            W[:, P], W[:, Q] = c * x - s * y, s * x + c * y
            rotated |= bool(rot.any())
        if not rotated:
            return sweep + 1
    return se.CAP + 1


def test_penalized_ritz_matrix_matches_jax_linalg():
    import jax.numpy as jnp
    T = _ritz(np.random.default_rng(SEED + 7))
    w, V, status = se.small_eigh_plain(torch.from_numpy(T))
    ref = np.asarray(jnp.linalg.eigh(jnp.asarray(T))[0])
    assert int(status[0]) > 0
    assert np.abs(w.numpy() - ref).max() <= TOL * np.abs(ref).max()
    blk = T[0, :10, :10]
    assert abs(float(w[0, 0]) - np.linalg.eigvalsh(blk)[0]) <= \
        TOL * np.abs(blk).max()


@pytest.mark.parametrize("scale", [1.0, 1e200, 1e-200])
def test_rotation_annihilates_at_any_scale(scale):
    """The kernels' half-angle rotation: c^2 + s^2 = 1 and J^T [[a, g],
    [g, b]] J diagonal to rounding, t = s / c as tau's formula gives it,
    with (d, 2g) scaled by a power of two past 1e150 or below 1e-150."""
    rng = np.random.default_rng(SEED + 8)
    a, b, g = (torch.from_numpy(rng.standard_normal(64) * scale)
               for _ in range(3))
    c, s, t = se._rotation(a, b, g)
    assert float((c * c + s * s - 1).abs().max()) <= 4 * se.EPS
    off = (c * c - s * s) * g + c * s * (a - b)
    assert float((off.abs() / (a.abs() + b.abs() + g.abs())).max()) <= \
        8 * se.EPS
    tau = (b - a) / (2 * g)
    ref = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
    assert float(((t - ref) / ref).abs().max()) <= 8 * se.EPS


@pytest.mark.parametrize("kind", ["eigh", "svd"])
def test_float32_inputs_are_solved_in_float64(kind):
    rng = np.random.default_rng(SEED + 5)
    if kind == "eigh":
        A = _sym(rng, 3, 24).astype(np.float32)
        w, V, status = se.small_eigh_plain(torch.from_numpy(A))
        assert w.dtype == V.dtype == torch.float32
        ref = np.linalg.eigvalsh(A.astype(np.float64))
        assert np.abs(w.numpy() - ref).max() <= TOL_F32 * np.abs(ref).max()
        rec, orth = _eigh_errors(A, w, V)
        assert rec <= TOL_F32 and orth <= TOL_F32
    else:
        A = rng.standard_normal((2, 32, 32)).astype(np.float32)
        U, S, Vh, status = se.small_svd_plain(torch.from_numpy(A))
        assert U.dtype == S.dtype == Vh.dtype == torch.float32
        _svd_check(A.astype(np.float64), U, S, Vh, TOL_F32)
    assert bool((status > 0).all())


@pytest.mark.parametrize("n,mm", [(1, 0), (2, 0), (3, 0), (24, 0), (31, 0),
                                  (3, 4), (5, 32), (48, 64), (31, 32)])
def test_round_robin_meets_every_pair_once_a_sweep(n, mm):
    rounds = se.round_robin(n, mm)
    assert len(rounds) == (mm or n + (n & 1)) - 1
    seen = [pq for P, Q in rounds for pq in zip(P, Q)]
    assert sorted(seen) == [(p, q) for p in range(n)
                            for q in range(p + 1, n)]
    for P, Q in rounds:
        assert len(set(P) | set(Q)) == 2 * len(P)   # disjoint


@pytest.mark.parametrize("mm", [2, 4, 24, 32, 64, 256])
def test_slot_ring_is_the_round_robin_and_moves_two_columns_a_cta(mm):
    """The kernels' slot ring: slots 2 i, 2 i + 1 hold round k's pair i,
    a column moving into slot s held slot ring_source(s)'s index, and
    split into CTAs of consecutive slots a CTA takes in (and hands out) at
    most two columns a round, one from each neighbour: the kernels' two
    spare buffers."""
    for k, (P, Q) in enumerate(se.round_robin(mm)):
        pairs = [se.ring_pair(mm, k, i) for i in range(mm // 2)]
        assert sorted(tuple(sorted(p)) for p in pairs) == sorted(zip(P, Q))
        for s in range(mm):
            assert se.ring_index(mm, k + 1, s) == \
                se.ring_index(mm, k, se.ring_source(mm, s))
    assert sorted(se.ring_source(mm, s) for s in range(mm)) == list(range(mm))
    for ctas in (1, 2, 4, 8, 16):
        if (mm // 2) % ctas:
            continue
        cpc = mm // ctas
        for c in range(ctas):
            srcs = [se.ring_source(mm, c * cpc + sl) // cpc
                    for sl in range(cpc)]
            incoming = [x for x in srcs if x != c]
            assert len(incoming) <= 2 and len(set(incoming)) == len(incoming)


def test_plans_choose_the_route_by_shared_memory():
    """K4: route cta (one CTA of 4 warps, the round-robin over 4, 8, 16,
    24 or 32 indices) up to m = 32, a cluster past it; K5: a cluster of
    CTAs with at most 16 pairs each, one CTA up to 32 columns, 16 CTAs
    from 128, the pairs padded to a whole number a CTA; route gmem for
    both where the columns do not fit.  Every plan fits a CTA's shared
    memory; one that cannot run raises."""
    assert se.eigh_plan(24) == se.JacobiPlan(se.CTA, 24, 1, 128,
                                             8 * (24 * 25 + 72))
    assert se.eigh_plan(3).mm == 4 and se.eigh_plan(3).threads == 64
    assert se.eigh_plan(33).route == se.CLUSTER and se.eigh_plan(33).mm == 64
    big = se.eigh_plan(256)
    assert (big.route, big.mm, big.ctas, big.threads) == (se.CLUSTER, 256,
                                                          16, 256)
    assert [se.eigh_plan(m).ctas for m in (96, 160, 224)] == [4, 8, 8]
    assert [se.svd_plan(n, n).ctas for n in (32, 60, 64, 128, 256)] == \
        [1, 2, 2, 16, 16]
    assert [se.svd_plan(n, n).mm for n in (34, 100, 130)] == [36, 104, 160]
    assert se.svd_plan(12, 20) == se.svd_plan(20, 12)
    assert se.svd_plan(32, 32).threads == 512
    assert se.svd_plan(60, 60, 4).mm == 64                # 30 pairs padded
    assert (se.eigh_plan(512).route, se.svd_plan(384, 384).route) == \
        (se.GMEM, se.GMEM)
    assert se.svd_plan(128, 128, 2).route == se.GMEM     # 32 pairs a CTA
    for plan in (big, se.svd_plan(256, 256), se.svd_plan(256, 256, 8),
                 se.eigh_plan(256, se.CLUSTER, 8), se.svd_plan(60, 60)):
        assert plan.smem <= se.SMEM_MAX
    for bad in (lambda: se.svd_plan(128, 128, 2, se.CLUSTER),
                lambda: se.svd_plan(60, 60, 3),
                lambda: se.eigh_plan(48, se.CTA),
                lambda: se.eigh_plan(64, se.CLUSTER, 32),
                lambda: se.eigh_plan(2048, se.CLUSTER)):  # shared memory
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("kind", ["eigh", "svd"])
def test_every_size_up_to_the_limit_has_a_plan(kind):
    """Every K4 size up to m = 8,000 and every K5 size up to 1,024
    columns (square, and with four times the rows) has a plan the kernels
    can run: ``mm`` covers the size and splits into whole pairs a CTA, a
    warp per pair (K5), shared memory fits a CTA, and route gmem is taken
    exactly where route cluster's columns do not fit.  One size past the
    limit raises."""
    if kind == "eigh":
        for m in range(1, 8001):
            p = se.eigh_plan(m)
            assert p.mm >= m and (p.mm // 2) % p.ctas == 0
            assert p.smem <= se.SMEM_MAX
            assert (p.route == se.CTA) == (m <= 32)
            if m > 32:
                fits = se._eigh_cluster_bytes(m, p.mm, p.ctas, False) \
                    <= se.SMEM_MAX
                assert (p.route == se.GMEM) == (not fits)
        with pytest.raises(ValueError):
            se.eigh_plan(8001)
        return
    for C in range(1, 1025):
        for R in (C, 4 * C):
            p = se.svd_plan(R, C)
            assert p.mm >= C and p.mm % (2 * p.ctas) == 0
            assert p.threads == 32 * p.mm // (2 * p.ctas)
            assert p.threads <= (1024 if p.route == se.GMEM else 512)
            assert p.smem <= se.SMEM_MAX
            fits = p.threads <= 512 and \
                se._svd_bytes(R, C, p.mm, p.ctas, False) <= se.SMEM_MAX
            assert (p.route == se.GMEM) == (not fits)
    for R in (1025, 4100):
        with pytest.raises(ValueError):
            se.svd_plan(R, 1025)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions; a non-finite
    matrix gets a failed status (<= 0) and leaves the others alone."""
    rng = np.random.default_rng(SEED + 6)
    A = torch.from_numpy(_sym(rng, 2, 5))
    for got, want in zip(se.small_eigh(A), se.small_eigh_plain(A)):
        assert torch.equal(got, want)
    bad = A.clone()
    bad[1, 3, 2] = float("nan")          # lower triangle: eigh reads it
    for status in (se.small_eigh(bad)[2], se.small_svd(bad)[3]):
        assert int(status[1]) <= 0 < int(status[0])
    assert se.check_health("cpu") == {}         # no kernel ran here


def _state(stack):
    v = stack[0][:1]
    for k in range(1, stack.shape[0]):
        v = np.einsum("...a,anb->...nb", v, stack[k])
    v = v[..., 0].reshape(-1)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_half_sweep_on_the_plain_versions_matches_lapack(solver,
                                                         monkeypatch):
    """A d=6, r=4 half-sweep of the Heisenberg chain with the Ritz eigh and
    the split SVD on K4/K5's plain versions against the LAPACK route:
    energy within 1e-10, the represented state up to sign within 1e-8."""
    d, r, n = 6, 4, 2
    with xt.host():
        xt.set_seed(SEED)
        H = xt.examples.heisenberg_mpo(d)
        x = xt.TTTensor.random([n] * d, r)
        x.move_core(0)
        x /= x.frob_norm()
        xs, _ = td.pad_cores([c._torch() for c in x.components])
        A = td._pad_operator_stack([c._torch() for c in H.components])
    body = td._half_sweep(solver, r, 24)
    ref, e_ref = body(xs, A)
    monkeypatch.setattr(td, "_ritz_eigh",
                        lambda T: se.small_eigh_plain(T)[:2])
    monkeypatch.setattr(td, "_split_svd",
                        lambda M: se.small_svd_plain(M)[:3])
    out, e = body(xs, A)
    assert abs(float(e) - float(e_ref)) < 1e-10
    overlap = abs(float(_state(out.numpy()) @ _state(ref.numpy())))
    assert overlap > 1.0 - 1e-8


@pytest.mark.slow
def test_plain_versions_match_jax_linalg():
    """Against jnp.linalg.eigh / svd on the CPU (the calls inside the JAX
    package's half-sweep programs)."""
    import jax.numpy as jnp
    for A in _eigh_cases().values():
        w, V, _ = se.small_eigh_plain(torch.from_numpy(A))
        ref = np.asarray(jnp.linalg.eigh(jnp.asarray(A))[0])
        assert np.abs(w.numpy() - ref).max() <= TOL * np.abs(ref).max()
    for A in _svd_cases().values():
        _, S, _, _ = se.small_svd_plain(torch.from_numpy(A))
        ref = np.asarray(jnp.linalg.svd(jnp.asarray(A), compute_uv=False))
        assert np.abs(S.numpy() - ref).max() <= TOL * max(
            np.abs(ref).max(), 1e-300)
