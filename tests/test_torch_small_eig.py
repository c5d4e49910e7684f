"""K4 and K5's plain versions (xerus_tpu_torch.ops.small_eig: Jacobi
eigh and SVD in float64, the kernels' steps in torch) held against LAPACK
on the CPU, and the Lanczos half-sweep run on them against its LAPACK
route.

Eigenvectors and singular vectors are compared only through gauge-free
quantities: eigenvalues and singular values against numpy's LAPACK within
1e-13 of the largest, reconstructions ||V diag(w) V^T - A|| and
||U S Vh - A|| within 1e-13 of ||A||, ||V^T V - I|| within 1e-13 (float32
inputs: 1e-5, after the cast back).  The half-sweep's energy agrees with
the LAPACK route's within 1e-10 and its represented state up to a global
sign within 1e-8.  The comparison against jnp.linalg is in the slow tier."""

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
            "diagonal": np.diag(rng.standard_normal(6))[None]}


def _svd_cases():
    rng = np.random.default_rng(SEED + 1)
    return {"32x32": rng.standard_normal((2, 32, 32)),
            "rank-deficient block": _deficient(rng),
            "5x3": rng.standard_normal((3, 5, 3)),
            "3x5": rng.standard_normal((3, 3, 5)),
            "zero": np.zeros((1, 6, 6)),
            "64x64": rng.standard_normal((1, 64, 64))}


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
    """The rank-4 block: sigma 5.. are exactly zero and U's columns there
    are an orthonormal completion (the shift projector needs orthonormal
    padded frames), not zero columns."""
    A = _deficient(np.random.default_rng(SEED + 4))
    U, S, Vh, _ = se.small_svd_plain(torch.from_numpy(A))
    assert torch.all(S[:, 4:] == 0) and torch.all(S[:, :4] > 0)
    K = S.shape[1]
    assert float((U.transpose(1, 2) @ U - torch.eye(K,
                 dtype=U.dtype)).abs().max()) <= TOL
    assert float(U[:, :, 4:].norm(dim=1).min()) > 1.0 - TOL


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


def test_round_robin_meets_every_pair_once_a_sweep():
    for n in (1, 2, 3, 24, 31):
        seen = [pq for P, Q in se.round_robin(n) for pq in zip(P, Q)]
        assert sorted(seen) == [(p, q) for p in range(n)
                                for q in range(p + 1, n)]
        for P, Q in se.round_robin(n):
            assert len(set(P) | set(Q)) == 2 * len(P)   # disjoint


def test_plans_choose_the_route_by_shared_memory():
    assert se.eigh_plan(24).route == se.eigh_plan(3).route == se.SMEM
    assert se.eigh_plan(256).route == se.GMEM
    assert se.svd_plan(32, 32).route == se.svd_plan(64, 64).route == se.SMEM
    assert se.svd_plan(60, 60).route == se.SMEM
    assert se.svd_plan(128, 128).route == se.svd_plan(256, 256).route \
        == se.GMEM
    for plan in (se.eigh_plan(256), se.svd_plan(256, 256),
                 se.svd_plan(64, 64, se.GMEM)):
        assert plan.smem <= se.SMEM_MAX
    with pytest.raises(ValueError):
        se.svd_plan(128, 128, se.SMEM)


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
