"""The port's two-site DMRG sweeps (xerus_tpu_torch.ops.dmrg_kernels) held
against xerus_tpu.ops.dmrg_kernels on the CPU.

Both packages get the same padded float64 stacks (built once in numpy from
one ``set_seed``) and run the same half-sweep.  SVD and eigh signs and the
null-space completions of the masked split differ between jnp and torch,
so only gauge-free results are compared: energies within 1e-10, the
represented TT up to a global sign within 1e-8 (the overlap of the
normalized contracted states), squared local residuals within 1e-10
relative.  Every call must leave its input tensors unchanged: JAX's
functional updates (``A_stack.at[0].multiply(-1)``, ``V.at[j].set``) are
in-place writes in torch.  Whole solves at d >= 8 are in the slow tier."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import xerus_tpu as xe
import xerus_tpu_torch as xt
from xerus_tpu.ops import dmrg_kernels as jd
from xerus_tpu_torch.ops import dmrg_kernels as td
from xerus_tpu_torch.ops import round_kernels as rk

SEED = 0xBAADF00D
E_TOL = 1e-10
STATE_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _host():
    with xt.host():
        yield


def _stacks(d, rank, op="heisenberg", n=2, seed=SEED, batch=1):
    """Padded float64 stacks in numpy: x canonical at 0 and normalized
    (batch of them, each from its own draw), and the padded operator."""
    xe.set_seed(seed)
    A = (xe.examples.heisenberg_mpo(d) if op == "heisenberg"
         else xe.examples.laplace_operator([n] * d))
    A_np = [np.asarray(c.to_ndarray()) for c in A.components]
    a = max(max(c.shape[0], c.shape[3]) for c in A_np)
    A_stack = np.zeros((d, a, n, n, a))
    for k, c in enumerate(A_np):
        A_stack[k, :c.shape[0], :, :, :c.shape[3]] = c
    xs = []
    for _ in range(batch):
        x = xe.TTTensor.random([n] * d, rank)
        x.move_core(0)
        x /= x.frob_norm()
        s = np.zeros((d, rank, n, rank))
        for k, c in enumerate(x.components):
            c = c.to_ndarray()
            s[k, :c.shape[0], :, :c.shape[2]] = c
        xs.append(s)
    return np.stack(xs), A_stack


def _state(stack):
    """The normalized full vector of a padded (d, r, n, r) stack."""
    stack = np.asarray(stack)
    v = stack[0][:1]
    for k in range(1, stack.shape[0]):
        v = np.einsum("...a,anb->...nb", v, stack[k])
    v = v[..., 0].reshape(-1)
    return v / np.linalg.norm(v)


def _same_state(a, b):
    overlap = abs(float(np.dot(_state(a), _state(b))))
    assert overlap > 1.0 - STATE_TOL, overlap


def _t(a):
    return torch.from_numpy(np.array(a))


def _unchanged(tensors, copies):
    for t, c in zip(tensors, copies):
        assert torch.equal(t, c)


HALF_SWEEPS = [("eigh", None), ("eigh", 3.0), ("lanczos", None),
               ("lanczos", 3.0), ("lobpcg", None), ("lobpcg", 3.0)]


@pytest.mark.parametrize("solver,shift", HALF_SWEEPS)
def test_half_sweep_matches_jax(solver, shift):
    """One padded half-sweep at d=6 rank 8 on the Heisenberg chain: energy
    and the represented state equal JAX's; a shift of 3 (solving A - 3 P)
    moves the reported energy by exactly -3 in both."""
    xs, A = _stacks(6, 8)
    x_np, A_np = xs[0], A
    jshift = None if shift is None else jnp.asarray(shift)
    if solver == "eigh":
        jout, je = jd._dmrg_eig_half_sweep_scan(jnp.asarray(x_np),
                                                jnp.asarray(A_np), jshift,
                                                rank=8)
    else:
        jout, je = jd._dmrg_lobpcg_half_sweep_scan(
            jnp.asarray(x_np), jnp.asarray(A_np), jshift, rank=8,
            lobpcg_iters=24, solver=solver)
    x_t, A_t = _t(x_np), _t(A_np)
    keep = (x_t.clone(), A_t.clone())
    body = td._half_sweep(solver, 8, 24)
    tout, te = body(x_t, A_t, shift)
    _unchanged((x_t, A_t), keep)
    assert abs(float(te) - float(je)) < E_TOL
    _same_state(tout.numpy(), jout)


def test_rank_cut_inside_a_multiplet_is_a_gauge_choice():
    """At d=6 rank 6 the cut at the middle bond splits a four-fold
    degenerate multiplet of the Heisenberg ground state's singular values
    (SU(2) symmetry): which 2 of the 4 directions survive is up to the
    SVD routine, so LAPACK through jnp and through torch keep different
    rank-6 states whose energies differ at 1e-6 (measured 2.1e-6 for
    Lanczos, 2.6e-7 for eigh), not at rounding level.  The port's own
    sweeps agree with each other to rounding level."""
    xs, A = _stacks(6, 6)
    seen = []
    split = td._masked_split

    def spy(ground, rank, r, n):
        seen.append(torch.linalg.svdvals(ground.reshape(1, r * n, n * r))[0])
        return split(ground, rank, r, n)

    td._masked_split = spy
    try:
        tout, te = td._half_sweep("lanczos", 6, 24)(_t(xs[0]), _t(A))
    finally:
        td._masked_split = split
    s = seen[2]                                     # the middle bond
    assert float(s[4] - s[7]) < 1e-12 * float(s[0])   # sv 5..8 degenerate
    assert float(s[7]) > 1e-3 * float(s[0])
    jout, je = jd._dmrg_lobpcg_half_sweep_scan(
        jnp.asarray(xs[0]), jnp.asarray(A), rank=6, lobpcg_iters=24,
        solver="lanczos")
    assert 1e-9 < abs(float(te) - float(je)) < 1e-5
    again, te2 = td._half_sweep("lanczos", 6, 24)(_t(xs[0]), _t(A))
    assert abs(float(te2) - float(te)) < E_TOL
    _same_state(again.numpy(), tout.numpy())


def test_right_prj_envs_match_jax():
    xs, _ = _stacks(6, 8)
    jp0, jR = jd._right_prj_envs(jnp.asarray(xs[0]), True)
    x_t = _t(xs[0])
    tp0, tR = td._right_prj_envs(x_t, True)
    np.testing.assert_array_equal(tp0.numpy(), np.asarray(jp0))
    np.testing.assert_allclose(torch.stack(tR).numpy(), np.asarray(jR),
                               rtol=0, atol=1e-13)
    # right-orthonormal frames: each projector env is diag(true-rank mask)
    for k, p in enumerate(tR):
        rank = min(8, 2 ** (k + 2), 2 ** (4 - k))   # bond k+2's
        np.testing.assert_allclose(p.numpy(), np.diag(
            (np.arange(8) < rank).astype(float)), atol=1e-12)
    assert td._right_prj_envs(x_t, False)[1] is None


def test_lanczos_and_lobpcg_leave_their_input_unchanged():
    """The local solvers on one Heisenberg two-site problem: the start
    block, the environments and the Krylov basis writes touch nothing the
    caller holds; both reach the dense eigh's lowest eigenvalue."""
    xs, A = _stacks(4, 4)
    x_t, A_t = _t(xs[0]), _t(A)
    xb = x_t.unsqueeze(0)
    R = td._right_op_envs(xb, A_t)[1]
    L = td._left_update(td._unit_env(1, 4, A_t.shape[1], xb), None,
                        xb[:, 0], A_t[0], False)[0]
    v0 = torch.einsum("zumb,zbMU->zumMU", xb[:, 1], xb[:, 2])
    keep = [t.clone() for t in (L, R, v0, A_t)]

    def apply(v):
        return td._local_apply(L, A_t[1], A_t[2], R, v)

    Aloc = torch.einsum("zuav,amnb,bMNc,zUcV->zumMUvnNV", L, A_t[1], A_t[2],
                        R)
    nn = int(np.prod(Aloc.shape[1:5]))
    e_min = float(torch.linalg.eigvalsh(Aloc.reshape(nn, nn))[0])
    _, e_l = td._lanczos_smallest(apply, v0, 24)
    _, e_b = td._lobpcg_smallest(apply, v0, 40)
    _unchanged((L, R, v0, A_t), keep)
    assert abs(float(e_l) - e_min) < 1e-10
    assert abs(float(e_b) - e_min) < 1e-8


def test_estimate_shift_negates_a_copy():
    """_estimate_shift runs on -A by negating one core of a new stack: the
    caller's operator stack and state are unchanged, and the estimate
    equals JAX's on the same stacks (PSD Laplace: 1.1 lambda_hat > 0;
    Heisenberg: positive too, its top eigenvalue is positive)."""
    for op, n in (("laplace", 3), ("heisenberg", 2)):
        xs, A = _stacks(5, 4, op=op, n=n)
        jfn = lambda x, a: jd._dmrg_lobpcg_half_sweep_scan(  # noqa: E731
            x, a, rank=4, lobpcg_iters=24, solver="lanczos")
        j = jd._estimate_shift(jfn, jnp.asarray(xs[0]), jnp.asarray(A))
        x_t, A_t = _t(xs[0]), _t(A)
        keep = (x_t.clone(), A_t.clone())
        t = td._estimate_shift(td._half_sweep("lanczos", 4, 24), x_t, A_t)
        _unchanged((x_t, A_t), keep)
        assert t > 0 and abs(t - j) < 1e-9 * abs(j)


def test_batched_half_sweep_matches_serial():
    """JAX test_eigensolver.py:140-186 in the port: the batched half-sweep
    (leading batch axis) equals per-instance serial sweeps, and the batch
    equals JAX's vmapped half-sweep."""
    xs, A = _stacks(6, 8, batch=3)
    A_t = _t(A)
    x_t = _t(xs)
    keep = x_t.clone()
    out, energies = td.dmrg_half_sweep_batched(x_t, A_t, 8, "lanczos", 24)
    _unchanged((x_t,), (keep,))
    jout, je = jd.dmrg_half_sweep_batched(jnp.asarray(xs), jnp.asarray(A), 8,
                                          "lanczos", 24)
    for i in range(3):
        want, we = td._half_sweep("lanczos", 8, 24)(x_t[i], A_t)
        assert abs(float(energies[i]) - float(we)) < E_TOL
        _same_state(out[i].numpy(), want.numpy())
        assert abs(float(energies[i]) - float(je[i])) < E_TOL
        _same_state(out[i].numpy(), np.asarray(jout[i]))


def test_device_loop_matches_host_loop():
    """JAX test_eigensolver.py:274-321 in the port: dmrg_run (the JAX
    package's while_loop program as a host loop) reproduces the per-sweep
    loop energy by energy and ends in the same orientation; its energies
    equal JAX's make_dmrg_run's (conv_eps 0: every half-sweep runs)."""
    d = 6
    xs, A = _stacks(d, 8)
    x_t, A_t = _t(xs[0]), _t(A)
    body = td._half_sweep("lanczos", 8, 24)
    cur, As, hist = x_t, A_t, []
    for _ in range(5):
        cur, e = body(cur, As)
        cur = td._normalize_last(cur)
        hist.append(float(e))
        cur, As = td._rev_x_stack(cur), td._rev_A_stack(As)
    run = jd.make_dmrg_run(tuple(xs[0].shape), 8, "float64", "lanczos", 24,
                           False, 64)
    for rem in (1, 4, 5):
        xs2, e2, cnt = td.dmrg_run(x_t, A_t, 0.0, 0.0, rem, np.inf,
                                   rank=8, solver="lanczos", lobpcg_iters=24,
                                   shifted=False)
        assert cnt == rem
        assert abs(e2 - hist[rem - 1]) <= 1e-12 * abs(hist[rem - 1])
        jx, je, jc = run(jnp.asarray(xs[0]), jnp.asarray(A),
                         jnp.float64(0.0), jnp.float64(0.0),
                         jnp.asarray(rem, jnp.int32), jnp.float64(np.inf))
        assert int(jc) == rem and abs(e2 - float(je)) < E_TOL
        _same_state(xs2.numpy(), np.asarray(jx))
    # 5 sweeps: the host loop ends reversed, the run un-reverses odd counts
    np.testing.assert_allclose(td._rev_x_stack(cur).numpy(), xs2.numpy(),
                               atol=1e-12)
    reads = rk.host_bool.reads
    td.dmrg_run(x_t, A_t, 0.0, 0.0, 3, np.inf, rank=8, solver="lanczos",
                lobpcg_iters=24, shifted=False)
    assert rk.host_bool.reads - reads == 3      # one energy per half-sweep


def test_solve_half_sweep_matches_jax():
    """One two-site SPD half-sweep on the Laplace system at d=6: the
    squared local residual and the represented solution equal JAX's."""
    d, n = 6, 2
    xe.set_seed(SEED)
    L = xe.examples.laplace_operator([n] * d)
    b = xe.TTTensor.ones([n] * d)
    xs, A = _stacks(d, 4, op="laplace", n=n)
    b_stack = np.zeros((d, 1, n, 1))
    for k, c in enumerate(b.components):
        b_stack[k] = c.to_ndarray()
    jout, jr = jd._dmrg_solve_half_sweep_scan(
        jnp.asarray(xs[0]), jnp.asarray(A), jnp.asarray(b_stack), rank=4)
    tout, tr = td._dmrg_solve_half_sweep_scan(_t(xs[0]), _t(A), _t(b_stack),
                                              rank=4)
    assert abs(float(tr) - float(jr)) <= 1e-10 * abs(float(jr)) + 1e-20
    np.testing.assert_allclose(_state(tout.numpy()), _state(jout),
                               atol=1e-9)


def test_dmrg_solve_rank_growth_matches_jax():
    """JAX test_als.py:146-165 in the port (d=10, rank 2 -> 8): residual
    below 1e-10, ranks grown to 8, the truth recovered; the residual and
    the solution equal JAX's."""
    out = []
    for pkg in (xe, xt):
        pkg.set_seed(SEED)
        d = 10
        Lop = pkg.examples.laplace_operator([2] * d)
        truth = pkg.TTTensor.random([2] * d, 4)
        b = pkg.apply_operator(Lop, truth)
        b.round(8)
        x = pkg.TTTensor.random([2] * d, 2)
        solve = jd.dmrg_solve if pkg is xe else xt.dmrg_solve
        res = solve(Lop, x, b, max_rank=8, num_half_sweeps=12)
        err = (x - truth).frob_norm() / truth.frob_norm()
        out.append((res, x.ranks(), float(err),
                    x.to_tensor().to_ndarray().ravel()))
    (jres, jranks, jerr, jx), (tres, tranks, terr, tx) = out
    assert tres < 1e-10 and max(tranks) == 8 and terr < 1e-10
    assert tranks == jranks and jres < 1e-10
    np.testing.assert_allclose(tx, jx, atol=1e-9 * np.abs(jx).max())


def test_groundstate_fast_matches_jax():
    """dmrg_groundstate_fast (the unrolled dense-eigh half-sweeps) at d=6
    rank 8: the energy equals JAX's and exact diagonalization's."""
    d = 6
    out = []
    for pkg, fn in ((xe, jd.dmrg_groundstate_fast),
                    (xt, xt.ops.dmrg_groundstate_fast)):
        pkg.set_seed(SEED)
        H = pkg.examples.heisenberg_mpo(d)
        x = pkg.TTTensor.random([2] * d, 8)
        e = fn(H, x, num_half_sweeps=8, conv_eps=1e-13)
        out.append((e, x.to_tensor().to_ndarray().ravel(),
                    H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)))
    (je, jx, Hm), (te, tx, _) = out
    exact = np.linalg.eigvalsh(Hm)[0]
    assert abs(te - je) < E_TOL and abs(te - exact) < 1e-10
    assert abs(float(np.dot(tx, jx))) > 1 - STATE_TOL


def test_unknown_solver_raises():
    H = xt.examples.heisenberg_mpo(4)
    with pytest.raises(ValueError):
        td.dmrg_groundstate_scan(H, xt.TTTensor.random([2] * 4, 2),
                                 solver="davidson")


def test_eigh_retries_where_torch_does_not_converge(monkeypatch):
    """Where torch.linalg.eigh reports non-convergence (torch's CPU syevd
    does on padded d=8 rank-16 local operators that LAPACK's own syevd
    solves), _eigh retries through scipy and gives the same pairs."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((2, 12, 12))
    M = _t(M + M.transpose(0, 2, 1))
    want_w, want_v = torch.linalg.eigh(M)
    real = torch.linalg.eigh

    def refuse(A):
        raise torch.linalg.LinAlgError("failed to converge")

    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    before = td._eigh.fallbacks
    w, v = td._eigh(M)
    monkeypatch.setattr(torch.linalg, "eigh", real)
    assert td._eigh.fallbacks == before + 1
    np.testing.assert_allclose(w.numpy(), want_w.numpy(), atol=1e-12)
    np.testing.assert_allclose(np.abs(np.einsum("bij,bij->bj", v.numpy(),
                                                want_v.numpy())), 1.0,
                               atol=1e-10)
