"""The object layer on the card held against the same calls under host().

Imports no jax, so the file also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_objects_cuda.py

Without a card every case skips.  Results are compared gauge-free
(reconstructions, spectra, solutions, products) at 1e-12 relative in
float64; index_add_ sums in no fixed order on the card, so the sparse
product is compared to rounding, not bitwise."""

import os

import numpy as np
import pytest
import torch

import xerus_tpu_torch as xt
from xerus_tpu_torch.core import factorizations as fact
from xerus_tpu_torch.misc import performance as perf

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "gesdd_failure_96x96.npy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _both(case):
    """The case on the card (the default device), then under host()."""
    xt.set_seed(0xBAADF00D)
    card = case()
    xt.set_seed(0xBAADF00D)
    with xt.host():
        cpu = case()
    return card, cpu


@pytest.mark.cuda
def test_computations_run_on_the_card(cuda):
    A = xt.Tensor.random([8, 8])
    assert A.to_torch().device.type == "cuda"
    i, j, k = xt.indices(3)
    C = xt.Tensor()
    C(i, k) << A(i, j) * A(j, k)
    assert C._dense.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", [([16, 8, 12], 1), ([64, 40], 1),
                                         ([40, 64], 1)])
def test_svd_qr_family_match_host(cuda, shape, split):
    def case():
        t = xt.Tensor.random(shape)
        U, S, Vt = xt.calculate_svd(t, split)
        out = {"s": np.diag(S.to_ndarray()),
               "svd": xt.contract(xt.contract(U, S, 1), Vt, 1).to_ndarray()}
        for kind in ("qr", "rq", "qc", "cq"):
            L, R = getattr(xt, f"calculate_{kind}")(t, split)
            out[kind] = xt.contract(L, R, 1).to_ndarray()
            out[kind + " rank"] = L.dimensions[-1]
        return out
    card, cpu = _both(case)
    for key, value in card.items():
        if isinstance(value, np.ndarray):
            assert _rel(value, cpu[key]) <= 1e-12, key
        else:
            assert value == cpu[key], key


@pytest.mark.cuda
def test_gesdd_fixture_on_the_card(cuda):
    m = np.load(FIXTURE)
    T = xt.Tensor.from_ndarray(m)
    U, S, Vt = xt.calculate_svd(T, 1)
    C, Q = xt.calculate_cq(T, 1)
    assert np.isfinite(np.diag(S.to_ndarray())).all()
    assert _rel(xt.contract(xt.contract(U, S, 1), Vt, 1).to_ndarray(),
                m) <= 1e-12
    assert _rel(xt.contract(C, Q, 1).to_ndarray(), m) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("kind,route", [("spd", "cholesky"),
                                        ("indefinite", "lu"),
                                        ("general", "lu"),
                                        ("singular", "least squares"),
                                        ("wide", "least squares")])
def test_solve_routes_match_host(cuda, kind, route):
    rng = np.random.default_rng(3)
    g = rng.normal(size=(30, 30))
    a = {"spd": g @ g.T + 30 * np.eye(30), "indefinite": g + g.T,
         "general": g, "singular": np.diag([1.0] + [0.0] * 29),
         "wide": g[:12]}[kind]
    b = rng.normal(size=a.shape[0])

    def case():
        perf.enable(True)
        perf.clear_analysis()
        try:
            x = fact.solve(xt.Tensor.from_ndarray(a),
                           xt.Tensor.from_ndarray(b))
            taken = [r for section, r in (("Solve (Cholesky)", "cholesky"),
                                          ("Solve (PLU)", "lu"),
                                          ("Solve Least Squares",
                                           "least squares"))
                     if section in perf._CALLS.get("Dense LAPACK", {})]
        finally:
            perf.enable(False)
            perf.clear_analysis()
        return x.to_ndarray(), taken[-1]
    (xc, rc), (xh, rh) = _both(case)
    assert rc == rh == route
    assert _rel(xc, xh) <= 1e-12


@pytest.mark.cuda
def test_sparse_times_dense_on_the_card(cuda):
    def case():
        S = xt.Tensor.random([2048, 2048], n=20_000)
        D = xt.Tensor.random([2048, 2048])
        P = xt.Tensor()
        i, j, k = xt.indices(3)
        P(i, j) << S(i, k) * D(k, j)
        assert P.is_dense()
        return P.to_ndarray(), P._dense.device.type
    (pc, dc), (ph, dh) = _both(case)
    assert (dc, dh) == ("cuda", "cpu")
    assert _rel(pc, ph) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["U*S", "dense x sparse^T",
                                  "sparse^T x dense", "pseudo_inverse"])
def test_small_sparse_products_stay_on_the_card(cuda, what):
    """Below DEVICE_SPARSE_THRESHOLD a product with a sparse operand (the
    SVD's S among them) still runs on the card, and agrees with host()
    (gauge-free: U * S is taken on to the reconstruction)."""
    def case():
        t = xt.Tensor.random([12, 9])
        sp = xt.Tensor.random([9, 9], n=20)
        if what == "U*S":
            U, S, Vt = xt.calculate_svd(t, 1)
            out = xt.contract(U, S, 1)
            return (xt.contract(out, Vt, 1).to_ndarray(),
                    torch.is_tensor(out._dense) and out._dense.is_cuda)
        out = {"dense x sparse^T": lambda: xt.contract(t, sp, 1,
                                                       rhs_trans=True),
               "sparse^T x dense": lambda: xt.contract(sp, t, 1,
                                                       lhs_trans=True,
                                                       rhs_trans=True),
               "pseudo_inverse": lambda: xt.pseudo_inverse(t, 1)}[what]()
        return (out.to_ndarray(),
                torch.is_tensor(out._dense) and out._dense.is_cuda)
    (pc, card), (ph, host) = _both(case)
    assert card and not host
    assert _rel(pc, ph) <= 1e-12


@pytest.mark.cuda
def test_svd_retry_stays_on_the_card(cuda, monkeypatch):
    """A nan spectrum from gesvd is retried with cuSOLVER's gesvdj on the
    card, never on the host."""
    def nan_spectrum(a):
        u, s, vt = torch.linalg.svd(a, full_matrices=False, driver="gesvd")
        return u, torch.full_like(s, float("nan")), vt

    monkeypatch.setattr(fact, "_svd", nan_spectrum)
    a = torch.from_numpy(np.random.default_rng(5).normal(size=(40, 24)))
    u, s, vt = fact._svd_robust(a.to(cuda))
    assert u.device.type == s.device.type == vt.device.type == "cuda"
    assert _rel(((u * s) @ vt).cpu().numpy(), a.numpy()) <= 1e-12


@pytest.mark.cuda
def test_eigh_failure_on_the_card_is_raised(cuda, monkeypatch):
    """An eigh that does not converge on the card raises: the scipy retry
    of the DMRG sweeps is for the CPU only and moves nothing to the
    host."""
    from xerus_tpu_torch.ops import dmrg_kernels as dk

    def refuse(A):
        raise torch.linalg.LinAlgError("failed to converge")

    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    before = dk._eigh.fallbacks
    with pytest.raises(torch.linalg.LinAlgError):
        dk._eigh(torch.eye(4, dtype=torch.float64, device=cuda))
    assert dk._eigh.fallbacks == before


# -- the tensor network and the TT classes on the card


@pytest.mark.cuda
def test_round_fast_gemm_exact_launches_k2(cuda):
    """round_fast('gemm_exact') on a TT whose components live on the card
    launches K2 for every truncation, certifies each (no SVD fallback),
    and keeps the rounded cores on the card."""
    from xerus_tpu_torch.ops import gemm_exact as ge
    xt.set_seed(0xBAADF00D)
    x = xt.TTTensor.random([2] * 8, 16)
    assert x.components[1]._dense.device.type == "cuda"
    ge.reset_counters()
    y = x.copy()
    y.round_fast(8, method="gemm_exact")
    calls = ge.trunc_step_gemm_exact.calls
    assert calls > 0 and ge.gemm_exact_kernel.launches == calls
    assert ge.trunc_step_gemm_exact.svd_fallbacks == 0
    assert all(c._dense.device.type == "cuda" for c in y.components)
    assert y.canonicalized and y.corePosition == 0
    with xt.host():
        h = xt.TTTensor(x)
        h.round_fast(8, method="svd")
    a, b = y.to_tensor().to_ndarray(), h.to_tensor().to_ndarray()
    assert y.ranks() == h.ranks()
    assert _rel(a, b) <= 1e-8


def _tt_case():
    x = xt.TTTensor.random([2] * 8, 6)
    z = xt.TTTensor.random([2] * 8, 3)
    A = xt.TTOperator.random([2] * 16, 2)
    i, j = xt.indices(2)
    r = x.copy()
    r.round(4)
    f = x.copy()
    f.round_fast(4, method="svd")
    b = xt.TTTensor()
    b(i & 0) << A(i / 2, j / 2) * x(j & 0)
    svd = xt.TTTensor(xt.Tensor(x), eps=1e-12)
    s = xt.Tensor()
    s() << x(i & 0) * z(i & 0)
    net = xt.TensorNetwork()
    net() << x(i & 0) * z(i & 0)
    return {"round": r.to_tensor().to_ndarray(), "round ranks": r.ranks(),
            "round_fast": f.to_tensor().to_ndarray(),
            "apply": b.to_tensor().to_ndarray(), "apply ranks": b.ranks(),
            "residual": xt.frob_norm(A(i / 2, j / 2) * x(j & 0) - b(i & 0))
            / b.frob_norm(),
            "tt-svd": svd.to_tensor().to_ndarray(), "svd ranks": svd.ranks(),
            "inner": np.array([xt.tt.inner(x, z), float(s[0]),
                               float(net.to_tensor()[0])])}


@pytest.mark.cuda
def test_tt_card_matches_host(cuda):
    """TT arithmetic, roundings, TT-SVD, the DSL residual and the three
    inner-product routes on the card against the same under host()."""
    card, cpu = _both(_tt_case)
    for key, value in card.items():
        if key == "residual":
            assert value <= 1e-13 and cpu[key] <= 1e-13
        elif isinstance(value, np.ndarray):
            assert _rel(value, cpu[key]) <= 1e-12, key
        else:
            assert value == cpu[key], key
    assert np.ptp(card["inner"]) <= 1e-12 * abs(card["inner"][0])


def _eigen_case():
    """The d=8 Heisenberg ground state three ways (the exact local eigh,
    Lanczos with shift 0, the auto-shifted Lanczos on the PSD Laplace),
    the d=8 two-site SPD solve, and the fused apply + round."""
    from xerus_tpu_torch.ops import dmrg_kernels as dk
    out = {}
    H = xt.examples.heisenberg_mpo(8)
    for solver, kw in (("exact", {}), ("lanczos", {"shift": 0.0})):
        x = xt.TTTensor.random([2] * 8, 4)
        e = xt.smallest_eigenvalue(H, x, sites=2, max_rank=16,
                                   num_sweeps=6, solver=solver, **kw)
        out[solver] = np.array([e, (xt.apply_operator(H, x) - e * x)
                                .frob_norm()])
        out[solver + " ranks"] = x.ranks()
    A = xt.examples.laplace_operator([2] * 8)
    x = xt.TTTensor.random([2] * 8, 4)
    out["psd"] = np.array([dk.dmrg_groundstate_scan(
        A, x, num_half_sweeps=8, solver="lanczos")])
    b = xt.TTTensor.ones([2] * 8)
    x = xt.TTTensor.random([2] * 8, 2)
    out["dmrg_solve"] = np.array([xt.dmrg_solve(A, x, b, max_rank=6)])
    out["dmrg_solve ranks"] = x.ranks()
    y = xt.ops.apply_operator_rounded(A, xt.TTTensor.random([2] * 8, 3), 4)
    out["apply ranks"] = y.ranks()
    return out


@pytest.mark.cuda
def test_eigensolver_and_dmrg_solve_card_match_host(cuda):
    """xt.smallest_eigenvalue (exact and Lanczos), the auto-shifted scan
    sweeps and xt.dmrg_solve at d=8 on the card against the same under
    host(): energies within 1e-10, eig-residuals and solve residuals both
    small, ranks equal.  With no solver named, the card runs Lanczos."""
    card, cpu = _both(_eigen_case)
    for key, value in card.items():
        if key.endswith("ranks"):
            assert value == cpu[key], key
        elif key == "dmrg_solve":
            assert value[0] < 1e-10 and cpu[key][0] < 1e-10
        else:
            assert abs(value[0] - cpu[key][0]) <= 1e-10 * abs(cpu[key][0])
    assert card["exact"][1] < 1e-6 and card["lanczos"][1] < 1e-6
    from xerus_tpu_torch.ops import round_kernels as rk
    xt.set_seed(0xBAADF00D)
    reads = rk.host_bool.reads
    xt.smallest_eigenvalue(xt.examples.heisenberg_mpo(6),
                           xt.TTTensor.random([2] * 6, 8), max_rank=8,
                           num_sweeps=2, eps=0.0, shift=0.0)
    assert rk.host_bool.reads - reads == 4          # the Lanczos loop ran
