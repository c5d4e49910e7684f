"""The df column loops of the port (xerus_tpu_torch.ops.df_loops: kernels
K1q and K1c) on the CPU.

On the CPU the wrappers ``mixed_precision.df_qr``,
``df_cholesky._df_chol_unblocked`` and ``_df_trsm_rlt`` run their plain
versions bit for bit, launch nothing and build nothing.  The plans route
the paths' shapes (the Poisson solve's (60, 30), the df rounding's
(512, 256), the Cholesky's (64, 64) blocks and (m, 64) / (512, 256)
panels) within one CTA's 227 KB.  The kernels' orders in torch
(``df_qr_model``: K1q's groups of lanes, butterflies and bands;
``df_chol_model`` and ``df_trsm_model``: K1c's right-looking steps) hold
the plain versions' accuracy, rank-deficient columns included, and agree
with the JAX package's outputs stored in tests/data/df_loops_jax.npz
(``df_loops_jax``), as the plain loops do.  No JAX compile in the default
tier: the comparison with the JAX package's loops run anew, and the check
that the stored outputs are theirs, are in the slow tier.  The kernels
themselves are held against the plain versions and the stored outputs in
tests/test_torch_kernels_cuda.py, on the card."""

import importlib

import numpy as np
import pytest
import torch

from xerus_tpu_torch.ops import df32
from xerus_tpu_torch.ops import df_loops as dl
from xerus_tpu_torch.ops import mixed_precision as mp

import df_loops_jax

# the package exports its function under the module's name
dc = importlib.import_module("xerus_tpu_torch.ops.df_cholesky")

CPU = torch.device("cpu")
DF_UNIT = 2.0 ** -48        # the df format's relative resolution


def _pair(x):
    return df32.df_from_f64(x, CPU)


def _joined(pair):
    return df32.df_to_f64(*pair)


def _launches():
    return (dl.df_qr_launch.launches, dl.df_chol_block_launch.launches,
            dl.df_trsm_rlt_launch.launches)


def _qr_input(m, r, seed, deficient):
    a = np.random.Generator(np.random.PCG64(seed)).normal(size=(m, r))
    if deficient:
        a[:, r // 3] = 2.0 * a[:, 1]
        a[:, r // 2] = 0.0
        a[:, r - 1] = a[:, 0] - 3.0 * a[:, 2]
    return a


def _spd(n, seed, decades=6):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.logspace(0, -decades, n)) @ Q.T


def _tril(B, seed):
    rng = np.random.default_rng(seed)
    return np.tril(rng.normal(size=(B, B)), -1) * 0.1 + np.diag(
        rng.uniform(0.5, 2.0, size=B))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("m,r,deficient", [(60, 30, False), (60, 30, True),
                                           (7, 3, False), (12, 12, True)])
def test_df_qr_wrapper_is_the_plain_version_on_the_cpu(m, r, deficient):
    ah, al = _pair(_qr_input(m, r, m + r, deficient))
    before, calls = _launches(), mp.df_qr.calls
    (qh, ql), (rh, rl) = mp.df_qr(ah, al)
    (pqh, pql), (prh, prl) = mp.df_qr_reference(ah, al)
    assert _equal((qh, ql, rh, rl), (pqh, pql, prh, prl))
    assert _launches() == before and mp.df_qr.calls == calls + 1


@pytest.mark.parametrize("B", [2, 37, 64])
def test_df_chol_block_wrapper_is_the_plain_version_on_the_cpu(B):
    Ah, Al = _pair(_spd(B, B))
    before = _launches()
    assert _equal(dc._df_chol_unblocked(Ah, Al),
                  dc._df_chol_unblocked_reference(Ah, Al))
    assert _launches() == before


@pytest.mark.parametrize("m,B", [(64, 64), (70, 13), (5, 20)])
def test_df_trsm_wrapper_is_the_plain_version_on_the_cpu(m, B):
    rng = np.random.default_rng(m + B)
    big = _pair(rng.normal(size=(m, B + 3)))
    Ah, Al = big[0][:, 2:2 + B], big[1][:, 2:2 + B]     # a strided panel
    Lh, Ll = _pair(_tril(B, B))
    before = _launches()
    assert _equal(dc._df_trsm_rlt(Ah, Al, Lh, Ll),
                  dc._df_trsm_rlt_reference(Ah, Al, Lh, Ll))
    assert _launches() == before


def test_df_cholesky_and_its_solve_launch_nothing_on_the_cpu():
    A = _spd(100, 1)
    before = _launches()
    L = _joined(dc.df_cholesky(*_pair(A), block=64))
    assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) < 1e-12
    assert _launches() == before


def test_df_loop_wrappers_raise_on_a_device_without_a_kernel():
    t = torch.empty((6, 3), device="meta")
    s = torch.empty((3, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        mp.df_qr(t, t)
    with pytest.raises(RuntimeError, match="no kernel"):
        dc._df_chol_unblocked(s, s)
    with pytest.raises(RuntimeError, match="no kernel"):
        dc._df_trsm_rlt(t, t, s, s)


def test_df_loop_launches_refuse_cpu_tensors_before_building():
    ah, al = _pair(_qr_input(6, 3, 1, False))
    with pytest.raises(ValueError, match="CUDA"):
        dl.df_qr_launch(ah, al, dl.df_qr_plan(6, 3))
    with pytest.raises(ValueError, match="CUDA"):
        dl.df_chol_block_launch(ah[:3], al[:3], dl.df_chol_block_plan(3))
    with pytest.raises(ValueError, match="CUDA"):
        dl.df_trsm_rlt_launch(ah, al, ah[:3], al[:3], dl.df_trsm_plan(6, 3))


def _poisson_qr_shapes(d=32, rank=30):
    """(u * 2, U) of every df_qr of a df half-sweep of the d-site,
    rank-``rank`` QTT Poisson solve, both directions."""
    ranks = [1] + [min(rank, 2 ** k, 2 ** (d - k)) for k in range(1, d)] + [1]
    fwd = [(ranks[k] * 2, ranks[k + 1]) for k in range(d - 1)]
    bwd = [(ranks[k + 1] * 2, ranks[k]) for k in range(d - 1, 0, -1)]
    return fwd + bwd


def _rounding_qr_shapes(d=32, rank=256):
    ranks = [1] + [min(rank, 2 ** k, 2 ** (d - k)) for k in range(1, d)] + [1]
    return [(ranks[k] * 2, ranks[k + 1]) for k in range(d - 1)]


def test_df_qr_plan_routes_the_paths_shapes():
    p = dl.df_qr_plan(60, 30)
    assert (p.route, p.ctas, p.rows) == ("cta", 1, 60)
    shapes = _poisson_qr_shapes()
    assert len(shapes) == 62 and shapes.count((60, 30)) == 44
    assert {dl.df_qr_plan(*s).route for s in shapes} == {"cta"}
    p = dl.df_qr_plan(512, 256)
    assert (p.route, p.ctas, p.rows) == ("cluster", 16, 32)
    assert 8 * 32 * 256 < p.smem
    routes = {s: dl.df_qr_plan(*s).route for s in _rounding_qr_shapes()}
    assert routes[(512, 256)] == routes[(256, 256)] == "cluster"
    assert routes[(128, 128)] == routes[(2, 2)] == "cta"
    for s in ((4096, 512), (1024, 512)):    # a rank-512 rounding's sites
        p = dl.df_qr_plan(*s)
        assert (p.route, p.ctas, p.rows) == ("gmem", 16, s[0] // 16)
        assert p.work == 2 * 16 * (s[0] // 16) * 512   # rows, 32-aligned
    for s in list(routes) + [(60, 30), (96, 48), (1000, 400), (4096, 512)]:
        assert dl.df_qr_plan(*s).smem <= dl.SMEM_MAX == 232_448
    with pytest.raises(ValueError, match=r"\(2097152, 8\).*232448"):
        dl.df_qr_plan(2 ** 21, 8)


@pytest.mark.parametrize("m,B,route", [
    (64, 64, "whole"), (128, 64, "whole"), (192, 64, "whole"),
    (1792, 64, "whole"), (512, 256, "tiles"), (256, 256, "tiles"),
    (64, 3000, "gmem")])
def test_df_trsm_plan_routes_the_panels(m, B, route):
    p = dl.df_trsm_plan(m, B)
    assert p.route == route
    assert p.ctas == -(-m // dl.TRSM_WARPS) and p.smem <= dl.SMEM_MAX
    if route == "gmem":
        assert p.tile == p.smem == 0
    else:
        assert p.tile == B if route == "whole" else 8 <= p.tile < B


def test_df_chol_block_plan_routes_the_blocks():
    for B in (2, 30, 64, 128):
        p = dl.df_chol_block_plan(B)
        assert p.route == "cta" and p.smem <= dl.SMEM_MAX
    assert dl.df_chol_block_plan(64).smem == 4 * (2 * 64 * 65 + 2 * 64)
    assert dl.df_chol_block_plan(200) == ("gmem", 1, 200, 0, 4 * 2 * 200, 0)
    with pytest.raises(ValueError, match=r"\(30000, 30000\).*232448"):
        dl.df_chol_block_plan(30000)


@pytest.mark.parametrize("entry,shape,route", [
    ("df_qr", (512, 256), "cluster"), ("df_qr", (60, 30), "cta"),
    ("df_chol_block", (64, 64), "cta"), ("df_trsm_rlt", (512, 256), "tiles"),
    ("df_trsm_rlt", (128, 64), "whole")])
def test_gmem_plan_at_the_paths_shapes(entry, shape, route):
    """Route gmem holds any path shape in little shared memory: the plans
    choose the shared-memory route there, gmem_plan gives the route the
    card tests and chip_smoke hold against it bitwise."""
    plan = {"df_qr": lambda s: dl.df_qr_plan(*s),
            "df_chol_block": lambda s: dl.df_chol_block_plan(s[0]),
            "df_trsm_rlt": lambda s: dl.df_trsm_plan(*s)}[entry](shape)
    g = dl.gmem_plan(entry, shape)
    assert plan.route == route and g.route == "gmem"
    assert g.ctas == (16 if entry == "df_qr" else plan.ctas)
    assert g.smem < plan.smem and g.smem <= 4 * 4 * shape[0] + 8192
    assert g.work == (2 * 16 * max(32, -(-shape[0] // 512) * 32) * shape[1]
                      if entry == "df_qr" else 0)
    with pytest.raises(ValueError, match="no entry"):
        dl.gmem_plan("df_matvec", shape)


@pytest.mark.parametrize("ctas,deficient", [(16, False), (16, True),
                                            (1, True)])
def test_df_qr_cluster_model_holds_the_plain_versions_accuracy(ctas,
                                                               deficient):
    """K1q's order in torch (``df_qr_model``) on its cluster routes' split
    (16 bands of 6 rows, 512 threads a band) and its route cta's (one band
    of 96 rows, 512 threads): ||QR - A|| / ||A|| and ||Q^T Q - I|| within
    1e-13 as the plain version's are, Q within 1e-13 of the plain
    version's, the same deficient columns (R's diagonal zeroed)."""
    a = _qr_input(96, 48, 11, deficient)
    (qh, ql), (rh, rl), bad = dl.df_qr_model(*_pair(a), ctas=ctas)
    Q, R = _joined((qh, ql)), _joined((rh, rl))
    PQ, PR = _joined(mp.df_qr_reference(*_pair(a))[0]), _joined(
        mp.df_qr_reference(*_pair(a))[1])
    for q, r in ((Q, R), (PQ, PR)):
        back, orth = dl.qr_backward_errors(q, r, a)
        assert back <= 1e-13 and orth <= 1e-13
    assert np.abs(Q - PQ).max() <= 1e-13
    assert bad == list(np.diag(PR) == 0.0)
    assert sum(bad) == (3 if deficient else 0)
    assert np.array_equal(np.diag(R) == 0.0, np.diag(PR) == 0.0)
    assert np.array_equal(np.triu(R), R)


def test_lane_fold_is_the_shuffle_tree():
    """K1q's lane sums and butterfly: lane g sums terms g, g + G, ... in
    two accumulators by parity, the butterfly adds lane g + off to lane g
    for off = G / 2, ..., 1; with one-hot terms every term arrives exactly
    once, and the pairing is the tree's."""
    t = torch.arange(1, 71, dtype=torch.float32)
    for G in (1, 2, 8, 32):
        h, l = dl._butterfly(*dl._lane_sums(t, torch.zeros_like(t), G))
        assert float(h) == float(t.sum()) and float(l) == 0.0
    th = torch.tensor([1.0] + [2.0 ** -30] * 31)
    h, l = dl._butterfly(*dl._lane_sums(th, torch.zeros_like(th), 32))
    assert float(h) + float(l) == 1.0 + 31 * 2.0 ** -30
    # lane 1 holds terms 1, 5 (a0) and 3 (a1) of six with G = 2
    sh, sl = dl._lane_sums(torch.tensor([0.0, 1.0, 0.0, 2.0, 0.0, 4.0]),
                           torch.zeros(6), 2)
    assert sh.tolist() == [0.0, 7.0] and sl.tolist() == [0.0, 0.0]
    v = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, 2.0 ** -24])
    h, l = dl._butterfly(v, torch.zeros_like(v))   # (1 + u) + (u + u)
    assert float(h) + float(l) == 1.0 + 3 * 2.0 ** -24


def test_qr_lanes_mirror_the_kernels_split():
    """The launch split K1q computes from the shape (csrc/df_qr.cu
    threads_for, coef_lanes, row_lanes) at the paths' shapes: 256 threads
    for the Poisson (60, 30), 8 lanes a column and 4 a row at its last
    step; 512 a CTA of the cluster routes, whose 32-row bands at
    (512, 256) take 2 lanes a column and 16 a row at step 255, 32 lanes
    a column at step 1."""
    assert dl.qr_threads(60, 30, "cta") == 256
    assert (dl.coef_lanes(256, 60, 29), dl.row_lanes(256, 60, 29)) == (8, 4)
    assert dl.row_lanes(256, 60, 0) == 1
    assert dl.qr_threads(2, 2, "cta") == 32
    assert dl.qr_threads(128, 128, "cta") == 512
    assert dl.qr_threads(512, 256, "cluster") == 512
    assert dl.qr_threads(1024, 512, "gmem") == 512
    assert (dl.coef_lanes(512, 32, 255), dl.row_lanes(512, 32, 255)) == \
        (2, 16)
    assert dl.coef_lanes(512, 32, 1) == 32
    assert dl.coef_lanes(512, 3, 1) == 4      # no more lanes than rows
    for T, rows, j in ((32, 2, 1), (256, 60, 30), (512, 64, 600)):
        G, H = dl.coef_lanes(T, rows, j), dl.row_lanes(T, rows, j)
        assert G & (G - 1) == 0 and H & (H - 1) == 0
        assert 1 <= G <= 32 and 1 <= H <= 32 and T % G == T % H == 0


@pytest.mark.parametrize("B,decades", [(64, 6), (37, 2), (2, 0)])
def test_df_chol_model_holds_the_plain_versions_accuracy(B, decades):
    """df_chol_block's right-looking order in torch: ||L L^T - A|| / ||A||
    within 2x the plain version's plus 2^-46, lower-triangular, L within
    1e-12 relative of the plain version's at condition 1e6."""
    A = _spd(B, B, decades)
    L = _joined(dl.df_chol_model(*_pair(A)))
    PL = _joined(dc._df_chol_unblocked_reference(*_pair(A)))
    assert np.array_equal(np.tril(L), L)
    assert dl.chol_backward_error(L, A) <= \
        2.0 * dl.chol_backward_error(PL, A) + 2.0 ** -46
    assert np.linalg.norm(L - PL) <= 1e-12 * np.linalg.norm(PL)


@pytest.mark.parametrize("m,B", [(192, 64), (70, 13), (5, 40)])
def test_df_trsm_model_holds_the_plain_versions_accuracy(m, B):
    """df_trsm_rlt's right-looking order in torch: ||X L^T - A|| /
    (||X|| ||L||) within 2x the plain version's plus 2^-46, X within
    1e-13 relative of the plain version's."""
    A = np.random.default_rng(m + B).normal(size=(m, B))
    L = _tril(B, B)
    X = _joined(dl.df_trsm_model(*_pair(A), *_pair(L)))
    PX = _joined(dc._df_trsm_rlt_reference(*_pair(A), *_pair(L)))
    assert dl.trsm_backward_error(X, L, A) <= \
        2.0 * dl.trsm_backward_error(PX, L, A) + 2.0 ** -46
    assert np.linalg.norm(X - PX) <= 1e-13 * np.linalg.norm(PX)


def test_backward_error_helpers():
    A = _spd(12, 3)
    L = np.linalg.cholesky(A)
    assert dl.chol_backward_error(L, A) < 1e-15
    X = np.random.default_rng(1).normal(size=(5, 12))
    assert dl.trsm_backward_error(X, L, X @ L.T) < 1e-15
    Q, R = np.linalg.qr(A)
    back, orth = dl.qr_backward_errors(Q, R, A)
    assert back < 1e-14 and orth < 1e-14
    assert DF_UNIT < dl.qr_backward_errors(Q + 1e-6, R, A)[1]


@pytest.mark.slow
def test_df_loops_match_the_jax_packages_loops():
    """The JAX package's df_qr, _df_chol_unblocked and _df_trsm_rlt on the
    same inputs as the port's wrappers (the plain loops on the CPU) and
    K1q's order on its cluster split: the same deficient columns, Q within
    1e-13 and
    the Cholesky factor (of an SPD block with kappa 1e2, so kappa(L) = 10)
    and the substitution within 1e-13 relative."""
    import jax.numpy as jnp
    from xerus_tpu.ops import df32 as jdf
    from xerus_tpu.ops import mixed_precision as jmp
    jchol = importlib.import_module("xerus_tpu.ops.df_cholesky")

    def jpair(x):
        return tuple(jnp.asarray(v) for v in jdf.df_from_f64(x))

    def jjoin(p):
        return jdf.df_to_f64(np.asarray(p[0]), np.asarray(p[1]))

    a = _qr_input(96, 48, 11, True)
    (jq, jr) = jmp.df_qr(*jpair(a))
    JQ, JR = jjoin(jq), jjoin(jr)
    (q, r) = mp.df_qr(*_pair(a))
    (mq, mr, _bad) = dl.df_qr_model(*_pair(a), ctas=16)
    for Q, R in ((_joined(q), _joined(r)), (_joined(mq), _joined(mr))):
        assert np.abs(Q - JQ).max() <= 1e-13
        assert np.array_equal(np.diag(R) == 0.0, np.diag(JR) == 0.0)
    A = _spd(64, 2, decades=2)
    JL = jjoin(jchol._df_chol_unblocked(*jpair(A)))
    L = _joined(dc._df_chol_unblocked(*_pair(A)))
    assert np.linalg.norm(L - JL) / np.linalg.norm(JL) <= 1e-13
    X = np.random.default_rng(4).normal(size=(192, 64))
    Lt = _tril(64, 5)
    JX = jjoin(jchol._df_trsm_rlt(*jpair(X), *jpair(Lt)))
    TX = _joined(dc._df_trsm_rlt(*_pair(X), *_pair(Lt)))
    assert np.linalg.norm(TX - JX) / np.linalg.norm(JX) <= 1e-13


@pytest.mark.parametrize("case", ["qr_60x30", "qr_1000x30", "chol_64",
                                  "trsm_192x64"])
def test_plain_loops_match_the_jax_fixture(case):
    """The port's plain loops (the wrappers on the CPU) against the JAX
    package's outputs on the same inputs: the same deficient columns, Q
    within 1e-13, L and X within 1e-13 relative."""
    x, jax_out = df_loops_jax.inputs(), df_loops_jax.load()
    if case.startswith("qr"):
        q, r = mp.df_qr(*_pair(x[case]))
        Q, R = _joined(q), _joined(r)
        JR = jax_out[case + "_R"]
        assert np.abs(Q - jax_out[case + "_Q"]).max() <= 1e-13
        assert np.array_equal(np.diag(R) == 0.0, np.diag(JR) == 0.0)
        assert (np.diag(JR) == 0.0).sum() == 3
        assert np.abs(R - JR).max() <= 1e-13 * np.abs(JR).max()
    elif case == "chol_64":
        L = _joined(dc._df_chol_unblocked(*_pair(x[case])))
        JL = jax_out["chol_64_L"]
        assert np.linalg.norm(L - JL) / np.linalg.norm(JL) <= 1e-13
    else:
        X = _joined(dc._df_trsm_rlt(*_pair(x[case]),
                                    *_pair(x["trsm_L_64"])))
        JX = jax_out["trsm_192x64_X"]
        assert np.linalg.norm(X - JX) / np.linalg.norm(JX) <= 1e-13


@pytest.mark.parametrize("case,ctas", [("qr_60x30", 1), ("qr_1000x30", 16),
                                       ("qr_1000x30", 1), ("chol_64", 1),
                                       ("trsm_192x64", 1)])
def test_kernel_order_models_match_the_jax_fixture(case, ctas):
    """The kernels' orders in torch against the JAX package's outputs on
    the same inputs: K1q's on route cta (one band) and on the cluster
    routes' 16 bands, the same deficient columns, Q within 1e-13, R within
    1e-13 of R's largest entry; K1c's right-looking block and panel, L and
    X within 1e-13 relative."""
    x, jax_out = df_loops_jax.inputs(), df_loops_jax.load()
    if case.startswith("qr"):
        q, r, bad = dl.df_qr_model(*_pair(x[case]), ctas=ctas)
        Q, R = _joined(q), _joined(r)
        JR = jax_out[case + "_R"]
        assert np.abs(Q - jax_out[case + "_Q"]).max() <= 1e-13
        assert bad == list(np.diag(JR) == 0.0) and sum(bad) == 3
        assert np.abs(R - JR).max() <= 1e-13 * np.abs(JR).max()
    elif case == "chol_64":
        L = _joined(dl.df_chol_model(*_pair(x[case])))
        JL = jax_out["chol_64_L"]
        assert np.linalg.norm(L - JL) / np.linalg.norm(JL) <= 1e-13
    else:
        X = _joined(dl.df_trsm_model(*_pair(x[case]),
                                     *_pair(x["trsm_L_64"])))
        JX = jax_out["trsm_192x64_X"]
        assert np.linalg.norm(X - JX) / np.linalg.norm(JX) <= 1e-13


@pytest.mark.slow
def test_jax_fixture_is_the_jax_packages_output():
    """tests/data/df_loops_jax.npz is what the JAX package's loops give
    on df_loops_jax.inputs() now, bit for bit."""
    fresh, stored = df_loops_jax.jax_outputs(), df_loops_jax.load()
    assert sorted(fresh) == sorted(stored)
    for k in fresh:
        assert np.array_equal(fresh[k], stored[k]), k
