"""ROADMAP fault 7 and its repair in K2's plain version, on the CPU.

A power step's image W = Gn (Gn V) squares the conditioning of one product
of Gn; on a bond whose kept spectrum is graded past float32's reach its
one-stage Newton-Schulz orthonormalization ends at the cap of 48 without
reaching 64 eps, and with exactly rounded products (each float32 product
computed in float64 and rounded once) every such step does, so the bond
never certifies and takes the SVD fallback.  The repair takes such a step
again from the same V in two stages, orth(Gn V), then orth(Gn Q1): the
same subspace, each stage the conditioning of one product.

The small bond is ``k2_grid.graded_bond`` at ``GRADED_BOND``, (128, 128)
keep 64; the bars are the reference's own for K2 in float32
(tests/test_pallas_lowering.py): truncation errors within 5e-6 of the SVD
truncation's, and on a clear subspace the reconstructions within 5e-6 of
||cur||.  The slow tier holds the repaired plain version to the bonds 0
and 14 of the d=32 rank-512 -> 256 rounding, where fault 7 was found."""

import numpy as np
import pytest
import torch

from xerus_tpu_torch.examples import k2_grid
from xerus_tpu_torch.examples.k2_grid import (GRADED_BOND, ExactProducts,
                                              graded_bond, plain_run)
from xerus_tpu_torch.ops import gemm_exact as ge

KEEP = GRADED_BOND["keep"]
# the reference's float32 bars (tests/test_pallas_lowering.py)
ERR_BAR, REC_BAR = 5e-6, 5e-6


@pytest.fixture(autouse=True)
def one_thread():
    """Torch's CPU products on one thread: the same sums whatever thread
    count a test worker has, and no oversubscription beside the other
    workers (thousands of small products)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bond():
    return graded_bond(**GRADED_BOND)


def test_one_stage_power_steps_end_at_the_cap(bond, monkeypatch):
    """The fault: with the retry off and exactly rounded products, the
    power steps' orthonormalizations end at the Newton-Schulz cap, and
    the bond does not certify within the 128 outer steps."""
    power_orth = ge._power_orth

    def one_stage(orth, Gn, GV, retry):
        return power_orth(orth, Gn, GV, False)

    one_stage.retries = one_stage.stops = 0
    monkeypatch.setattr(ge, "_power_orth", one_stage)
    cur = torch.tensor(bond, dtype=torch.float32)
    r = plain_run(cur, KEEP, KEEP, exact=True)
    max_outer = ge._gemm_exact_tuning(torch.float32)[0]
    assert not r["certified"] and r["outer"] == max_outer
    assert r["retries"] == 0 and r["orths_at_the_cap"] >= max_outer // 2


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("products", ["torch", "exact"])
def test_two_stage_retry_certifies_the_graded_bond(bond, products, order):
    """The repair: with torch's float32 products and with exactly rounded
    ones, under three orders of the bond's columns (G = cur cur^T and
    every step's exact value stay; only the sums' order changes), the
    truncation certifies (no SVD fallback) after two-stage retries, and
    its kept subspace is the SVD truncation's within the float32 bars."""
    perm = (np.arange(bond.shape[1]) if order == 0
            else np.random.default_rng(100 + order).permutation(
                bond.shape[1]))
    cur = torch.tensor(bond[:, perm], dtype=torch.float32)
    ge.reset_counters()
    if products == "exact":
        with ExactProducts():
            us, vt = ge.trunc_step_gemm_exact(cur, KEEP, KEEP)
    else:
        us, vt = ge.trunc_step_gemm_exact(cur, KEEP, KEEP)
    cnt = ge.trunc_step_gemm_exact
    assert cnt.calls == 1 and cnt.svd_fallbacks == 0
    assert cnt.retries > 0
    A = cur.double().numpy()
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    rec_svd = (U[:, :KEEP] * s[:KEEP]) @ Vt[:KEEP]
    err_svd = np.sum(s[KEEP:] ** 2) / np.sum(s ** 2)
    rec = us.double().numpy() @ vt.double().numpy()
    err = np.linalg.norm(A - rec) ** 2 / np.linalg.norm(A) ** 2
    assert abs(err - err_svd) < ERR_BAR, (err, err_svd)
    assert np.linalg.norm(rec - rec_svd) / np.linalg.norm(A) < REC_BAR


def test_retry_stops_where_the_first_stage_ends_at_the_cap(monkeypatch):
    """A cliff inside the kept columns (12 singular values from 1 to 0.1,
    then 1e-6 and less; keep 16), exactly rounded products: the first
    power step's retry ends its first stage, orth(Gn V), at the cap too,
    so it stops there, the step keeps its one-stage result, and no later
    step retries.  The truncation's outputs are then bitwise those of the
    reference's one-stage steps."""
    cur = torch.tensor(graded_bond(32, 40, 12, 10.0, 1e5, 1),
                       dtype=torch.float32)
    mask = torch.ones(16)
    tuning = ge._gemm_exact_tuning(torch.float32)
    ge.reset_counters()
    with ExactProducts():
        two = ge._gemm_exact_body(cur, mask, *tuning)
    assert ge._power_orth.retries == ge._power_orth.stops == 1
    power_orth = ge._power_orth

    def one_stage(orth, Gn, GV, retry):
        return power_orth(orth, Gn, GV, False)

    monkeypatch.setattr(ge, "_power_orth", one_stage)
    with ExactProducts():
        one = ge._gemm_exact_body(cur, mask, *tuning)
    assert bool(two[3]) and two[4] == one[4]
    assert all(torch.equal(a, b) for a, b in zip(two[:4], one[:4]))


def test_float64_takes_no_retry(bond):
    """The retry is float32's: in float64 the same bond runs the
    reference's one-stage steps."""
    retries0 = ge._power_orth.retries
    mask = torch.ones(KEEP, dtype=torch.float64)
    ge._gemm_exact_body(torch.tensor(bond), mask,
                        *ge._gemm_exact_tuning(torch.float64))
    assert ge._power_orth.retries == retries0


@pytest.mark.slow
@pytest.mark.parametrize("n", [0, 14])
def test_rank512_fault7_bonds_certify(n):
    """Bonds 0 and 14 of the d=32 rank-512 -> 256 rounding, the two that
    fell back on K2's grid route: the repaired plain version certifies
    each with torch's products and with exactly rounded ones, where it
    retries and no orthonormalization that converges takes more than 44
    of the 48 steps."""
    cur, keep, cap = k2_grid.bond_inputs(512, 256, torch.device("cpu"))[n]
    for exact in (True, False):
        r = plain_run(cur, keep, cap, exact)
        assert r["certified"], (n, exact, r)
        if exact:
            assert r["retries"] > 0 and r["ns_max_converged"] <= 44, r


@pytest.mark.slow
def test_rank256_edge_bonds_sit_at_the_cap():
    """The d=32 rank-256 -> 128 rounding (the cluster route's bonds): with
    exactly rounded products the first and the last bond the sweep visits
    (0 and 16 of the svd rounding's trunc inputs) end their power steps'
    one-stage orthonormalizations at the cap and certify through two-stage
    retries; the bonds between take none.  So a retry there on the card is
    a property of those bonds, not of K2's sums (chip_smoke's
    ``_retries_at_the_cap``)."""
    inputs = k2_grid.bond_inputs(256, 128, torch.device("cpu"))
    for n in (0, 8, 16):
        cur, keep, cap = inputs[n]
        r = plain_run(cur, keep, cap, exact=True)
        assert r["certified"], (n, r)
        assert (r["retries"] > 0) == (n != 8), (n, r)
