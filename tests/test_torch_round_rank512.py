"""The d=32 rank-512 -> 256 gemm_exact rounding, whose bonds take K2's grid
route on the card: its static bond schedule against the JAX package's
rule, the grid route's launch plan and workspace (the host's mirrors of
csrc/gemm_exact_grid.cuh), and, in the slow tier, the port's plain
rounding against the JAX package's at reduced depth (d=20, 3 bonds of the
grid route's shape), seeded with numpy.

Only gauge-free quantities are compared: log-norms and the relative
distance of the two rounded TTs, at slice 2's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xerus_tpu.ops import tt_kernels as jtk
from xerus_tpu_torch.convert import cores_to_torch
from xerus_tpu_torch.examples import (bench_round_instance, cpu_round_sweep,
                                      host_tt_distance, host_tt_log_norm)
from xerus_tpu_torch.ops import gemm_exact as ge
from xerus_tpu_torch.ops import round_kernels as rk

SEED = 0xBAADF00D
RANK, TARGET = 512, 256
# slice 2's bars (chip_smoke.py ROUND_F64_BAR, GE_VS_SVD_BAR)
ROUND_F64_BAR, PORT_VS_JAX_BAR = 2e-4, 1e-4


def _true_k(shapes):
    true_k, kprev = [], 1
    for i in range(len(shapes) - 1):
        k = min(kprev * shapes[i][1], shapes[i][2])
        true_k.append((kprev, k))
        kprev = k
    true_k.append((kprev, shapes[-1][2]))
    return true_k


def _jax_schedule(true_k, n_of, k_in, max_ranks, eps, min_bucket):
    """The JAX package's static truncation schedule, as written in
    xerus_tpu/ops/tt_kernels.py _round_sweep_segmented (lines 1425-1450),
    on its own _p2."""
    d = len(true_k)
    sched = []
    for i in range(d - 1, 0, -1):
        rl, rb = true_k[i]
        n = n_of[i]
        keep = min(int(max_ranks[i - 1]), rl, n * k_in)
        Bk = max(jtk._p2(k_in), min_bucket)
        if eps == 0.0 and keep == n * k_in and Bk == k_in:
            mode = "full_cols"
        elif eps == 0.0 and keep == rl:
            mode = "full_rows"
        else:
            mode = "trunc"
        sched.append(dict(i=i, rl=rl, rb=rb, n=n, k_in=k_in, keep=keep,
                          mode=mode, Bl=max(jtk._p2(rl), min_bucket),
                          Bb=max(jtk._p2(rb), min_bucket), Bk=Bk,
                          Bkeep=max(jtk._p2(keep), min_bucket)))
        k_in = keep
    return sched


def test_rank512_schedule_is_the_jax_packages():
    """The d=32 rank-512 -> 256 instance: the port's schedule is the JAX
    package's, and K2 sees 15 trunc-mode bonds (sites 9..23), each at
    (Bl, n Bk) = (512, 512) with keep and bucket 256."""
    shapes = [c.shape for c in bench_round_instance(32, 2, RANK, SEED)]
    true_k = _true_k(shapes)
    args = (true_k, [2] * 32, 1, [TARGET] * 31, 0.0, 32)
    sched = rk._round_schedule(*args)
    ref = _jax_schedule(*args)
    assert sched == ref
    trunc = [s for s in sched if s["mode"] == "trunc"]
    assert sorted(s["i"] for s in trunc) == list(range(9, 24))
    assert all((s["Bl"], s["n"] * s["Bk"], s["keep"], s["Bk"])
               == (512, 512, 256, 256) for s in trunc)


@pytest.mark.parametrize("B,M,K", [(512, 512, 256), (1024, 1024, 512),
                                   (512, 1024, 256), (264, 200, 8),
                                   (300, 70, 33)])
@pytest.mark.parametrize("grid", [132, 114, 1])
def test_grid_plan_covers_every_tile_once(B, M, K, grid):
    """Every product of a grid-route launch: its work items cover each
    output tile (those on and above the diagonal of a symmetric product)
    exactly once, each tile's k slices partition [0, k) in order, split
    partials fit the workspace's GRID_MAX_ITEMS, and the padded sizes are
    the 64-multiples of the shape."""
    pad = lambda n: -(-n // 64) * 64
    for prod in ge.grid_plan(B, M, K, grid):
        m, n, k, s = prod["m"], prod["n"], prod["k"], prod["splits"]
        assert m % 32 == n % 32 == k % 64 == 0
        assert {m, n, k} <= {pad(B), pad(M), pad(K)}
        tiles = {(i, j) for i in range(m // 32) for j in range(n // 32)
                 if not prod["sym"] or i <= j}
        assert prod["tiles"] == len(tiles)
        assert 1 <= s <= min(prod["units"], ge.GRID_MAX_SPLIT)
        if s > 1:
            assert len(prod["items"]) <= ge.GRID_MAX_ITEMS
        seen = {}
        for i, j, k0, k1 in prod["items"]:
            assert k0 < k1 and k0 % 64 == k1 % 64 == 0
            seen.setdefault((i, j), []).append((k0, k1))
        assert set(seen) == tiles
        for ranges in seen.values():
            assert len(ranges) == s and ranges[0][0] == 0
            assert ranges[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("B,M,K", [(512, 512, 256), (1024, 1024, 512),
                                   (264, 200, 8)])
def test_grid_layout_holds_every_buffer(B, M, K):
    """The grid route's workspace: buffers in order, 64-element aligned,
    each as large as the padded array it holds, within the wrapper's
    WORKSPACE_CAP in float64 at the rounding's shapes."""
    pB, pK, pM = (-(-n // 64) * 64 for n in (B, K, M))
    lay = ge.grid_layout(B, M, K)
    need = {"curp": pB * pM, "G": pB * pB, "Gn": pB * pB, "V": pB * pK,
            "X1": pB * pK, "X2": pB * pK, "GV": pB * pK, "W": pB * pK,
            "Y1": pB * pK, "P": pK * pK, "Ya": pK * pM, "Yb": pK * pM,
            "part": ge.GRID_MAX_ITEMS * 32 * 32,
            "slots": 2 * max(pB * pB, pB * pK, pK * pM) // 1024,
            "colvec": max(pB, pK), "tickets": ge.GRID_MAX_ITEMS}
    names = list(need) + ["total"]
    offsets = [lay[n] for n in names]
    assert offsets == sorted(offsets) and offsets[0] == 0
    for name, nxt in zip(names, names[1:]):
        assert lay[name] % 64 == 0 and lay[nxt] - lay[name] >= need[name]
    assert lay["total"] * 8 <= ge.WORKSPACE_CAP


@pytest.mark.slow
def test_rank512_rounding_matches_the_jax_package():
    """d=20, rank 512 -> 256, float32 on the CPU (3 trunc bonds at
    (512, 512) keep 256): the port's gemm_exact rounding (K2's plain
    version) against the JAX package's _round_sweep_segmented on the same
    cores: log-norms within 1e-4 of each other and within 2e-4 of the f64
    chain's, and truncation errors ||X - Y|| / ||X|| within 10% of each
    other.

    The cuts are near-degenerate (s_256 / s_257 about 0.98), where the
    certificates stop on f32 noise: each certified rounding keeps a valid
    subspace whose truncation error lies up to 25% above the SVD chain's,
    so the two roundings lie about a truncation error apart (0.012 of
    ||X|| here), not 1e-4; the log-norms and the errors agree.

    The port certifies every bond the JAX package certifies: the JAX
    package's decision on each bond is read from its own
    _gemm_exact_body on the port's input to that bond, with x64 off.  The
    first bond sits on ROADMAP fault 7: its power steps' one-stage
    Newton-Schulz orthonormalization needs the whole 48-step cap, and
    whether the 48th step lands under 64 eps depends on the last bits of
    the products (the JAX package's XLA products make it); the port takes
    a step that ends at the cap again in two stages and certifies the
    bond whatever the products' last bits."""
    host = bench_round_instance(20, 2, RANK, SEED)
    jc = [jnp.asarray(c, jnp.float32) for c in host]
    with jax.enable_x64(False):
        j = jtk.tt_round_sweep_segmented(jc, TARGET, method="gemm_exact")
        j = [np.asarray(c, np.float64) for c in j]
    ge.reset_counters()
    seen = []
    body = ge._gemm_exact_body

    def capture(cur, mask, *tuning):
        out = body(cur, mask, *tuning)
        seen.append((cur.clone(), mask.clone(), bool(out[3])))
        return out

    capture.ns_iters = capture.ns_row_iters = 0
    try:
        ge._gemm_exact_body = capture
        t = rk.tt_round_sweep_segmented(list(cores_to_torch(
            host, torch.device("cpu"))), TARGET, method="gemm_exact")
    finally:
        ge._gemm_exact_body = body
    assert ge.trunc_step_gemm_exact.calls == 3
    fallbacks = ge.trunc_step_gemm_exact.svd_fallbacks
    retries = ge.trunc_step_gemm_exact.retries
    tuning = ge._gemm_exact_tuning(torch.float32)
    with jax.enable_x64(False):
        jax_ok = [bool(jtk._gemm_exact_body(
            jnp.asarray(cur.numpy()), jnp.asarray(mask.numpy()),
            jnp.float32, 1e-30, *tuning)[3]) for cur, mask, _ok in seen]
    port_ok = [ok for _c, _m, ok in seen]
    t = [c.numpy().astype(np.float64) for c in t]
    lj, lt = host_tt_log_norm(j), host_tt_log_norm(t)
    chain = cpu_round_sweep(host, TARGET)
    l64 = host_tt_log_norm(chain)
    x = [np.asarray(c, np.float64) for c in host]
    nx = np.exp(host_tt_log_norm(x))
    ej, et, e64 = (host_tt_distance(x, y) / nx for y in (j, t, chain))
    print(f"d=20 rank {RANK} -> {TARGET} gemm_exact, float32 on the CPU: "
          f"log-norm port {lt!r}, JAX {lj!r}, f64 chain {l64!r}; f32-vs-f64 "
          f"port {abs(lt - l64) / abs(l64):.3e}, JAX "
          f"{abs(lj - l64) / abs(l64):.3e}; truncation error port {et:.6e},"
          f" JAX {ej:.6e}, f64 SVD chain {e64:.6e}; port to JAX "
          f"{host_tt_distance(t, j) / nx:.3e}; the port's SVD fallbacks "
          f"{fallbacks}, two-stage retries {retries}; bonds certified by "
          f"the port {port_ok}, by the JAX package's body {jax_ok}")
    assert all(p or not q for p, q in zip(port_ok, jax_ok))
    assert fallbacks == port_ok.count(False)
    assert abs(lt - lj) <= PORT_VS_JAX_BAR * abs(lj), (lt, lj)
    assert abs(lj - l64) <= ROUND_F64_BAR * abs(l64), (lj, l64)
    assert abs(lt - l64) <= ROUND_F64_BAR * abs(l64), (lt, l64)
    assert abs(et - ej) <= 0.1 * ej, (et, ej)
    assert e64 <= min(et, ej)
