"""The JAX package's own readings on chip_smoke.py's rounding instance,
recomputed on the CPU: the reference numbers behind the bars that
``phase_rounding_rest`` holds the port's card runs to.

The instance is ``bench_round_instance(32, 2, 256, 0xBAADF00D)`` rounded to
128 (bench.py workload 1), its float64 LAPACK chain ``cpu_round_sweep``,
and the 1e-9 cliff of ``chip_smoke.DF_CLIFF``.  Each reading:

- ``df_round``: ``xerus_tpu.ops.df_rounding.tt_round_df_from_f64``, the
  log-norm's relative distance to the chain (``chip_smoke.JAX_DF_REACH``:
  the reference's reach, short of the 1e-10 the port meets on the card);
- ``df_cliff``: the same on the cliff with eps 1e-7, whether its interior
  ranks equal the svd-eps chain's and its relative distance to it
  (``JAX_DF_REACH``);
- ``df_solve``: ``df_solve_spd_chol`` on tests/test_df32.py's kappa=1e10
  construction at n=1800, relative residual with 3 and 5 refinement steps
  (``DF_SOLVE``);
- ``cholqr``: ``tt_round_sweep_uniform(method="cholqr")`` in float32 and
  float64, the log-norm's relative distance to the chain (``CHOLQR_BAR``);
- ``sensitivity``: for each method of ``round_fast``'s card-vs-``host()``
  check, the relative TT distance between the float64 rounding of the
  cores and of the cores moved by 1e-15 relative (numpy seed
  0xBAADF00D, chip_smoke's perturbation) (``CARD_HOST_BARS``).

Run it as a script to print one JSON line per reading (about 10 minutes
on one CPU core, most of it XLA compiles):

    JAX_PLATFORMS=cpu python tests/test_torch_rounding_reference.py \\
        [df_round df_cliff df_solve cholqr sensitivity]

The slow tier (``-m slow``) recomputes each reading and holds chip_smoke's
constants to it."""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xerus_tpu_torch.examples import (bench_round_instance,  # noqa: E402
                                      cliff_instance, cpu_round_sweep,
                                      host_tt_distance, host_tt_log_norm)

METHODS = ("cholqr", "gram_parallel", "subspace_parallel", "streaming")


def _instance():
    host = [c.astype(np.float64) for c in bench_round_instance(
        cs.ROUND_D, cs.ROUND_N, cs.ROUND_RANK, cs.SEED)]
    chain = cpu_round_sweep(host, cs.ROUND_TARGET)
    return host, chain, host_tt_log_norm(chain)


def df_round():
    from xerus_tpu.ops.df_rounding import tt_round_df_from_f64
    host, chain, ref = _instance()
    out = tt_round_df_from_f64(host, cs.ROUND_TARGET)
    return {"log_norm_rel": abs(host_tt_log_norm(out) - ref) / abs(ref),
            "distance_rel": host_tt_distance(out, chain) / np.exp(ref)}


def df_cliff():
    from xerus_tpu.ops.df_rounding import tt_round_df_from_f64
    host, _chain, _ref = _instance()
    sig, scale, eps = cs.DF_CLIFF
    cl = cliff_instance(host, sig, scale)
    chain = cpu_round_sweep(cl, cs.ROUND_RANK, eps=eps)
    out = tt_round_df_from_f64(cl, cs.ROUND_RANK, eps=eps)
    return {"ranks_equal": ([c.shape[2] for c in out[:-1]]
                            == [c.shape[2] for c in chain[:-1]]),
            "distance_rel": (host_tt_distance(out, chain)
                             / np.exp(host_tt_log_norm(chain)))}


def df_solve():
    import jax.numpy as jnp
    from xerus_tpu.ops.df32 import df_from_f64, df_to_f64
    from xerus_tpu.ops.df_cholesky import df_solve_spd_chol
    n, kappa, _steps = cs.DF_SOLVE
    A = cs._spd(n, kappa)
    b = A @ np.random.default_rng(3).normal(size=n)
    Ah, Al = df_from_f64(A)
    bh, bl = df_from_f64(b)
    out = {}
    for steps in (3, 5):
        with jax.enable_x64(False), jax.default_matmul_precision("highest"):
            xh, xl = df_solve_spd_chol(
                jnp.asarray(Ah), jnp.asarray(Al), jnp.asarray(bh),
                jnp.asarray(bl), refine_iters=steps)
        x = df_to_f64(np.asarray(xh), np.asarray(xl))
        out[f"residual_{steps}_steps"] = float(
            np.linalg.norm(A @ x - b) / np.linalg.norm(b))
    return out


def _jax_round(method, cores):
    import jax.numpy as jnp
    from xerus_tpu.ops import tt_kernels as jtk
    js = [jnp.asarray(c) for c in cores]
    if method == "streaming":
        out = jtk.tt_round_streaming_uniform(js, cs.ROUND_TARGET)
    else:
        out = jtk.tt_round_sweep_uniform(js, cs.ROUND_TARGET, method=method)
    return [np.asarray(c, np.float64) for c in out]


def cholqr():
    host, _chain, ref = _instance()
    out = {}
    for dtype in (np.float32, np.float64):
        h = _jax_round("cholqr", [c.astype(dtype) for c in host])
        out[np.dtype(dtype).name] = abs(host_tt_log_norm(h) - ref) / abs(ref)
    return out


def sensitivity():
    host, _chain, _ref = _instance()
    rng = np.random.default_rng(cs.SEED)
    pert = [c * (1.0 + 1e-15 * rng.standard_normal(c.shape)) for c in host]
    out = {}
    for method in METHODS:
        a = _jax_round(method, host)
        b = _jax_round(method, pert)
        out[method] = host_tt_distance(a, b) / np.exp(host_tt_log_norm(a))
    return out


READINGS = {"df_round": df_round, "df_cliff": df_cliff,
            "df_solve": df_solve, "cholqr": cholqr,
            "sensitivity": sensitivity}


# chip_smoke's constants against the readings they were taken from; the
# readings are deterministic on one CPU, 1% covers another BLAS's order

@pytest.mark.slow
def test_df_round_reach_is_the_jax_reading():
    got = df_round()
    assert got["log_norm_rel"] == pytest.approx(cs.JAX_DF_REACH[0], rel=1e-2)
    assert got["log_norm_rel"] > cs.DF_ROUND_BAR


@pytest.mark.slow
def test_df_cliff_reach_is_the_jax_reading():
    got = df_cliff()
    assert got["ranks_equal"]
    assert got["distance_rel"] == pytest.approx(cs.JAX_DF_REACH[1], rel=1e-2)
    assert got["distance_rel"] > cs.DF_CLIFF_BAR


@pytest.mark.slow
def test_df_solve_needs_five_steps_in_jax():
    got = df_solve()
    assert got["residual_3_steps"] > cs.DF_SOLVE_BAR
    assert got["residual_5_steps"] <= cs.DF_SOLVE_BAR
    assert cs.DF_SOLVE[2] == 5


@pytest.mark.slow
def test_cholqr_bars_hold_for_jax():
    got = cholqr()
    for dtype, bar in cs.CHOLQR_BAR.items():
        assert got[dtype] <= bar, (dtype, got[dtype], bar)


@pytest.mark.slow
def test_card_host_bars_are_ten_times_the_jax_sensitivity():
    got = sensitivity()
    for method in METHODS:
        want = max(cs.ROUND_REST_CARD_HOST, 10.0 * got[method])
        assert cs.CARD_HOST_BARS[method] == pytest.approx(want, rel=1e-2), (
            method, got[method])


if __name__ == "__main__":
    for name in sys.argv[1:] or READINGS:
        t0 = time.perf_counter()
        reading = READINGS[name]()
        print(json.dumps({"reading": name, **reading,
                          "seconds": time.perf_counter() - t0}), flush=True)
