"""The JAX package's df column loops on fixed inputs, kept as a fixture.

The port's kernels K1q and K1c (xerus_tpu_torch/ops/df_loops.py) run only
on a CUDA card, where the JAX package is not installed.  This module makes
their inputs from seeds with numpy and stores what the JAX package's loops
give on them (``xerus_tpu.ops.mixed_precision.df_qr``,
``xerus_tpu.ops.df_cholesky._df_chol_unblocked`` and ``_df_trsm_rlt``, on
the CPU, joined to float64) in ``tests/data/df_loops_jax.npz``, so a card
test can hold the kernels to the JAX package and not only to the port's
own plain loops.  Regenerate with

    JAX_PLATFORMS=cpu python tests/df_loops_jax.py

tests/test_torch_df_loops.py checks in its slow tier that the file is what
the JAX package gives now, and in its default tier holds the port's plain
loops to it.
"""

import importlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "df_loops_jax.npz")


def qr_input(m, r, seed, deficient):
    """A Gaussian (m, r) matrix; ``deficient``: columns r // 3, r // 2 and
    r - 1 made dependent (a multiple, zero, a combination)."""
    a = np.random.Generator(np.random.PCG64(seed)).normal(size=(m, r))
    if deficient:
        a[:, r // 3] = 2.0 * a[:, 1]
        a[:, r // 2] = 0.0
        a[:, r - 1] = a[:, 0] - 3.0 * a[:, 2]
    return a


def inputs():
    """CGS2 at the Poisson solve's (60, 30) (K1q route cta) and at
    (1000, 30) (route cluster), each with three deficient columns; a
    (64, 64) Cholesky block of condition 1e2; a (192, 64) panel and its
    (64, 64) lower-triangular factor."""
    rng = np.random.default_rng(2)
    Q, _ = np.linalg.qr(rng.normal(size=(64, 64)))
    rng = np.random.default_rng(5)
    L = np.tril(rng.normal(size=(64, 64)), -1) * 0.1 + np.diag(
        rng.uniform(0.5, 2.0, size=64))
    return {"qr_60x30": qr_input(60, 30, 21, True),
            "qr_1000x30": qr_input(1000, 30, 22, True),
            "chol_64": (Q * np.logspace(0, -2, 64)) @ Q.T,
            "trsm_192x64": np.random.default_rng(4).normal(size=(192, 64)),
            "trsm_L_64": L}


def jax_outputs():
    """The JAX package's loops on ``inputs()``, joined to float64: Q and
    R of each QR, the Cholesky factor L, the substitution's X."""
    import jax.numpy as jnp
    from xerus_tpu.ops import df32 as jdf
    from xerus_tpu.ops import mixed_precision as jmp
    jchol = importlib.import_module("xerus_tpu.ops.df_cholesky")

    def pair(x):
        return tuple(jnp.asarray(v) for v in jdf.df_from_f64(x))

    def joined(p):
        return jdf.df_to_f64(np.asarray(p[0]), np.asarray(p[1]))

    x = inputs()
    out = {}
    for key in ("qr_60x30", "qr_1000x30"):
        q, r = jmp.df_qr(*pair(x[key]))
        out[key + "_Q"], out[key + "_R"] = joined(q), joined(r)
    out["chol_64_L"] = joined(jchol._df_chol_unblocked(*pair(x["chol_64"])))
    out["trsm_192x64_X"] = joined(jchol._df_trsm_rlt(
        *pair(x["trsm_192x64"]), *pair(x["trsm_L_64"])))
    return out


def load():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(HERE))
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(FIXTURE, **jax_outputs())
    print(f"wrote {FIXTURE}: {sorted(load())}")
