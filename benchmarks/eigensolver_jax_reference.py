"""The JAX package's eigensolver and two-site SPD solver on the CPU in
float64: the reference numbers the PyTorch port's chip check holds its
card runs to.

Workload 4 (the d=32 Heisenberg chain's two-site DMRG ground state):

The instance is benchmarks/all_workloads.py's workload 4 bit for bit
(``set_seed(0xBAADF00D + 4)``, ``heisenberg_mpo(32)``,
``TTTensor.random([2] * 32, 4)``), solved by
``smallest_eigenvalue(H, g, sites=2, max_rank=R, num_sweeps=6)`` with
``solver="lanczos", shift=0.0`` (the padded-stack Lanczos sweeps) at each
rank R of ``--ranks`` and, with ``--exact``, ``solver="exact"`` at rank 16.
One JSON line per run: energy, eig_residual ||H g - E g|| in TT form, max
rank, wall seconds.

``--dmrg-solve``: ``dmrg_solve(A, x, b, max_rank=30, num_half_sweeps=8)``
on the d=32 rank-30 QTT Poisson system of the north-star solve (the
instance of ``xerus_tpu_torch/examples/poisson.py``, numpy only), its
relative residual and ranks.

    JAX_PLATFORMS=cpu python benchmarks/eigensolver_jax_reference.py \\
        [--ranks 16,32,64] [--exact] [--dmrg-solve]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import xerus_tpu as xe  # noqa: E402
from xerus_tpu import TTTensor  # noqa: E402
from xerus_tpu.examples import heisenberg_mpo  # noqa: E402


def run(solver: str, max_rank: int) -> dict:
    xe.set_seed(0xBAADF00D + 4)
    H = heisenberg_mpo(32)
    g = TTTensor.random([2] * 32, 4)
    kw = {"shift": 0.0} if solver == "lanczos" else {}
    t0 = time.perf_counter()
    lam = xe.smallest_eigenvalue(H, g, sites=2, max_rank=max_rank,
                                 num_sweeps=6, solver=solver, **kw)
    secs = time.perf_counter() - t0
    var = (xe.apply_operator(H, g) - lam * g).frob_norm()
    return {"workload": "dmrg_heisenberg_d32", "package": "xerus_tpu",
            "platform": "cpu", "dtype": "float64", "solver": solver,
            "max_rank_arg": max_rank, "ground_energy": repr(float(lam)),
            "eig_residual": repr(float(var)), "max_rank": max(g.ranks()),
            "seconds": round(secs, 3)}


def dmrg_solve_poisson() -> dict:
    from xerus_tpu.core.tensor import Tensor
    from xerus_tpu.ops.dmrg_kernels import dmrg_solve
    from xerus_tpu_torch.examples.poisson import qtt_poisson_instance
    xs, A_np, b_np = qtt_poisson_instance(32, 30, 0xBAADF00D)

    def tt(cls, cores):
        return cls._make([Tensor.from_ndarray(c) for c in cores])

    x = tt(TTTensor, xs)
    t0 = time.perf_counter()
    res = dmrg_solve(tt(xe.TTOperator, A_np), x, tt(TTTensor, b_np),
                     max_rank=30, num_half_sweeps=8)
    return {"solve": "dmrg_solve", "package": "xerus_tpu", "platform": "cpu",
            "dtype": "float64", "d": 32, "max_rank": 30,
            "residual": repr(float(res)), "ranks": x.ranks(),
            "seconds": round(time.perf_counter() - t0, 3)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="16")
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--dmrg-solve", action="store_true")
    args = ap.parse_args()
    for r in [int(v) for v in args.ranks.split(",") if v]:
        print(json.dumps(run("lanczos", r)), flush=True)
    if args.exact:
        print(json.dumps(run("exact", 16)), flush=True)
    if args.dmrg_solve:
        print(json.dumps(dmrg_solve_poisson()), flush=True)


if __name__ == "__main__":
    main()
