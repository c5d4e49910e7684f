"""How far rounding and the SVD routine move ``dmrg_solve`` on the d=32
rank-30 QTT Poisson system of the north-star solve
(``qtt_poisson_instance(32, 30, 0xBAADF00D)``, ``max_rank=30``, 8
half-sweeps).

Runs the solve from the instance's right-canonical start, from the same
cores handed over as not canonical (``dmrg_solve`` then canonicalizes
them itself: the same tensor in another gauge), and from the start with
its cores scaled entrywise by 1 + s N(0, 1) noise (s = 1e-15, 1e-13,
numpy seed 0), and prints one JSON line each: the SVD routine of the
sweeps' two-site splits, the relative residual and the ranks.
On the card (K5, the Jacobi SVD of ``ops/small_eig.py``) unless ``--cpu``
(LAPACK gesdd, the object layer's CPU SVD); ``--cpu --gesvd`` splits with LAPACK's gesvd through
scipy instead:

    python3 -m xerus_tpu_torch.examples.dmrg_solve_sensitivity [--cpu [--gesvd]]
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np


def _lapack_gesvd(M):
    """Thin SVD of a CPU matrix or batch by LAPACK's gesvd (scipy)."""
    import torch
    from scipy.linalg import svd
    mats = M.reshape((-1,) + tuple(M.shape[-2:])).numpy()
    parts = [svd(m, full_matrices=False, lapack_driver="gesvd")
             for m in mats]
    return tuple(torch.from_numpy(np.stack([p[i] for p in parts]).reshape(
        tuple(M.shape[:-2]) + parts[0][i].shape)) for i in range(3))


def main() -> None:
    import xerus_tpu_torch as xt
    from xerus_tpu_torch.examples.poisson import qtt_poisson_instance
    from xerus_tpu_torch.ops import dmrg_kernels

    xs, A_np, b_np = qtt_poisson_instance(32, 30, 0xBAADF00D)
    on_cpu = "--cpu" in sys.argv
    device = "cpu" if on_cpu else xt.cuda_device()
    routine = "jacobi" if not on_cpu else "gesdd"
    if on_cpu and "--gesvd" in sys.argv:
        dmrg_kernels.thin_svd = _lapack_gesvd
        routine = "gesvd"
    rng = np.random.default_rng(0)
    cases = [("canonical start", xs, True), ("not canonical", xs, False)]
    for s in (1e-15, 1e-13):
        cases.append((f"noise {s:g}", [c * (1 + s * rng.standard_normal(
            c.shape)) for c in xs], True))
    with xt.host() if on_cpu else contextlib.nullcontext():
        for name, cores, canonical in cases:
            x = xt.convert.tt_from_numpy(cores, canonicalized=canonical,
                                         device=device)
            A = xt.convert.tt_from_numpy(A_np, operator=True, device=device)
            b = xt.convert.tt_from_numpy(b_np, device=device)
            res = xt.dmrg_solve(A, x, b, max_rank=30, num_half_sweeps=8)
            print(json.dumps({"start": name, "device": str(device),
                              "svd": routine, "residual": repr(res),
                              "ranks": x.ranks()}), flush=True)


if __name__ == "__main__":
    main()
