"""Randomized TT-SVD of a dense tensor.

Counterpart of ``xerus_tpu/algorithms/random_svd.py``, the re-design of
include/xerus/algorithms/randomSVD.h (the reference ships the algorithm
commented out): the exact unfolding TT (``TTTensor.from_dense_unfolding``,
factorization-free) rounded by the randomized sweep
(``ops/round_kernels._round_randomized`` through ``round_fast``), the same
randomize-then-orthogonalize mathematics.  The sketch is drawn from a
``torch.Generator`` seeded 0 on the tensor's device; the JAX package drew
it from ``jax.random``, so the two agree exactly only where the ranks
represent the tensor.
"""

from __future__ import annotations

from typing import Sequence, Union

from ..config import require
from ..tt.ttnetwork import TTTensor


def randomTTSVD(tensor, ranks: Union[int, Sequence[int]],
                oversampling: Union[int, Sequence[int], None] = None
                ) -> TTTensor:
    """Quasi-optimal TT approximation of a dense tensor at the given
    per-bond ``ranks`` by randomized sketching (randomSVD.h:30-124).

    ``oversampling`` is accepted for the reference's signature and only
    validated: the sweep manages its own oversampling.  Sparse tensors
    densify."""
    tt = TTTensor.from_dense_unfolding(tensor)
    n_bonds = tt.num_ranks()
    if not isinstance(ranks, int):
        ranks = [int(r) for r in ranks]
        require(len(ranks) == n_bonds,
                f"need {n_bonds} ranks, got {len(ranks)}")
    if oversampling is not None and not isinstance(oversampling, int):
        require(len(list(oversampling)) == n_bonds,
                f"need {n_bonds} oversampling entries")
    tt.round_fast(ranks, method="randomized")
    return tt
