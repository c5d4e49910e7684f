"""Completion targets and the instances of the completion slice.

``inverse_index_norm`` and ``inverse_index_ratio`` are the closed-form
targets of ``xerus_tpu/examples/completion.py``.  ``workload5_instance``
rebuilds benchmark workload 5 (``benchmarks/all_workloads.py``: d=5,
n=4, rank 3, 400 samples) from its seed, drawing in the JAX package's
order: the truth as ``TTTensor.random`` draws it (one normal array per
core, then canonicalized to component 0), normalized; 400 distinct
positions by the measurement set's rejection loop; a rank-1 start.
``completion_instance`` builds the full-width instance the same way (d=10,
n=4, rank 8, 20,000 samples).  Cores are float64 numpy arrays; they cross
to the port through ``convert.cores_to_torch``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..algorithms.adf import reduce_to_maximal_ranks
from ..algorithms.measurements import SinglePointMeasurementSet
from ..convert import cores_to_torch


def inverse_index_norm(position: Sequence[int],
                       additive_const: float = 1.0) -> float:
    norm_sqr = sum((float(i) + additive_const) ** 2 for i in position)
    return 1.0 / math.sqrt(norm_sqr)


def inverse_index_ratio(position: Sequence[int],
                        additive_const: float = 1.0) -> float:
    s = sum((float(position[j]) + 1.0) / (float(position[j + 1])
                                          + additive_const)
            for j in range(len(position) - 1))
    return 1.0 / (additive_const + s)


class CompletionInstance(NamedTuple):
    truth: List[np.ndarray]                    # normalized, canonical at 0
    measurements: SinglePointMeasurementSet    # measured on the truth
    start: List[np.ndarray]                    # rank-1 start, canonical at 0
    max_ranks: List[int]


def _canonicalize_left(cores: List[np.ndarray]) -> List[np.ndarray]:
    """Right-to-left QR sweep in float64 (the represented tensor is
    unchanged)."""
    cores = [np.array(c, np.float64) for c in cores]
    for i in range(len(cores) - 1, 0, -1):
        rl, n, rr = cores[i].shape
        q, r = np.linalg.qr(cores[i].reshape(rl, n * rr).T)
        cores[i] = q.T.reshape(q.shape[1], n, rr)
        cores[i - 1] = np.einsum("anb,bk->ank", cores[i - 1], r.T)
    return cores


def random_tt(dims: Sequence[int], rank: int, rng: np.random.Generator
              ) -> List[np.ndarray]:
    """``TTTensor.random(dims, rank)``'s draw: ranks reduced to the maximal
    ones, one ``rng.normal`` array per core in order, canonical at 0."""
    d = len(dims)
    ranks = reduce_to_maximal_ranks([rank] * (d - 1), dims)
    rs = [1] + ranks + [1]
    return _canonicalize_left([rng.normal(size=(rs[k], int(dims[k]), rs[k + 1]))
                               for k in range(d)])


def completion_instance(d: int = 10, n: int = 4, rank: int = 8,
                        num: int = 20_000, seed: int = 0xBAADF00D + 10
                        ) -> CompletionInstance:
    """Truth of ``rank`` normalized to unit Frobenius norm, ``num`` sampled
    entries of it, a rank-1 start and the maximal ranks, in the draw order
    of ``benchmarks/all_workloads.py``'s workload 5."""
    rng = np.random.Generator(np.random.PCG64(seed))
    dims = [n] * d
    truth = random_tt(dims, rank, rng)
    truth[0] = truth[0] / np.linalg.norm(truth[0])   # canonical at 0
    ms = SinglePointMeasurementSet.random(num, dims, rng=rng)
    ms.measure(list(cores_to_torch(truth, torch.device("cpu"),
                                   torch.float64)))
    start = random_tt(dims, 1, rng)
    return CompletionInstance(truth, ms, start,
                              reduce_to_maximal_ranks([rank] * (d - 1), dims))


def workload5_instance(seed: int = 0xBAADF00D + 5) -> CompletionInstance:
    """Benchmark workload 5: d=5, n=4, rank 3, 400 samples."""
    return completion_instance(5, 4, 3, 400, seed)


def full_grid_positions(dims: Sequence[int]) -> np.ndarray:
    """All prod(dims) positions as an (N, d) int64 array in row-major
    order, the order of the dense tensor's flattened entries."""
    grid = np.indices([int(n) for n in dims]).reshape(len(dims), -1).T
    return np.ascontiguousarray(grid, dtype=np.int64)


def host_full_tensor(cores: Sequence[np.ndarray]) -> np.ndarray:
    """The TT contracted to its flattened entries in float64 on the
    host."""
    t = np.ones((1, 1))
    for c in cores:
        c = np.asarray(c, np.float64)
        t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape(-1)
