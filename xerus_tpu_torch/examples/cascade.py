"""Signal-cascade Markov master equation (SLIM operator + implicit Euler).

Counterpart of ``xerus_tpu/examples/cascade.py``, the port of the
reference's flagship "cascade" example
(its doc/jekyll/_posts/1000-10-10-cascade.md): a genetic
signal cascade of ``num_proteins`` species, each holding 0..n-1 copies.
Protein 1 is created at constant rate 0.7; protein i+1 is created at rate
x_i/(x_i+5); every protein decays at rate 0.07*x_i.  The generator A of
the master equation dP/dt = A P has the SLIM TT-operator form (P. Gelss
et al., 2017, Example 4.1)

    A = [S*  L  I] x [[I 0 0] [M 0 0] [S L I]] x ... x [[I] [M] [S]]

built here component-by-component through the index DSL, exactly as the
reference page does.  Time stepping is implicit Euler, each step solved
with ALS_SPD, with one-norm renormalization (probabilities sum to 1).
Everything runs on the TT objects' device.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np

from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor, TTOperator
from ..network.network import TensorNetwork
from ..indexing.index import Index, indices
from .. import algorithms as _alg


def create_M(n: int) -> Tensor:
    """Creation event: -1 on the diagonal, +1 on the first subdiagonal
    (cascade.md create_M)."""
    M = -1.0 * Tensor.identity([n, n])
    for i in range(n - 1):
        M[[i + 1, i]] = 1.0
    return M


def create_L(n: int) -> Tensor:
    """Coupling weights diag(i / (i+5)) — the probability that protein i
    triggers creation of protein i+1 (cascade.md create_L)."""
    L = Tensor([n, n])
    for i in range(n):
        L[[i, i]] = i / (i + 5.0)
    return L


def create_S(n: int) -> Tensor:
    """Destruction event at rate 0.07*x: 0.07*(-i on the diagonal, +(i+1)
    on the first superdiagonal) (cascade.md create_S)."""
    S = Tensor([n, n])
    for i in range(n):
        S[[i, i]] = -float(i)
    for i in range(n - 1):
        S[[i, i + 1]] = float(i + 1)
    return 0.07 * S


def cascade_operator(num_proteins: int, max_num_per_site: int = 32) -> TTOperator:
    """SLIM TT-operator of the cascade generator (cascade.md
    create_operator): rank-3 MPO over ``num_proteins`` sites."""
    n = max_num_per_site
    i, j, k, l = indices(4)

    M = create_M(n)
    S = create_S(n)
    L = create_L(n)
    Sstar = 0.7 * M + S
    I = Tensor.identity([n, n])

    A = TTOperator(2 * num_proteins)

    comp = Tensor()
    comp(i, j, k, l) << (
        Sstar(j, k) * Tensor.dirac([1, 3], 0)(i, l)
        + L(j, k) * Tensor.dirac([1, 3], 1)(i, l)
        + I(j, k) * Tensor.dirac([1, 3], 2)(i, l))
    A.set_component(0, comp)

    if num_proteins > 2:
        comp = Tensor()
        comp(i, j, k, l) << (
            I(j, k) * Tensor.dirac([3, 3], [0, 0])(i, l)
            + M(j, k) * Tensor.dirac([3, 3], [1, 0])(i, l)
            + S(j, k) * Tensor.dirac([3, 3], [2, 0])(i, l)
            + L(j, k) * Tensor.dirac([3, 3], [2, 1])(i, l)
            + I(j, k) * Tensor.dirac([3, 3], [2, 2])(i, l))
        for c in range(1, num_proteins - 1):
            A.set_component(c, comp)

    comp = Tensor()
    comp(i, j, k, l) << (
        I(j, k) * Tensor.dirac([3, 1], 0)(i, l)
        + M(j, k) * Tensor.dirac([3, 1], 1)(i, l)
        + S(j, k) * Tensor.dirac([3, 1], 2)(i, l))
    A.set_component(num_proteins - 1, comp)

    return A


def one_norm(x: TTTensor) -> float:
    """<x, ones> — the 1-norm under the all-entries-positive assumption
    (cascade.md one_norm)."""
    j = Index()
    return float(x(j & 0) * TTTensor.ones(list(x.dimensions))(j & 0))


def implicit_euler(A: TTOperator, x: TTTensor, step_size: float, n: int,
                   conv_eps: float = 1e-4, num_half_sweeps: int = 100,
                   verbose: bool = False,
                   residuals: Optional[list] = None) -> List[TTTensor]:
    """n implicit-Euler steps of dP/dt = A P: solve (I - tau*A) x_new = x
    with ALS_SPD each step, then renormalize to unit one-norm
    (cascade.md implicit_euler)."""
    op = TTOperator.identity(list(A.dimensions)) - step_size * A

    j, k = indices(2)
    our_als = copy.copy(_alg.ALS_SPD)
    our_als.convergenceEpsilon = conv_eps
    our_als.numHalfSweeps = num_half_sweeps

    results = [x]
    next_x = TTTensor(x)
    for it in range(n):
        our_als(op, next_x, x)

        norm = one_norm(next_x)
        next_x /= norm

        if verbose or residuals is not None:
            res = (op(j / 2, k / 2) * next_x(k & 0) - x(j & 0)).frob_norm()
            if residuals is not None:
                residuals.append(float(res))
            if verbose:
                print(f"done itr {it} residual: {res} one-norm: {norm}")

        x = TTTensor(next_x)
        results.append(x)

    return results


def mean_concentration(x: TTTensor, protein: int) -> float:
    """Expected copy number of one protein: weight its mode with
    (0,1,2,...) and contract ones into every other mode
    (cascade.md get_mean_concentration)."""
    n_sites = x.degree()
    k, l = indices(2)
    result = TensorNetwork(x)
    n = x.dimensions[protein]
    weights = Tensor.from_function([n], lambda idx: float(idx[0]))
    for j in range(n_sites):
        vec = weights if j == protein else Tensor.ones([result.dimensions[0]])
        out = TensorNetwork()
        out(l & 0) << result(k, l & 1) * vec(k)
        result = out
    return float(result[[]])


def run_cascade(num_proteins: int = 10, num_steps: int = 200,
                step_size: float = 1.0, rank_x: int = 3,
                max_num_per_site: int = 32,
                verbose: bool = False) -> List[TTTensor]:
    """The complete example (cascade.md main): start from the
    zero-proteins dirac state (plus a tiny rank-broadening perturbation)
    and evolve ``num_steps`` implicit-Euler steps."""
    A = cascade_operator(num_proteins, max_num_per_site)

    start = TTTensor.dirac([max_num_per_site] * num_proteins, 0)
    start.use_dense_representations()
    start += 1e-14 * TTTensor.random(
        list(start.dimensions), [rank_x - 1] * (start.degree() - 1))

    return implicit_euler(A, start, step_size, num_steps, verbose=verbose)


def mean_concentration_table(results: List[TTTensor]) -> np.ndarray:
    """(num_steps+1, num_proteins) matrix of mean copy numbers
    (cascade.md print_mean_concentrations_to_file, in-memory)."""
    return np.array([[mean_concentration(res, p)
                      for p in range(res.degree())] for res in results])
