"""The port's QTT Poisson instance (numpy only) and its host-f64 check."""

import numpy as np

from xerus_tpu_torch.examples import host_poisson_residual, qtt_poisson_instance

SEED = 0xBAADF00D


def _dense_op(cores):
    t = np.ones((1, 1, 1))
    for c in cores:
        t = np.einsum("ija,amnb->imjnb", t, c).reshape(
            t.shape[0] * 2, t.shape[1] * 2, c.shape[3])
    return t[:, :, 0]


def _kron_sum_laplace(d):
    """sum_k I x .. x L x .. x I, L = [[2, -1], [-1, 2]]: the operator the
    rank-2 MPO represents (a Laplacian on the 2^d grid of d binary modes)."""
    L = np.array([[2.0, -1.0], [-1.0, 2.0]])
    total = np.zeros((2 ** d, 2 ** d))
    for k in range(d):
        term = np.ones((1, 1))
        for i in range(d):
            term = np.kron(term, L if i == k else np.eye(2))
        total += term
    return total


def _full(cores):
    t = np.ones((1, 1))
    for c in cores:
        t = np.einsum("ia,anb->inb", t, c).reshape(-1, c.shape[2])
    return t.reshape(-1)


def test_instance_structure_small():
    xs, A, b = qtt_poisson_instance(6, 4, SEED)
    n = 2 ** 6
    np.testing.assert_array_equal(_dense_op(A), _kron_sum_laplace(6))
    np.testing.assert_array_equal(_full(b), np.ones(n))
    assert [c.shape for c in xs] == [(1, 2, 2), (2, 2, 4), (4, 2, 4),
                                     (4, 2, 4), (4, 2, 2), (2, 2, 1)]
    for c in xs[1:]:                       # right-canonical: core at site 0
        m = c.reshape(c.shape[0], -1)
        assert np.abs(m @ m.T - np.eye(m.shape[0])).max() < 1e-13


def test_instance_north_star_shapes_and_seed():
    """d=32, rank 30: 22 interior sites of ranks (30, 30), whose local
    systems (1800 rows) pass the df matvec kernel's 2^20 gate."""
    xs, A, b = qtt_poisson_instance(32, 30, SEED)
    xs2, _, _ = qtt_poisson_instance(32, 30, SEED)
    assert all(np.array_equal(p, q) for p, q in zip(xs, xs2))
    big = [i for i, c in enumerate(xs)
           if (c.shape[0] * c.shape[1] * c.shape[2]) ** 2 >= 1 << 20]
    assert big == list(range(5, 27))
    assert len(A) == len(b) == 32


def test_host_residual_of_exact_and_wrong_solutions():
    _, A, b = qtt_poisson_instance(6, 4, SEED)
    x = np.linalg.solve(_kron_sum_laplace(6), np.ones(2 ** 6))
    # x as a TT by successive SVDs (exact, ranks <= 8)
    cores, rest, rl = [], x.reshape(1, -1), 1
    for _ in range(5):
        u, s, vt = np.linalg.svd(rest.reshape(rl * 2, -1), full_matrices=False)
        r = int(np.sum(s > 1e-14 * s[0]))
        cores.append(u[:, :r].reshape(rl, 2, r))
        rest, rl = s[:r, None] * vt[:r], r
    cores.append(rest.reshape(rl, 2, 1))
    assert host_poisson_residual(cores, A, b) < 1e-12
    wrong = [c.copy() for c in cores]
    wrong[0] = 1.01 * wrong[0]
    assert abs(host_poisson_residual(wrong, A, b) - 0.01) < 1e-6
