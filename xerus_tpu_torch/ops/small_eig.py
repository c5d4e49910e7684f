"""K4 and K5: the batched small symmetric eigensolver and thin SVD of the
two-site DMRG sweeps, by Jacobi rotations in float64 with no host read.

The JAX package solves the Lanczos / LOBPCG Ritz problems and the masked
split with ``jnp.linalg.eigh`` / ``jnp.linalg.svd`` inside its compiled
half-sweep programs (``xerus_tpu/ops/dmrg_kernels.py:305``, ``:365``,
``:586``).  On the card the port's ``torch.linalg`` calls read each
call's ``info`` back to the host, so no half-sweep could be captured.
Here the two calls are hand-written CUDA kernels (``csrc/jacobi.cu``) that
write a per-matrix status to the device and count failures in a device
health record; the solves read it once each (``check_health``),
outside any captured region, and raise if a matrix failed.

- ``small_eigh(A)``: (B, m, m) symmetric (the lower triangle is read) ->
  ascending eigenvalues (B, m), orthonormal eigenvectors (B, m, m) with
  eigenvector k in column k, status (B,);
- ``small_svd(A)``: (B, M, N) -> U (B, M, K), S (B, K) descending,
  Vh (B, K, N), status (B,), K = min(M, N); where sigma is zero the
  factor of K rows (Vh, or U where M < N) gets an orthonormal completion,
  and the other factor is orthonormal by construction.

Both compute in float64: float32 inputs are promoted and the results cast
back.  On CPU tensors the wrappers run the plain versions
(``small_eigh_plain``, ``small_svd_plain``: the kernels' algorithms step
for step, the same pair order, pivots, tests and sweep cap, in torch); on
CUDA tensors they launch the kernel or raise.  A status > 0 is the sweeps
a matrix took; <= 0 means it did not converge in ``CAP`` sweeps or is not
finite.  The plans (``eigh_plan``, ``svd_plan``) are the only source of a
launch's route, cluster size, threads and shared-memory size:

- K4 route ``cta`` (m <= 32): one CTA of 4 warps per matrix, the
  round-robin over ``mm`` = 4, 8, 16, 24 or 32 indices; route ``cluster``
  (m > 32): one thread-block cluster per matrix, ``mm`` = m rounded up to
  32;
- K5: one cluster per matrix (of one CTA up to 32 columns), a warp per
  column pair of a round, after a column-pivoted Householder QR; ``mm``
  = min(M, N) rounded up to a multiple of twice the cluster size;
- route ``gmem`` (K4 and K5), where the columns do not fit the cluster's
  shared memory: the cluster route with them in a global workspace the
  wrapper allocates, bitwise the cluster route at the same plan (K4 past
  m = 448, K5 from 360 columns of a square block).  K4 runs to m = 8,000
  and K5 to min(M, N) = 1,024; past that a plan raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple

import torch

from .. import build
from . import programs

EPS = 2.0 ** -52            # float64 machine epsilon
CAP = 60                    # sweeps before a matrix counts as failed
SMEM_MAX = 232_448          # dynamic shared memory a block may opt in to
CTA, CLUSTER, GMEM = "cta", "cluster", "gmem"
CTA_MM = (4, 8, 16, 24, 32)     # csrc/jacobi.cu's route-cta instantiations
EIGH_THREADS = 256          # K4 route cluster: threads per CTA
CLUSTER_MAX = 16            # CTAs in a cluster (non-portable size)
HEALTH = ("failures", "max_sweeps", "total_sweeps", "matrices",
          "rotations")


class JacobiPlan(NamedTuple):
    route: str      # cta, cluster or gmem
    mm: int         # indices of the round-robin (padded)
    ctas: int       # CTAs per matrix (1 on route cta)
    threads: int    # threads per CTA
    smem: int       # bytes of dynamic shared memory per CTA


def _eigh_cluster_bytes(m: int, mm: int, ctas: int, gmem: bool) -> int:
    """csrc/jacobi.cu EighLayout: per CTA 2 ppc + 2 column buffers of A
    and of V (m rows; none on route gmem), the own slots' published
    entries (2 each, two parities), every pair's rotation (5 each), the own
    slots' diagonal; ints: every pair's (p, q, orientation), the
    slot-to-buffer tables (two parities), 2 spares, 6 for the incoming
    columns, 4 flags."""
    pairs = mm // 2
    ppc = pairs // ctas
    cpc, nb = 2 * ppc, 0 if gmem else 2 * ppc + 2
    return 8 * (2 * nb * m + 5 * cpc + 5 * pairs) \
        + 4 * (3 * pairs + 2 * cpc + 2 + 6 + 4)


def _svd_bytes(R: int, C: int, mm: int, ctas: int, gmem: bool) -> int:
    """csrc/jacobi.cu SvdLayout: per CTA its cpc columns of W (R rows),
    cpc + 2 slot buffers of X and of V_J (C rows), the staged pivot
    column (R), none of these on route gmem; beta / tau / scale (3 C),
    column norms and sigma (cpc each), the warps' pivot candidates (2
    parities); ints: the pivots (C), the own columns' pivoted flags, the
    candidates' indices, the slot tables (two parities), 2 spares, 6 for
    the incoming columns, 4 flags."""
    ppc = mm // 2 // ctas
    cpc, nb = 2 * ppc, 0 if gmem else 2 * ppc + 2
    cols = 0 if gmem else R * cpc + R
    return 8 * (cols + 2 * nb * C + 3 * C + 2 * cpc + 2 * ppc) \
        + 4 * (C + cpc + 2 * ppc + 2 * cpc + 2 + 6 + 4)


def _pow2_at_most(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


@lru_cache(maxsize=None)
def eigh_plan(m: int, route: str = "", ctas: int = 0) -> JacobiPlan:
    """K4's plan for (m, m) matrices: route ``cta`` up to m = 32 (one CTA
    of 4 warps per matrix, 2 for ``mm`` = 4), else ``cluster`` with
    ``mm`` = m rounded up to 32 and, unless ``ctas`` forces a size, one CTA
    per 8 pairs up to 16 (rounded down to a power of two), or ``gmem``
    where the columns do not fit a CTA's shared memory.  ``route`` forces a
    route; a plan that cannot run raises ValueError."""
    if route not in ("", CTA, CLUSTER, GMEM):
        raise ValueError(f"small_eigh: no route {route!r}")
    if route in ("", CTA) and m <= CTA_MM[-1]:
        mm = next(x for x in CTA_MM if x >= m)
        warps = 2 if mm == 4 else 4
        return JacobiPlan(CTA, mm, 1, 32 * warps,
                          8 * (mm * (mm + 1) + 3 * mm))
    if route == CTA:
        raise ValueError(f"small_eigh: ({m}, {m}) is past route cta")
    mm = 32 * -(-m // 32)
    ctas = ctas or _pow2_at_most(min(CLUSTER_MAX, mm // 16))
    if ctas not in (1, 2, 4, 8, 16) or (mm // 2) % ctas:
        raise ValueError(f"small_eigh: {ctas} CTAs do not split "
                         f"{mm // 2} pairs")
    route = route or (CLUSTER if _eigh_cluster_bytes(m, mm, ctas, False)
                      <= SMEM_MAX else GMEM)
    smem = _eigh_cluster_bytes(m, mm, ctas, route == GMEM)
    if smem > SMEM_MAX:
        raise ValueError(f"small_eigh: ({m}, {m}) on {ctas} CTAs of route "
                         f"{route} needs {smem} bytes of shared memory a CTA")
    return JacobiPlan(route, mm, ctas, EIGH_THREADS, smem)


SVD_WARPS_MAX = 16          # K5: pairs (warps) a CTA at most
SVD_WARPS_GMEM = 32         # on route gmem


def _svd_ctas(pairs: int) -> int:
    """K5's default cluster size: the smallest with at most
    ``SVD_WARPS_MAX`` pairs a CTA, and 16 from 64 pairs on (a round's
    barrier costs more on 16 CTAs, but its pairs spread over more SMs,
    which won at (128, 128) and (256, 256) on an H100)."""
    if pairs >= 64:
        return CLUSTER_MAX
    n = 1
    while pairs > n * SVD_WARPS_MAX:
        n *= 2
    return n


@lru_cache(maxsize=None)
def svd_plan(M: int, N: int, ctas: int = 0, route: str = "") -> JacobiPlan:
    """K5's plan for (M, N) matrices (W of R = max(M, N) rows and
    C = min(M, N) columns): a cluster of ``ctas`` CTAs (default
    ``_svd_ctas``), a warp per pair, ``mm`` = C rounded up to a multiple
    of 2 ``ctas`` (the pad columns' pairs are skipped); route ``cluster``
    where its columns fit a CTA's shared memory, else ``gmem``.  ``route``
    forces a route; a plan that cannot run (more than 16 pairs a CTA, 32
    on route gmem, more than 16 CTAs, shared memory past a CTA's) raises
    ValueError."""
    if route not in ("", CLUSTER, GMEM):
        raise ValueError(f"small_svd: no route {route!r}")
    R, C = max(M, N), min(M, N)
    pairs = max((C + 1) // 2, 1)
    n = ctas or _svd_ctas(pairs)
    if n not in (1, 2, 4, 8, 16):
        raise ValueError(f"small_svd: no cluster of {n} CTAs")
    ppc = -(-pairs // n)
    mm = 2 * n * ppc
    if not route:
        route = CLUSTER if ppc <= SVD_WARPS_MAX and \
            _svd_bytes(R, C, mm, n, False) <= SMEM_MAX else GMEM
    warps = SVD_WARPS_GMEM if route == GMEM else SVD_WARPS_MAX
    if ppc > warps:
        raise ValueError(f"small_svd: {n} CTAs do not split {pairs} pairs "
                         f"into at most {warps} a CTA")
    smem = _svd_bytes(R, C, mm, n, route == GMEM)
    if smem > SMEM_MAX:
        raise ValueError(f"small_svd: ({M}, {N}) on {n} CTAs needs {smem} "
                         f"bytes of shared memory a CTA")
    return JacobiPlan(route, mm, n, 32 * ppc, smem)


def eigh_tol(m: int) -> float:
    return max(m, 1) * EPS


def svd_tol(M: int, N: int) -> float:
    """The orthogonality test's tolerance and the dead-column threshold
    (relative to ||A||_F): R eps."""
    return max(M, N, 1) * EPS


# ---------------------------------------------------------------------------
# the pair order and the slot ring of the kernels


def round_robin(n: int, mm: int = 0):
    """The kernels' parallel pair order over n indices padded to an even
    ``mm`` >= n (default n rounded up to even): a list of mm - 1 rounds,
    each a (p, q) pair of index lists with p < q; pairs reaching a pad
    index >= n are dropped."""
    mm = mm or n + (n & 1)
    rounds = []
    for k in range(mm - 1):
        pairs = [(min(a, b), max(a, b)) for a, b in
                 (ring_pair(mm, k, i) for i in range(mm // 2))]
        pairs = [(p, q) for p, q in pairs if q < n]
        rounds.append(([p for p, _ in pairs], [q for _, q in pairs]))
    return rounds


def ring_pos(mm: int, s: int) -> int:
    """The round-robin position of slot s: pair i holds positions i (slot
    2 i) and mm - 1 - i (slot 2 i + 1)."""
    return s // 2 if s % 2 == 0 else mm - 1 - s // 2


def ring_slot(mm: int, j: int) -> int:
    return 2 * j if j < mm // 2 else 2 * (mm - 1 - j) + 1


def ring_index(mm: int, k: int, s: int) -> int:
    """The index slot s holds in round k: position 0 stays, the others
    rotate by one a round."""
    j = ring_pos(mm, s)
    return 0 if j == 0 else 1 + (k + j - 1) % (mm - 1)


def ring_pair(mm: int, k: int, i: int):
    """The indices of pair i (slots 2 i, 2 i + 1) in round k."""
    return ring_index(mm, k, 2 * i), ring_index(mm, k, 2 * i + 1)


def ring_source(mm: int, s: int) -> int:
    """The slot whose column moves into slot s between two rounds."""
    j = ring_pos(mm, s)
    return ring_slot(mm, 0 if j == 0 else 1 if j == mm - 1 else j + 1)


# ---------------------------------------------------------------------------
# the plain versions: the kernels' steps in torch


def _rotation(a, b, g):
    """(c, s, t) of the rotation annihilating g in [[a, g], [g, b]] as the
    kernels compute it, by half angles: d = b - a, r = sqrt(d^2 + 4 g^2)
    ((d, 2g) scaled by a power of two past 1e150 or below 1e-150),
    h = (1 + |d| / r) / 2, c = h rsqrt(h), s = sign(d g) |g| rsqrt(h) / r,
    t = sign(d g) |g| / (r h); g must be nonzero where the result is
    used."""
    d, g2 = b - a, 2.0 * g
    h0 = torch.maximum(d.abs(), g2.abs())
    e = torch.frexp(torch.where(h0 > 0, h0, torch.ones_like(h0))).exponent
    e = torch.where((h0 > 1e150) | (h0 < 1e-150), e - 1,
                    torch.zeros_like(e))
    d, g2 = torch.ldexp(d, -e), torch.ldexp(g2, -e)
    x = torch.rsqrt(d * d + g2 * g2)
    h = 0.5 * (d.abs() * x + 1.0)
    gx = torch.where((d != 0) & (torch.signbit(d) != torch.signbit(g2)),
                     -0.5, 0.5) * g2.abs() * x
    rh = torch.rsqrt(h)
    return h * rh, gx * rh, gx * (1.0 / h)


def _off_diagonal(a, b, g, tol):
    """The kernels' relative test |g| > tol sqrt|a| sqrt|b|, computed as
    g^2 > tol^2 |a b| on (a, b, g) scaled by the power of two that brings
    the largest into [1, 2)."""
    h = torch.maximum(torch.maximum(a.abs(), b.abs()), g.abs())
    e = torch.frexp(torch.where(h > 0, h, torch.ones_like(h))).exponent - 1
    a, b, g = (torch.ldexp(x, -e) for x in (a, b, g))
    return g * g > tol * tol * (a * b).abs()


def _status(sweeps, converged, finite):
    """The kernels' per-matrix status: sweeps used where converged, minus
    that where not, -(CAP + 1) where not finite."""
    st = torch.where(converged, sweeps, -sweeps)
    return torch.where(finite, st, torch.full_like(st, -(CAP + 1))) \
        .to(torch.int32)


def _rounds(n: int, mm: int, dev):
    return [(torch.tensor(p, device=dev), torch.tensor(q, device=dev))
            for p, q in round_robin(n, mm) if p]


def small_eigh_plain(A: torch.Tensor, plan: JacobiPlan = None):
    """K4's algorithm in torch on any device: cyclic two-sided Jacobi in
    the round-robin order over the plan's ``mm`` indices, a round
    J^T A J with its 2 x 2 blocks set to their new diagonal and 0, the
    relative test |a_pq| > m eps sqrt|a_pp| sqrt|a_qq| (``_off_diagonal``),
    at most ``CAP``
    sweeps, ascending order (ties by index).  (B, m, m) -> (w (B, m),
    V (B, m, m), status (B,))."""
    dt = A.dtype
    B, m = A.shape[0], A.shape[-1]
    plan = plan or eigh_plan(m)
    A = torch.tril(A.double())
    A = A + torch.tril(A, -1).transpose(1, 2)
    V = torch.eye(m, dtype=torch.float64, device=A.device).repeat(B, 1, 1)
    finite = torch.isfinite(A).reshape(B, -1).all(1)
    tol = eigh_tol(m)
    sweeps = torch.zeros(B, dtype=torch.int64, device=A.device)
    converged = torch.zeros(B, dtype=torch.bool, device=A.device)
    rounds = _rounds(m, plan.mm, A.device)
    for _ in range(CAP):
        active = finite & ~converged
        if not bool(active.any()):
            break
        rotated = torch.zeros(B, dtype=torch.bool, device=A.device)
        for P, Q in rounds:
            app, aqq = A[:, P, P], A[:, Q, Q]
            apq = A[:, P, Q]
            rot = (apq != 0) & _off_diagonal(app, aqq, apq, tol) \
                & active[:, None]
            c, s, t = _rotation(app, aqq, apq)
            rotated |= rot.any(1)
            c = torch.where(rot, c, torch.ones_like(c))[:, :, None]
            s = torch.where(rot, s, torch.zeros_like(s))[:, :, None]
            r3 = rot[:, :, None]
            x, y = A[:, P, :], A[:, Q, :]
            A[:, P, :] = torch.where(r3, c * x - s * y, x)
            A[:, Q, :] = torch.where(r3, s * x + c * y, y)
            ct, st, rt = c.transpose(1, 2), s.transpose(1, 2), \
                r3.transpose(1, 2)
            for Mx in (A, V):
                x, y = Mx[:, :, P], Mx[:, :, Q]
                Mx[:, :, P] = torch.where(rt, ct * x - st * y, x)
                Mx[:, :, Q] = torch.where(rt, st * x + ct * y, y)
            dp = torch.where(rot, app - t * apq, app)
            dq = torch.where(rot, aqq + t * apq, aqq)
            A[:, P, P], A[:, Q, Q] = dp, dq
            zero = torch.zeros_like(apq)
            A[:, P, Q] = torch.where(rot, zero, A[:, P, Q])
            A[:, Q, P] = torch.where(rot, zero, A[:, Q, P])
        sweeps += active.long()
        converged |= active & ~rotated
    w = torch.diagonal(A, dim1=1, dim2=2)
    finite &= torch.isfinite(w).all(1)
    order = torch.sort(w, dim=1, stable=True).indices
    w = torch.gather(w, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(B, m, m))
    return w.to(dt), V.to(dt), _status(sweeps, converged, finite)


def _pivoted_qr(W: torch.Tensor):
    """K5's column-pivoted Householder QR of the (B, R, C) batch W, in
    place: step k takes the unpivoted column of the largest norm over rows
    k.. (ties by index), its reflector (LAPACK's dlarfg: beta =
    -sign(alpha) ||x||, tau = (beta - alpha) / beta, v = x / (alpha -
    beta) below the diagonal; tau = 0 where x is zero below it) and applies
    it to the unpivoted columns; a pivoted column is left as it was, its
    rows below k the reflector's unscaled x.  Returns (piv (B, C),
    beta, tau, scale (B, C)); R[i, k] is W[i, piv[k]] above the diagonal
    and beta[k] on it."""
    B, R, C = W.shape
    dev = W.device
    bi = torch.arange(B, device=dev)
    done = torch.zeros(B, C, dtype=torch.bool, device=dev)
    piv = torch.zeros(B, C, dtype=torch.int64, device=dev)
    beta, tau, scale = (torch.zeros(B, C, dtype=W.dtype, device=dev)
                        for _ in range(3))
    for k in range(C):
        n2 = (W[:, k:, :] * W[:, k:, :]).sum(1)
        n2 = torch.where(done, torch.full_like(n2, -1.0), n2)
        p = torch.argmax(n2, dim=1)
        piv[:, k] = p
        x = W[bi, :, p]                                  # (B, R)
        alpha, below = x[:, k], x[:, k + 1:]
        s2 = (below * below).sum(1)
        norm = torch.sqrt(alpha * alpha + s2)
        b = torch.where(s2 > 0, -torch.copysign(norm, alpha), alpha)
        t = torch.where(s2 > 0, (b - alpha) / torch.where(b != 0, b, 1.0),
                        torch.zeros_like(b))
        sc = torch.where(s2 > 0, 1.0 / torch.where(s2 > 0, alpha - b, 1.0),
                         torch.zeros_like(b))
        beta[:, k], tau[:, k], scale[:, k] = b, t, sc
        done[bi, p] = True
        Wk = W[:, k:, :]
        dot = Wk[:, 0, :] + sc[:, None] * (below[:, :, None]
                                           * Wk[:, 1:, :]).sum(1)
        f = torch.where(done, torch.zeros_like(dot), t[:, None] * dot)
        W[:, k, :] = Wk[:, 0, :] - f
        W[:, k + 1:, :] = Wk[:, 1:, :] - f[:, None, :] * (
            sc[:, None] * below)[:, :, None]
    return piv, beta, tau, scale


def _apply_q(W, piv, tau, scale, Z):
    """Q Z for the (B, R, C) reflectors of ``_pivoted_qr`` on W and the
    (B, R, K) Z, reflector C - 1 first: z -= tau (v^T z) v with v = 1 at
    row k and scale x below it."""
    B, R, C = W.shape
    bi = torch.arange(B, device=W.device)
    for k in range(C - 1, -1, -1):
        below = W[bi, k + 1:, piv[:, k]]                 # (B, R - k - 1)
        dot = Z[:, k, :] + scale[:, k, None] * (below[:, :, None]
                                                * Z[:, k + 1:, :]).sum(1)
        f = tau[:, k, None] * dot
        Z[:, k, :] = Z[:, k, :] - f
        Z[:, k + 1:, :] = Z[:, k + 1:, :] - f[:, None, :] * (
            scale[:, k, None] * below)[:, :, None]
    return Z


def small_svd_plain(A: torch.Tensor, plan: JacobiPlan = None):
    """K5's algorithm in torch on any device: W = A (M >= N) or A^T, R x C
    with C <= R; the column-pivoted Householder QR W P = Q R
    (``_pivoted_qr``); one-sided Jacobi on the columns of X = R^T with
    V_J, the round-robin order over the plan's ``mm``, rotation where both
    columns are alive (||x||^2 > (R eps ||A||_F)^2) and |x_p . x_q| >
    R eps ||x_p|| ||x_q||, at most ``CAP`` sweeps; sigma_i = ||x_i|| (0
    for a dead column), descending (ties by index); the left factor
    Q V_J, the right P X / sigma with the orthonormal completion for the
    zero sigma.  (B, M, N) -> (U, S, Vh, status); a matrix that is not
    finite gets NaN factors."""
    dt = A.dtype
    B, M, N = A.shape
    plan = plan or svd_plan(M, N)
    trans = M < N
    W = (A.transpose(1, 2) if trans else A).double().clone()
    R, C = W.shape[1:]
    dev = A.device
    tol = dead = svd_tol(M, N)
    f2 = (W * W).sum(1).sum(1)
    dead2 = dead * dead * f2
    finite = torch.isfinite(f2)
    W = torch.where(finite[:, None, None], W, torch.zeros_like(W))
    piv, beta, tau, scale = _pivoted_qr(W)
    # X[j, i] = R[i, j]: row i of R, W[i, piv[j]] right of the diagonal
    Rf = torch.gather(W[:, :C, :], 2, piv[:, None, :].expand(B, C, C))
    Rf = torch.triu(Rf, 1) + torch.diag_embed(beta)
    X = Rf.transpose(1, 2).contiguous()
    VJ = torch.eye(C, dtype=torch.float64, device=dev).repeat(B, 1, 1)
    sweeps = torch.zeros(B, dtype=torch.int64, device=dev)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = _rounds(C, plan.mm, dev)
    for _ in range(CAP):
        active = finite & ~converged
        if not bool(active.any()):
            break
        rotated = torch.zeros(B, dtype=torch.bool, device=dev)
        for P, Q in rounds:
            x, y = X[:, :, P], X[:, :, Q]
            al, be, ga = (x * x).sum(1), (y * y).sum(1), (x * y).sum(1)
            d2 = dead2[:, None]
            rot = (al > d2) & (be > d2) & (ga != 0) \
                & _off_diagonal(al, be, ga, tol) & active[:, None]
            c, s, _ = _rotation(al, be, ga)
            rotated |= rot.any(1)
            c = torch.where(rot, c, torch.ones_like(c))[:, None, :]
            s = torch.where(rot, s, torch.zeros_like(s))[:, None, :]
            r3 = rot[:, None, :]
            for Mx in (X, VJ):
                x, y = Mx[:, :, P], Mx[:, :, Q]
                Mx[:, :, P] = torch.where(r3, c * x - s * y, x)
                Mx[:, :, Q] = torch.where(r3, s * x + c * y, y)
        sweeps += active.long()
        converged |= active & ~rotated
    n2 = (X * X).sum(1)
    sig = torch.where(n2 > dead2[:, None], n2.sqrt(), torch.zeros_like(n2))
    order = torch.sort(sig, dim=1, descending=True, stable=True).indices
    sig = torch.gather(sig, 1, order)
    X = torch.gather(X, 2, order[:, None, :].expand(B, C, C))
    VJ = torch.gather(VJ, 2, order[:, None, :].expand(B, C, C))
    Y = torch.where(sig[:, None, :] > 0,
                    X / torch.where(sig > 0, sig, torch.ones_like(sig))
                    [:, None, :], torch.zeros_like(X))
    right = torch.zeros_like(Y)                         # P Y
    right.scatter_(1, piv[:, :, None].expand(B, C, C), Y)
    Z = torch.cat([VJ, VJ.new_zeros(B, R - C, C)], 1)
    left = _apply_q(W, piv, tau, scale, Z)
    for b in range(B):
        if bool(finite[b]) and not _complete(right[b],
                                             int((sig[b] > 0).sum())):
            finite[b] = False
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=dev)
    bad = ~torch.isfinite(f2)
    left, sig, right = (torch.where(bad.view(-1, *[1] * (t.dim() - 1)), nan,
                                    t) for t in (left, sig, right))
    U, Vh = (right, left.transpose(1, 2)) if trans \
        else (left, right.transpose(1, 2))
    return (U.contiguous().to(dt), sig.to(dt), Vh.contiguous().to(dt),
            _status(sweeps, converged, finite))


def _complete(Q: torch.Tensor, nonzero: int) -> bool:
    """Fill columns ``nonzero``.. of the (n, K) Q in place, each with the
    first canonical vector (ascending from the last one taken) whose part
    orthogonal to the columns before it, projected out twice, keeps a
    squared norm above 1 / 2n; normalized.  False if one was not found."""
    n, K = Q.shape
    trial = 0
    for k in range(nonzero, K):
        while trial < n:
            z = torch.zeros(n, dtype=Q.dtype, device=Q.device)
            z[trial] = 1.0
            for _ in range(2):
                z = z - Q[:, :k] @ (Q[:, :k].T @ z)
            n2 = float(z @ z)
            trial += 1
            if n2 > 0.5 / n:
                Q[:, k] = z / n2 ** 0.5
                break
        else:
            Q[:, k] = 0.0
            return False
    return True


# ---------------------------------------------------------------------------
# bindings, launches, the device health record

_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_longlong
_ARGTYPES = {
    "xerus_small_eigh": [_P] * 6 + [_I] * 7 + [_D, _I, _P],
    "xerus_small_svd": [_P] + [_L] * 3 + [_P] * 6 + [_I] * 9
    + [_D, _D, _I, _P],
}
# the C functions' return code for a cluster the card cannot schedule
UNSCHEDULABLE = 1000
_EIGH_ROUTE = {CTA: 0, CLUSTER: 1, GMEM: 2}     # csrc/jacobi.cu route codes


@lru_cache(maxsize=None)
def _fn(name: str):
    f = getattr(build.load_kernel_library("jacobi"), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = ctypes.c_int
    return f


_HEALTH: Dict[torch.device, torch.Tensor] = {}
# the last record check_health read, by HEALTH's names
last_health: Dict[str, int] = {}


def _key(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _health(dev) -> torch.Tensor:
    """The device's health record (int64, ``HEALTH``), made at its first
    launch, which must not be inside a captured region: a kernel adds to
    it."""
    dev = _key(dev)
    h = _HEALTH.get(dev)
    if h is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("small_eig: the first launch on a device "
                               "must run before any capture")
        h = _HEALTH[dev] = torch.zeros(len(HEALTH), dtype=torch.int64,
                                       device=dev)
    return h


def check_health(dev) -> Dict[str, int]:
    """Read and reset the health record of the card ``dev`` (one host
    read; nothing when no kernel has run there) and raise if a matrix
    failed.  Returns the record by ``HEALTH``'s names."""
    h = _HEALTH.get(_key(dev))
    if h is None:
        return {}
    vals = dict(zip(HEALTH, h.tolist()))
    h.zero_()
    last_health.clear()
    last_health.update(vals)
    if vals["failures"]:
        raise RuntimeError(
            f"small_eigh / small_svd: {vals['failures']} of "
            f"{vals['matrices']} matrices did not converge in {CAP} Jacobi "
            f"sweeps or were not finite")
    return vals


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_check(name: str, A: torch.Tensor, dims: int = 3):
    if A.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {A.device}")
    if A.dim() != dims:
        raise ValueError(f"{name}: needs a (B, M, N) batch, got shape "
                         f"{tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64, not {A.dtype}")
    if max(A.shape) >= 2 ** 31 or A.numel() >= 2 ** 62:
        raise ValueError(f"{name}: exceeds the kernel's extents")


def _raise(name: str, rc: int, plan: JacobiPlan):
    why = ("a cluster the card cannot schedule" if rc == UNSCHEDULABLE
           else f"error {rc}")
    raise RuntimeError(f"{name} kernel launch failed ({plan}): {why}")


def small_eigh_launch(A: torch.Tensor, plan: JacobiPlan = None):
    """K4 on a (B, m, m) CUDA batch by ``plan`` (default ``eigh_plan``)."""
    _cuda_check("small_eigh", A)
    B, m, m2 = A.shape
    if m != m2:
        raise ValueError(f"small_eigh: square matrices, got {(m, m2)}")
    plan = plan or eigh_plan(m)
    a = A.double().contiguous()
    w = a.new_empty((B, m))
    v = a.new_empty((B, m, m))
    status = torch.empty(B, dtype=torch.int32, device=A.device)
    # route gmem: A's and V's columns
    work = a.new_empty((B, 2, m, m)) if plan.route == GMEM else None
    with torch.cuda.device(A.device):
        rc = _fn("xerus_small_eigh")(
            a.data_ptr(), w.data_ptr(), v.data_ptr(), status.data_ptr(),
            _health(A.device).data_ptr(),
            None if work is None else work.data_ptr(), B, m,
            _EIGH_ROUTE[plan.route], plan.mm, plan.ctas, plan.threads, CAP,
            eigh_tol(m), plan.smem, _stream(a))
    if rc != 0:
        _raise("small_eigh", rc, plan)
    small_eigh_launch.launches += 1
    return w.to(A.dtype), v.to(A.dtype), status


def small_svd_launch(A: torch.Tensor, plan: JacobiPlan = None):
    """K5 on a (B, M, N) CUDA batch by ``plan`` (default ``svd_plan``)."""
    _cuda_check("small_svd", A)
    B, M, N = A.shape
    plan = plan or svd_plan(M, N)
    a = A.double()
    trans = M < N
    R, C = max(M, N), min(M, N)
    sb, sr, sc = a.stride()
    if trans:
        sr, sc = sc, sr
    u = a.new_empty((B, M, C))
    s = a.new_empty((B, C))
    vh = a.new_empty((B, C, N))
    status = torch.empty(B, dtype=torch.int32, device=A.device)
    tol = svd_tol(M, N)
    gmem = plan.route == GMEM
    # route gmem: W, X and V_J
    work = a.new_empty((B, plan.mm * (R + 2 * C))) if gmem else None
    with torch.cuda.device(A.device):
        rc = _fn("xerus_small_svd")(
            a.data_ptr(), sb, sr, sc, u.data_ptr(), s.data_ptr(),
            vh.data_ptr(), status.data_ptr(), _health(A.device).data_ptr(),
            None if work is None else work.data_ptr(), B, R, C, int(trans),
            int(gmem), plan.mm, plan.ctas, plan.threads, CAP, tol, tol,
            plan.smem, _stream(a))
    if rc != 0:
        _raise("small_svd", rc, plan)
    small_svd_launch.launches += 1
    return u.to(A.dtype), s.to(A.dtype), vh.to(A.dtype), status


small_eigh_launch.launches = 0
small_svd_launch.launches = 0
programs.counter(small_eigh_launch, "launches")
programs.counter(small_svd_launch, "launches")


def small_eigh(A: torch.Tensor):
    """K4 on a CUDA batch; on a CPU batch its plain version.  (B, m, m) ->
    (w, V, status)."""
    if A.device.type == "cpu":
        return small_eigh_plain(A)
    return small_eigh_launch(A)


def small_svd(A: torch.Tensor):
    """K5 on a CUDA batch; on a CPU batch its plain version.  (B, M, N) ->
    (U, S, Vh, status)."""
    if A.device.type == "cpu":
        return small_svd_plain(A)
    return small_svd_launch(A)
