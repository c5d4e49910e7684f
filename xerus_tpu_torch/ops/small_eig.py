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
  Vh (B, K, N), status (B,), K = min(M, N); U (or Vh where M < N) gets an
  orthonormal completion where sigma is zero.

Both compute in float64: float32 inputs are promoted and the results cast
back.  On CPU tensors the wrappers run the plain versions
(``small_eigh_plain``, ``small_svd_plain``: the kernels' algorithms step
for step, the same pair order, tests and sweep cap, in torch); on CUDA
tensors they launch the kernel or raise.  A status > 0 is the sweeps a
matrix took; <= 0 means it did not converge in ``CAP`` sweeps or is not
finite.  The plans (``eigh_plan``, ``svd_plan``) choose route ``smem``
(the operands in shared memory) or ``gmem`` (the same steps on a global
workspace) from the shape alone and are the only source of a launch's
shared-memory size.
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
BIG_TAU = 1e150             # past it, t = 1 / 2|tau| (tau^2 overflows)
SMEM_MAX = 232_448          # dynamic shared memory a block may opt in to
WARPS = 8                   # csrc/jacobi.cu kThreads / 32
SMEM, GMEM = "smem", "gmem"
HEALTH = ("failures", "max_sweeps", "total_sweeps", "matrices",
          "rotations")


class JacobiPlan(NamedTuple):
    route: str      # smem or gmem
    smem: int       # bytes of dynamic shared memory per CTA
    work: int       # doubles of global workspace per matrix (route gmem)


def _eigh_bytes(m: int, gmem: bool) -> int:
    mm = m + (m & 1)
    np_ = mm // 2
    return 8 * (4 * np_ + (0 if gmem else 2 * m * m)) \
        + 4 * (3 * np_ + 1 + mm)


def _svd_bytes(R: int, C: int, gmem: bool) -> int:
    return 8 * (WARPS + 1 + 2 * C + R + (0 if gmem else R * C + C * C)) \
        + 4 * (1 + C)


@lru_cache(maxsize=None)
def eigh_plan(m: int, route: str = "") -> JacobiPlan:
    """K4's route for (m, m) matrices: ``smem`` where A and V fit a CTA's
    shared memory (m <= 118), else ``gmem``; ``route`` forces one (gmem
    fits any m whose vectors fit)."""
    if route != GMEM and _eigh_bytes(m, False) <= SMEM_MAX:
        return JacobiPlan(SMEM, _eigh_bytes(m, False), 0)
    if route == SMEM:
        raise ValueError(f"small_eigh: ({m}, {m}) does not fit route smem")
    return JacobiPlan(GMEM, _eigh_bytes(m, True), 2 * m * m)


@lru_cache(maxsize=None)
def svd_plan(M: int, N: int, route: str = "") -> JacobiPlan:
    """K5's route for (M, N) matrices (W of R = max(M, N) rows and
    C = min(M, N) columns): ``smem`` where W and V fit a CTA's shared
    memory ((64, 64) does, (128, 128) does not), else ``gmem``; ``route``
    forces one."""
    R, C = max(M, N), min(M, N)
    if route != GMEM and _svd_bytes(R, C, False) <= SMEM_MAX:
        return JacobiPlan(SMEM, _svd_bytes(R, C, False), 0)
    if route == SMEM:
        raise ValueError(f"small_svd: ({M}, {N}) does not fit route smem")
    return JacobiPlan(GMEM, _svd_bytes(R, C, True), R * C + C * C)


def eigh_tol(m: int) -> float:
    return max(m, 1) * EPS


def svd_tol(M: int, N: int) -> float:
    """The orthogonality test's tolerance and the dead-column threshold
    (relative to ||A||_F): R eps."""
    return max(M, N, 1) * EPS


# ---------------------------------------------------------------------------
# the plain versions: the kernels' steps in torch


def round_robin(n: int):
    """The kernels' parallel pair order over n indices (padded to even mm):
    a list of mm - 1 rounds, each a (p, q) pair of index lists with p < q;
    pairs reaching the pad index mm - 1 >= n are dropped."""
    mm = n + (n & 1)
    rounds = []
    for k in range(mm - 1):
        def slot(j):
            return 0 if j == 0 else 1 + (k + j - 1) % (mm - 1)
        pairs = [(min(slot(i), slot(mm - 1 - i)), max(slot(i),
                                                      slot(mm - 1 - i)))
                 for i in range(mm // 2)]
        pairs = [(p, q) for p, q in pairs if q < n]
        rounds.append(([p for p, _ in pairs], [q for _, q in pairs]))
    return rounds


def _rotation(a, b, g):
    """(c, s, t) of the rotation annihilating g in [[a, g], [g, b]]; g must
    be nonzero where the result is used."""
    tau = (b - a) / (2.0 * torch.where(g != 0, g, torch.ones_like(g)))
    at = tau.abs()
    tt = torch.where(at > BIG_TAU, 0.5 / at,
                     1.0 / (at + torch.sqrt(1.0 + tau * tau)))
    t = torch.where(tau < 0, -tt, tt)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c, t


def _status(sweeps, converged, finite):
    """The kernels' per-matrix status: sweeps used where converged, minus
    that where not, -(CAP + 1) where not finite."""
    st = torch.where(converged, sweeps, -sweeps)
    return torch.where(finite, st, torch.full_like(st, -(CAP + 1))) \
        .to(torch.int32)


def small_eigh_plain(A: torch.Tensor):
    """K4's algorithm in torch on any device: cyclic two-sided Jacobi in
    the round-robin order, the relative test |a_pq| > m eps sqrt|a_pp|
    sqrt|a_qq|, at most ``CAP`` sweeps, ascending order (ties by index).
    (B, m, m) -> (w (B, m), V (B, m, m), status (B,))."""
    dt = A.dtype
    B, m = A.shape[0], A.shape[-1]
    A = torch.tril(A.double())
    A = A + torch.tril(A, -1).transpose(1, 2)
    V = torch.eye(m, dtype=torch.float64, device=A.device).repeat(B, 1, 1)
    finite = torch.isfinite(A).reshape(B, -1).all(1)
    tol = eigh_tol(m)
    sweeps = torch.zeros(B, dtype=torch.int64, device=A.device)
    converged = torch.zeros(B, dtype=torch.bool, device=A.device)
    rounds = [(torch.tensor(p, device=A.device), torch.tensor(q,
                                                              device=A.device))
              for p, q in round_robin(m) if p]
    for _ in range(CAP):
        active = finite & ~converged
        if not bool(active.any()):
            break
        rotated = torch.zeros(B, dtype=torch.bool, device=A.device)
        for P, Q in rounds:
            app, aqq = A[:, P, P], A[:, Q, Q]
            apq = A[:, P, Q]
            rot = (apq != 0) & (apq.abs() > tol * app.abs().sqrt()
                                * aqq.abs().sqrt()) & active[:, None]
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
            for M in (A, V):
                x, y = M[:, :, P], M[:, :, Q]
                M[:, :, P] = torch.where(rt, ct * x - st * y, x)
                M[:, :, Q] = torch.where(rt, st * x + ct * y, y)
            dp = torch.where(rot, app - t * apq, app)
            dq = torch.where(rot, aqq + t * apq, aqq)
            A[:, P, P], A[:, Q, Q] = dp, dq
            zero = torch.where(rot, torch.zeros_like(apq), A[:, P, Q])
            A[:, P, Q] = zero
            A[:, Q, P] = torch.where(rot, torch.zeros_like(apq), A[:, Q, P])
        sweeps += active.long()
        converged |= active & ~rotated
    w = torch.diagonal(A, dim1=1, dim2=2)
    finite &= torch.isfinite(w).all(1)
    order = torch.sort(w, dim=1, stable=True).indices
    w = torch.gather(w, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(B, m, m))
    return w.to(dt), V.to(dt), _status(sweeps, converged, finite)


def small_svd_plain(A: torch.Tensor):
    """K5's algorithm in torch on any device: one-sided Jacobi on the
    columns of A (M >= N) or A^T, the round-robin order, rotation where
    both columns are alive (||w||^2 > (R eps ||A||_F)^2) and
    |w_p . w_q| > R eps ||w_p|| ||w_q||, at most ``CAP`` sweeps; sigma
    descending (ties by index, 0 for a dead column), Q = W V / sigma and
    the orthonormal completion for the zero sigma.  (B, M, N) -> (U, S,
    Vh, status)."""
    dt = A.dtype
    B, M, N = A.shape
    trans = M < N
    W = (A.transpose(1, 2) if trans else A).double().clone()
    R, C = W.shape[1:]
    V = torch.eye(C, dtype=torch.float64, device=A.device).repeat(B, 1, 1)
    tol = dead = svd_tol(M, N)
    f2 = (W * W).sum(1).sum(1)
    dead2 = dead * dead * f2
    finite = torch.isfinite(f2)
    sweeps = torch.zeros(B, dtype=torch.int64, device=A.device)
    converged = torch.zeros(B, dtype=torch.bool, device=A.device)
    rounds = [(torch.tensor(p, device=A.device), torch.tensor(q,
                                                              device=A.device))
              for p, q in round_robin(C) if p]
    for _ in range(CAP):
        active = finite & ~converged
        if not bool(active.any()):
            break
        rotated = torch.zeros(B, dtype=torch.bool, device=A.device)
        for P, Q in rounds:
            x, y = W[:, :, P], W[:, :, Q]
            al, be, ga = (x * x).sum(1), (y * y).sum(1), (x * y).sum(1)
            d2 = dead2[:, None]
            rot = (al > d2) & (be > d2) & (ga != 0) & (
                ga.abs() > tol * al.sqrt() * be.sqrt()) & active[:, None]
            c, s, _ = _rotation(al, be, ga)
            rotated |= rot.any(1)
            c = torch.where(rot, c, torch.ones_like(c))[:, None, :]
            s = torch.where(rot, s, torch.zeros_like(s))[:, None, :]
            r3 = rot[:, None, :]
            for Mx in (W, V):
                x, y = Mx[:, :, P], Mx[:, :, Q]
                Mx[:, :, P] = torch.where(r3, c * x - s * y, x)
                Mx[:, :, Q] = torch.where(r3, s * x + c * y, y)
        sweeps += active.long()
        converged |= active & ~rotated
    n2 = (W * W).sum(1)
    sig = torch.where(n2 > dead2[:, None], n2.sqrt(), torch.zeros_like(n2))
    finite &= torch.isfinite(sig).all(1)
    order = torch.sort(sig, dim=1, descending=True, stable=True).indices
    sig = torch.gather(sig, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(B, C, C))
    W = torch.gather(W, 2, order[:, None, :].expand(B, R, C))
    Q = torch.where(sig[:, None, :] > 0,
                    W / torch.where(sig > 0, sig, torch.ones_like(sig))
                    [:, None, :], torch.zeros_like(W))
    for b in range(B):
        if bool(finite[b]) and not _complete(Q[b], int((sig[b] > 0).sum())):
            finite[b] = False
    U, Vh = (V, Q.transpose(1, 2)) if trans else (Q, V.transpose(1, 2))
    return (U.to(dt), sig.to(dt), Vh.contiguous().to(dt),
            _status(sweeps, converged, finite))


def _complete(Q: torch.Tensor, nonzero: int) -> bool:
    """Fill columns ``nonzero``.. of the (R, C) Q in place, each with the
    first canonical vector (ascending from the last one taken) whose part
    orthogonal to the columns before it, projected out twice, keeps a
    squared norm above 1 / 2R; normalized.  False if one was not found."""
    R, C = Q.shape
    trial = 0
    for k in range(nonzero, C):
        while trial < R:
            z = torch.zeros(R, dtype=Q.dtype, device=Q.device)
            z[trial] = 1.0
            for _ in range(2):
                z = z - Q[:, :k] @ (Q[:, :k].T @ z)
            n2 = float(z @ z)
            trial += 1
            if n2 > 0.5 / R:
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
    "xerus_small_eigh": [_P] * 6 + [_I] * 4 + [_D, _I, _P],
    "xerus_small_svd": [_P] + [_L] * 3 + [_P] * 6 + [_I] * 6 + [_D, _D, _I,
                                                                _P],
}


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
    work = a.new_empty((B * plan.work,)) if plan.route == GMEM else None
    with torch.cuda.device(A.device):
        rc = _fn("xerus_small_eigh")(
            a.data_ptr(), w.data_ptr(), v.data_ptr(), status.data_ptr(),
            _health(A.device).data_ptr(),
            work.data_ptr() if work is not None else None, B, m,
            int(plan.route == GMEM), CAP, eigh_tol(m), plan.smem,
            _stream(a))
    if rc != 0:
        raise RuntimeError(f"small_eigh kernel launch failed: error {rc}")
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
    work = a.new_empty((B * plan.work,)) if plan.route == GMEM else None
    tol = svd_tol(M, N)
    with torch.cuda.device(A.device):
        rc = _fn("xerus_small_svd")(
            a.data_ptr(), sb, sr, sc, u.data_ptr(), s.data_ptr(),
            vh.data_ptr(), status.data_ptr(), _health(A.device).data_ptr(),
            work.data_ptr() if work is not None else None, B, R, C,
            int(trans), int(plan.route == GMEM), CAP, tol, tol, plan.smem,
            _stream(a))
    if rc != 0:
        raise RuntimeError(f"small_svd kernel launch failed: error {rc}")
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
