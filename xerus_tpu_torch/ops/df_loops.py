"""K1q and K1c: the double-word column loops in one launch each.

The CGS2 df QR (``mixed_precision.df_qr``) and the df Cholesky's diagonal
blocks and panel substitutions (``df_cholesky._df_chol_unblocked`` and
``_df_trsm_rlt``) are column-sequential loops whose steps are df row
products.  The JAX package runs each as one ``lax.fori_loop`` program
(``xerus_tpu/ops/mixed_precision.py:91-153``,
``xerus_tpu/ops/df_cholesky.py:38-137``); run eagerly they are thousands of
launches.  Here each is one hand-written CUDA kernel whose row products are
K1's arithmetic (``csrc/df_arith.cuh``):

- K1q, ``csrc/df_qr.cu``: the CGS2 df QR of an (m, r) matrix, in one CTA
  (route ``cta``), in one 16-CTA cluster holding a band of rows per CTA
  (route ``cluster``), or, where a band does not fit shared memory, in the
  same cluster with the bands in a global workspace (route ``gmem``);
- K1c, ``csrc/df_chol.cu``: ``df_chol_block`` (one CTA, the block in shared
  memory, or in place in the output past it) and ``df_trsm_rlt`` (a warp
  per row of X, L staged in shared memory whole or in double-buffered row
  tiles, or read from global memory past that).

This module holds their ctypes bindings, their launch counters
(``df_qr_launch.launches`` etc., counting kernel launches and nothing
else), their plans (plain Python from the shapes alone, no card needed;
the only source of each launch's shared-memory size, which the kernel
checks covers its layout) and ``df_qr_cluster_model``, a torch model of
K1q's data split and reduction order.  The wrappers that choose between a
kernel and the plain version by device live where the plain versions do.
Every shape within int32 extents has a kernel route, but for K1q and
``df_chol_block`` at sizes whose vectors alone pass shared memory, where
the plan raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import build
from . import programs
from .df32 import df_add, df_mul, df_sub

SMEM_MAX = 232_448        # dynamic shared memory a block may opt in to
QR_WARPS = 16             # warps of a K1q CTA (csrc/df_qr.cu kThreads / 32)
CLUSTER_CTAS = 16         # CTAs of K1q's cluster routes
TRSM_WARPS = 8            # rows of X per df_trsm_rlt CTA
CTA, CLUSTER, GMEM, WHOLE, TILES = "cta", "cluster", "gmem", "whole", "tiles"
_QR_ROUTE = {CTA: 0, CLUSTER: 1, GMEM: 2}     # csrc/df_qr.cu enum Route


class LoopPlan(NamedTuple):
    route: str      # cta / cluster / gmem (K1q), cta / gmem
                    # (df_chol_block), whole / tiles / gmem (df_trsm_rlt)
    ctas: int       # CTAs launched
    rows: int       # rows a CTA holds (K1q's band; rows of X per CTA)
    tile: int       # df_trsm_rlt: rows of L staged at a time (0: gmem)
    smem: int       # bytes of dynamic shared memory per CTA
    work: int = 0   # K1q route gmem: floats of the global workspace


# ---------------------------------------------------------------------------
# plans: each route's shared memory (csrc/df_qr.cu layout(),
# csrc/df_chol.cu block_floats() / trsm_floats() check that it suffices)


def _qr_floats(m: int, r: int, route: str) -> int:
    rows = m if route == CTA else -(-m // CLUSTER_CTAS)
    ld = rows | 1
    slots = -(-r // CLUSTER_CTAS)
    n = (0 if route == GMEM else 2 * ld * r) + 2 * ld + 4 * r \
        + 3 * QR_WARPS + r
    if route != CTA:
        n += 2 * CLUSTER_CTAS * slots + 4 * CLUSTER_CTAS
    return n


@lru_cache(maxsize=None)
def df_qr_plan(m: int, r: int) -> LoopPlan:
    """K1q's route for an (m, r) input: ``cta`` where the whole matrix and
    the loop's vectors fit one CTA's shared memory, else ``cluster`` where
    a band of ceil(m / 16) rows fits each of 16 CTAs, else ``gmem_plan``'s
    (the bands in global memory)."""
    smem = 4 * _qr_floats(m, r, CTA)
    if smem <= SMEM_MAX:
        return LoopPlan(CTA, 1, m, 0, smem)
    smem = 4 * _qr_floats(m, r, CLUSTER)
    if smem <= SMEM_MAX:
        return LoopPlan(CLUSTER, CLUSTER_CTAS, -(-m // CLUSTER_CTAS), 0, smem)
    return gmem_plan("df_qr", (m, r))


@lru_cache(maxsize=None)
def df_chol_block_plan(B: int) -> LoopPlan:
    """df_chol_block's route for a (B, B) block: ``cta`` where the block
    (odd row stride) and its diagonal fit one CTA, else ``gmem_plan``'s
    (the block in place in the output)."""
    smem = 4 * (2 * B * (B | 1) + 2 * B)
    if smem <= SMEM_MAX:
        return LoopPlan(CTA, 1, B, 0, smem)
    return gmem_plan("df_chol_block", (B, B))


def _trsm_floats(B: int, tile: int) -> int:
    bufs = 2 if -(-B // tile) > 1 else 1
    return 2 * TRSM_WARPS * B + 2 * bufs * tile * B


@lru_cache(maxsize=None)
def df_trsm_plan(m: int, B: int) -> LoopPlan:
    """df_trsm_rlt's route for an (m, B) panel: ``whole`` where L fits
    beside the CTA's rows of X, ``tiles`` (two buffers of as many rows of L
    as fit, at least 8) otherwise, ``gmem_plan``'s past that."""
    ctas = -(-m // TRSM_WARPS)
    smem = 4 * _trsm_floats(B, B)
    if smem <= SMEM_MAX:
        return LoopPlan(WHOLE, ctas, TRSM_WARPS, B, smem)
    tile = (SMEM_MAX // 4 - 2 * TRSM_WARPS * B) // (4 * B)
    tile = min(B - 1, tile - tile % 8)
    if tile >= 8:
        return LoopPlan(TILES, ctas, TRSM_WARPS, tile,
                        4 * _trsm_floats(B, tile))
    return gmem_plan("df_trsm_rlt", (m, B))


def gmem_plan(entry: str, shape) -> LoopPlan:
    """Route ``gmem`` of ``entry`` ("df_qr", "df_chol_block" or
    "df_trsm_rlt") at ``shape``: the plans' route past shared memory, and
    at any shape one that computes bitwise what K1q's cluster route and
    K1c's shared-memory routes compute (the same steps in the same orders,
    with the operands in global memory), so tests and chip_smoke hold it
    against them on the paths' shapes.  K1q: the cluster with each band
    in a global workspace and the vectors in shared memory; df_chol_block:
    the block in place in the output, the diagonal in shared memory;
    df_trsm_rlt: X's rows in place in the output, L read from global
    memory.  Raises ValueError for a shape whose vectors alone pass
    shared memory (K1q, df_chol_block)."""
    if entry == "df_qr":
        m, r = shape
        rows = -(-m // CLUSTER_CTAS)
        band = (rows | 1) * r
        smem = 4 * _qr_floats(m, r, GMEM)
        if smem <= SMEM_MAX and 2 * band < 2 ** 31:
            return LoopPlan(GMEM, CLUSTER_CTAS, rows, 0, smem,
                            2 * CLUSTER_CTAS * band)
        raise ValueError(f"df_qr: no K1q route for an ({m}, {r}) matrix: "
                         f"route gmem's vectors take {smem} bytes of shared "
                         f"memory (at most {SMEM_MAX}) and a CTA's band "
                         f"{2 * band} floats (under 2^31)")
    if entry == "df_chol_block":
        B = shape[0]
        if 4 * 2 * B <= SMEM_MAX:
            return LoopPlan(GMEM, 1, B, 0, 4 * 2 * B)
        raise ValueError(f"df_chol_block: no K1c route for a ({B}, {B}) "
                         f"block: its diagonal takes {4 * 2 * B} bytes of "
                         f"shared memory (at most {SMEM_MAX})")
    if entry == "df_trsm_rlt":
        return LoopPlan(GMEM, -(-shape[0] // TRSM_WARPS), TRSM_WARPS, 0, 0)
    raise ValueError(f"gmem_plan: no entry {entry!r}")


# ---------------------------------------------------------------------------
# bindings and launches

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "xerus_df_qr": [_P] * 2 + [_I] + [_P] * 6 + [ctypes.c_longlong]
    + [_I] * 4 + [_P],
    "xerus_df_chol_block": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 3 + [_P],
    "xerus_df_trsm_rlt": [_P] * 2 + [_I] + [_P] * 2 + [_I] + [_P] * 2
    + [_I] * 4 + [_P],
}


@lru_cache(maxsize=None)
def _fn(lib: str, name: str):
    f = getattr(build.load_kernel_library(lib), name)
    f.argtypes = _ARGTYPES[name]
    f.restype = ctypes.c_int
    return f


def _rows(entry: str, pairs):
    """Check (name, hi, lo, shape) operands: float32 on one CUDA device,
    hi and lo alike, unit column stride.  Returns each pair with its row
    stride, copied to contiguous where the strides do not allow a view."""
    dev = pairs[0][1].device
    out = []
    for name, h, lo, shape in pairs:
        for t in (h, lo):
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"{entry}: {name} on {t.device}, needs the "
                                 f"CUDA device {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"{entry}: {name} is {t.dtype}, needs "
                                "float32")
            if tuple(t.shape) != shape:
                raise ValueError(f"{entry}: {name} has shape "
                                 f"{tuple(t.shape)}, needs {shape}")
        if not (h.stride() == lo.stride() and h.stride(1) == 1
                and h.stride(0) >= shape[1]):
            h, lo = h.contiguous(), lo.contiguous()
        if max(shape) >= 2 ** 31 or h.stride(0) >= 2 ** 31:
            raise ValueError(f"{entry}: {name} exceeds int32 extents")
        out.append((h, lo, h.stride(0)))
    return out


def _raise(entry: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: error {rc}"
                           + (" (the card cannot schedule a 16-CTA cluster)"
                              if rc == 1000 else ""))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def df_qr_launch(ah, al, plan: LoopPlan, stats=None):
    """K1q on an (m, r) CUDA df pair by ``plan`` (route cta, cluster or
    gmem).  Returns ((Qh, Ql), (Rh, Rl)); ``stats``, an (r, 2) float32
    tensor on the same device, receives each column's post-projection norm
    (high word) and its deficiency threshold."""
    m, r = ah.shape
    if plan.route not in _QR_ROUTE:
        raise ValueError(f"df_qr_launch: route {plan.route!r}")
    ((ah, al, lda),) = _rows("df_qr", [("A", ah, al, (m, r))])
    qh = ah.new_empty((m, r))
    ql = ah.new_empty((m, r))
    rh = ah.new_empty((r, r))
    rl = ah.new_empty((r, r))
    work = ah.new_empty((plan.work,)) if plan.work else None
    if stats is not None and (stats.shape != (r, 2) or not
                              stats.is_contiguous() or
                              stats.device != ah.device):
        raise ValueError("df_qr_launch: stats must be a contiguous (r, 2) "
                         "tensor on A's device")
    with torch.cuda.device(ah.device):
        rc = _fn("df_qr", "xerus_df_qr")(
            ah.data_ptr(), al.data_ptr(), lda, qh.data_ptr(), ql.data_ptr(),
            rh.data_ptr(), rl.data_ptr(),
            stats.data_ptr() if stats is not None else None,
            work.data_ptr() if work is not None else None, plan.work, m, r,
            _QR_ROUTE[plan.route], plan.smem, _stream(ah))
    _raise("df_qr", rc)
    df_qr_launch.launches += 1
    return (qh, ql), (rh, rl)


def df_chol_block_launch(Ah, Al, plan: LoopPlan):
    """df_chol_block on a (B, B) CUDA df block by ``plan`` (route cta or
    gmem): its lower-triangular df Cholesky factor (Lh, Ll), contiguous."""
    B = Ah.shape[0]
    if plan.route not in (CTA, GMEM):
        raise ValueError(f"df_chol_block_launch: route {plan.route!r}")
    ((ah, al, lda),) = _rows("df_chol_block", [("A", Ah, Al, (B, B))])
    lh = ah.new_empty((B, B))
    ll = ah.new_empty((B, B))
    with torch.cuda.device(ah.device):
        rc = _fn("df_chol", "xerus_df_chol_block")(
            ah.data_ptr(), al.data_ptr(), lda, lh.data_ptr(), ll.data_ptr(),
            B, int(plan.route == GMEM), plan.smem, _stream(ah))
    _raise("df_chol_block", rc)
    df_chol_block_launch.launches += 1
    return lh, ll


def df_trsm_rlt_launch(Ah, Al, Lh, Ll, plan: LoopPlan):
    """df_trsm_rlt: X with X L^T = A for an (m, B) CUDA df A and a (B, B)
    lower-triangular df L, by ``plan`` (route whole, tiles or gmem).
    Returns (Xh, Xl), contiguous."""
    m, B = Ah.shape
    if plan.route not in (WHOLE, TILES, GMEM):
        raise ValueError(f"df_trsm_rlt_launch: route {plan.route!r}")
    (ah, al, lda), (lh, ll, ldl) = _rows(
        "df_trsm_rlt", [("A", Ah, Al, (m, B)), ("L", Lh, Ll, (B, B))])
    xh = ah.new_empty((m, B))
    xl = ah.new_empty((m, B))
    with torch.cuda.device(ah.device):
        rc = _fn("df_chol", "xerus_df_trsm_rlt")(
            ah.data_ptr(), al.data_ptr(), lda, lh.data_ptr(), ll.data_ptr(),
            ldl, xh.data_ptr(), xl.data_ptr(), m, B, plan.tile, plan.smem,
            _stream(ah))
    _raise("df_trsm_rlt", rc)
    df_trsm_rlt_launch.launches += 1
    return xh, xl


df_qr_launch.launches = 0
df_chol_block_launch.launches = 0
df_trsm_rlt_launch.launches = 0
for _launch in (df_qr_launch, df_chol_block_launch, df_trsm_rlt_launch):
    programs.counter(_launch, "launches")


# ---------------------------------------------------------------------------
# a torch model of K1q's data split and reduction order


def _lane_fold(ph, pl):
    """K1q's warp reduction of the terms along dim 0: lane l sums terms l,
    l + 32, ... in order from zero, then the shuffle-down fold (lane l adds
    lane l + off for off = 16, ..., 1); lane 0's result."""
    n = ph.shape[0]
    rest = tuple(ph.shape[1:])
    ah = ph.new_zeros((32,) + rest)
    al = ph.new_zeros((32,) + rest)
    for s in range(0, n, 32):
        w = min(32, n - s)
        sh, sl = df_add(ah[:w], al[:w], ph[s:s + w], pl[s:s + w])
        ah, al = torch.cat([sh, ah[w:]]), torch.cat([sl, al[w:]])
    for off in (16, 8, 4, 2, 1):
        ah, al = df_add(ah[:off], al[:off], ah[off:2 * off], al[off:2 * off])
    return ah[0], al[0]


def _serial(ph, pl):
    """Sum along dim 0 in order from zero (warps in order, bands in
    order)."""
    sh = ph.new_zeros(ph.shape[1:])
    sl = ph.new_zeros(ph.shape[1:])
    for k in range(ph.shape[0]):
        sh, sl = df_add(sh, sl, ph[k], pl[k])
    return sh, sl


def _f32_serial(x):
    s = x.new_zeros(x.shape[1:])
    for k in range(x.shape[0]):
        s = s + x[k]
    return s


def df_qr_cluster_model(ah, al, ctas: int = CLUSTER_CTAS):
    """K1q's computation in torch on any device, with its data split: the
    rows in ``ctas`` bands of ceil(m / ctas) (``ctas=1`` is route cta),
    every df reduction in the kernel's order (``_lane_fold`` within a
    band, the 16 warp partials of a norm and then the bands in order, the
    reduce-scatter's band order for Q^T v; the plain f32 sums behind the
    threshold in torch's order).  Arithmetic is ``df32``'s
    (its masked-split TwoProd, where the kernel uses an FMA), so it follows
    the kernel's order, not its bits.  Returns ((Qh, Ql), (Rh, Rl),
    deficient) with ``deficient`` a list of bools."""
    from .mixed_precision import df_div, df_sqrt
    m, r = ah.shape
    rows = -(-m // ctas)
    bands = [(b * rows, min(m, (b + 1) * rows)) for b in range(ctas)]
    bands = [(s, e) for s, e in bands if e > s] or [(0, 0)]

    def coefs(qh, ql, vh, vl, j):
        parts = [_lane_fold(*df_mul(qh[s:e, :j], ql[s:e, :j],
                                    vh[s:e, None], vl[s:e, None]))
                 for s, e in bands]
        return _serial(torch.stack([p[0] for p in parts]),
                       torch.stack([p[1] for p in parts]))

    def project(qh, ql, vh, vl, j):
        if j == 0:
            ch = cl = ah.new_zeros((0,))
            ph = pl = ah.new_zeros((m,))
        else:
            ch, cl = coefs(qh, ql, vh, vl, j)
            ph, pl = _lane_fold(*df_mul(qh[:, :j].T, ql[:, :j].T,
                                        ch[:, None], cl[:, None]))
        vh, vl = df_sub(vh, vl, ph, pl)
        return vh, vl, ch, cl

    def band_norm(vh, vl, s, e):
        """thread t of 512 sums rows t, t + 512, ...; lanes fold per warp;
        the 16 warp partials in order."""
        n = e - s
        pad = -(-max(n, 1) // (32 * QR_WARPS)) * 32 * QR_WARPS
        th, tl = df_mul(vh[s:e], vl[s:e], vh[s:e], vl[s:e])
        th = torch.cat([th, th.new_zeros(pad - n)]).reshape(-1, QR_WARPS, 32)
        tl = torch.cat([tl, tl.new_zeros(pad - n)]).reshape(-1, QR_WARPS, 32)
        acc_h, acc_l = _serial(th, tl)                       # (warps, 32)
        wh, wl = _lane_fold(acc_h.T, acc_l.T)                # (warps,)
        return _serial(wh, wl)

    def norm(vh, vl):
        parts = [band_norm(vh, vl, s, e) for s, e in bands]
        sh, sl = _serial(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
        return df_sqrt(sh, sl)

    colsq = torch.stack([_f32_serial((ah[s:e] * ah[s:e]).sum(0)[None])
                         for s, e in bands])
    mat_scale = torch.sqrt(torch.max(_f32_serial(colsq)))
    qh, ql = ah.new_zeros((m, r)), ah.new_zeros((m, r))
    rh, rl = ah.new_zeros((r, r)), ah.new_zeros((r, r))
    deficient = []
    for j in range(r):
        vh, vl = ah[:, j], al[:, j]
        orig_norm = torch.sqrt(_f32_serial(torch.stack(
            [(vh[s:e] * vh[s:e]).sum() for s, e in bands]))) + 1e-38
        coefh, coefl = ah.new_zeros((j,)), ah.new_zeros((j,))
        for _ in range(2):
            vh, vl, ch, cl = project(qh, ql, vh, vl, j)
            coefh, coefl = df_add(coefh, coefl, ch, cl)
        nh, nl = norm(vh, vl)
        thr = torch.maximum(1e-12 * orig_norm, 1e-13 * mat_scale) + 1e-30
        bad = bool(nh <= thr)
        deficient.append(bad)
        n2h, n2l = nh, nl
        if bad:
            eh = ah.new_zeros((m,))
            eh[j % m] = 1.0
            vh, vl, _, _ = project(qh, ql, eh, torch.zeros_like(eh), j)
            n2h, n2l = norm(vh, vl)
            nh, nl = torch.zeros_like(nh), torch.zeros_like(nl)
        inv_h, inv_l = df_div(ah.new_ones(()), ah.new_zeros(()),
                              torch.clamp_min(n2h, 1e-20), n2l)
        qh[:, j], ql[:, j] = df_mul(vh, vl, inv_h, inv_l)
        rh[:j, j], rl[:j, j] = coefh, coefl
        rh[j, j], rl[j, j] = nh, nl
    return (qh, ql), (rh, rl), deficient


# ---------------------------------------------------------------------------
# backward errors in float64 on the host, by which a kernel and its plain
# version are held against each other (numpy arrays, df pairs joined)


def qr_backward_errors(Q, R, A):
    """(||QR - A||_F / ||A||_F, ||Q^T Q - I||_F)."""
    return (float(np.linalg.norm(Q @ R - A) / np.linalg.norm(A)),
            float(np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1]))))


def chol_backward_error(L, A):
    """||L L^T - A||_F / ||A||_F."""
    return float(np.linalg.norm(L @ L.T - A) / np.linalg.norm(A))


def trsm_backward_error(X, L, A):
    """||X L^T - A||_F / (||X||_F ||L||_F)."""
    return float(np.linalg.norm(X @ L.T - A)
                 / (np.linalg.norm(X) * np.linalg.norm(L)))
