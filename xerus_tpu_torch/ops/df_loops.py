"""K1q and K1c: the double-word column loops in one launch each.

The CGS2 df QR (``mixed_precision.df_qr``) and the df Cholesky's diagonal
blocks and panel substitutions (``df_cholesky._df_chol_unblocked`` and
``_df_trsm_rlt``) are column-sequential loops whose steps are df row
products.  The JAX package runs each as one ``lax.fori_loop`` program
(``xerus_tpu/ops/mixed_precision.py:91-153``,
``xerus_tpu/ops/df_cholesky.py:38-137``); run eagerly they are thousands of
launches.  Here each is one hand-written CUDA kernel with K1's arithmetic
(``csrc/df_arith.cuh``), laid out so that no step's dependent chain walks
reductions one after another:

- K1q, ``csrc/df_qr.cu``: the CGS2 df QR of an (m, r) matrix, in one CTA
  (route ``cta``), in one 16-CTA cluster holding a band of rows per CTA
  (route ``cluster``), or, where a band does not fit shared memory, in the
  same cluster with the bands in a global workspace (route ``gmem``).
  Q^T v by a group of lanes per column, Q c by a group of lanes per row,
  each folded by one butterfly; the cluster routes all-reduce the band
  partials by one pull over distributed shared memory;
- K1c, ``csrc/df_chol.cu``: ``df_chol_block`` (one CTA, right-looking: a
  step is a df_sqrt, a df_div of the column by its owners and a rank-1
  update of the trailing triangle by its owners, one barrier; the block in
  shared memory, or in place in the output past it) and ``df_trsm_rlt``
  (a warp per row of X, its lanes owning the row's columns: a step is one
  df_div, one shuffle and a rank-1 update; L staged in shared memory
  whole or in double-buffered column tiles, or read from global memory
  past that).

This module holds their ctypes bindings, their launch counters
(``df_qr_launch.launches`` etc., counting kernel launches and nothing
else), their plans (plain Python from the shapes alone, no card needed;
the only source of each launch's shared-memory size, which the kernel
checks covers its layout) and torch models of the kernels' orders
(``df_qr_model``, ``df_chol_model``, ``df_trsm_model``).  The wrappers
that choose between a kernel and the plain version by device live where
the plain versions do.  Every shape within int32 extents has a kernel
route, but for K1q and ``df_chol_block`` at sizes whose vectors alone pass
shared memory, where the plan raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import build
from . import programs
from .df32 import df_add, df_sub, fast_two_sum

SMEM_MAX = 232_448        # dynamic shared memory a block may opt in to
QR_WARPS = 16             # warps of a K1q cluster CTA (df_qr.cu kMaxWarps)
CLUSTER_CTAS = 16         # CTAs of K1q's cluster routes
TRSM_WARPS = 8            # rows of X per df_trsm_rlt CTA
CTA, CLUSTER, GMEM, WHOLE, TILES = "cta", "cluster", "gmem", "whole", "tiles"
_QR_ROUTE = {CTA: 0, CLUSTER: 1, GMEM: 2}     # csrc/df_qr.cu enum Route


class LoopPlan(NamedTuple):
    route: str      # cta / cluster / gmem (K1q), cta / gmem
                    # (df_chol_block), whole / tiles / gmem (df_trsm_rlt)
    ctas: int       # CTAs launched
    rows: int       # rows a CTA holds (K1q's band; rows of X per CTA)
    tile: int       # df_trsm_rlt: columns of L staged at a time (0: gmem)
    smem: int       # bytes of dynamic shared memory per CTA
    work: int = 0   # K1q route gmem: floats of the global workspace


# ---------------------------------------------------------------------------
# plans: each route's shared memory (csrc/df_qr.cu layout(),
# csrc/df_chol.cu block_floats() / trsm_floats() check that it suffices)


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def qr_threads(m: int, r: int, route: str) -> int:
    """Threads of a K1q CTA (csrc/df_qr.cu threads_for): 512 on the
    cluster routes; on route cta the power of two at or past 2 m and 8 r,
    within 32 and 512."""
    if route != CTA:
        return 32 * QR_WARPS
    return min(32 * QR_WARPS, max(32, _pow2_ceil(max(2 * m, 8 * r))))


def coef_lanes(T: int, rows: int, j: int) -> int:
    """Lanes a column of K1q's Q^T v at step j >= 1 on T threads and a band
    of ``rows`` rows (csrc/df_qr.cu coef_lanes)."""
    return min(_pow2_floor(max(1, T // j)), 32, _pow2_ceil(max(rows, 1)))


def row_lanes(T: int, rows: int, j: int) -> int:
    """Lanes a row of K1q's Q c at step j (csrc/df_qr.cu row_lanes)."""
    return min(_pow2_floor(max(1, T // max(rows, 1))), 32,
               _pow2_ceil(max(j, 1)))


def _qr_ld(m: int, route: str) -> int:
    """K1q's column stride of a band: its rows rounded up to 32."""
    rows = m if route == CTA else -(-m // CLUSTER_CTAS)
    return max(32, -(-rows // 32) * 32)


def _qr_floats(m: int, r: int, route: str) -> int:
    ld = _qr_ld(m, route)
    n = (0 if route == GMEM else 2 * ld * r) + 2 * ld + 4 * r \
        + 2 * QR_WARPS + r
    if route != CTA:     # two exchange slots of r pairs rounded up to even
        n = -(-(n + r) // 4) * 4 + 4 * (r + (r & 1))
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
    return 2 * TRSM_WARPS * B + 2 * bufs * tile * B + 2 * B


@lru_cache(maxsize=None)
def df_trsm_plan(m: int, B: int) -> LoopPlan:
    """df_trsm_rlt's route for an (m, B) panel: ``whole`` where L fits
    beside the CTA's rows of X, ``tiles`` (two buffers of as many columns
    of L as fit, at least 8) otherwise, ``gmem_plan``'s past that."""
    ctas = -(-m // TRSM_WARPS)
    smem = 4 * _trsm_floats(B, B)
    if smem <= SMEM_MAX:
        return LoopPlan(WHOLE, ctas, TRSM_WARPS, B, smem)
    tile = (SMEM_MAX // 4 - 2 * TRSM_WARPS * B - 2 * B) // (4 * B)
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
    df_trsm_rlt: L read in place from global memory, each row of X in
    place in the output.  Raises
    ValueError for a shape whose vectors alone pass shared memory (K1q,
    df_chol_block)."""
    if entry == "df_qr":
        m, r = shape
        rows = -(-m // CLUSTER_CTAS)
        band = _qr_ld(m, GMEM) * r
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
    "xerus_df_qr_threads": [_I] * 3,
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
# torch models of the kernels' data splits and reduction orders: the same
# steps in the same orders with the kernels' arithmetic (csrc/df_arith.cuh:
# round-to-nearest f32 operations, FMA TwoProd), so on the same inputs
# they give the kernels' bits; tests/test_torch_kernels_cuda.py holds each
# kernel to its model on the card


def _two_prod(a, b):
    """FMA TwoProd: the rounded f32 product and its error, exact (an f32
    product is exact in float64, and its rounding error is an f32)."""
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def _df_mul(xh, xl, yh, yl):
    ph, pe = _two_prod(xh, yh)
    return fast_two_sum(ph, pe + (xh * yl + xl * yh))


def _df_div(xh, xl, yh, yl):
    q1 = xh / yh
    ph, pe = _two_prod(q1, yh)
    rh, _rl = df_sub(xh, xl, *fast_two_sum(ph, pe + q1 * yl))
    return fast_two_sum(q1, rh / yh)


def _df_sqrt(xh, xl):
    # the rounded square root by way of float64: torch's float32 sqrt on
    # the CPU is not always the rounded one, the kernels' __fsqrt_rn is
    s = torch.sqrt(torch.clamp_min(xh, 0.0).double()).float()
    rh, _rl = df_sub(xh, xl, *_two_prod(s, s))
    return fast_two_sum(s, torch.where(
        s > 0, rh / torch.clamp_min(2.0 * s, 1e-38), torch.zeros_like(s)))


def _lane_sums(ph, pl, lanes: int):
    """Terms along dim 0 dealt to ``lanes`` lanes (lane g the terms g,
    g + lanes, ...), each lane summing its even-numbered and odd-numbered
    terms in two accumulators from zero, then the two: (lanes, ...).  A
    lane adds only the terms it has: adding a zero term can change a df
    sum whose low word is not the high word's rounding error."""
    n = ph.shape[0]
    acc = ph.new_zeros((2, 2, lanes) + tuple(ph.shape[1:]))
    for t, s in enumerate(range(0, n, lanes)):
        c = min(lanes, n - s)
        acc[t % 2, 0, :c], acc[t % 2, 1, :c] = df_add(
            acc[t % 2, 0, :c], acc[t % 2, 1, :c], ph[s:s + c], pl[s:s + c])
    return df_add(acc[0, 0], acc[0, 1], acc[1, 0], acc[1, 1])


def _butterfly(ph, pl):
    """The xor butterfly over dim 0 (a power of two of lanes): lane 0's
    sum, ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7)) for eight."""
    while ph.shape[0] > 1:
        off = ph.shape[0] // 2
        ph, pl = df_add(ph[:off], pl[:off], ph[off:], pl[off:])
    return ph[0], pl[0]


def df_qr_model(ah, al, ctas: int = 1):
    """K1q's computation in torch on any device, in its order: the rows in
    ``ctas`` bands of ceil(m / ctas) (1: route cta, 16: routes cluster and
    gmem) on ``qr_threads`` threads a band; per band and step j, Q^T v by
    ``coef_lanes`` lanes a column (``_lane_sums``, ``_butterfly``), the
    butterfly's tree over the bands; Q c by ``row_lanes`` lanes a row; the
    norm from each thread's rows in order, the warp butterfly, the tree
    over the warps and over the bands; the plain f32 sums behind the
    threshold in torch's order.
    Returns ((Qh, Ql), (Rh, Rl), deficient) with ``deficient`` a list of
    bools."""
    m, r = ah.shape
    T = qr_threads(m, r, CTA if ctas == 1 else CLUSTER)
    rows = -(-m // ctas)
    # bands of one size at a time: (size, band indices, (size, bands) rows)
    sizes = [max(0, min(m, (b + 1) * rows) - b * rows) for b in range(ctas)]
    groups = [(n, [b for b in range(ctas) if sizes[b] == n],
               torch.stack([torch.arange(b * rows, b * rows + n)
                            for b in range(ctas) if sizes[b] == n]).T)
              for n in sorted(set(sizes)) if n > 0]
    zero = ah.new_zeros(())

    def by_band(parts_h, parts_l):
        """(..., ctas) band partials summed by the butterfly's tree."""
        return _butterfly(parts_h.movedim(-1, 0), parts_l.movedim(-1, 0))

    def coefs(qh, ql, vh, vl, j):
        ph, pl = ah.new_zeros((j, ctas)), ah.new_zeros((j, ctas))
        for n, idx, rr in groups:
            bh, bl = _butterfly(*_lane_sums(
                *_df_mul(qh[rr, :j], ql[rr, :j], vh[rr, None], vl[rr, None]),
                coef_lanes(T, n, j)))                        # (bands, j)
            ph[:, idx], pl[:, idx] = bh.T, bl.T
        return by_band(ph, pl)

    def project_out(qh, ql, ch, cl, srch, srcl, j):
        """v = src - Q c, and the norm of v."""
        vh, vl = srch.clone(), srcl.clone()
        nh, nl = ah.new_zeros(ctas), ah.new_zeros(ctas)
        for n, idx, rr in groups:
            H = row_lanes(T, n, j)
            ph = pl = ah.new_zeros(rr.shape)
            if j > 0:
                ph, pl = _butterfly(*_lane_sums(
                    *_df_mul(qh[rr, :j].permute(2, 0, 1),
                            ql[rr, :j].permute(2, 0, 1),
                            ch[:, None, None], cl[:, None, None]), H))
            bh, bl = df_sub(srch[rr], srcl[rr], ph, pl)      # (n, bands)
            vh[rr], vl[rr] = bh, bl
            # thread q H holds the rows q, q + T / H, ... in order; the
            # warp butterfly; the butterfly's tree over the warps
            nq, nb = T // H, len(idx)
            steps = -(-n // nq)
            pad = ah.new_zeros((steps * nq - n, nb))
            sh, sl = _df_mul(bh, bl, bh, bl)
            sh = torch.cat([sh, pad]).reshape(steps, nq, nb)
            sl = torch.cat([sl, pad]).reshape(steps, nq, nb)
            th, tl = ah.new_zeros((nq, nb)), ah.new_zeros((nq, nb))
            for t in range(steps):
                th, tl = df_add(th, tl, sh[t], sl[t])
            lh, ll = ah.new_zeros((T, nb)), ah.new_zeros((T, nb))
            lh[::H], ll[::H] = th, tl
            wh, wl = _butterfly(lh.reshape(-1, 32, nb).transpose(0, 1),
                                ll.reshape(-1, 32, nb).transpose(0, 1))
            nh[idx], nl[idx] = _butterfly(wh, wl)
        return vh, vl, _df_sqrt(*by_band(nh, nl))

    def rounds(srch, srcl, j, count, coefh, coefl):
        for _ in range(count):
            ch = cl = ah.new_zeros((0,))
            if j > 0:
                ch, cl = coefs(qh, ql, srch, srcl, j)
                if coefh is not None:
                    coefh, coefl = df_add(coefh, coefl, ch, cl)
            srch, srcl, n = project_out(qh, ql, ch, cl, srch, srcl, j)
        return srch, srcl, n, coefh, coefl

    colsq = (ah * ah).sum(0)
    mat_scale = torch.sqrt(torch.max(colsq))
    qh, ql = ah.new_zeros((m, r)), ah.new_zeros((m, r))
    rh, rl = ah.new_zeros((r, r)), ah.new_zeros((r, r))
    deficient = []
    for j in range(r):
        orig_norm = torch.sqrt(colsq[j]) + 1e-38
        vh, vl, (nh, nl), coefh, coefl = rounds(
            ah[:, j], al[:, j], j, 2, ah.new_zeros((j,)), ah.new_zeros((j,)))
        thr = torch.maximum(1e-12 * orig_norm, 1e-13 * mat_scale) + 1e-30
        bad = bool(nh <= thr)
        deficient.append(bad)
        n2h, n2l = nh, nl
        if bad:
            eh = ah.new_zeros((m,))
            eh[j % m] = 1.0
            vh, vl, (n2h, n2l), _, _ = rounds(eh, torch.zeros_like(eh), j,
                                              1, None, None)
            nh, nl = zero, zero
        inv_h, inv_l = _df_div(ah.new_ones(()), zero,
                              torch.clamp_min(n2h, 1e-20), n2l)
        qh[:, j], ql[:, j] = _df_mul(vh, vl, inv_h, inv_l)
        rh[:j, j], rl[:j, j] = coefh, coefl
        rh[j, j], rl[j, j] = nh, nl
    return (qh, ql), (rh, rl), deficient


def df_chol_model(Ah, Al):
    """``df_chol_block``'s right-looking order in torch: step j updates the
    trailing block by column j - 1 (a_ik -= L_i,j-1 L_k,j-1), then
    L_jj = df_sqrt(max(a_jj, 1e-30)) and L_ij = df_div(a_ij, L_jj).
    Returns lower-triangular (Lh, Ll)."""
    B = Ah.shape[0]
    wh, wl = Ah.clone(), Al.clone()
    Lh, Ll = Ah.new_zeros((B, B)), Ah.new_zeros((B, B))
    for j in range(B):
        if j > 0:
            ch, cl = Lh[j:, j - 1], Ll[j:, j - 1]
            uh, ul = _df_mul(ch[:, None], cl[:, None], ch[None, :],
                            cl[None, :])
            wh[j:, j:], wl[j:, j:] = df_sub(wh[j:, j:], wl[j:, j:], uh, ul)
        dh, dl = _df_sqrt(torch.clamp_min(wh[j, j], 1e-30), wl[j, j])
        Lh[j, j], Ll[j, j] = dh, dl
        Lh[j + 1:, j], Ll[j + 1:, j] = _df_div(wh[j + 1:, j], wl[j + 1:, j],
                                              dh, dl)
    return Lh, Ll


def df_trsm_model(Ah, Al, Lh, Ll):
    """``df_trsm_rlt``'s right-looking order in torch, all rows at once:
    step j, x_j = df_div(a_j, L_jj), then a_k -= x_j L_kj for k > j.
    Returns (Xh, Xl)."""
    B = Ah.shape[1]
    xh, xl = Ah.clone(), Al.clone()
    for j in range(B):
        ch, cl = _df_div(xh[:, j], xl[:, j], Lh[j, j], Ll[j, j])
        xh[:, j], xl[:, j] = ch, cl
        if j + 1 < B:
            ph, pl = _df_mul(ch[:, None], cl[:, None], Lh[None, j + 1:, j],
                            Ll[None, j + 1:, j])
            xh[:, j + 1:], xl[:, j + 1:] = df_sub(xh[:, j + 1:],
                                                  xl[:, j + 1:], ph, pl)
    return xh, xl


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
