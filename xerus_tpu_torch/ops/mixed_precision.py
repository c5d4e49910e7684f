"""Mixed-precision (double-word f32) TT operations: the path to f64-quality
residuals without float64 compute.

Counterpart of ``xerus_tpu/ops/mixed_precision.py``: df tensor
contractions, a thin df QR (CGS2) and the single-site SPD ALS half-sweep
in df precision, whose only f32-approximate step is the Cholesky
preconditioner inside the refined local solves (``df_als_sweep``,
``df_als_multi_sweep``); ``als_f32_df_run``, the whole mixed-precision
solve (f32 half-sweeps to the f32 plateau, then df half-sweeps); and
``als_spd_mixed``, df half-sweeps on TT objects.  The JAX package compiled
each into one XLA program; here each f32 half-sweep with its residual and
each df half-sweep is one captured program (``make_als_sweep_res``,
``make_df_als_sweep``; ``ops/programs.py``), replayed on the card and run
eagerly on the CPU, with one host read per odd f32 half-sweep for the stop
rule and none in the df phase.  The df QR's column loop is one launch of
kernel K1q on the card (``ops/df_loops.py``), inside the df half-sweep's
graph.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .df32 import (DF, df_add, df_matmul, df_matvec, df_mul, df_reduce_sum,
                   df_solve_spd_refined, df_sub, fast_two_sum, two_prod)
from . import df_loops
from .als_kernels import make_als_sweep_res
from . import programs
from .programs import Program, call, factory


# ---------------------------------------------------------------------------
# scalar helpers
# ---------------------------------------------------------------------------

def df_div(xh, xl, yh, yl):
    q1 = xh / yh
    # r = x - q1*y in df
    ph, pe = two_prod(q1, yh)
    pe = pe + q1 * yl
    rh, rl = df_sub(xh, xl, *fast_two_sum(ph, pe))
    q2 = rh / yh
    return fast_two_sum(q1, q2)


def df_sqrt(xh, xl):
    s = torch.sqrt(torch.clamp_min(xh, 0.0))
    ph, pe = two_prod(s, s)
    rh, rl = df_sub(xh, xl, ph, pe)
    e = torch.where(s > 0, rh / torch.clamp_min(2.0 * s, 1e-38),
                    torch.zeros_like(s))
    return fast_two_sum(s, e)


def df_dot_vec(xh, xl, yh, yl):
    ph, pl = df_mul(xh, xl, yh, yl)
    return df_reduce_sum(ph, pl, axis=0)


def df_norm_vec(xh, xl):
    sh, sl = df_dot_vec(xh, xl, xh, xl)
    return df_sqrt(sh, sl)


# ---------------------------------------------------------------------------
# df tensordot (np.tensordot axes semantics)
# ---------------------------------------------------------------------------

def df_tensordot(a: DF, b: DF, axes) -> DF:
    ah, al = a
    bh, bl = b
    if isinstance(axes, int):
        a_axes = list(range(ah.dim() - axes, ah.dim()))
        b_axes = list(range(axes))
    else:
        a_axes = [ax % ah.dim() for ax in np.atleast_1d(axes[0])]
        b_axes = [ax % bh.dim() for ax in np.atleast_1d(axes[1])]
    a_free = [i for i in range(ah.dim()) if i not in a_axes]
    b_free = [i for i in range(bh.dim()) if i not in b_axes]
    k = int(np.prod([ah.shape[i] for i in a_axes])) if a_axes else 1
    m = int(np.prod([ah.shape[i] for i in a_free])) if a_free else 1
    n = int(np.prod([bh.shape[i] for i in b_free])) if b_free else 1
    pa, pb = a_free + a_axes, b_axes + b_free
    oh, ol = df_matmul(ah.permute(pa).reshape(m, k),
                       al.permute(pa).reshape(m, k),
                       bh.permute(pb).reshape(k, n),
                       bl.permute(pb).reshape(k, n))
    shape = (tuple(ah.shape[i] for i in a_free)
             + tuple(bh.shape[i] for i in b_free))
    return oh.reshape(shape), ol.reshape(shape)


# ---------------------------------------------------------------------------
# df thin QR by twice-reorthogonalized classical Gram-Schmidt (CGS2)
# ---------------------------------------------------------------------------

def df_qr(ah: torch.Tensor, al: torch.Tensor) -> Tuple[DF, DF]:
    """Thin QR of an (m, r) df matrix, m >= r.  Returns (Q, R) as df pairs.

    On CPU tensors the plain version ``df_qr_reference``; on CUDA tensors
    kernel K1q in one launch (``df_loops.df_qr_launch``, route cta, cluster
    or gmem by ``df_loops.df_qr_plan``, which raises for a shape no route
    holds).  A failed launch raises."""
    df_qr.calls += 1
    if ah.device.type == "cpu":
        return df_qr_reference(ah, al)
    if ah.device.type != "cuda":
        raise RuntimeError(f"df_qr: no kernel for device {ah.device}")
    return df_loops.df_qr_launch(ah, al, df_loops.df_qr_plan(*ah.shape))


df_qr.calls = 0
programs.counter(df_qr, "calls")


def df_qr_reference(ah: torch.Tensor, al: torch.Tensor) -> Tuple[DF, DF]:
    """The plain version of ``df_qr``: thin QR of an (m, r) df matrix by a
    column loop of torch df operations.

    Sequential over columns; each step is df matvecs (CGS2).  A column
    whose post-projection norm is f32 noise relative to the matrix carries
    no df-trustworthy direction: normalizing it would give a column
    orthogonal only to ~f32 accuracy and floor the df sweep at f32
    residuals, so it takes the projected canonical vector instead.  Both
    branches are computed and selected on the device (no host sync)."""
    m, r = ah.shape
    zero = ah.new_zeros(())
    one = ah.new_ones(())
    mat_scale = torch.sqrt(torch.max(torch.sum(ah * ah, dim=0)))
    qh = ah.new_zeros((m, r))
    ql = ah.new_zeros((m, r))
    rh_ = ah.new_zeros((r, r))
    rl_ = ah.new_zeros((r, r))
    for j in range(r):
        vh, vl = ah[:, j], al[:, j]
        orig_norm = torch.sqrt(torch.sum(vh * vh)) + 1e-38
        # two rounds of projection against the (zero-padded) current Q
        coefh = ah.new_zeros((r,))
        coefl = ah.new_zeros((r,))
        for _ in range(2):
            ch, cl = df_matvec(qh.T, ql.T, vh, vl)           # (r,)
            pjh, pjl = df_matvec(qh, ql, ch, cl)             # (m,)
            vh, vl = df_sub(vh, vl, pjh, pjl)
            coefh, coefl = df_add(coefh, coefl, ch, cl)
        nh, nl = df_norm_vec(vh, vl)
        # the absolute floor catches exactly-zero columns, whose relative
        # threshold underflows
        deficient = nh <= torch.maximum(1e-12 * orig_norm,
                                        1e-13 * mat_scale) + 1e-30
        eh = ah.new_zeros((m,))
        eh[j % m] = 1.0
        fch, fcl = df_matvec(qh.T, ql.T, eh, torch.zeros_like(eh))
        fph, fpl = df_matvec(qh, ql, fch, fcl)
        fvh, fvl = df_sub(eh, torch.zeros_like(eh), fph, fpl)
        fnh, fnl = df_norm_vec(fvh, fvl)
        vh = torch.where(deficient, fvh, vh)
        vl = torch.where(deficient, fvl, vl)
        nh2 = torch.where(deficient, fnh, nh)
        nl2 = torch.where(deficient, fnl, nl)
        inv_h, inv_l = df_div(one, zero, torch.clamp_min(nh2, 1e-20), nl2)
        qcol_h, qcol_l = df_mul(vh, vl, inv_h, inv_l)
        # the R diagonal keeps the original (possibly ~0) norm
        nh = torch.where(deficient, zero, nh)
        nl = torch.where(deficient, zero, nl)
        qh[:, j] = qcol_h
        ql[:, j] = qcol_l
        coefh[j] = nh
        coefl[j] = nl
        rh_[:, j] = coefh
        rl_[:, j] = coefl
    return (qh, ql), (rh_, rl_)


# ---------------------------------------------------------------------------
# Mixed-precision SPD ALS half-sweep
# ---------------------------------------------------------------------------

def _env_push_right(xc: DF, Ac: DF, env: DF) -> DF:
    """Right environment (U,b,V) of the sites right of xc -> (u,a,v)."""
    t1 = df_tensordot(xc, env, axes=([2], [0]))          # (u,m,b,V)
    t2 = df_tensordot(t1, Ac, axes=([1, 2], [1, 3]))     # (u,V,a,n)
    return df_tensordot(t2, xc, axes=([3, 1], [1, 2]))   # (u,a,v)


def _rhs_push_right(xc: DF, bc: DF, env: DF) -> DF:
    t1 = df_tensordot(xc, env, axes=([2], [0]))          # (u,m,B)
    return df_tensordot(t1, bc, axes=([1, 2], [1, 2]))   # (u,b)


def _env_push_left(xc: DF, Ac: DF, env: DF) -> DF:
    t1 = df_tensordot(env, xc, axes=([0], [0]))          # (a,v,m,U)
    t2 = df_tensordot(t1, Ac, axes=([0, 2], [0, 1]))     # (v,U,n,b)
    return df_tensordot(t2, xc, axes=([0, 2], [0, 1]))   # (U,b,V)


def _rhs_push_left(xc: DF, bc: DF, env: DF) -> DF:
    t1 = df_tensordot(env, xc, axes=([0], [0]))          # (b,m,U)
    return df_tensordot(t1, bc, axes=([0, 1], [0, 1]))   # (U,B)


def _als_half_sweep_df(x_cores: Sequence[DF], A_cores: Sequence[DF],
                       b_cores: Sequence[DF], refine_iters: int = 3
                       ) -> Tuple[DF, ...]:
    """Left-to-right single-site SPD half-sweep in df precision; x
    canonicalized at site 0 (df-orthogonal).  Mirrors
    ``als_kernels._als_half_sweep``."""
    d = len(x_cores)
    ref = x_cores[0][0]
    one3 = (ref.new_ones((1, 1, 1)), ref.new_zeros((1, 1, 1)))
    one2 = (ref.new_ones((1, 1)), ref.new_zeros((1, 1)))
    op_right: List[DF] = [one3]
    rhs_right: List[DF] = [one2]
    for k in range(d - 1, 0, -1):
        op_right.append(_env_push_right(x_cores[k], A_cores[k],
                                        op_right[-1]))
        rhs_right.append(_rhs_push_right(x_cores[k], b_cores[k],
                                         rhs_right[-1]))

    x_out = list(x_cores)
    op_left, rhs_left = one3, one2
    for k in range(d):
        Ac, bc = A_cores[k], b_cores[k]
        Renv = op_right[d - 1 - k]
        Rrhs = rhs_right[d - 1 - k]
        # Aloc[(u m U),(v n V)] = L[u,a,v] A[a,m,n,b] R[U,b,V]
        t = df_tensordot(op_left, Ac, axes=([1], [0]))       # (u,v,m,n,b)
        th, tl = df_tensordot(t, Renv, axes=([4], [1]))      # (u,v,m,n,U,V)
        th = th.permute(0, 2, 4, 1, 3, 5)                    # (u,m,U,v,n,V)
        tl = tl.permute(0, 2, 4, 1, 3, 5)
        u_, m_, U_ = th.shape[0], th.shape[1], th.shape[2]
        nn = u_ * m_ * U_
        # bloc[u m U] = Lb[u,b] b[b,m,B] Rb[U,B]
        t = df_tensordot(rhs_left, bc, axes=([1], [0]))      # (u,m,B)
        bh, bl = df_tensordot(t, Rrhs, axes=([2], [1]))      # (u,m,U)
        xh, xl = df_solve_spd_refined(th.reshape(nn, nn), tl.reshape(nn, nn),
                                      bh.reshape(nn), bl.reshape(nn),
                                      iterations=refine_iters)
        if k < d - 1:
            (Qh, Ql), R = df_qr(xh.reshape(u_ * m_, U_),
                                xl.reshape(u_ * m_, U_))
            kk = Qh.shape[1]
            x_out[k] = (Qh.reshape(u_, m_, kk), Ql.reshape(u_, m_, kk))
            x_out[k + 1] = df_tensordot(R, x_out[k + 1], axes=([1], [0]))
            op_left = _env_push_left(x_out[k], Ac, op_left)
            rhs_left = _rhs_push_left(x_out[k], bc, rhs_left)
        else:
            x_out[k] = (xh.reshape(u_, m_, U_), xl.reshape(u_, m_, U_))
    return tuple(x_out)


def _reverse_df(cores: Sequence[DF], op: bool = False) -> Tuple[DF, ...]:
    """Site reversal: the chain read from the other end (exact transposes)."""
    perm = (3, 1, 2, 0) if op else (2, 1, 0)
    return tuple((h.permute(perm), l.permute(perm)) for (h, l) in reversed(cores))


df_als_sweep = _als_half_sweep_df


def _contiguous(cores: Sequence[DF]) -> Tuple[DF, ...]:
    """Copies with row-major strides, size-1 dimensions' included (which
    ``Tensor.contiguous`` leaves as they are)."""
    return tuple((h.clone(memory_format=torch.contiguous_format),
                  l.clone(memory_format=torch.contiguous_format))
                 for (h, l) in cores)


@factory(16)
def make_df_als_sweep(shapes_key, dtype_str: str, refine_iters: int = 3
                      ) -> Program:
    """One df half-sweep as a program: (x_df, A_df, b_df) -> x_df."""
    return Program(partial(_als_half_sweep_df, refine_iters=refine_iters),
                   "df_als_sweep")


def df_als_multi_sweep(x_df: Sequence[DF], A_df: Sequence[DF],
                       b_df: Sequence[DF], n_half_sweeps: int,
                       refine_iters: int = 3, eager: bool = False
                       ) -> Tuple[DF, ...]:
    """``n_half_sweeps`` df half-sweeps alternating direction by site
    reversal (exact transposes), starting left to right; x enters
    canonicalized at site 0 and leaves unreversed.

    Each half-sweep is one replay of ``make_df_als_sweep``'s program on
    contiguous chains: the reversed operator and right-hand side are
    copied once, x after each half-sweep, so a chain whose reversal has
    its own shapes (the QTT Poisson system's symmetric ranks) replays one
    graph in both directions.  ``eager`` runs the half-sweeps eagerly on
    the reversed views instead (the plain version)."""
    x_df, A_df, b_df = tuple(x_df), tuple(A_df), tuple(b_df)
    if eager:
        for _ in range(n_half_sweeps):
            x_df = _als_half_sweep_df(x_df, A_df, b_df,
                                      refine_iters=refine_iters)
            x_df = _reverse_df(x_df)
            A_df = _reverse_df(A_df, op=True)
            b_df = _reverse_df(b_df)
    else:
        x_df = _contiguous(x_df)
        chains = ((_contiguous(A_df), _contiguous(b_df)),
                  (_contiguous(_reverse_df(A_df, op=True)),
                   _contiguous(_reverse_df(b_df))))
        for s in range(n_half_sweeps):
            A, b = chains[s % 2]
            x_df = _contiguous(_reverse_df(call(
                make_df_als_sweep, (x_df, A, b), refine_iters)))
    if n_half_sweeps % 2 == 1:
        x_df = _reverse_df(x_df)
    return x_df


@lru_cache(maxsize=8)
def make_df_als_multi_sweep(shapes_key, dtype_str: str, n_half_sweeps: int,
                            refine_iters: int = 3):
    """``df_als_multi_sweep`` with its static arguments bound: (x_df,
    A_df, b_df) -> x_df, one program replay per half-sweep."""
    return partial(df_als_multi_sweep, n_half_sweeps=n_half_sweeps,
                   refine_iters=refine_iters)


def df_split(t: torch.Tensor) -> DF:
    """A float64 tensor as its (hi, lo) float32 pair on its device, the
    split of ``df32.df_from_f64``."""
    hi = t.to(torch.float32)
    return hi, (t - hi.to(torch.float64)).to(torch.float32)


def df_join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi + lo in float64 on their device."""
    return hi.to(torch.float64) + lo.to(torch.float64)


# ---------------------------------------------------------------------------
# The whole mixed-precision solve
# ---------------------------------------------------------------------------

def f32_half_sweep(cores, A32, b32, even: bool, eager: bool = False):
    """One f32 half-sweep of ``als_f32_df_run`` and the relative residual
    after it, lr when ``even``: a call of ``make_als_sweep_res``'s program
    in the form the solve makes (``warmup`` warms it so)."""
    return call(make_als_sweep_res, (tuple(cores), tuple(A32), tuple(b32)),
                "lr" if even else "rl", eager=eager)


def als_f32_df_run(x32: Sequence[torch.Tensor], A32: Sequence[torch.Tensor],
                   b32: Sequence[torch.Tensor], A_df: Sequence[DF],
                   b_df: Sequence[DF], max_f32_sweeps: int, df_sweeps: int,
                   refine_iters: int = 3, eager: bool = False):
    """f32 SPD half-sweeps (lr/rl by parity, relative residual after each)
    until the f32 plateau (res > 0.3 * res two sweeps back) or the cap,
    then a df seed (hi = f32 cores, lo = 0) and ``df_sweeps`` df
    half-sweeps, alternating direction by site reversal.

    Counterpart of ``make_als_f32_df_run(...)(x32, A32, b32, A_df, b_df)``.
    x32 must be canonicalized at site 0.  Returns (df_cores, f32_hist,
    f32_count): f32_hist is a (max_f32_sweeps,) tensor, inf past the count.

    The df phase needs the core at site 0, so both exits of the f32 loop,
    the plateau stop and the cap, land on even counts; the stop rule reads
    one boolean to the host after each odd half-sweep.  Each f32
    half-sweep with its residual is a replay of ``make_als_sweep_res``'s
    program and each df half-sweep of ``make_df_als_sweep``'s (a program's
    first ``programs.EAGER_CALLS`` calls per shape key run eagerly, the
    next captures).  ``eager`` runs the same functions eagerly (the plain
    version)."""
    max_even = max_f32_sweeps - (max_f32_sweeps % 2)
    ref = x32[0]
    hist = torch.full((max_f32_sweeps,), float("inf"), dtype=ref.dtype,
                      device=ref.device)
    cores = tuple(x32)
    r_prev = r_prev2 = ref.new_full((), float("inf"))
    i = 0
    while i < max_even:
        cores, res = f32_half_sweep(cores, A32, b32, i % 2 == 0, eager)
        hist[i] = res
        stop = i % 2 == 1 and bool(res > 0.3 * r_prev2)
        r_prev2, r_prev = r_prev, res
        i += 1
        if stop:
            break

    x_df = tuple((c, torch.zeros_like(c)) for c in cores)
    return (df_als_multi_sweep(x_df, A_df, b_df, df_sweeps, refine_iters,
                               eager), hist, i)


@lru_cache(maxsize=8)
def make_als_f32_df_run(shapes_key, dtype_str: str, max_f32_sweeps: int,
                        df_sweeps: int, refine_iters: int = 3):
    """``als_f32_df_run`` with its static arguments bound: (x32, A32, b32,
    A_df, b_df) -> (df_cores, f32_hist, f32_count)."""
    return partial(als_f32_df_run, max_f32_sweeps=max_f32_sweeps,
                   df_sweeps=df_sweeps, refine_iters=refine_iters)


def als_spd_mixed(A, x, b, num_half_sweeps: int = 6) -> List[torch.Tensor]:
    """Mixed-precision single-site SPD ALS on TT objects: the float64
    components split into df pairs on their device, then df half-sweeps
    in pairs (each pair starts and ends unreversed; an odd count rounds up
    to the next even, as in the JAX package).  ``x`` is not changed.
    Returns the refined cores as float64 tensors on the device; verify the
    residual in float64 (the df quadratic form would cancel below
    ~1e-7)."""
    from ..config import require
    require(A.is_symmetric(),
            "als_spd_mixed requires a symmetric operator; "
            "use ALS_SPD for general operators")
    x = x.copy()
    x.move_core(0)
    x_df = tuple(df_split(c._torch()) for c in x.components)
    A_df = tuple(df_split(c._torch()) for c in A.components)
    b_df = tuple(df_split(c._torch()) for c in b.components)
    for _ in range((int(num_half_sweeps) + 1) // 2):
        x_df = df_als_multi_sweep(x_df, A_df, b_df, 2)
    return [df_join(h, l) for (h, l) in x_df]
