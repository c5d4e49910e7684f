"""float64-quality TT rounding in double-word f32.

Counterpart of ``xerus_tpu/ops/df_rounding.py``.  The f32 sweeps round at
~1e-7 relative, so eps thresholds below that are invisible to them; here
both passes run in double-word f32 and the truncation decisions and kept
factors carry ~2^-48:

- orthogonalization: df CholeskyQR per site (Gram by Ozaki GEMM, blocked
  df Cholesky, df triangular solve), with the CGS2 df QR
  (``mixed_precision.df_qr``) where the Gram conditioning defeats it;
- truncation: the Gram-route df SVD (``df_eigh.df_svd``) per site.

Sequential over sites like the reference, whose three jitted site steps
(``_jit_qr_apply``, ``_jit_svd_site``, ``_jit_trunc_apply``) are
captured programs here (``make_qr_apply``, ``make_svd_site``,
``make_trunc_apply``; eager on the CPU), keyed as the reference keys
them.  The reference chose the CGS2 branch inside its program
(``lax.cond`` on the orthogonality defect); here both branches run and
``torch.where`` selects on the device, so a site reads nothing back.  The
sites that took CGS2 are summed on the device and read once a call,
together with K4's health record (the seed eigh of ``df_svd``), counted
in ``tt_round_df.cgs2_fallbacks``.  The per-site singular values are read
to the host between the SVD and truncation programs for the rank
decision, as in the reference; each read counts in
``round_kernels.host_bool.reads``.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import small_eig
from .df32 import df_from_f64, df_mul, df_to_f64
from .df_cholesky import _df_trsm_rlt, df_cholesky
from .df_eigh import df_svd
from .mixed_precision import df_qr as _df_qr_cgs2
from .ozaki import ozaki_matmul
from .programs import Program, call, factory
from .round_kernels import host_bool

# orthogonality defect ||Q^T Q - I|| above which a site takes CGS2
CGS2_DEFECT = 1e-11


def _df_qr_chol(Mh, Ml):
    """df thin QR of a tall (m, r) df matrix via CholeskyQR:
    G = M^T M (Ozaki), L = df_chol(G), Q = M L^-T, R = L^T."""
    Gh, Gl = ozaki_matmul(Mh.T, Ml.T, Mh, Ml)
    Lh, Ll = df_cholesky(Gh, Gl, block=min(64, Gh.shape[0]))
    Qh, Ql = _df_trsm_rlt(Mh, Ml, Lh, Ll)
    return Qh, Ql, Lh.T, Ll.T


def _qr_apply(Mh, Ml, nh, nl):
    """Orthogonalization step: df CholeskyQR, or CGS2 where its df
    orthogonality defect exceeds ``CGS2_DEFECT`` (CholeskyQR squares the
    condition: directions below ~sqrt(u_df) * sigma_max are lost).  Both
    run and the defect selects on the device, the counterpart of the
    reference's ``lax.cond``.  Returns (Q, R @ next, whether CGS2 was
    taken as a 0-d bool)."""
    Qh, Ql, Rh, Rl = _df_qr_chol(Mh, Ml)
    r = Qh.shape[1]
    Gh, Gl = ozaki_matmul(Qh.T, Ql.T, Qh, Ql)
    # Gh - I is Sterbenz-exact on the diagonal; adding the low word keeps
    # the estimate meaningful below f32 resolution
    eye = torch.eye(r, dtype=Gh.dtype, device=Gh.device)
    defect = torch.linalg.vector_norm((Gh - eye) + Gl)
    took = defect > CGS2_DEFECT
    (Q2h, Q2l), (R2h, R2l) = _df_qr_cgs2(Mh, Ml)
    Qh, Ql, Rh, Rl = (torch.where(took, a, b) for a, b in
                      zip((Q2h, Q2l, R2h, R2l), (Qh, Ql, Rh, Rl)))
    Ph, Pl = ozaki_matmul(Rh, Rl, nh, nl)
    return Qh, Ql, Ph, Pl, took


def _svd_site(Mh, Ml):
    """df_svd of the transposed (rl, n rr) unfolding (tall side first for
    the Gram)."""
    return df_svd(Mh.T, Ml.T)


def _trunc_apply(keep, Uh, Ul, Vh, Vl, sh, sl, ph, pl):
    USh, USl = df_mul(Vh[:, :keep], Vl[:, :keep], sh[None, :keep],
                      sl[None, :keep])
    Ph, Pl = ozaki_matmul(ph, pl, USh, USl)
    return Uh[:, :keep].T, Ul[:, :keep].T, Ph, Pl


@factory(64)
def make_qr_apply(shapes_key, dtype_str: str) -> Program:
    """``_qr_apply`` as a program: (Mh, Ml, nh, nl) -> (Qh, Ql, Ph, Pl,
    took) (the reference's ``_jit_qr_apply``, keyed by both operands'
    shapes and the dtype)."""
    return Program(_qr_apply, "df_qr_apply")


@factory(64)
def make_svd_site(shapes_key, dtype_str: str) -> Program:
    """``_svd_site`` as a program: (Mh, Ml) -> (Uh, Ul, sh, sl, Vh, Vl)
    (the reference's ``_jit_svd_site``)."""
    return Program(_svd_site, "df_svd_site")


@factory(64)
def make_trunc_apply(shapes_key, dtype_str: str, keep: int) -> Program:
    """``_trunc_apply`` at ``keep`` as a program: (Uh, Ul, Vh, Vl, sh, sl,
    ph, pl) -> (U^T h, U^T l, Ph, Pl) (the reference's
    ``_jit_trunc_apply``, keyed by keep and the shapes)."""
    return Program(partial(_trunc_apply, keep), f"df_trunc_apply[{keep}]")


def tt_round_df(cores_h: Sequence[torch.Tensor],
                cores_l: Sequence[torch.Tensor], target_rank: int,
                eps: float = 0.0, eager: bool = False):
    """Round a df TT (float32 (hi, lo) cores (rl, n, rr)) to
    ``target_rank`` and/or relative ``eps`` in double-word arithmetic.
    Returns (cores_h, cores_l) lists with trimmed ranks.  Each site step
    is its program on the card, or with ``eager`` its function run
    eagerly."""
    d = len(cores_h)
    ch = list(cores_h)
    cl = list(cores_l)
    took = []

    # left -> right df CholeskyQR orthogonalization
    for k in range(d - 1):
        rl, n, rr = ch[k].shape
        Qh, Ql, Ph, Pl, t = call(make_qr_apply, (
            ch[k].reshape(rl * n, rr), cl[k].reshape(rl * n, rr),
            ch[k + 1].reshape(rr, -1), cl[k + 1].reshape(rr, -1)),
            eager=eager)
        took.append(t)
        ch[k] = Qh.reshape(rl, n, rr)
        cl[k] = Ql.reshape(rl, n, rr)
        ch[k + 1] = Ph.reshape(ch[k + 1].shape)
        cl[k + 1] = Pl.reshape(cl[k + 1].shape)

    # right -> left df SVD truncation
    for k in range(d - 1, 0, -1):
        rl, n, rr = ch[k].shape
        Uh, Ul, sh, sl, Vh, Vl = call(make_svd_site, (
            ch[k].reshape(rl, n * rr), cl[k].reshape(rl, n * rr)),
            eager=eager)
        host_bool.reads += 1
        s_host = df_to_f64(sh, sl)
        keep = int(min(target_rank, rl, n * rr))
        if eps > 0.0:
            keep = min(keep, max(1, int(np.sum(s_host > eps * s_host[0]))))
        # M^T = U S V^T  =>  M = (V S) U^T: core k <- U^T (row-orthonormal
        # (keep, n, rr)); V S goes into core k-1 (contracted over rl)
        Ut_h, Ut_l, Ph, Pl = call(make_trunc_apply, (
            Uh, Ul, Vh, Vl, sh, sl, ch[k - 1].reshape(-1, rl),
            cl[k - 1].reshape(-1, rl)), keep, eager=eager)
        ch[k] = Ut_h.reshape(keep, n, rr)
        cl[k] = Ut_l.reshape(keep, n, rr)
        shape = tuple(ch[k - 1].shape[:2]) + (keep,)
        ch[k - 1] = Ph.reshape(shape)
        cl[k - 1] = Pl.reshape(shape)
    if took:
        # one read: the CGS2 sites and, on the card, K4's health record
        host_bool.reads += 1
        tt_round_df.cgs2_fallbacks += small_eig.check_health_and(
            ch[0].device, torch.stack(took).sum().reshape(1))[1][0]
    return ch, cl


# CGS2 orthogonalizations taken by tt_round_df, all calls
tt_round_df.cgs2_fallbacks = 0


def tt_round_df_from_f64(cores64: Sequence[np.ndarray], target_rank: int,
                         eps: float = 0.0,
                         device: Optional[torch.device] = None,
                         eager: bool = False) -> List[np.ndarray]:
    """float64 host cores in, float64 host cores out, double-word inside on
    ``device`` (default: where object computations run, the card unless
    the caller entered ``host()``); ``eager`` as ``tt_round_df``'s."""
    if device is None:
        from ..config import compute_device
        device = compute_device()
    hs, ls = [], []
    for c in cores64:
        h, l = df_from_f64(np.asarray(c, np.float64), device)
        hs.append(h)
        ls.append(l)
    ch, cl = tt_round_df(hs, ls, target_rank, eps, eager)
    return [df_to_f64(h, l) for h, l in zip(ch, cl)]
