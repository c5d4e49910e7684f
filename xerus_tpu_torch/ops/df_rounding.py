"""float64-quality TT rounding in double-word f32.

Counterpart of ``xerus_tpu/ops/df_rounding.py``.  The f32 sweeps round at
~1e-7 relative, so eps thresholds below that are invisible to them; here
both passes run in double-word f32 and the truncation decisions and kept
factors carry ~2^-48:

- orthogonalization: df CholeskyQR per site (Gram by Ozaki GEMM, blocked
  df Cholesky, df triangular solve), with the CGS2 df QR
  (``mixed_precision.df_qr``) where the Gram conditioning defeats it;
- truncation: the Gram-route df SVD (``df_eigh.df_svd``) per site.

Sequential over sites like the reference.  The JAX package chose the CGS2
branch inside the program (``lax.cond`` on the orthogonality defect);
here one boolean per site is read to the host (``host_bool``) and only
the chosen branch runs; CGS2 runs are counted in
``tt_round_df.cgs2_fallbacks``.  The per-site singular values are read
to the host for the rank decision, as in the JAX package, counted with
the other reads in ``round_kernels.host_bool.reads``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .df32 import df_from_f64, df_mul, df_to_f64
from .df_cholesky import _df_trsm_rlt, df_cholesky
from .df_eigh import df_svd
from .mixed_precision import df_qr as _df_qr_cgs2
from .ozaki import ozaki_matmul
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
    """Orthogonalization step: df CholeskyQR, or CGS2 when its df
    orthogonality defect exceeds ``CGS2_DEFECT`` (CholeskyQR squares the
    condition: directions below ~sqrt(u_df) * sigma_max are lost).
    Returns (Q, R @ next)."""
    Qh, Ql, Rh, Rl = _df_qr_chol(Mh, Ml)
    r = Qh.shape[1]
    Gh, Gl = ozaki_matmul(Qh.T, Ql.T, Qh, Ql)
    # Gh - I is Sterbenz-exact on the diagonal; adding the low word keeps
    # the estimate meaningful below f32 resolution
    eye = torch.eye(r, dtype=Gh.dtype, device=Gh.device)
    defect = torch.linalg.vector_norm((Gh - eye) + Gl)
    if host_bool(defect > CGS2_DEFECT):
        tt_round_df.cgs2_fallbacks += 1
        (Qh, Ql), (Rh, Rl) = _df_qr_cgs2(Mh, Ml)
    Ph, Pl = ozaki_matmul(Rh, Rl, nh, nl)
    return Qh, Ql, Ph, Pl


def _trunc_apply(keep, Uh, Ul, Vh, Vl, sh, sl, ph, pl):
    USh, USl = df_mul(Vh[:, :keep], Vl[:, :keep], sh[None, :keep],
                      sl[None, :keep])
    Ph, Pl = ozaki_matmul(ph, pl, USh, USl)
    return Uh[:, :keep].T, Ul[:, :keep].T, Ph, Pl


def tt_round_df(cores_h: Sequence[torch.Tensor],
                cores_l: Sequence[torch.Tensor], target_rank: int,
                eps: float = 0.0):
    """Round a df TT (float32 (hi, lo) cores (rl, n, rr)) to
    ``target_rank`` and/or relative ``eps`` in double-word arithmetic.
    Returns (cores_h, cores_l) lists with trimmed ranks."""
    d = len(cores_h)
    ch = list(cores_h)
    cl = list(cores_l)

    # left -> right df CholeskyQR orthogonalization
    for k in range(d - 1):
        rl, n, rr = ch[k].shape
        Qh, Ql, Ph, Pl = _qr_apply(ch[k].reshape(rl * n, rr),
                                   cl[k].reshape(rl * n, rr),
                                   ch[k + 1].reshape(rr, -1),
                                   cl[k + 1].reshape(rr, -1))
        ch[k] = Qh.reshape(rl, n, rr)
        cl[k] = Ql.reshape(rl, n, rr)
        ch[k + 1] = Ph.reshape(ch[k + 1].shape)
        cl[k + 1] = Pl.reshape(cl[k + 1].shape)

    # right -> left df SVD truncation
    for k in range(d - 1, 0, -1):
        rl, n, rr = ch[k].shape
        # SVD of the transposed unfolding (tall side first for the Gram)
        Uh, Ul, sh, sl, Vh, Vl = df_svd(ch[k].reshape(rl, n * rr).T,
                                        cl[k].reshape(rl, n * rr).T)
        host_bool.reads += 1
        s_host = df_to_f64(sh, sl)
        keep = int(min(target_rank, rl, n * rr))
        if eps > 0.0:
            keep = min(keep, max(1, int(np.sum(s_host > eps * s_host[0]))))
        # M^T = U S V^T  =>  M = (V S) U^T: core k <- U^T (row-orthonormal
        # (keep, n, rr)); V S goes into core k-1 (contracted over rl)
        Ut_h, Ut_l, Ph, Pl = _trunc_apply(keep, Uh, Ul, Vh, Vl, sh, sl,
                                          ch[k - 1].reshape(-1, rl),
                                          cl[k - 1].reshape(-1, rl))
        ch[k] = Ut_h.reshape(keep, n, rr)
        cl[k] = Ut_l.reshape(keep, n, rr)
        shape = tuple(ch[k - 1].shape[:2]) + (keep,)
        ch[k - 1] = Ph.reshape(shape)
        cl[k - 1] = Pl.reshape(shape)
    return ch, cl


# CGS2 orthogonalizations taken by tt_round_df, all calls
tt_round_df.cgs2_fallbacks = 0


def tt_round_df_from_f64(cores64: Sequence[np.ndarray], target_rank: int,
                         eps: float = 0.0,
                         device: Optional[torch.device] = None
                         ) -> List[np.ndarray]:
    """float64 host cores in, float64 host cores out, double-word inside on
    ``device`` (default: where object computations run, the card unless
    the caller entered ``host()``)."""
    if device is None:
        from ..config import compute_device
        device = compute_device()
    hs, ls = [], []
    for c in cores64:
        h, l = df_from_f64(np.asarray(c, np.float64), device)
        hs.append(h)
        ls.append(l)
    ch, cl = tt_round_df(hs, ls, target_rank, eps)
    return [df_to_f64(h, l) for h, l in zip(ch, cl)]
