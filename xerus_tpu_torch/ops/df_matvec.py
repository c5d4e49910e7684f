"""K1: the one-pass double-word f32 matvec, hand-written in CUDA for Hopper.

Counterpart of ``xerus_tpu/ops/pallas_df.py`` (``_df_matvec_kernel``,
entry ``pallas_df_matvec``).  The kernel is ``csrc/df_matvec.cu``; its
header says what bounds it on the card and how the design answers.

``df_matvec`` takes the plain version ``df_matvec_reference`` for tensors
on the CPU, and only there.  For CUDA tensors it launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import build
from . import programs
# the plain version: broadcast df products + pairwise tree, in torch
from .df32 import df_matvec as df_matvec_reference

_C_FN = "xerus_df_matvec_f32"


@lru_cache(maxsize=1)
def _kernel():
    lib = build.load_kernel_library("df_matvec")
    fn = getattr(lib, _C_FN)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def df_matvec(Ah, Al, xh, xl):
    """df (m,k) @ df (k,) -> df (m,).

    ``df_matvec.calls`` counts every call; ``df_matvec.launches`` counts the
    kernel launches, and only those."""
    df_matvec.calls += 1
    if Ah.device.type == "cpu":
        return df_matvec_reference(Ah, Al, xh, xl)
    if Ah.device.type != "cuda":
        raise RuntimeError(f"df_matvec: no kernel for device {Ah.device}")
    m, k = Ah.shape
    for name, t, shape in (("Ah", Ah, (m, k)), ("Al", Al, (m, k)),
                           ("xh", xh, (k,)), ("xl", xl, (k,))):
        if t.device != Ah.device:
            raise ValueError(f"df_matvec: {name} on {t.device}, Ah on "
                             f"{Ah.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"df_matvec: {name} is {t.dtype}, needs float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"df_matvec: {name} has shape {tuple(t.shape)}, "
                             f"needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"df_matvec: {name} must be contiguous")
    if m >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"df_matvec: shape {(m, k)} exceeds int32 extents")
    fn = _kernel()
    yh = torch.empty((m,), dtype=torch.float32, device=Ah.device)
    yl = torch.empty((m,), dtype=torch.float32, device=Ah.device)
    with torch.cuda.device(Ah.device):
        stream = torch.cuda.current_stream(Ah.device).cuda_stream
        rc = fn(Ah.data_ptr(), Al.data_ptr(), xh.data_ptr(), xl.data_ptr(),
                yh.data_ptr(), yl.data_ptr(), m, k, stream)
    if rc != 0:
        raise RuntimeError(f"df_matvec kernel launch failed: cudaError {rc}")
    df_matvec.launches += 1
    return yh, yl


df_matvec.calls = 0
df_matvec.launches = 0
programs.counter(df_matvec, "calls")
programs.counter(df_matvec, "launches")
