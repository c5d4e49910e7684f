"""K3: a TT evaluated at M index tuples, hand-written in CUDA for Hopper.

Counterpart of ``xerus_tpu/ops/pallas_tt_eval.py`` (``_tt_eval_kernel``,
entry ``tt_eval_at_points_pallas``) and of the XLA path of
``xerus_tpu/algorithms/measurements.py`` ``_evaluate_tt_at_points``.  The
kernel is ``csrc/tt_eval.cu``; its header says what bounds it on the card
and how the design answers.

``tt_eval_at_points`` takes the plain version
``tt_eval_at_points_reference`` for tensors on the CPU, and only there.
For CUDA tensors it launches the kernel at every M and every rank, or
raises: the TPU's gates (M >= 512, ranks <= 128) and its f32 downcast of
f64 input are not carried over.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence

import torch

from .. import build
from .stacking import pad_cores


def tt_eval_at_points_reference(cores: Sequence[torch.Tensor],
                                positions: torch.Tensor) -> torch.Tensor:
    """values[m] = TT[positions[m]]: one gather and one batched product
    per site, the frontier (M, r) written between sites, as the JAX
    package's XLA path does.  ``positions`` is (M, d) int64 on the cores'
    device."""
    M = positions.shape[0]
    F = cores[0].new_ones((M, 1))
    for k, C in enumerate(cores):
        taken = C[:, positions[:, k], :]             # (rl, M, rr)
        F = torch.einsum("ma,amb->mb", F, taken)
    return F[:, 0]


@lru_cache(maxsize=1)
def _library():
    lib = build.load_kernel_library("tt_eval")
    lib.xerus_tt_eval_scratch_elems.argtypes = [ctypes.c_int,
                                                ctypes.c_longlong]
    lib.xerus_tt_eval_scratch_elems.restype = ctypes.c_longlong
    for name in ("xerus_tt_eval_f32", "xerus_tt_eval_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(cores: Sequence[torch.Tensor], positions: torch.Tensor) -> None:
    if not cores:
        raise ValueError("tt_eval_at_points: no cores")
    dev, dtype = cores[0].device, cores[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tt_eval_at_points: cores are {dtype}, need "
                        "float32 or float64")
    for k, c in enumerate(cores):
        if c.device != dev or c.dtype != dtype:
            raise ValueError(f"tt_eval_at_points: core {k} is {c.dtype} on "
                             f"{c.device}, core 0 {dtype} on {dev}")
        if c.dim() != 3:
            raise ValueError(f"tt_eval_at_points: core {k} must be an "
                             "(rl, n, rr) tensor")
    if positions.device != dev:
        raise ValueError(f"tt_eval_at_points: positions on "
                         f"{positions.device}, cores on {dev}")
    if positions.dtype != torch.int64:
        raise TypeError(f"tt_eval_at_points: positions are "
                        f"{positions.dtype}, need int64")
    if (positions.dim() != 2 or positions.shape[1] != len(cores)
            or not positions.is_contiguous()):
        raise ValueError(f"tt_eval_at_points: positions must be a "
                         f"contiguous (M, {len(cores)}) tensor, got "
                         f"{tuple(positions.shape)}")


def _launch(cores: Sequence[torch.Tensor], positions: torch.Tensor):
    """Pad the cores and launch K3 on checked CUDA inputs; returns (out,
    bad) on the card without reading ``bad`` (the count of indices outside
    the padded stack)."""
    device = cores[0].device
    stack, r = pad_cores(cores)
    d, _r, n, _ = stack.shape
    M = positions.shape[0]
    lib = _library()
    out = torch.empty((M,), dtype=stack.dtype, device=device)
    n_scratch = lib.xerus_tt_eval_scratch_elems(r, M)
    scratch = (torch.empty((n_scratch,), dtype=stack.dtype, device=device)
               if n_scratch else None)
    bad = torch.zeros((1,), dtype=torch.int32, device=device)
    fn = (lib.xerus_tt_eval_f32 if stack.dtype == torch.float32
          else lib.xerus_tt_eval_f64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(stack.data_ptr(), positions.data_ptr(), out.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                bad.data_ptr(), d, r, n, M, stream)
    if rc != 0:
        raise RuntimeError(f"tt_eval kernel launch failed: cudaError {rc}")
    tt_eval_at_points.launches += 1
    return out, bad


def tt_eval_at_points(cores: Sequence[torch.Tensor],
                      positions: torch.Tensor) -> torch.Tensor:
    """values[m] = TT[positions[m]] for cores (rl, n, rr) and positions
    (M, d) int64 on one device; returns (M,) in the cores' dtype.

    ``tt_eval_at_points.calls`` counts every call;
    ``tt_eval_at_points.launches`` counts the kernel launches, and only
    those.  On the card an index outside the padded stack raises
    ValueError after the launch (one 4-byte read to the host)."""
    tt_eval_at_points.calls += 1
    device = cores[0].device
    if device.type == "cpu":
        return tt_eval_at_points_reference(cores, positions)
    if device.type != "cuda":
        raise RuntimeError(f"tt_eval_at_points: no kernel for device "
                           f"{device}")
    _check(cores, positions)
    out, bad = _launch(cores, positions)
    n_bad = int(bad.item())
    if n_bad:
        raise ValueError(f"tt_eval_at_points: {n_bad} of {out.shape[0]} "
                         f"positions lie outside the mode sizes")
    return out


def reset_counters() -> None:
    """Zero the call and launch counts."""
    tt_eval_at_points.calls = 0
    tt_eval_at_points.launches = 0


reset_counters()
