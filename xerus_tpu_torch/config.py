"""Configuration of xerus_tpu_torch: the precision guard, checks, device.

Counterpart of ``xerus_tpu/config.py``.  Importing this module pins every
float32 matrix product to full float32: on the card, cuBLAS would otherwise
be free to run f32 products through TF32 (about 10 mantissa bits), the
counterpart of the TPU's bf16 default that stalled an f32 ALS solve at
residual 0.14, and to reduce bf16/fp16 products in reduced precision,
which breaks the exact f32 accumulation that split-GEMM error budgets
assume.

The object layer (``core/``, ``indexing/``) computes on ``config.device``,
the card by default.  ``host()`` is the caller's explicit request for the
CPU; nothing in the port enters it by itself, and without a card every
object computation outside it raises ``RuntimeError``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def _pin_full_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


_pin_full_precision()


class _Config:
    """Mutable runtime configuration (the reference's config.mk)."""

    def __init__(self) -> None:
        # xerus is a double-precision library (basic.h:37-43); torch's own
        # default is float32, so the object layer names its dtype here
        self.value_dtype = np.dtype(np.float64)
        # dimension/format validation (XERUS_DISABLE_RUNTIME_CHECKS)
        self.runtime_checks = (
            os.environ.get("XERUS_TPU_DISABLE_CHECKS", "0") != "1")
        # dense <-> sparse switch heuristic factor (tensor.h:72)
        self.sparsity_factor = 4
        # NaN/Inf guards in solver loops
        self.nan_checks = os.environ.get("XERUS_TPU_NAN_CHECKS", "0") == "1"
        # where object computations run: the card unless host() is entered
        self.device = torch.device("cuda")

    @property
    def epsilon(self) -> float:
        """Default comparison tolerance: 8 * machine eps (basic.h:43)."""
        return 8.0 * float(np.finfo(self.value_dtype).eps)


config = _Config()


def value_dtype():
    return config.value_dtype


def set_value_dtype(dtype) -> None:
    config.value_dtype = np.dtype(dtype)


def torch_dtype() -> torch.dtype:
    """``config.value_dtype`` as a torch dtype."""
    return torch.from_numpy(np.empty((), config.value_dtype)).dtype


def EPSILON() -> float:
    return config.epsilon


def checks_enabled() -> bool:
    return config.runtime_checks


_COVERAGE = bool(os.environ.get("XERUS_TEST_COVERAGE"))


def _dump_coverage() -> None:
    from .misc import coverage
    coverage.dump_at_exit()


if _COVERAGE:
    import atexit
    atexit.register(_dump_coverage)


def require(cond: bool, msg: str = "") -> None:
    """REQUIRE analogue (xerus misc/check.h): raises ValueError on False
    while runtime checks are on.

    With XERUS_TEST_COVERAGE=1 every executed call records its call site
    as a coverage landmark (misc/coverage.py)."""
    if _COVERAGE:
        from .misc import coverage
        coverage.record_caller()
    if config.runtime_checks and not cond:
        raise ValueError(msg or "xerus_tpu_torch runtime check failed")


def cuda_device() -> torch.device:
    """The CUDA device, or RuntimeError.  Never the CPU: a caller that asks
    for the card must not quietly run its work somewhere else."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def compute_device() -> torch.device:
    """The device object computations run on now: the CPU inside
    ``host()``, else the card (``cuda_device()``, which raises without
    one)."""
    if config.device.type == "cpu":
        return config.device
    return cuda_device()


@contextlib.contextmanager
def host():
    """Context manager pinning object computations to the CPU, the
    caller's explicit request (the counterpart of ``xerus_tpu.host()``):

        with xt.host():
            A = xt.Tensor.random([8, 8])
            print(A.frob_norm())
    """
    saved = config.device
    config.device = torch.device("cpu")
    try:
        yield
    finally:
        config.device = saved
