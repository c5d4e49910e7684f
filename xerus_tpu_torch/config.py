"""Configuration of xerus_tpu_torch: the precision guard, checks, device.

Counterpart of ``xerus_tpu/config.py``.  Importing this module pins every
float32 matrix product to full float32: on the card, cuBLAS would otherwise
be free to run f32 products through TF32 (about 10 mantissa bits), the
counterpart of the TPU's bf16 default that stalled an f32 ALS solve at
residual 0.14, and to reduce bf16/fp16 products in reduced precision,
which breaks the exact f32 accumulation that split-GEMM error budgets
assume.
"""

from __future__ import annotations

import torch


def _pin_full_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


_pin_full_precision()


def require(cond: bool, msg: str = "") -> None:
    """REQUIRE analogue (xerus misc/check.h): raises ValueError on False."""
    if not cond:
        raise ValueError(msg or "xerus_tpu_torch runtime check failed")


def cuda_device() -> torch.device:
    """The CUDA device, or RuntimeError.  Never the CPU: a caller that asks
    for the card must not quietly run its work somewhere else."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")
