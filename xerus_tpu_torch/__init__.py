"""xerus_tpu_torch: the PyTorch + CUDA port of xerus_tpu, for NVIDIA Hopper.

Imports torch and numpy, never jax.  The JAX package ``xerus_tpu`` stays
the reference that every ported function is tested against.  Ported so
far: the mixed-precision QTT Poisson ALS solve at core level
(``ops.mixed_precision.als_f32_df_run``) with its hand kernel K1, the
one-pass double-word matvec (``ops.df_matvec``, ``csrc/df_matvec.cu``);
deterministic and randomized TT rounding at core level
(``ops.round_kernels.tt_round_sweep_segmented``, ``_round_randomized``)
with its hand kernel K2, the certified GEMM-only truncation
(``ops.gemm_exact``, ``csrc/gemm_exact.cu``).
"""

from . import config
from .config import cuda_device, require
from . import convert, examples, ops
