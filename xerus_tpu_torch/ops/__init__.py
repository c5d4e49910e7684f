from . import (als_kernels, df32, df_matvec, gemm_exact, mixed_precision,
               round_kernels)
from .mixed_precision import als_f32_df_run
from .round_kernels import (_round_randomized, randomized_round_flops,
                            round_flops, tt_round_sweep_segmented)
