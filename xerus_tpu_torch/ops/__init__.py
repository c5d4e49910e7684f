from . import (adf_kernels, als_kernels, df32, df_matvec, gemm_exact,
               mixed_precision, round_kernels, sparse_kernels, stacking,
               tt_eval)
from .mixed_precision import als_f32_df_run
from .round_kernels import (_round_randomized, randomized_round_flops,
                            round_flops, tt_round_sweep_segmented)
from .tt_eval import tt_eval_at_points
