from . import (adf_kernels, als_kernels, apply_kernels, df32, df_matvec,
               dmrg_kernels, gemm_exact, mixed_precision, round_kernels,
               sparse_kernels, stacking, tt_eval)
from .apply_kernels import (apply_operator_rounded,
                            apply_operator_rounded_cores)
from .dmrg_kernels import dmrg_groundstate_fast
from .mixed_precision import als_f32_df_run
from .round_kernels import (_round_randomized, randomized_round_flops,
                            round_flops, tt_round_sweep_segmented)
from .tt_eval import tt_eval_at_points
