from . import (adf_kernels, als_kernels, apply_kernels, df32, df_matvec,
               df_rounding, dmrg_kernels, gemm_exact, mixed_precision, ozaki,
               programs, round_kernels, round_uniform, small_eig,
               sparse_kernels, stacking, tt_eval)
from .adf_kernels import make_adf_iteration
from .als_kernels import (als_half_sweep_batched, als_sweep_flops,
                          make_als_multi_sweep_res, make_als_sweep,
                          make_als_sweep_res, tt_residual_rel)
from .apply_kernels import (apply_operator_rounded,
                            apply_operator_rounded_cores)
from .dmrg_kernels import dmrg_groundstate_fast
from .mixed_precision import als_f32_df_run
from .round_kernels import (SPEED_PRESETS, _round_randomized,
                            randomized_round_flops, round_flops,
                            tt_round_randomized, tt_round_sweep_segmented)
from .round_uniform import (tt_round_eps_fast, tt_round_randomized_uniform,
                            tt_round_streaming_uniform, tt_round_sweep,
                            tt_round_sweep_uniform)
from .ozaki import ozaki_matmul, ozaki_matmul_f32
from .df_cholesky import df_cholesky, df_solve_spd_chol
from .df_eigh import df_eigh, df_svd, df_svd_jw
from .df_rounding import tt_round_df, tt_round_df_from_f64
from .stacking import pad_cores
from .tt_eval import tt_eval_at_points
from .sparse_kernels import sparse_times_dense, dense_times_sparse
from .small_eig import small_eigh, small_svd
