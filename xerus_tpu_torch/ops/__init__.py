from . import als_kernels, df32, df_matvec, mixed_precision
from .mixed_precision import als_f32_df_run
